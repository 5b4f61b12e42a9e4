"""Run-compressed traceback walk over direction-flag matrices.

Generic walk shared by the short-read mapper, the sharded mappers and
the wide-band two-pass aligner (alignment/wide.py): the flag matrix
stays in HBM and the walk jumps one CIGAR RUN per gather round.
Extracted from models/mapper.py (ref: the reference's per-thread flag
walk, nvbio/alignment/batched_banded_inl.h traceback path) so library
code below the models layer can use it without an upward import.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def runjump_walk(dirs_flat, STRIDE: int, i0, k0, active=None,
                  max_runs: int | None = None):
    """Run-level traceback walk: O(#CIGAR-runs) gather rounds.

    A per-step walk is a chain of ~2L dependent single-element gathers,
    each a separate device step regardless of its size.  The
    trace automaton's moves are runs — M-runs go straight down a band
    column, D-runs (E state) left along a row, I-runs (F state) down an
    anti-diagonal — so every cell's full run (length + landing cell) is
    precomputable with three *vectorized* scans over the flag matrix
    (no gathers), and the walk jumps one RUN per gather round: ~6-10
    rounds for 100 bp reads instead of ~460 steps.  (ref: the
    reference's per-thread flag walk, traceback_inl.h — same trace,
    batch-parallel run-compressed schedule.)

    Flag encoding (banded_directions_*): bits 0-1 H-source (0 diag,
    1 E, 2 F, 3 origin), bit 2 e_done, bit 3 f_done; cell (i, k) of the
    walk reads flag row i-1.

    Returns (p_start, t_k_final, run_ops (R, MAXR) uint8 codes
    {0 none, 1 M, 2 D, 3 I}, run_lens (R, MAXR) int32), runs in
    end->start walk order.
    """
    R, LPS = dirs_flat.shape
    ROWS = LPS // STRIDE
    F = dirs_flat.reshape(R, ROWS, STRIDE).astype(jnp.int32)
    f2 = F & 3

    # M-runs: consecutive diag flags down a column.  NZ[r, k] = last
    # row <= r with a non-diag flag (-1 if none); at a diag cell the
    # run lands at pattern row NZ+1 after r - NZ M ops.
    ridx = jnp.arange(ROWS, dtype=jnp.int32)[None, :, None]
    NZ = jax.lax.associative_scan(
        jnp.maximum, jnp.where(f2 != 0, ridx, -1), axis=1)
    # D-runs (E state): left along the row to the nearest gap-open.
    # EE[r, k] = last column <= k with e_done (-1 if none).
    cidx = jnp.arange(STRIDE, dtype=jnp.int32)[None, None, :]
    EE = jax.lax.associative_scan(
        jnp.maximum, jnp.where(((F >> 2) & 1) == 1, cidx, -1), axis=2)
    # I-runs (F state): down-right along an anti-diagonal (constant
    # text column).  G[r, k] = steps to the nearest f_done along it.
    BIG = jnp.int32(1 << 12)
    bit3 = ((F >> 3) & 1) == 1

    def gstep(carry, b3row):
        shifted = jnp.concatenate(
            [carry[:, 1:], jnp.full((R, 1), BIG, jnp.int32)], axis=1)
        g = jnp.where(b3row, 0, jnp.minimum(shifted + 1, BIG))
        return g, g

    _, Gs = jax.lax.scan(
        gstep, jnp.full((R, STRIDE), BIG, jnp.int32),
        bit3.transpose(1, 0, 2))
    G = Gs.transpose(1, 0, 2)

    # ONE packed int32 descriptor per cell: op(2) | term(1) | len(29).
    # The landing cell is arithmetic in (op, len) — M: (i-len, k),
    # D/E: (i, k-len), I/F: (i-len, k+len) — so the walk needs no
    # stored next-coords, the precompute materializes one output
    # array, and run lengths are unclipped (long-read CIGARs carry
    # multi-thousand M runs).
    m_len = ridx - NZ
    e_len = cidx - EE + 1
    f_len = G + 1
    is_m = f2 == 0
    is_e = f2 == 1
    is_f = f2 == 2
    ln = jnp.where(is_m, m_len, jnp.where(is_e, e_len, f_len))
    op = jnp.where(is_m, 1, jnp.where(is_e, 2, jnp.where(is_f, 3, 0)))
    # terminal: origin flag, or a garbage lane whose run never closes
    # (no e_done / f_done reachable) or lands outside the band —
    # genuine traces terminate via origin/i==0 inside the band; garbage
    # lanes (results discarded) must still STOP so the all-done early
    # exit is never pinned by a straggler
    term = ((f2 == 3) | (is_e & (EE <= 0)) | (is_f & (G >= BIG))
            | (is_f & (cidx + G + 1 >= STRIDE)))
    ln = jnp.clip(ln, 0, (1 << 29) - 1)
    desc = op | (term.astype(jnp.int32) << 2) | (ln << 3)
    desc_flat = desc.reshape(R, LPS)

    MAXR = 2 * ROWS + STRIDE + 4  # run-count bound (each round emits
    # >= 1 op or terminates; ops <= 2*ROWS + STRIDE for genuine paths)
    if max_runs is not None:
        # tighter score-budget bound (_max_cigar_runs): every lane a
        # caller will consume finishes within it; sub-threshold lanes
        # that would walk longer just stop with garbage runs, which
        # the score >= score-min gate discards.  MAXR sizes BOTH the
        # round count and the (MAXR, R) outputs shipped to the host.
        MAXR = min(MAXR, max_runs)

    def jbody(carry):
        i, k, done, t, rops, rlens = carry
        done = done | (i <= 0) | (k < 0) | (k >= STRIDE)
        idx = jnp.clip((i - 1) * STRIDE + k, 0, LPS - 1)
        d = jnp.take_along_axis(desc_flat, idx[:, None], axis=1)[:, 0]
        act = ~done & (((d >> 2) & 1) == 0)
        done = done | (((d >> 2) & 1) == 1)
        op = d & 3
        ln = d >> 3
        rops = jax.lax.dynamic_update_slice(
            rops, jnp.where(act, op, 0).astype(jnp.uint8)[None],
            (t, 0))
        rlens = jax.lax.dynamic_update_slice(
            rlens, jnp.where(act, ln, 0).astype(jnp.int32)[None],
            (t, 0))
        # landing cell from (op, len): M down the column, D left along
        # the row, I down-right along the anti-diagonal
        i = jnp.where(act & (op != 2), i - ln, i)
        k = jnp.where(act, k + jnp.where(op == 3, ln,
                                         jnp.where(op == 2, -ln, 0)), k)
        return (i, k, done, t + 1, rops, rlens)

    done0 = (jnp.zeros((R,), bool) if active is None
             else ~active.astype(bool))
    (fi, fk, _, _, rops, rlens) = jax.lax.while_loop(
        lambda c: (c[3] < MAXR) & ~jnp.all(c[2]),
        jbody,
        (i0, k0, done0, jnp.int32(0),
         jnp.zeros((MAXR, R), jnp.uint8),
         jnp.zeros((MAXR, R), jnp.int32)),
    )
    return fi, fk, rops.T, rlens.T
