"""Approximate (<=1 mismatch) seed search over the FM-index.

Ref parity: nvbio/fmindex/backtrack.h — ``hamming_backtrack()``, the
DFS-with-stack kernel behind nvBowtie's ``-N 1`` seeding
(mapping_inl.h ``map_approx``).

Batched reformulation: the DFS over one-substitution branches
becomes a *wavefront of all branches at once*.  One exact backward
pass records the SA range of every seed suffix; then a second scan
walks positions right-to-left carrying the state of every (position p,
substitute b) branch simultaneously — branch (p, b) is born at step
j == p from the stored suffix range, extended with b, and from then on
follows the exact symbols.  Fixed (N, L, 4) shapes, no stack, no
divergence — the XLA replacement for the reference's per-thread
backtracking stack (SURVEY.md §3.12).

Cost: O(L) rank4 steps on an (N, L, 4) state = O(L^2) ranks per seed,
the same total work as the DFS without its warp divergence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .index import FMIndex, rank


@functools.partial(jax.jit, static_argnames=())
def hamming_backtrack_1(fm: FMIndex, seeds, slens=None):
    """All exact and 1-substitution SA ranges of each seed.

    seeds: (N, L) int32 symbols, left-aligned; slens: (N,) effective
    lengths (None = L).  Returns dict:
      exact_lo/exact_hi — (N,) exact-match range;
      lo/hi — (N, L, 4) range of the seed with position p substituted
        by base b;
      valid — (N, L, 4) True where p < slen, b != seed[p], range
        non-empty, and the seed has no N inside (those entries are
        masked out).
    """
    seeds = jnp.asarray(seeds, jnp.int32)
    N, L = seeds.shape
    if slens is None:
        slens = jnp.full((N,), L, jnp.int32)
    slens = jnp.asarray(slens, jnp.int32)
    n1 = fm.n + 1

    def lf(c, lo, hi):
        nlo = fm.C[c] + rank(fm, c, lo)
        nhi = fm.C[c] + rank(fm, c, hi)
        return nlo, nhi

    # ---- pass 1: exact suffix ranges (right-to-left) ----
    lo0 = jnp.zeros((N,), jnp.int32)
    hi0 = jnp.full((N,), n1, jnp.int32)

    def exact_step(carry, pos):
        lo, hi = carry
        c = seeds[:, pos]
        active = pos < slens
        bad = c >= 4
        c4 = jnp.minimum(c, 3)
        nlo, nhi = lf(c4, lo, hi)
        nlo = jnp.where(bad, 0, nlo)
        nhi = jnp.where(bad, 0, nhi)
        lo = jnp.where(active, nlo, lo)
        hi = jnp.where(active, nhi, hi)
        return (lo, hi), (lo, hi)

    positions = jnp.arange(L - 1, -1, -1, dtype=jnp.int32)
    (elo, ehi), (suf_lo, suf_hi) = jax.lax.scan(
        exact_step, (lo0, hi0), positions
    )
    # suffix range entering step at position pos (range of seed[pos+1:]):
    # for scan index k (pos = L-1-k), the INPUT range is the previous
    # output; build tables indexed by pos.
    suf_lo_by_pos = jnp.flip(suf_lo, axis=0)  # (L, N): range of seed[pos:]
    suf_hi_by_pos = jnp.flip(suf_hi, axis=0)
    # range of seed[pos+1:] = table at pos+1 (pos = L-1 -> full range)
    start_lo = jnp.concatenate(
        [suf_lo_by_pos[1:], jnp.zeros((1, N), jnp.int32)], axis=0)
    start_hi = jnp.concatenate(
        [suf_hi_by_pos[1:], jnp.full((1, N), n1, jnp.int32)], axis=0)
    # positions >= slen have no branch; exact range:
    # the scan left ranges unchanged beyond slen, so elo/ehi are correct

    # ---- pass 2: all (p, b) branches in one wavefront ----
    bases = jnp.arange(4, dtype=jnp.int32)[None, None, :]  # (1, 1, 4)
    blo0 = jnp.zeros((N, L, 4), jnp.int32)
    bhi0 = jnp.zeros((N, L, 4), jnp.int32)

    def branch_step(carry, pos):
        blo, bhi = carry
        # branches born at this position: substitute b for seed[pos]
        s_lo = start_lo[pos][:, None, None]  # (N, 1, 1)
        s_hi = start_hi[pos][:, None, None]
        born_lo, born_hi = lf(
            jnp.broadcast_to(bases, (N, 1, 4)),
            jnp.broadcast_to(s_lo, (N, 1, 4)),
            jnp.broadcast_to(s_hi, (N, 1, 4)),
        )
        p_idx = jnp.arange(L, dtype=jnp.int32)[None, :, None]
        is_born = p_idx == pos
        # branches already alive (p > pos): extend with the exact symbol
        c = seeds[:, pos]
        bad = c >= 4
        c4 = jnp.minimum(c, 3)[:, None, None]
        ext_lo, ext_hi = lf(
            jnp.broadcast_to(c4, blo.shape), blo, bhi)
        ext_lo = jnp.where(bad[:, None, None], 0, ext_lo)
        ext_hi = jnp.where(bad[:, None, None], 0, ext_hi)
        alive = p_idx > pos
        nlo = jnp.where(is_born, jnp.broadcast_to(born_lo, blo.shape),
                        jnp.where(alive, ext_lo, blo))
        nhi = jnp.where(is_born, jnp.broadcast_to(born_hi, bhi.shape),
                        jnp.where(alive, ext_hi, bhi))
        # freeze positions beyond the seed length
        in_seed = (p_idx < slens[:, None, None]) & (
            pos < slens[:, None, None])
        blo = jnp.where(in_seed, nlo, blo)
        bhi = jnp.where(in_seed, nhi, bhi)
        return (blo, bhi), None

    (blo, bhi), _ = jax.lax.scan(branch_step, (blo0, bhi0), positions)

    p_idx = jnp.arange(L, dtype=jnp.int32)[None, :, None]
    seed_at_p = seeds[:, :, None]
    has_n = (jnp.where(
        jnp.arange(L)[None, :] < slens[:, None], seeds, 0) >= 4).any(
        axis=1)
    valid = (
        (p_idx < slens[:, None, None])
        & (jnp.arange(4)[None, None, :] != seed_at_p)
        & (bhi > blo)
        & ~has_n[:, None, None]
    )
    return {
        "exact_lo": elo,
        "exact_hi": ehi,
        "lo": blo,
        "hi": bhi,
        "valid": valid,
    }
