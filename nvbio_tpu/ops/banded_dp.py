"""Banded Gotoh DP on the GPU, and the one place the DP engine is chosen.

The XLA twin (``alignment.batched``) advances one DP row per
``lax.scan`` step, and every step reads and writes the lanes x band
state in device memory.  The kernel here follows the reference's
banded aligners instead (ref: nvbio/alignment/banded_inl.h —
``banded_alignment_score``; batched.h — one thread per alignment):

- one alignment per lane of a ``BLOCK``-lane program (Pallas
  ``backend="triton"``);
- the band's H/F state and the text symbols under it are Python-unrolled
  lists of ``(BLOCK,)`` vectors, so they live in registers for the whole
  alignment; the row loop runs inside the kernel, and nothing carries
  across the grid;
- the within-row E recurrence is the plain left-to-right
  ``E[k] = max(A[k], E[k-1] - ge)``, which equals the twin's weighted
  cumulative max exactly;
- pattern, quality and text rows are read from ``(seq, batch)``-major
  staged arrays, so each row is one coalesced load per operand, and the
  direction flags of a row are stored straight to device memory.

Semantics are the twin's, bit for bit: the same int32 recurrences, the
same masks and the same sink tie-breaks (``tests/test_banded_pallas.py``
checks them in interpret mode; ``chip_smoke.py`` on the card).

``select_banded_dp`` keys the engine on the backend and the band:
bands wider than ``TRITON_MAX_BAND_W`` (the PE rescue chunks) and
substitution-matrix schemes take the twin.  ``banded_score`` and
``banded_directions`` are the entry points every model calls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..alignment.batched import (PAD_SYMBOL, banded_directions_batch,
                                 banded_score_batch)
from ..alignment.types import AlignmentType, NEG_INF, gap_penalties

#: widest band half-width the register-resident kernel takes: three
#: band vectors (H, F, text) of 2w+1 int32 values per thread plus the
#: row's temporaries stay within ~128 registers at w = 16
TRITON_MAX_BAND_W = 16
#: alignments per program: one per thread of four warps
BLOCK = 128


def select_banded_dp(backend: str, band_w: int, scheme=None) -> str:
    """The banded DP engine for ``backend`` at half-width ``band_w``:
    ``"triton"`` (the kernel below) or ``"xla"`` (the twin)."""
    if (backend == "gpu" and band_w <= TRITON_MAX_BAND_W
            and not hasattr(scheme, "matrix")):
        return "triton"
    return "xla"


def _engine(band_w, scheme) -> str:
    return select_banded_dp(jax.default_backend(), band_w, scheme)


def banded_score(patterns, plens, texts, tlens, quals=None, *, scheme,
                 atype, band_w):
    """Score-only banded alignment on the selected engine; the
    contract of ``alignment.banded_score_batch``."""
    if _engine(band_w, scheme) == "triton":
        return banded_score_triton(patterns, plens, texts, tlens, quals,
                                   scheme=scheme, atype=atype,
                                   band_w=band_w)
    return banded_score_batch(patterns, plens, texts, tlens, quals,
                              scheme=scheme, atype=atype, band_w=band_w)


def banded_directions(patterns, plens, texts, tlens, quals=None, *,
                      scheme, atype, band_w):
    """Sinks plus per-cell direction flags on the selected engine; the
    contract of ``alignment.banded_directions_batch`` (flags shaped
    (NB, Lp, 2*band_w+1))."""
    if _engine(band_w, scheme) == "triton":
        return banded_directions_triton(
            patterns, plens, texts, tlens, quals, scheme=scheme,
            atype=atype, band_w=band_w)
    return banded_directions_batch(patterns, plens, texts, tlens, quals,
                                   scheme=scheme, atype=atype,
                                   band_w=band_w)


def _make_kernel(Lp: int, scheme, atype: AlignmentType, band_w: int):
    BAND = 2 * band_w + 1
    eo, ee, fo, fe = gap_penalties(scheme)
    local = atype == AlignmentType.LOCAL
    NEG = np.int32(NEG_INF)  # numpy scalars: a kernel captures no arrays

    def kernel(pat_ref, qual_ref, text_ref, plen_ref, tlen_ref, out_ref,
               dirs_ref=None):
        plen = plen_ref[0, :]
        tlen = tlen_ref[0, :]
        zero = jnp.zeros_like(plen)
        # row 0 (the twin's _row0_scheme): j0 = k - w text symbols
        # consumed before the pattern starts
        H0 = []
        for k in range(BAND):
            j0 = k - band_w
            if atype == AlignmentType.GLOBAL:
                h = 0 if j0 == 0 else (
                    -(scheme.gap_open + scheme.gap_extend * j0)
                    if j0 > 0 else NEG_INF)
            else:
                h = 0 if j0 >= 0 else NEG_INF
            H0.append(jnp.where(j0 <= tlen, np.int32(h), NEG))
        F0 = [jnp.full_like(plen, NEG_INF) for _ in range(BAND)]
        T0 = [text_ref[k, :] for k in range(BAND)]
        best0 = zero if local else jnp.full_like(plen, NEG_INF)
        if atype == AlignmentType.GLOBAL:
            k_goal = tlen - plen + band_w
            k_clip = jnp.clip(k_goal, 0, BAND - 1)

        def row(i0, carry):
            H, F, T, best, best_i, best_k = carry
            p = pat_ref[i0, :]
            q = jnp.minimum(qual_ref[i0, :], 40)
            mm = scheme.mismatch_min + (
                (scheme.mismatch_max - scheme.mismatch_min) * q) // 40
            p_n = p >= 4
            r = i0 + 1
            Hn, Fn = [], []
            e_run = h_prev_m = None  # E chain; masked Hhat of cell k-1
            for k in range(BAND):
                t = T[k]
                s = jnp.where(p_n | (t >= 4), np.int32(-scheme.n_penalty),
                              jnp.where(p == t, np.int32(scheme.match),
                                        -mm))
                up_h = H[k + 1] if k + 1 < BAND else NEG
                up_f = F[k + 1] if k + 1 < BAND else NEG
                f_open = up_h - (fo + fe)
                f_new = jnp.maximum(f_open, up_f - fe)
                h_diag = H[k] + s
                hhat = jnp.maximum(h_diag, f_new)
                if local:
                    hhat = jnp.maximum(hhat, 0)
                j = r + (k - band_w)
                valid = (j >= 0) & (j <= tlen)
                a = (h_prev_m if k else NEG) - (eo + ee)
                e_run = a if k == 0 else jnp.maximum(a, e_run - ee)
                h_new = jnp.maximum(hhat, e_run)
                if local:
                    h_new = jnp.maximum(h_new, 0)
                h_new = jnp.where(valid, h_new, NEG)
                f_new = jnp.where(valid, f_new, NEG)
                if dirs_ref is not None:
                    e_new = jnp.where(valid, e_run, NEG)
                    flag = jnp.where(h_new == h_diag, 0,
                                     jnp.where(h_new == e_new, 1, 2))
                    if local:
                        flag = jnp.where(h_new <= 0, 3, flag)
                    flag = jnp.where(valid, flag, 3)
                    flag = (flag | ((e_new == a).astype(jnp.int32) << 2)
                            | ((f_new == f_open).astype(jnp.int32) << 3))
                    dirs_ref[i0 * BAND + k, :] = flag.astype(jnp.uint8)
                h_prev_m = jnp.where(valid, hhat, NEG)
                Hn.append(h_new)
                Fn.append(f_new)
            # sink bookkeeping (the twin's per-row best update)
            if atype == AlignmentType.GLOBAL:
                hit = r == plen
                hg = Hn[0]
                for k in range(1, BAND):
                    hg = jnp.where(k_clip == k, Hn[k], hg)
                best = jnp.where(hit, hg, best)
                best_i = jnp.where(hit, r, best_i)
                best_k = jnp.where(hit, k_goal, best_k)
            else:
                rb, rk = Hn[0], zero
                for k in range(1, BAND):
                    up = Hn[k] > rb
                    rb = jnp.where(up, Hn[k], rb)
                    rk = jnp.where(up, k, rk)
                upd = ((r <= plen) & (rb > best)) if local else r == plen
                best = jnp.where(upd, rb, best)
                best_i = jnp.where(upd, r, best_i)
                best_k = jnp.where(upd, rk, best_k)
            # slide the text window one symbol: row i0+1 reads staged
            # rows i0+1 .. i0+BAND
            T = T[1:] + [text_ref[i0 + BAND, :]]
            return Hn, Fn, T, best, best_i, best_k

        carry = (H0, F0, T0, best0, zero, zero + band_w)
        _, _, _, best, best_i, best_k = jax.lax.fori_loop(0, Lp, row, carry)
        out_ref[0, :] = best
        out_ref[1, :] = best_i
        out_ref[2, :] = jnp.maximum(best_i + best_k - band_w, 0)
        out_ref[3, :] = zero

    return kernel


def _stage(patterns, plens, texts, tlens, quals, band_w):
    """(seq, batch)-major operands padded to whole programs: staged
    text row m holds text[m - band_w] (PAD_SYMBOL outside the text)."""
    NB, Lp = patterns.shape
    BAND = 2 * band_w + 1
    nbp = -(-NB // BLOCK) * BLOCK
    padb = nbp - NB
    if quals is None:
        quals = jnp.full((NB, Lp), 40, jnp.int32)
    pats_t = jnp.pad(patterns.astype(jnp.int32), ((0, padb), (0, 0)),
                     constant_values=PAD_SYMBOL).T
    quals_t = jnp.pad(quals.astype(jnp.int32), ((0, padb), (0, 0))).T
    Lt = texts.shape[1]
    rows = Lp + BAND  # the window slides one row past the last DP row
    texts_t = jnp.pad(
        texts.astype(jnp.int32),
        ((0, padb), (band_w, max(0, rows - band_w - Lt))),
        constant_values=PAD_SYMBOL)[:, :rows].T
    lens = lambda x: jnp.pad(x.astype(jnp.int32), (0, padb))[None, :]
    return (pats_t, quals_t, texts_t, lens(plens), lens(tlens)), nbp


def _call(Lp, nbp, band_w, scheme, atype, with_dirs, interpret, ops):
    BAND = 2 * band_w + 1
    spec = lambda rows: pl.BlockSpec((rows, BLOCK), lambda b: (0, b))
    out_shape = [jax.ShapeDtypeStruct((4, nbp), jnp.int32)]
    out_specs = [spec(4)]
    if with_dirs:
        out_shape.append(jax.ShapeDtypeStruct((Lp * BAND, nbp), jnp.uint8))
        out_specs.append(spec(Lp * BAND))
    return pl.pallas_call(
        _make_kernel(Lp, scheme, atype, band_w),
        out_shape=out_shape,
        grid=(nbp // BLOCK,),
        in_specs=[spec(Lp), spec(Lp), spec(Lp + BAND), spec(1), spec(1)],
        out_specs=out_specs,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=BLOCK // 32,
                                                num_stages=1),
        interpret=interpret,
        name="banded_dirs" if with_dirs else "banded_score",
    )(*ops)


def _result(out, NB):
    return {"score": out[0, :NB], "p_end": out[1, :NB],
            "t_end": out[2, :NB]}


@functools.partial(jax.jit, static_argnames=("scheme", "atype", "band_w",
                                             "interpret"))
def banded_score_triton(patterns, plens, texts, tlens, quals=None, *,
                        scheme, atype, band_w, interpret=False):
    """Kernel twin of ``alignment.banded_score_batch`` (any NB)."""
    NB, Lp = patterns.shape
    ops, nbp = _stage(patterns, plens, texts, tlens, quals, band_w)
    (out,) = _call(Lp, nbp, band_w, scheme, atype, False, interpret, ops)
    return _result(out, NB)


@functools.partial(jax.jit, static_argnames=("scheme", "atype", "band_w",
                                             "interpret"))
def banded_directions_triton(patterns, plens, texts, tlens, quals=None, *,
                             scheme, atype, band_w, interpret=False):
    """Kernel twin of ``alignment.banded_directions_batch``: one pass
    emits the sinks and the (NB, Lp, 2*band_w+1) uint8 flags."""
    NB, Lp = patterns.shape
    ops, nbp = _stage(patterns, plens, texts, tlens, quals, band_w)
    out, dirs = _call(Lp, nbp, band_w, scheme, atype, True, interpret, ops)
    dirs = dirs.T[:NB].reshape(NB, Lp, 2 * band_w + 1)
    return _result(out, NB), dirs
