"""Batched banded Gotoh DP in pure JAX/XLA (reference semantics: SURVEY.md §3.5).

Replaces the reference's ``BatchedAlignmentScore`` /
``banded_alignment_score<BAND_LEN>`` (ref: nvbio/alignment/batched.h,
banded_inl.h) CUDA schedulers with a fully vectorized formulation:

- alignments ride the leading batch axis (the vectorized form of
  one-thread-per-alignment data parallelism);
- a `lax.scan` advances one DP row per step;
- the within-row horizontal-gap recurrence
  ``E[k] = max(E[k-1] - ge, Hhat[k-1] - go - ge)`` is solved exactly as a
  weighted cumulative max: ``E = cummax(A + k*ge) - k*ge``;
- band coordinates: cell (i, j) lives at k = j - i + w, so the diagonal
  dependency is at the same k, the vertical at k+1 of the previous row,
  and the horizontal at k-1 of the current row.

The GPU kernel (``nvbio_tpu.ops.banded_dp``) implements the same math
with one alignment per thread; this module is its oracle-checked XLA
twin, the engine on every other backend, and the reference it is
compared with.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties

DIAG, FROM_E, FROM_F, ORIGIN = 0, 1, 2, 3
PAD_SYMBOL = 7  # never matches; outside-text cells are masked anyway


def _subst_scores(p, q, tsl, scheme):
    """Vectorized substitution scores: p,q are (B,), tsl is (B, BAND).

    Accepts ``GotohScheme`` (quality-aware match/mismatch) or a
    ``MatrixScheme`` (substitution-matrix gather, e.g. BLOSUM62 for
    protein SW — ref: examples/proteinsw)."""
    if hasattr(scheme, "matrix"):
        mat = jnp.asarray(scheme.matrix_np)
        K = mat.shape[0]
        p_ = jnp.clip(p[:, None], 0, K - 1)
        t_ = jnp.clip(tsl, 0, K - 1)
        return mat[p_, t_].astype(jnp.int32)
    qc = jnp.minimum(q.astype(jnp.int32), 40)
    mm = scheme.mismatch_min + (
        (scheme.mismatch_max - scheme.mismatch_min) * qc
    ) // 40
    p_ = p[:, None]
    is_n = (p_ >= 4) | (tsl >= 4)
    match = p_ == tsl
    return jnp.where(
        is_n,
        -scheme.n_penalty,
        jnp.where(match, scheme.match, -mm[:, None]),
    ).astype(jnp.int32)


def _shift_up_k(x, fill=NEG_INF):
    """out[k] = x[k-1] (band axis is last)."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1
    )


def _shift_down_k(x, fill=NEG_INF):
    """out[k] = x[k+1]."""
    return jnp.concatenate(
        [x[..., 1:], jnp.full(x.shape[:-1] + (1,), fill, x.dtype)], axis=-1
    )


def _row0_scheme(tlens, band_w, atype, scheme, n_batch):
    B = 2 * band_w + 1
    j0 = jnp.arange(B, dtype=jnp.int32) - band_w
    if atype == AlignmentType.GLOBAL:
        h0 = jnp.where(
            j0 == 0,
            0,
            jnp.where(
                j0 > 0,
            -(scheme.gap_open + scheme.gap_extend * j0),  # leading text
            NEG_INF                                       # = E/read gap
            ),
        ).astype(jnp.int32)
    else:
        h0 = jnp.where(j0 >= 0, 0, NEG_INF).astype(jnp.int32)
    h0 = jnp.broadcast_to(h0, (n_batch, B))
    return jnp.where(j0[None, :] <= tlens[:, None], h0, NEG_INF)


def _row_step(H, F, p, q, tsl, valid, scheme, atype):
    """One DP row update in band coordinates.

    H, F: previous-row bands (B, BAND); p,q: pattern symbol/qual (B,);
    tsl: text symbols under the band (B, BAND); valid: cell validity of
    the new row (B, BAND).  Returns (H_new, F_new, E_new, Hdiag, A).
    """
    eo, ee, fo, fe = gap_penalties(scheme)
    s = _subst_scores(p, q, tsl, scheme)
    up_H = _shift_down_k(H)
    up_F = _shift_down_k(F)
    f_open = up_H - (fo + fe)
    f_ext = up_F - fe
    F_new = jnp.maximum(f_open, f_ext)
    Hdiag = H + s
    Hhat = jnp.maximum(Hdiag, F_new)
    if atype == AlignmentType.LOCAL:
        Hhat = jnp.maximum(Hhat, 0)
    Hhat_m = jnp.where(valid, Hhat, NEG_INF)
    A = _shift_up_k(Hhat_m) - (eo + ee)
    B = A.shape[-1]
    kk = jnp.arange(B, dtype=jnp.int32) * ee
    E_new = jax.lax.cummax(A + kk[None, :], axis=A.ndim - 1) - kk[None, :]
    H_new = jnp.maximum(Hhat, E_new)
    if atype == AlignmentType.LOCAL:
        H_new = jnp.maximum(H_new, 0)
    H_new = jnp.where(valid, H_new, NEG_INF)
    F_new = jnp.where(valid, F_new, NEG_INF)
    E_new = jnp.where(valid, E_new, NEG_INF)
    return H_new, F_new, E_new, Hdiag, A, f_open


def _pad_texts(texts, band_w, n_rows):
    """Pad so that padded[:, i0 + k] = text[i0 + k - w]."""
    B_, Lt = texts.shape
    need = n_rows + 2 * band_w + 1
    pad_right = max(0, need - band_w - Lt)
    return jnp.pad(
        texts, ((0, 0), (band_w, pad_right)), constant_values=PAD_SYMBOL
    )


@functools.partial(
    jax.jit, static_argnames=("scheme", "atype", "band_w")
)
def banded_score_batch(
    patterns,  # (B, Lp) int8/int32 symbols (0..3, 4=N); pad arbitrary
    plens,  # (B,) int32
    texts,  # (B, Lt) symbols
    tlens,  # (B,) int32
    quals=None,  # (B, Lp) or None
    *,
    scheme: GotohScheme,
    atype: AlignmentType,
    band_w: int,
):
    """Score-only banded alignment of each (pattern, text) pair.

    Returns dict with: ``score`` (B,) int32, ``p_end``, ``t_end`` (B,)
    int32 — DP cell coordinates of the winning sink (symbols consumed).
    Band: cells with |j - i| <= band_w.
    """
    patterns = patterns.astype(jnp.int32)
    texts = texts.astype(jnp.int32)
    plens = plens.astype(jnp.int32)
    tlens = tlens.astype(jnp.int32)
    nb, Lp = patterns.shape
    BAND = 2 * band_w + 1
    if quals is None:
        quals = jnp.full((nb, Lp), 40, jnp.int32)
    tp = _pad_texts(texts, band_w, Lp)
    H0 = _row0_scheme(tlens, band_w, atype, scheme, nb)
    F0 = jnp.full((nb, BAND), NEG_INF, jnp.int32)
    karange = jnp.arange(BAND, dtype=jnp.int32)

    if atype == AlignmentType.GLOBAL:
        k_goal = tlens - plens + band_w

    def step(carry, i0):
        H, F, best, best_i, best_k = carry
        p = patterns[:, i0]
        q = quals[:, i0]
        tsl = jax.lax.dynamic_slice_in_dim(tp, i0, BAND, axis=1)
        j = (i0 + 1) + karange[None, :] - band_w  # (1|B, BAND)
        valid = (j >= 0) & (j <= tlens[:, None])
        H_new, F_new, _, _, _, _ = _row_step(
            H, F, p, q, tsl, valid, scheme, atype
        )
        row = i0 + 1
        if atype == AlignmentType.GLOBAL:
            hit = row == plens
            h_goal = jnp.take_along_axis(
                H_new, jnp.clip(k_goal, 0, BAND - 1)[:, None], axis=1
            )[:, 0]
            best = jnp.where(hit, h_goal, best)
            best_i = jnp.where(hit, row, best_i)
            best_k = jnp.where(hit, k_goal, best_k)
        elif atype == AlignmentType.SEMI_GLOBAL:
            hit = row == plens
            row_best = jnp.max(H_new, axis=1)
            row_k = jnp.argmax(H_new, axis=1).astype(jnp.int32)
            upd = hit
            best = jnp.where(upd, row_best, best)
            best_i = jnp.where(upd, row, best_i)
            best_k = jnp.where(upd, row_k, best_k)
        else:  # LOCAL: best over all active rows, earliest (i, then j)
            active = row <= plens
            row_best = jnp.max(H_new, axis=1)
            row_k = jnp.argmax(H_new, axis=1).astype(jnp.int32)
            upd = active & (row_best > best)
            best = jnp.where(upd, row_best, best)
            best_i = jnp.where(upd, row, best_i)
            best_k = jnp.where(upd, row_k, best_k)
        return (H_new, F_new, best, best_i, best_k), None

    best0 = (
        jnp.zeros((nb,), jnp.int32)  # LOCAL: empty alignment scores 0
        if atype == AlignmentType.LOCAL
        else jnp.full((nb,), NEG_INF, jnp.int32)
    )
    init = (H0, F0, best0, jnp.zeros((nb,), jnp.int32),
            jnp.full((nb,), band_w, jnp.int32))
    (H, F, best, best_i, best_k), _ = jax.lax.scan(
        step, init, jnp.arange(Lp, dtype=jnp.int32)
    )
    t_end = best_i + best_k - band_w
    return {
        "score": best,
        "p_end": best_i,
        "t_end": jnp.maximum(t_end, 0),
    }


@functools.partial(
    jax.jit, static_argnames=("scheme", "atype", "band_w")
)
def banded_directions_batch(
    patterns,
    plens,
    texts,
    tlens,
    quals=None,
    *,
    scheme: GotohScheme,
    atype: AlignmentType,
    band_w: int,
):
    """Like `banded_score_batch` but also emits per-cell direction flags
    for traceback (uint8, bits 0-1: H source, bit 2: E open, bit 3: F
    open, per SURVEY.md §5.5 sense-1 checkpointing replaced by full
    direction storage — winners-only batches are small).

    Returns (result_dict, dirs) with dirs shaped (B, Lp, BAND).
    """
    patterns = patterns.astype(jnp.int32)
    texts = texts.astype(jnp.int32)
    plens = plens.astype(jnp.int32)
    tlens = tlens.astype(jnp.int32)
    nb, Lp = patterns.shape
    BAND = 2 * band_w + 1
    if quals is None:
        quals = jnp.full((nb, Lp), 40, jnp.int32)
    tp = _pad_texts(texts, band_w, Lp)
    H0 = _row0_scheme(tlens, band_w, atype, scheme, nb)
    F0 = jnp.full((nb, BAND), NEG_INF, jnp.int32)
    karange = jnp.arange(BAND, dtype=jnp.int32)

    def step(carry, i0):
        H, F = carry
        p = patterns[:, i0]
        q = quals[:, i0]
        tsl = jax.lax.dynamic_slice_in_dim(tp, i0, BAND, axis=1)
        j = (i0 + 1) + karange[None, :] - band_w
        valid = (j >= 0) & (j <= tlens[:, None])
        H_new, F_new, E_new, Hdiag, A, f_open = _row_step(
            H, F, p, q, tsl, valid, scheme, atype
        )
        flag = jnp.where(
            H_new == Hdiag,
            DIAG,
            jnp.where(H_new == E_new, FROM_E, FROM_F),
        ).astype(jnp.uint8)
        if atype == AlignmentType.LOCAL:
            flag = jnp.where(H_new <= 0, ORIGIN, flag)
        flag = jnp.where(valid, flag, ORIGIN)
        open_e = (E_new == A).astype(jnp.uint8) << 2
        open_f = (F_new == f_open).astype(jnp.uint8) << 3
        dirs = flag | open_e | open_f
        return (H_new, F_new), dirs

    (H, F), dirs = jax.lax.scan(
        step, (H0, F0), jnp.arange(Lp, dtype=jnp.int32)
    )
    res = banded_score_batch(
        patterns, plens, texts, tlens, quals,
        scheme=scheme, atype=atype, band_w=band_w,
    )
    return res, jnp.transpose(dirs, (1, 0, 2))


def window_slices(arr, starts, width: int):
    """Per-lane contiguous windows ``arr[s : s + width]`` fetched as
    one slice-level gather (vmapped dynamic_slice: one index per lane
    instead of ``width``).  Starts are clamped to ``[0, len - width]``
    by dynamic_slice semantics; callers keep a tail pad (the mapper's
    genome carries ``lt_pad`` PAD symbols) so no live lane clamps."""
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(arr, (s,), (width,)))(starts)
