"""Myers bit-vector edit distance (batched, VPU-friendly).

Ref parity: nvbio/alignment/myers_inl.h — ``make_myers_aligner``, the
reference's bit-parallel scoring-only edit-distance aligner.  The
algorithm (Myers 1999, with Hyyrö's formulation) advances one text
column per step using only bitwise ops and one addition per word —
which vectorizes well: each 32-bit word lives in an int32
lane, the batch is the leading axis, and the text scan is a
``lax.scan``.  Cost: O(Lt * ceil(Lp/32)) vector ops per alignment
versus O(Lt * Lp) cells for the DP engine — the reason the reference
offers Myers for short-pattern edit-distance batches.

Modes:
- GLOBAL: edit distance of pattern vs the whole text.
- SEMI_GLOBAL (search): min edit distance of pattern vs any text
  substring (text ends free) + its end position.

Multi-word (Lp > 32) is supported with explicit carry propagation
across the statically-unrolled word axis.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .types import AlignmentType

_ONE = np.uint32(1)


def _add_with_carry(a, b):
    """(a + b) over (N, W) uint32 words, little-endian word order."""
    W = a.shape[1]
    out = []
    carry = jnp.zeros(a.shape[:1], jnp.uint32)
    for w in range(W):
        s = a[:, w] + b[:, w] + carry
        # carry out: s < a (wrapped) or (s == a and carry was set)
        carry = ((s < a[:, w]) | ((s == a[:, w]) & (carry == 1))).astype(
            jnp.uint32)
        out.append(s)
    return jnp.stack(out, axis=1)


def _shift_left1(x, fill):
    """(x << 1) across words with per-element fill bit into bit 0."""
    W = x.shape[1]
    out = []
    carry = fill.astype(jnp.uint32)
    for w in range(W):
        out.append((x[:, w] << _ONE) | carry)
        carry = x[:, w] >> np.uint32(31)
    return jnp.stack(out, axis=1)


@functools.partial(jax.jit, static_argnames=("atype",))
def _myers(patterns, plens, texts, tlens, atype: AlignmentType):
    N, Lp = patterns.shape
    _, Lt = texts.shape
    W = (Lp + 31) // 32

    # Peq[c]: per pattern, bitmask of positions equal to symbol c
    bitpos = jnp.arange(Lp, dtype=jnp.int32)
    word_of = bitpos // 32
    bit_of = (bitpos % 32).astype(jnp.uint32)
    in_len = bitpos[None, :] < plens[:, None]  # (N, Lp)

    def peq_for(c):
        hit = (patterns == c) & in_len  # (N, Lp)
        bits = jnp.where(hit, _ONE << bit_of[None, :], 0).astype(jnp.uint32)
        return jax.vmap(
            lambda b: jnp.zeros(W, jnp.uint32).at[word_of].add(b)
        )(bits)

    peq = jnp.stack([peq_for(c) for c in range(4)], axis=1)  # (N, 4, W)

    # masks for the per-element final bit (pattern end)
    m1 = jnp.maximum(plens - 1, 0)
    end_word = m1 // 32  # (N,)
    end_bit = (m1 % 32).astype(jnp.uint32)
    lens_mask = jax.vmap(
        lambda m: jnp.where(
            jnp.arange(W) < (m + 31) // 32,
            jnp.where(
                jnp.arange(W) == (m - 1) // 32,
                jnp.where(m % 32 == 0, ~jnp.uint32(0),
                          (_ONE << (m % 32).astype(jnp.uint32)) - _ONE),
                ~jnp.uint32(0),
            ),
            jnp.uint32(0),
        )
    )(jnp.maximum(plens, 1))  # (N, W) low plens bits set

    vp0 = lens_mask
    vn0 = jnp.zeros((N, W), jnp.uint32)
    dist0 = plens.astype(jnp.int32)
    best0 = jnp.where(plens > 0, jnp.int32(1 << 30), 0)
    bestj0 = jnp.zeros((N,), jnp.int32)
    fill = jnp.ones((N,), jnp.uint32) if atype == AlignmentType.GLOBAL \
        else jnp.zeros((N,), jnp.uint32)

    def step(carry, j):
        vp, vn, dist, best, bestj = carry
        c = texts[:, j].astype(jnp.int32)
        eq = jnp.where(
            (c[:, None] < 4),
            peq[jnp.arange(N), jnp.minimum(c, 3)],
            jnp.uint32(0),
        )  # (N, W)
        xv = eq | vn
        xh = (_add_with_carry(eq & vp, vp) ^ vp) | eq
        ph = vn | ~(xh | vp)
        mh = vp & xh
        ebit = (
            jnp.take_along_axis(ph, end_word[:, None], axis=1)[:, 0]
            >> end_bit
        ) & _ONE
        mbit = (
            jnp.take_along_axis(mh, end_word[:, None], axis=1)[:, 0]
            >> end_bit
        ) & _ONE
        ndist = dist + ebit.astype(jnp.int32) - mbit.astype(jnp.int32)
        ph = _shift_left1(ph, fill) & lens_mask
        mh = _shift_left1(mh, jnp.zeros((N,), jnp.uint32)) & lens_mask
        nvp = (mh | ~(xv | ph)) & lens_mask
        nvn = (ph & xv) & lens_mask
        active = j < tlens
        vp = jnp.where(active[:, None], nvp, vp)
        vn = jnp.where(active[:, None], nvn, vn)
        dist = jnp.where(active, ndist, dist)
        upd = active & (dist < best)
        best = jnp.where(upd, dist, best)
        bestj = jnp.where(upd, j + 1, bestj)
        return (vp, vn, dist, best, bestj), None

    (vp, vn, dist, best, bestj), _ = jax.lax.scan(
        step, (vp0, vn0, dist0, best0, bestj0),
        jnp.arange(Lt, dtype=jnp.int32),
    )
    if atype == AlignmentType.GLOBAL:
        return dist, tlens
    best = jnp.minimum(best, dist0)  # empty-text alignment
    return best, bestj


def myers_edit_distance_batch(patterns, plens, texts, tlens, *,
                              atype: AlignmentType = AlignmentType.SEMI_GLOBAL):
    """Batched bit-vector edit distance.

    patterns: (N, Lp) symbols (>=4 treated as never-matching), plens,
    texts: (N, Lt), tlens.  Returns (distance, t_end): for SEMI_GLOBAL
    the min distance over text end positions and the (1-based) end; for
    GLOBAL the distance consuming the whole text.
    """
    if atype == AlignmentType.LOCAL:
        raise ValueError("Myers aligner is GLOBAL/SEMI_GLOBAL only")
    return _myers(
        jnp.asarray(patterns, jnp.int32),
        jnp.asarray(plens, jnp.int32),
        jnp.asarray(texts, jnp.int32),
        jnp.asarray(tlens, jnp.int32),
        atype,
    )


def edit_distance_oracle(pat, text, atype=AlignmentType.SEMI_GLOBAL):
    """Scalar Levenshtein DP oracle (NumPy) for tests."""
    pat = np.asarray(pat)
    text = np.asarray(text)
    m, n = len(pat), len(text)
    D = np.zeros((m + 1, n + 1), np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1) if atype == AlignmentType.GLOBAL else 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = 0 if (pat[i - 1] == text[j - 1] and pat[i - 1] < 4) else 1
            D[i, j] = min(D[i - 1, j - 1] + sub, D[i - 1, j] + 1,
                          D[i, j - 1] + 1)
    if atype == AlignmentType.GLOBAL:
        return int(D[m, n])
    return int(D[m, :].min())
