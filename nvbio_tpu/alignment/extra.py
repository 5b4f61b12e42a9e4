"""Remaining aligner taxonomy: Hamming and full-matrix wrappers.

Ref parity: nvbio/alignment/alignment.h ``make_hamming_distance_aligner``
and the full-matrix (non-banded) ``alignment_score`` paths.  Here the
full matrix is the banded engine with the band covering every diagonal
— one code path, no separate kernel (the reference's Myers bit-vector
aligner is an implementation alternative for edit distance, which the
Gotoh engine already covers via EDIT_DISTANCE_SCHEME).
"""

from __future__ import annotations

import jax.numpy as jnp

from .batched import banded_score_batch
from .types import AlignmentType, GotohScheme


def hamming_score_batch(patterns, plens, texts, quals=None, *,
                        scheme: GotohScheme = GotohScheme()):
    """Gapless alignment at offset 0: sum of substitution scores over
    the pattern length (ref: hamming_inl.h semantics)."""
    patterns = patterns.astype(jnp.int32)
    texts = texts.astype(jnp.int32)
    R, L = patterns.shape
    if quals is None:
        quals = jnp.full((R, L), 40, jnp.int32)
    qc = jnp.minimum(quals.astype(jnp.int32), 40)
    mm = scheme.mismatch_min + (
        (scheme.mismatch_max - scheme.mismatch_min) * qc
    ) // 40
    t = texts[:, :L]
    is_n = (patterns >= 4) | (t >= 4)
    s = jnp.where(is_n, -scheme.n_penalty,
                  jnp.where(patterns == t, scheme.match, -mm))
    mask = jnp.arange(L)[None, :] < plens[:, None]
    return jnp.sum(jnp.where(mask, s, 0), axis=1).astype(jnp.int32)


def full_score_batch(patterns, plens, texts, tlens, quals=None, *,
                     scheme: GotohScheme, atype: AlignmentType):
    """Full-matrix DP: the banded engine with a band spanning all
    diagonals (band_w >= max(Lp, Lt))."""
    band_w = max(patterns.shape[1], texts.shape[1])
    return banded_score_batch(
        patterns, plens, texts, tlens, quals,
        scheme=scheme, atype=atype, band_w=band_w,
    )
