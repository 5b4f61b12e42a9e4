"""Q-gram index: sorted (key, position) arrays + batched filter.

Ref parity: nvbio/qgram/qgram.h (``QGramIndexHost/Device::build``),
qgram/filter.h (``QGramFilter`` — batch seed-hit generation + diagonal
merging).  The q-group variant (qgroup.h) is a space optimization the
flat layout subsumes (device-resident sorted arrays + binary
search are already one gather per probe).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class QGramIndex(NamedTuple):
    q: int  # gram length
    keys: jnp.ndarray  # (m,) int32/int64 sorted q-gram keys
    pos: jnp.ndarray  # (m,) int32 text position of each key


def qgram_keys(text: np.ndarray, q: int) -> np.ndarray:
    """Rolling 2-bit keys of every length-q window (host, vectorized).

    Keys are int32 (q <= 15 at 2 bits/symbol) so device lookups work
    without jax_enable_x64."""
    if q > 15:
        raise ValueError("q-gram keys are int32: q <= 15")
    text = np.asarray(text, dtype=np.int32) & 3
    n = len(text) - q + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    keys = np.zeros(n, dtype=np.int32)
    for j in range(q):  # q is small (<= 16); windows are vectorized
        keys = (keys << 2) | text[j : j + n]
    return keys


def build_qgram_index(text: np.ndarray, q: int = 12) -> QGramIndex:
    keys = qgram_keys(text, q)
    order = np.argsort(keys, kind="stable")
    return QGramIndex(
        q=q,
        keys=jnp.asarray(keys[order]),
        pos=jnp.asarray(order.astype(np.int32)),
    )


def qgram_filter(index: QGramIndex, queries, offsets, max_hits: int):
    """Batched q-gram lookup with diagonal output.

    queries: (N,) int keys (one per extracted read q-gram);
    offsets: (N,) read offset of each q-gram (for diagonal binning).
    Returns (diag, valid): (N, max_hits) candidate text diagonals
    (hit_pos - offset) and validity mask — the reference's merged
    (diagonal-binned) hit output.
    """
    queries = jnp.asarray(queries, index.keys.dtype)
    lo = jnp.searchsorted(index.keys, queries, side="left")
    hi = jnp.searchsorted(index.keys, queries, side="right")
    t = jnp.arange(max_hits, dtype=jnp.int32)
    rows = lo[:, None] + t[None, :]
    valid = rows < hi[:, None]
    rows = jnp.clip(rows, 0, index.pos.shape[0] - 1)
    hit_pos = index.pos[rows]
    diag = hit_pos - offsets[:, None].astype(jnp.int32)
    return jnp.where(valid, diag, jnp.int32(-(1 << 30))), valid
