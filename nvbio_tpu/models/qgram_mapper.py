"""Q-gram-seeded mapper (examples/qmap equivalent).

Ref parity: examples/qmap/qmap.cu — the reference's q-gram-index
variant of the seed-and-extend mapper: read q-grams are looked up in a
sorted q-gram index of the genome (qgram/filter.h ``QGramFilter``,
diagonal-binned hits), then candidates flow through the same extension
/ reduce / traceback back half as the FM-index pipelines
(models/mapper.py ``extend_candidates``/``top2_finish``).

Hash seeding trades the FM-index's O(L) LF-gather chain per seed for a
single binary search per q-gram — fewer dependent gathers at the
cost of index size (one int64+int32 per genome position).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..fmindex import FMIndex
from ..qgram.index import QGramIndex, build_qgram_index, qgram_filter
from .mapper import Mapper, both_strands, extend_candidates, top2_finish
from .params import MapperParams


@functools.partial(
    jax.jit, static_argnames=("q", "stride", "max_hits", "params"))
def qgram_map_batch(
    fm: FMIndex,
    qidx: QGramIndex,
    genome,
    reads,
    lens,
    quals,
    *,
    q: int,
    stride: int,
    max_hits: int,
    params: MapperParams,
):
    """Forward q-gram mapping step; same output contract as
    ``mapper.map_batch``."""
    if q > 15:
        raise ValueError("q-gram keys are int32 (2 bits/symbol): q <= 15")
    R, L = reads.shape
    n = fm.n
    all_reads, all_quals, lens2 = both_strands(reads, lens, quals)

    # --- q-gram extraction at fixed stride (both strands) ---
    S = max(1, (L - q) // stride + 1)
    offs = (jnp.arange(S, dtype=jnp.int32) * stride)  # (S,)
    win_idx = offs[:, None] + jnp.arange(q, dtype=jnp.int32)[None, :]
    win = all_reads[:, win_idx]  # (2R, S, q)
    bad = (win >= 4).any(axis=-1) | (offs[None, :] + q > lens2[:, None])
    keys = jnp.zeros(win.shape[:2], jnp.int32)
    for j in range(q):
        keys = (keys << 2) | (win[:, :, j].astype(jnp.int32) & 3)
    keys = jnp.where(bad, jnp.int32(-1), keys)  # -1 never matches

    # --- q-gram filter: diagonal-binned hits ---
    diag, valid = qgram_filter(
        qidx, keys.reshape(-1),
        jnp.broadcast_to(offs[None, :], keys.shape).reshape(-1),
        max_hits,
    )  # (2R*S, max_hits)
    SENT = n + 2 * L + 1
    cand = jnp.where(valid, diag, SENT).reshape(2 * R, S * max_hits)
    cand = jnp.clip(cand, 0, SENT)

    cands = extend_candidates(
        fm, genome, all_reads, all_quals, lens2, cand,
        params=params)
    return top2_finish(cands, lens, params)


class QGramMapper(Mapper):
    ESCALATES = False  # escalation re-seeds uniformly
    """Host orchestration: builds the genome q-gram index once, then
    maps with q-gram seeding; SAM emit shared with the flagship."""

    def __init__(self, fm, ssa, genome_symbols: np.ndarray, *,
                 q: int = 14, stride: int = 8, max_hits: int = 8,
                 **kw):
        super().__init__(fm, ssa, genome_symbols, **kw)
        self.q = q
        self.stride = stride
        self.max_hits = max_hits
        self.qidx = build_qgram_index(np.asarray(genome_symbols), q=q)

    def _forward(self, jr, jl, jq, uniform_shift: int = -1,
                 params=None):
        del uniform_shift  # MEM/q-gram seeding reverse-complements per candidate
        return qgram_map_batch(
            self.fm, self.qidx, self.genome, jr, jl, jq,
            q=self.q, stride=self.stride, max_hits=self.max_hits,
            params=params or self.params)
