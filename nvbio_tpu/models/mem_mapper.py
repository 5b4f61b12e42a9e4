"""MEM-seeded mapper ("nvMem" equivalent).

The reference ships a BWA-MEM-style example mapper built on its MEM
filter (ref: examples/mem/mem.cu over nvbio/fmindex/mem.h —
``MEMFilter``/``find_mems``; "nvMem" in BASELINE.md).  Pipeline here:

    SMEM search (fixed-shape, fmindex/mem.py) -> top-K SMEM selection
    by length -> SA-interval expansion + locate -> diagonal dedupe ->
    banded Gotoh extension -> top-2 reduce -> MAPQ -> traceback/SAM

The back half (extension, reduce, traceback, SAM emit) is shared with
the nvBowtie-equivalent pipeline (models/mapper.py); only the seeding
strategy differs, mirroring how the reference's example reuses the
library alignment layer.  Seed *chaining* is approximated by diagonal
dedupe + extension scoring: collinear SMEMs land on one diagonal and
are scored once, which matches the example's single-extension-per-
candidate behavior (the reference's chaining details are uncertain,
SURVEY.md §3.9 [L]).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..fmindex import FMIndex, SSA, locate
from ..fmindex.mem import find_mems
from .mapper import Mapper, both_strands, extend_candidates, top2_finish
from .params import MapperParams


@functools.partial(jax.jit, static_argnames=("params",))
def mem_map_batch(
    fm: FMIndex,
    ssa: SSA,
    genome,
    reads,  # (R, L) int8
    lens,  # (R,) int32
    quals,
    *,
    params: MapperParams,
):
    """Forward MEM-mapping step; same output contract as
    ``mapper.map_batch`` (per-read best/second/strand/mapq)."""
    R, L = reads.shape
    K = params.max_smems
    CAP = params.max_hits_per_seed
    n = fm.n

    all_reads, all_quals, lens2 = both_strands(reads, lens, quals)

    # --- SMEM search (both strands at once) ---
    mems = find_mems(fm, all_reads, lens2, max_len=L,
                     min_len=params.min_mem_len)

    # --- top-K SMEMs per read-strand by match length ---
    val = jnp.where(mems["smem"], mems["len"], -1)
    order = jnp.argsort(-val, axis=1)[:, :K]  # (2R, K) end indices e-1
    take = lambda a: jnp.take_along_axis(a, order, axis=1)
    k_len = take(mems["len"])
    k_lo = take(mems["lo"])
    k_hi = take(mems["hi"])
    k_ok = take(val) > 0

    sizes = jnp.where(k_ok, k_hi - k_lo, 0)
    use = jnp.where(sizes > params.max_range, 0, jnp.minimum(sizes, CAP))

    # --- SA-interval expansion + locate ---
    t = jnp.arange(CAP, dtype=jnp.int32)
    rows = k_lo[:, :, None] + t[None, None, :]  # (2R, K, CAP)
    hit_ok = t[None, None, :] < use[:, :, None]
    rows_safe = jnp.clip(rows, 0, n).reshape(-1)
    pos = locate(fm, ssa, rows_safe, k_sample=params.sa_sample)
    pos = pos.reshape(2 * R, K, CAP)

    # candidate window start = hit position - read offset of the SMEM
    start_in_read = order + 1 - k_len  # e = order+1; SMEM spans [e-len, e)
    SENT = n + 2 * L + 1
    cand = jnp.where(hit_ok, pos - start_in_read[:, :, None], SENT)
    cand = jnp.where(cand < 0, 0, cand)

    cands = extend_candidates(
        fm, genome, all_reads, all_quals, lens2,
        cand.reshape(2 * R, K * CAP),
        params=params)
    return top2_finish(cands, lens, params)


class MemMapper(Mapper):
    ESCALATES = False  # escalation re-seeds uniformly
    """Host orchestration for the MEM pipeline — same SAM emit path as
    the flagship mapper, MEM seeding in the forward step."""

    def _forward(self, jr, jl, jq, uniform_shift: int = -1,
                 params=None):
        del uniform_shift  # MEM/q-gram seeding reverse-complements per candidate
        return mem_map_batch(
            self.fm, self.ssa, self.genome, jr, jl, jq,
            params=params or self.params)
