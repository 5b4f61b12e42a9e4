"""Seed-and-extend short-read mapper (nvBowtie-equivalent flagship).

The reference pipeline (ref: nvBowtie/bowtie2/cuda/best_approx_inl.h —
``best_approx_sc``; call stack SURVEY.md §4.1):

    seed -> map (FM backward search) -> select -> locate -> score
    (banded Gotoh) -> reduce (top-2) -> traceback -> MAPQ -> SAM

re-designed for XLA as two jitted fixed-shape stages plus host
formatting:

1. ``map_batch`` — the forward step: both strands are seeded uniformly
   (mapping_inl.h equivalent), seed SA ranges come from one batched
   backward search, hit selection is capacity-capped expansion +
   per-strand diagonal dedupe via double-sort (replacing the
   reference's SeedHitDequeArray priority deques and persistent-thread
   work queues with compaction, per SURVEY.md §3.12), candidates are
   extended with the banded Gotoh kernel, and a top-2 reduction +
   MAPQ finishes on-device.
2. ``traceback_walk_batch`` — winners-only banded DP re-run emitting
   direction flags, then an ON-DEVICE traceback walk (traceback_inl.h
   equivalent): only 2-bit op streams reach the host, where native C++
   (native/traceback.cpp) assembles CIGAR/MD/NM strings.

The ``Mapper`` class wires index + genome + params and produces SAM.
The banded DP engine of both stages is chosen by
``ops.select_banded_dp`` from the backend and the band.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..alignment.cigar import cigar_to_string, make_md_string
from ..alignment.types import NEG_INF, AlignmentType
from ..fmindex import (FMIndex, SSA, backward_search, locate,
                       backward_search2, locate2, locate2_mono,
                       build_fm2)
from ..alignment.batched import window_slices
from ..ops.banded_dp import banded_directions, banded_score
from ..strings.seeds import extract_uniform_seeds, num_uniform_seeds
from ..basic.alphabet import dna_to_char
from ..io.sam import SamRecord, FLAG_UNMAPPED, FLAG_REVERSE
from .params import MapperParams
from .mapq import mapq_v2

PAD = 7


def _revcomp_batch(reads, lens, quals, uniform_shift: int = -1):
    """Reverse-complement left-aligned padded reads (and reverse quals).

    ``uniform_shift`` (static, >= 0): every read has the same length,
    pad_width - length == uniform_shift, so the reverse is a free
    static flip + static left-shift instead of a per-row gather
    (uniform-length batches are the common Illumina case and the
    dispatcher knows from host lens)."""
    R, L = reads.shape
    if uniform_shift >= 0:
        sh = uniform_shift
        g = reads[:, ::-1]
        rc = jnp.where(g < 4, 3 - g, g).astype(reads.dtype)
        q = quals[:, ::-1]
        if sh:
            rc = jnp.concatenate(
                [rc[:, sh:], jnp.full((R, sh), PAD, reads.dtype)], axis=1)
            q = jnp.concatenate(
                [q[:, sh:], jnp.zeros((R, sh), quals.dtype)], axis=1)
        return rc, q
    idx = lens[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
    ok = idx >= 0
    g = jnp.take_along_axis(reads, jnp.maximum(idx, 0), axis=1)
    rc = jnp.where(ok, jnp.where(g < 4, 3 - g, g), PAD).astype(reads.dtype)
    q = jnp.take_along_axis(quals, jnp.maximum(idx, 0), axis=1)
    q = jnp.where(ok, q, 0).astype(quals.dtype)
    return rc, q


def _score_min(lens, params: MapperParams):
    """Per-read minimum acceptable score: Bowtie2 --score-min function
    ``fn,a,b`` applied to read length (ref: bowtie2 SimpleFunc /
    params.cpp --score-min; C constant, L linear, S sqrt, G log)."""
    x = lens.astype(jnp.float32)
    fn = params.score_min_fn
    if fn == "C":
        g = jnp.ones_like(x)
        v = jnp.full_like(x, params.score_min_a)
        return jnp.ceil(v).astype(jnp.int32)
    if fn == "L":
        g = x
    elif fn == "S":
        g = jnp.sqrt(x)
    elif fn == "G":
        g = jnp.log(jnp.maximum(x, 1.0))
    else:
        raise ValueError(f"unknown score-min function {fn!r}")
    v = params.score_min_a + params.score_min_b * g
    return jnp.ceil(v).astype(jnp.int32)


def score_min_host(L: int, params: MapperParams) -> int:
    """Host-scalar twin of _score_min."""
    import math as _m
    fn = params.score_min_fn
    g = {"C": 1.0, "L": float(L), "S": _m.sqrt(L),
         "G": _m.log(max(L, 1))}[fn]
    if fn == "C":
        return _m.ceil(params.score_min_a)
    return _m.ceil(params.score_min_a + params.score_min_b * g)


def _score_perfect(lens, params: MapperParams):
    return (lens * params.scheme.match).astype(jnp.int32)


def extend_candidates(
    fm: FMIndex,
    genome,
    all_reads,  # (2R, L) forward rows then reverse-complement rows
    all_quals,
    lens2,  # (2R,)
    cand,  # (2R, M) candidate genome start positions, >= SENT invalid
    *,
    params: MapperParams,
):
    """Diagonal dedupe + banded Gotoh extension of located candidates.

    The shared back half of every seeding strategy (uniform-seed,
    SMEM, q-gram): dedupes candidate diagonals per read-strand via
    double-sort (replacing the reference's persistent-thread scoring
    queues, SURVEY.md §3.12), keeps the first ``max_candidates``, and
    scores them with the banded kernel (ref: score_inl.h
    ``score_best``).  Returns dict of (R, 2C) arrays.
    """
    R2, L = all_reads.shape
    R = R2 // 2
    C = params.max_candidates
    W = params.band_w
    LT = L + 2 * W
    n = fm.n
    SENT = n + 2 * L + 1
    cand = jnp.minimum(cand, SENT)

    # --- dedupe diagonals per read-strand, keep first C ---
    cand = jnp.sort(cand, axis=1)
    first = jnp.concatenate(
        [
            jnp.ones((R2, 1), bool),
            cand[:, 1:] != cand[:, :-1],
        ],
        axis=1,
    )
    # budget signal: more unique diagonals than the C-slot candidate
    # list holds (kept-first-by-position, so a better-scoring one may
    # have been cut — escalation re-runs such reads, see map_batch)
    n_uniq = (first & (cand < SENT)).sum(axis=1)
    cand = jnp.sort(jnp.where(first, cand, SENT), axis=1)[:, :C]  # (2R, C)
    cand_ok = cand < SENT

    # --- extension scoring (banded Gotoh), cross-read compacted ---
    # Most of the (R2, C) candidate matrix is empty (1%-error reads
    # place 1-3 unique diagonals; round-4 hg profile: the dense
    # extension was 957 of 1323 ms/stage).  Like locate_compact, the
    # valid candidates are compacted SLOT-RANK-MAJOR (every read's
    # rank-j diagonal before any read's rank-j+1, so the first C *
    # extend_frac candidates per read always survive) into an
    # extend_frac-budgeted dense batch; the DP, its window gathers and
    # its pattern staging all shrink by the compaction factor.  Reads
    # whose candidates drop surface in cand_overflow -> escalation.
    win_start = jnp.minimum(cand, jnp.maximum(n - 1, 0)).astype(jnp.int32)
    EXT_CAP = max(int(R2 * C * params.extend_frac) // 8 * 8, 1024)
    EXT_CAP = min(EXT_CAP, R2 * C)
    okT = cand_ok.T.reshape(-1)  # (C * R2,) slot-rank-major
    wsT = win_start.T.reshape(-1)
    ridxT = jnp.broadcast_to(
        jnp.arange(R2, dtype=jnp.int32)[None, :], (C, R2)).reshape(-1)
    cpos = jnp.cumsum(okT.astype(jnp.int32)) - 1
    keep = okT & (cpos < EXT_CAP)
    tgt = jnp.where(keep, cpos, EXT_CAP)
    ws_c = jnp.zeros(EXT_CAP, jnp.int32).at[tgt].set(wsT, mode="drop")
    ridx_c = jnp.zeros(EXT_CAP, jnp.int32).at[tgt].set(ridxT, mode="drop")
    n_kept = keep.sum()
    lane_ok = jnp.arange(EXT_CAP, dtype=jnp.int32) < n_kept
    pats = all_reads[ridx_c]
    pquals = all_quals[ridx_c]
    plens = jnp.where(lane_ok, lens2[ridx_c], 0)  # pad lanes exit early
    tlens = jnp.clip(n - ws_c, 0, LT)
    texts = window_slices(genome, ws_c, LT)  # genome carries lt_pad PAD
    res = banded_score(
        pats, plens, texts, tlens, pquals,
        scheme=params.scheme, atype=params.atype, band_w=W,
    )
    # scatter back to the (C, R2) slot layout; dropped slots NEG_INF
    back = jnp.minimum(cpos, EXT_CAP - 1)
    scores = jnp.where(keep, res["score"][back], NEG_INF) \
        .reshape(C, R2).T
    t_end = jnp.where(keep, res["t_end"][back], 0).reshape(C, R2).T
    p_end = jnp.where(keep, res["p_end"][back], 0).reshape(C, R2).T
    ext_dropped = (okT & ~keep).reshape(C, R2).any(axis=0)  # (R2,)

    to_r2c = lambda a: a.reshape(2, R, C).transpose(1, 0, 2).reshape(R, 2 * C)
    return {
        "score": to_r2c(scores),
        "win_start": to_r2c(win_start),
        "t_end": to_r2c(t_end),
        "p_end": to_r2c(p_end),
        "cand_overflow": ((n_uniq > C).reshape(2, R).any(axis=0)
                          | ext_dropped.reshape(2, R).any(axis=0)),
    }


def both_strands(reads, lens, quals, uniform_shift: int = -1):
    """Stack forward + reverse-complement rows: (2R, L) arrays."""
    rc_reads, rc_quals = _revcomp_batch(reads, lens, quals,
                                        uniform_shift=uniform_shift)
    all_reads = jnp.concatenate([reads, rc_reads], axis=0)
    all_quals = jnp.concatenate([quals, rc_quals], axis=0)
    lens2 = jnp.concatenate([lens, lens])
    return all_reads, all_quals, lens2


def locate_compact(fm, ssa, rows, ok, *, k_sample: int, capacity: int,
                   fm2=None, bi: bool = False):
    """SSA-locate only the valid rows of a (N, K) budget matrix.

    The SSA walk is the mapper's dominant gather cost and most budget
    slots are empty (measured ~10% valid on 1% -error reads: the
    reverse strand of a read rarely hits at all).  Valid rows are
    compacted SLOT-RANK-MAJOR (every lane's rank-j hits before any
    lane's rank-j+1) into a `capacity`-row dense array, walked once,
    and scattered back.  On overflow the globally least-prioritized
    slots are dropped (ok returned False) — the same effort-budget
    semantics as ``max_locate`` (ref: nvBowtie max_effort).

    Returns (pos (N, K) int32 — valid only where ok_out, ok_out,
    n_dropped — scalar count of valid slots dropped by the budget, so
    callers can surface overflow instead of silently losing hits).
    """
    N, K = rows.shape
    okT = ok.T.reshape(-1)  # slot-rank-major
    rowsT = rows.T.reshape(-1)
    cpos = jnp.cumsum(okT.astype(jnp.int32)) - 1
    keep = okT & (cpos < capacity)
    n_dropped = okT.sum() - keep.sum()
    comp_rows = jnp.zeros(capacity, jnp.int32).at[
        jnp.where(keep, cpos, capacity)
    ].set(rowsT, mode="drop")
    if fm2 is not None and bi:
        # 2-step LF walk over the bi-marked SSA: floor((K-1)/2) gather
        # rounds instead of K (fmindex/fm2.py)
        comp_pos = locate2(fm, fm2, ssa, comp_rows, k_sample=k_sample)
    elif fm2 is not None:
        # mono-marked SSA (sharded hg-scale layout): same chain length
        # via the parallel marked(i)/marked(LF(i)) check — fm2.py
        comp_pos = locate2_mono(fm, fm2, ssa, comp_rows,
                                k_sample=k_sample)
    else:
        comp_pos = locate(fm, ssa, comp_rows, k_sample=k_sample)
    pos_flat = jnp.where(
        keep, comp_pos[jnp.minimum(cpos, capacity - 1)], 0
    )
    return (pos_flat.reshape(K, N).T, keep.reshape(K, N).T, n_dropped)


def extract_seed_batch(all_reads, lens2, *, params: MapperParams):
    """Seed extraction alone (index-INDEPENDENT: sharded mappers hoist
    this out of the per-shard loop — one extraction serves every
    shard's backward search).  Returns (seeds (2R, S, seed_len),
    offsets (2R, S), sval)."""
    R2, L = all_reads.shape
    if params.seed_slots > 0:
        # per-read -i (ref: params.cpp SimpleFunc per read): interval
        # computed from each read's own length on device; slot count
        # sized by the caller for the chunk's densest read
        from ..strings.seeds import extract_seeds_per_read

        S = params.seed_slots
        seeds, offsets, sval = extract_seeds_per_read(
            all_reads, lens2, params.seed_len, S,
            params.seed_interval_fn, params.seed_interval_a,
            params.seed_interval_b)
    else:
        S = num_uniform_seeds(L, params.seed_len, params.seed_interval)
        seeds, offsets, sval = extract_uniform_seeds(
            all_reads, lens2, params.seed_len, params.seed_interval
        )
        # (S,) static offsets -> per-read layout shared with the
        # dynamic path (XLA folds the broadcast)
        offsets = jnp.broadcast_to(offsets[None, :], (R2, S))
    return seeds, offsets, sval


def seed_and_search(fm, all_reads, lens2, *, params: MapperParams,
                    lut=None, fm2=None, pre_seeds=None):
    """Seed extraction + FM backward search (ref: mapping_inl.h
    ``map_whole_read``/``map_exact``; SURVEY.md §4.1 hot loop 2).

    Split out of candidate_stage so the hg-scale stage bench
    (benchsuite/hg_stage_bench.py --substages) times exactly the code
    the mapper runs.  ``pre_seeds``: hoisted (seeds, offsets, sval)
    from extract_seed_batch.  Returns (lo, hi (2R, S), offsets
    (2R, S), sval, flat_seeds (2R*S, seed_len))."""
    R2, L = all_reads.shape
    seeds, offsets, sval = (pre_seeds if pre_seeds is not None
                            else extract_seed_batch(
                                all_reads, lens2, params=params))
    S = seeds.shape[1]
    flat_seeds = seeds.reshape(R2 * S, params.seed_len)
    lut_k = params.lut_k if lut is not None else 0
    if fm2 is not None:
        lo, hi = backward_search2(fm, fm2, flat_seeds, lut=lut, lut_k=lut_k)
    else:
        lo, hi = backward_search(fm, flat_seeds, lut=lut, lut_k=lut_k)
    return lo.reshape(R2, S), hi.reshape(R2, S), offsets, sval, flat_seeds


def select_and_locate(fm, ssa, lo, hi, offsets, sval, L, *,
                      params: MapperParams, fm2=None, bi: bool = False):
    """Rarity-priority hit selection + compacted SSA locate.

    The SSA walk in locate() is the gather-bound hot spot (SURVEY.md
    §4.1 hot loop 3): select the most promising hits FIRST and walk
    only those.  Priority = smaller SA range (rarer seed), the
    reference's SeedHitDequeArray ordering (ref: seed_hit_deque_array
    .h, select_inl.h) — here a fixed-budget top-K over (seed, slot).
    Returns (cand (2R, KLOC) candidate window starts with >= SENT
    invalid, ovf (2R,) budget-overflow evidence, n_drop scalar)."""
    R2, S = lo.shape
    CAP = params.max_hits_per_seed
    n = fm.n
    sizes = jnp.where(sval, hi - lo, 0)
    use = jnp.where(sizes > params.max_range, 0, jnp.minimum(sizes, CAP))
    # per-read budget-overflow evidence (ref: nvBowtie max_effort
    # rounds): seeds skipped as too-repetitive now, locate drops and
    # candidate truncation folded in by the caller
    ovf = (sval & (sizes > params.max_range)).any(axis=1)  # (2R,)
    t = jnp.arange(CAP, dtype=jnp.int32)
    rows = (lo[:, :, None] + t[None, None, :]).reshape(R2, S * CAP)
    hit_ok = (t[None, None, :] < use[:, :, None]).reshape(R2, S * CAP)
    INF = jnp.int32(1 << 30)
    prio = jnp.where(
        hit_ok,
        jnp.broadcast_to(sizes[:, :, None], (R2, S, CAP)).reshape(
            R2, S * CAP),
        INF,
    )
    KLOC = min(params.max_locate, S * CAP)
    order = jnp.argsort(prio, axis=1)[:, :KLOC]  # (2R, KLOC)
    rows_sel = jnp.take_along_axis(rows, order, axis=1)
    ok_sel = jnp.take_along_axis(prio, order, axis=1) < INF
    offs_flat = jnp.broadcast_to(
        offsets[:, :, None], (R2, S, CAP)).reshape(R2, S * CAP)
    offs_sel = jnp.take_along_axis(offs_flat, order, axis=1)
    capacity = max(int(R2 * KLOC * params.locate_frac) // 8 * 8, 512)
    pos, ok_loc, n_drop = locate_compact(
        fm, ssa, jnp.clip(rows_sel, 0, n), ok_sel,
        k_sample=params.sa_sample, capacity=capacity, fm2=fm2, bi=bi,
    )
    ovf = ovf | (ok_sel & ~ok_loc).any(axis=1)
    # more real hit slots than the per-read locate budget keeps
    ovf = ovf | (use.sum(axis=1) > KLOC)
    SENT = n + 2 * L + 1
    cand = jnp.where(ok_loc, pos - offs_sel, SENT)
    cand = jnp.where(cand < 0, 0, cand)  # clamp starts hanging off the left
    return cand, ovf, n_drop


@functools.partial(jax.jit, static_argnames=("params", "uniform_shift"))
def stage_reads(reads, lens, quals, *, params: MapperParams,
                uniform_shift: int = -1):
    """Index-independent front half of candidate_stage (strands +
    seed extraction), hoisted so sharded mappers run it ONCE per
    batch instead of once per shard.  Returns the ``pre`` tuple
    candidate_stage accepts."""
    all_reads, all_quals, lens2 = both_strands(
        reads, lens, quals, uniform_shift=uniform_shift)
    seeds, offsets, sval = extract_seed_batch(all_reads, lens2,
                                              params=params)
    return all_reads, all_quals, lens2, seeds, offsets, sval


def candidate_stage(
    fm: FMIndex,
    ssa: SSA,
    genome,  # (n + pad,) int8, padded with PAD beyond position n
    reads,  # (R, L) int8
    lens,  # (R,) int32
    quals,  # (R, L) uint8/int32
    *,
    params: MapperParams,
    lut=None,
    fm2=None,
    bi: bool = False,
    uniform_shift: int = -1,
    pre=None,
):
    """Seed -> map -> select -> locate -> score: per-candidate arrays.

    Returns dict of (R, 2C)-shaped arrays (C candidates per strand;
    columns [0, C) = forward, [C, 2C) = reverse): score, win_start,
    t_end, p_end — the shared front half of the SE and PE pipelines
    (ref: best_approx_inl.h stages before reduce).

    ``pre``: hoisted index-independent front half — (all_reads,
    all_quals, lens2, seeds, offsets, sval) from ``stage_reads``.  A
    sharded mapper computes it ONCE per batch and reuses it for every
    shard's stage (strands + seed extraction repeated S times was
    pure waste; VERDICT r4 missing #2 follow-up).
    """
    R, L = reads.shape
    n = fm.n

    if pre is None:
        all_reads, all_quals, lens2 = both_strands(
            reads, lens, quals, uniform_shift=uniform_shift)
        pre_seeds = None
    else:
        all_reads, all_quals, lens2, seeds_p, offs_p, sval_p = pre
        pre_seeds = (seeds_p, offs_p, sval_p)
    lo, hi, offsets, sval, flat_seeds = seed_and_search(
        fm, all_reads, lens2, params=params, lut=lut, fm2=fm2,
        pre_seeds=pre_seeds)
    cand, ovf, n_drop = select_and_locate(
        fm, ssa, lo, hi, offsets, sval, L, params=params, fm2=fm2, bi=bi)
    S = lo.shape[1]
    SENT = n + 2 * L + 1

    if params.seed_mismatches >= 1:
        # 1-mismatch seeding (bowtie2 -N 1; ref: mapping_inl.h
        # map_approx): every one-substitution variant's SA range,
        # expanded to a few hits each, joins the candidate pool.
        from ..fmindex.backtrack import hamming_backtrack_1

        Ls = params.seed_len
        CAPV = params.max_hits_per_mm
        bt = hamming_backtrack_1(fm, flat_seeds)
        vlo = bt["lo"].reshape(2 * R, S, Ls * 4)
        vsz = jnp.where(bt["valid"], bt["hi"] - bt["lo"], 0).reshape(
            2 * R, S, Ls * 4)
        use_v = jnp.where(vsz > params.max_range, 0,
                          jnp.minimum(vsz, CAPV))
        tv = jnp.arange(CAPV, dtype=jnp.int32)
        rows_v = vlo[..., None] + tv  # (2R, S, Ls*4, CAPV)
        ok_v = tv < use_v[..., None]
        KV = S * Ls * 4 * CAPV
        pos_v, ok_v2, n_drop_v = locate_compact(
            fm, ssa, jnp.clip(rows_v, 0, n).reshape(2 * R, KV),
            ok_v.reshape(2 * R, KV),
            k_sample=params.sa_sample,
            capacity=max(int(2 * R * KV * params.mm_locate_frac)
                         // 8 * 8, 512),
            fm2=fm2, bi=bi,
        )
        n_drop = n_drop + n_drop_v
        ovf = ovf | (ok_v.reshape(2 * R, KV)
                     & ~ok_v2.reshape(2 * R, KV)).any(axis=1)
        pos_v = pos_v.reshape(rows_v.shape)
        ok_v = ok_v2.reshape(rows_v.shape)
        cand_v = jnp.where(ok_v, pos_v - offsets[:, :, None, None],
                           SENT)
        cand_v = jnp.where(cand_v < 0, 0, cand_v)
        cand = jnp.concatenate(
            [cand, cand_v.reshape(2 * R, S * Ls * 4 * CAPV)], axis=1)

    out = extend_candidates(
        fm, genome, all_reads, all_quals, lens2, cand, params=params,
    )
    # locate-budget overflow count (ADVICE r1: locate_frac drops must
    # be observable — repetitive batches can exhaust the cross-read
    # budget silently otherwise); surfaced via MappingStats
    out["locate_dropped"] = n_drop
    out["overflow"] = (ovf.reshape(2, R).any(axis=0)
                       | out.pop("cand_overflow"))
    return out


@functools.partial(jax.jit, static_argnames=("params", "bi",
                                              "uniform_shift"))
def map_batch(
    fm: FMIndex,
    ssa: SSA,
    genome,
    reads,
    lens,
    quals,
    *,
    params: MapperParams,
    lut=None,
    fm2=None,
    bi: bool = False,
    uniform_shift: int = -1,
):
    """Forward mapping step: per-read best/second alignments + MAPQ.

    Returns dict of (R,)-shaped arrays: aligned, score, second,
    has_second, strand, win_start, t_end, p_end, mapq.
    """
    cands = candidate_stage(
        fm, ssa, genome, reads, lens, quals,
        params=params, lut=lut, fm2=fm2, bi=bi,
        uniform_shift=uniform_shift,
    )
    return top2_finish(cands, lens, params)


def top2_finish(cands, lens, params: MapperParams):
    """Top-2 reduce across strands & candidates + MAPQ (ref:
    reduce_inl.h ``score_reduce`` + mapq.h)."""
    R = lens.shape[0]
    C = params.max_candidates
    sc = cands["score"]
    t_end = cands["t_end"]
    p_end = cands["p_end"]
    ws = cands["win_start"]
    bi = jnp.argmax(sc, axis=1)
    best = jnp.take_along_axis(sc, bi[:, None], axis=1)[:, 0]
    # mask-by-compare: no scatter, so no duplicate-index ordering
    cols_m = jnp.arange(sc.shape[1], dtype=jnp.int32)
    sc_masked = jnp.where(cols_m[None, :] == bi[:, None], NEG_INF, sc)
    second = jnp.max(sc_masked, axis=1)
    has_second = second > NEG_INF // 2

    smin = _score_min(lens, params)
    smax = _score_perfect(lens, params)
    aligned = (best >= smin) & (lens > 0)
    strand = (bi // C).astype(jnp.int32)
    take = lambda a: jnp.take_along_axis(a, bi[:, None], axis=1)[:, 0]
    mapq = jnp.where(
        aligned,
        mapq_v2(best, second, has_second & (second >= smin), smin, smax),
        0,
    )
    return {
        "aligned": aligned,
        "score": best,
        "second": second,
        "has_second": has_second,
        "strand": strand,
        "win_start": take(ws),
        "t_end": take(t_end),
        "p_end": take(p_end),
        "mapq": mapq,
        "locate_dropped": cands.get("locate_dropped", jnp.int32(0)),
        "overflow": cands.get(
            "overflow", jnp.zeros((R,), bool)),
    }


@functools.partial(jax.jit, static_argnames=("params",))
def traceback_batch(
    genome, n, reads, lens, quals, win_start, strand, *,
    params: MapperParams
):
    """Winners-only direction-flag DP for exact CIGARs.

    reads/quals here are the ORIGINAL reads; the strand winner decides
    whether the forward or reverse-complemented pattern is re-aligned.
    Returns (result dict, packed dirs) for the host CIGAR walk; dirs
    are nibble-packed on device (two band cells per byte) to halve the
    device->host transfer — unpack with ``unpack_dirs``.
    """
    R, L = reads.shape
    W = params.band_w
    LT = L + 2 * W
    rc_reads, rc_quals = _revcomp_batch(reads, lens, quals)
    pats = jnp.where(strand[:, None] == 1, rc_reads, reads)
    pquals = jnp.where(strand[:, None] == 1, rc_quals, quals)
    texts = window_slices(genome, win_start, LT)
    tlens = jnp.clip(n - win_start, 0, LT)
    res, dirs = banded_directions(
        pats, lens, texts, tlens, pquals,
        scheme=params.scheme, atype=params.atype, band_w=W,
    )
    band = dirs.shape[2]
    if band % 2:
        dirs = jnp.pad(dirs, ((0, 0), (0, 0), (0, 1)))
    packed = dirs[:, :, 0::2] | (dirs[:, :, 1::2] << 4)
    return res, packed


def runs_to_packed(run_ops: np.ndarray, run_lens: np.ndarray) -> np.ndarray:
    """Expand device CIGAR runs (end->start order) into the 2-bit
    packed op stream the native string builder consumes (host NumPy;
    ~1 ms for 16k x 100 bp)."""
    run_ops = np.asarray(run_ops)
    run_lens = np.asarray(run_lens).astype(np.int64)
    R = run_ops.shape[0]
    total = run_lens.sum(axis=1)
    MAX = int(total.max()) if total.size else 0
    MAX4 = max((MAX + 3) // 4 * 4, 4)
    codes = np.zeros((R, MAX4), np.uint8)
    flat = np.repeat(run_ops.ravel(), run_lens.ravel())
    rows = np.repeat(np.arange(R), total)
    offs = np.zeros(R, np.int64)
    np.cumsum(total[:-1], out=offs[1:])
    idx = np.arange(flat.size, dtype=np.int64) - np.repeat(offs, total)
    codes[rows, idx] = flat
    return (codes[:, 0::4] | (codes[:, 1::4] << 2)
            | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))


def unpack_dirs(packed: np.ndarray, band: int) -> np.ndarray:
    """Host-side inverse of traceback_batch's nibble packing."""
    packed = np.asarray(packed)
    R, Lp, half = packed.shape
    dirs = np.empty((R, Lp, 2 * half), np.uint8)
    dirs[:, :, 0::2] = packed & 0xF
    dirs[:, :, 1::2] = packed >> 4
    return dirs[:, :, :band]


@functools.partial(jax.jit, static_argnames=("params",))
def traceback_walk_batch(
    genome, n, reads, lens, quals, win_start, strand, *,
    params: MapperParams, active=None,
):
    """Winners-only DP + ON-DEVICE traceback walk.

    The reference walks the DP flags in its traceback kernel (ref:
    traceback_inl.h ``banded_traceback_best``); doing the same here
    keeps the (B, Lp, BAND) direction matrix in HBM and ships only
    CIGAR runs per read to the host (run_ops/run_lens, end->start
    order); the host builds CIGAR/MD strings from the runs (native C++
    or Python fallback).  `active`: lanes to walk (None = all; pass
    the aligned mask so discarded lanes never pin the walk loop).
    """
    L = reads.shape[1]
    LT = L + 2 * params.band_w
    # one slice per lane (genome carries lt_pad tail PAD)
    texts = window_slices(genome, win_start, LT)
    tlens = jnp.clip(n - win_start, 0, LT)
    return traceback_walk_windows(texts, tlens, reads, lens, quals,
                                  strand, params=params, active=active)


@functools.partial(jax.jit, static_argnames=("params",))
def traceback_walk_windows(
    texts, tlens, reads, lens, quals, strand, *, params: MapperParams,
    active=None,
):
    """Core of traceback_walk_batch over pre-gathered window texts
    (shape (R, L + 2*band_w)).  Sharded mappers gather each lane's
    winner-shard window first, so ONE walk serves all shards.  The
    winners DP and its flag emission run on the engine
    ``ops.select_banded_dp`` picks."""
    R, L = reads.shape
    W = params.band_w
    BAND = 2 * W + 1
    rc_reads, rc_quals = _revcomp_batch(reads, lens, quals)
    pats = jnp.where(strand[:, None] == 1, rc_reads, reads)
    pquals = jnp.where(strand[:, None] == 1, rc_quals, quals)
    res, dirs = banded_directions(
        pats, lens, texts, tlens, pquals,
        scheme=params.scheme, atype=params.atype, band_w=W,
    )
    i0 = res["p_end"].astype(jnp.int32)
    k0 = res["t_end"].astype(jnp.int32) - i0 + W
    fi, fk, run_ops, run_lens = _runjump_walk(
        dirs.reshape(R, L * BAND), BAND, i0, k0, active=active,
        max_runs=_max_cigar_runs(L, params))
    return res, {
        "run_ops": run_ops,
        "run_lens": run_lens,
        "p_start": fi,
        "t_start": fi + fk - W,
    }


def _max_cigar_runs(L: int, params: MapperParams) -> int:
    """Worst-case CIGAR run count of any alignment that can pass
    score-min: each gap RUN costs at least open + extend, so the
    accepted-score budget bounds the gap-run count, and M runs can only
    interleave them.  Bounds _runjump_walk's output arrays (their
    host transfer is per-batch) and its round count.  Sub-threshold
    lanes may need more rounds, but their results are discarded
    (callers gate on score >= score-min before using any walk)."""
    from ..alignment.types import gap_penalties
    eo, ee, fo, fe = gap_penalties(params.scheme)
    smin = score_min_host(L, params)
    budget = max(L * params.scheme.match - smin, 0)
    per_run = max(min(eo, fo) + min(ee, fe), 1)
    gap_runs = budget // per_run
    return int(min(2 * gap_runs + 4, 2 * L + 4))


from ..alignment.walk import runjump_walk as _runjump_walk  # noqa: E402
# (walk moved to alignment/walk.py; re-export keeps the public test/API path)


@dataclass
class MapResult:
    """One read's final alignment (host-side)."""

    aligned: bool
    pos: int = 0  # 0-based concat-genome position of the alignment start
    strand: int = 0
    score: int = 0
    second: int | None = None
    mapq: int = 0
    cigar: str = "*"
    md: str = ""
    nm: int = 0
    ref_span: int = 0  # genome bases consumed (CIGAR M+D)


class Mapper:
    """Host orchestration: index + genome + params -> SAM records.

    Plays the role of nvBowtie's ComputeThread + OutputFile glue (ref:
    compute_thread.cpp, output_sam.cpp) for a single device.
    """

    def __init__(self, fm, ssa, genome_symbols: np.ndarray,
                 params: MapperParams = MapperParams(),
                 ref_name: str = "ref", contigs: dict | None = None,
                 lut=None):
        # fused block rows: 1 HBM gather per rank/LF instead of 3
        # (fmindex.index.fuse_occ; +~0.6 B/bp device memory)
        from ..fmindex.index import fuse_occ
        if getattr(fm, "fused", None) is None:
            fm = fuse_occ(fm)
        self.fm = fm
        self.ssa = ssa
        self.lut = lut  # optional k-mer range LUT (params.lut_k)
        # adopt the index's build-time SSA sampling rate: a smaller
        # params.sa_sample silently corrupts locate positions, a larger
        # one wastes LF steps
        ssa_k = int(getattr(ssa, "k", 0) or 0)
        if ssa_k and params.sa_sample != ssa_k:
            from dataclasses import replace
            params = replace(params, sa_sample=ssa_k)
        self.params = params
        self.ref_name = ref_name
        self.n = int(genome_symbols.shape[0])
        # contig table for multi-sequence references (nvBWT .ann equiv)
        if contigs is None:
            contigs = {"names": [ref_name], "starts": np.zeros(1, np.int64),
                       "lens": np.array([self.n], np.int64)}
        self.contigs = contigs
        lt_pad = params.max_read_len + 2 * params.band_w + 8
        gp = np.full(self.n + lt_pad, PAD, dtype=np.int8)
        gp[: self.n] = genome_symbols
        self.genome = jnp.asarray(gp)
        self._genome_np = gp  # host copy for the native traceback walk
        # 2-step FM-index: halves the backward-search gather chain;
        # with a bi-marked SSA also shortens the locate walk
        self.fm2 = build_fm2(fm) if self.params.use_fm2 else None
        self.bi = bool(getattr(ssa, "bi", 0))
        # cumulative count of locate-budget slots dropped on overflow
        # (params.locate_frac / mm_locate_frac; see locate_compact)
        self.locate_dropped = 0
        # re-maps performed by escalation rounds (params.max_effort;
        # a read re-mapped in two rounds counts twice)
        self.escalated = 0
        # reads whose round-1 budgets overflowed (escalation pressure)
        self.overflowed = 0

    @staticmethod
    def _len_bucket(seqs, lens, quals):
        """Trim the pad axis to the batch's max length rounded up to 32
        — avoids running the DP over max_read_len padding (the
        fixed-shape analog of the reference's staged-by-length
        scheduler, ref: batched.h DeviceStagedThreadScheduler)."""
        if len(lens) == 0:
            return seqs, quals
        lb = max(32, (int(lens.max()) + 31) // 32 * 32)
        lb = min(lb, seqs.shape[1])
        return seqs[:, :lb], quals[:, :lb]

    def map_reads(self, seqs: np.ndarray, lens: np.ndarray,
                  quals: np.ndarray) -> list[MapResult]:
        """Map one padded batch; returns per-read MapResult."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, quals = self._len_bucket(seqs, lens, quals)
        out: list[MapResult] = []
        for s0 in range(0, R, B):
            out.extend(self._map_chunk(
                seqs[s0 : s0 + B], lens[s0 : s0 + B], quals[s0 : s0 + B]
            ))
        return out

    def _pad_chunk(self, seqs, lens, quals):
        """Pad a partial chunk to the jit batch shape."""
        B = self.params.batch_size
        R = seqs.shape[0]
        if R < B:
            pad = B - R
            seqs = np.concatenate([seqs, np.full((pad, seqs.shape[1]), PAD,
                                                 seqs.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            quals = np.concatenate([quals, np.zeros((pad, quals.shape[1]),
                                                    quals.dtype)])
        return seqs, lens, quals

    @staticmethod
    def _group_all(results, R, K):
        """Group flat (R*K) --all results per read, deduping positions
        overlapping windows produce (shared with the sharded mapper)."""
        grouped = []
        for r in range(R):
            alns = [results[r * K + j] for j in range(K)
                    if results[r * K + j].aligned]
            seen, uniq = set(), []
            for a in alns:
                if (a.pos, a.strand) not in seen:
                    seen.add((a.pos, a.strand))
                    uniq.append(a)
            grouped.append(uniq)
        return grouped

    def _chunk_params(self, max_len: int,
                      min_len: int | None = None) -> MapperParams:
        """Per-chunk params for the Bowtie2 ``-i`` interval function
        (ref: params.cpp SimpleFunc per read, SURVEY.md §5.7).

        Uniform-length chunks (min_len is None or == max_len) resolve
        the function to one static interval — exactly the per-read
        value.  Mixed-length chunks switch candidate_stage to the TRUE
        per-read path (params.seed_slots > 0): the interval is
        evaluated from each read's own length on device, with the
        static slot count sized for the densest length in
        [min_len, max_len]."""
        p = self.params
        if p.seed_interval_fn is None:
            return p
        from dataclasses import replace

        from .params import eval_simple_func

        def iv_of(length: int) -> int:
            return max(1, int(eval_simple_func(
                p.seed_interval_fn, p.seed_interval_a,
                p.seed_interval_b, max(int(length), 1)) + 0.5))

        max_len = max(int(max_len), 1)
        if min_len is not None and int(min_len) != max_len:
            from ..strings.seeds import num_uniform_seeds
            slots = max(
                (num_uniform_seeds(length, p.seed_len, iv_of(length))
                 for length in range(max(int(min_len), p.seed_len),
                                     max_len + 1)), default=1)
            return replace(p, seed_slots=max(slots, 1))
        iv = iv_of(max_len)
        if iv == p.seed_interval:
            return p
        return replace(p, seed_interval=iv)

    def _dispatch_chunk(self, seqs, lens, quals, params=None):
        """Launch the device work for one chunk (async; nothing is
        pulled to the host here)."""
        R = seqs.shape[0]
        params = params or self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr = jnp.asarray(seqs)
        jl = jnp.asarray(lens.astype(np.int32))
        jq = jnp.asarray(quals.astype(np.uint8))
        # uniform-length batches take the static-flip revcomp path
        ushift = (seqs.shape[1] - int(lens.max())
                  if len(lens) and lens.min() == lens.max() else -1)
        fwd = self._forward(jr, jl, jq, uniform_shift=ushift,
                            params=params)
        res, walk = traceback_walk_batch(
            self.genome, jnp.asarray(self.n, jnp.int32), jr, jl, jq,
            fwd["win_start"], fwd["strand"], params=params,
            active=fwd["aligned"],
        )
        return (seqs, lens, quals, fwd, res, walk, R)

    #: subclasses with their own seeding pipelines (MEM, q-gram) keep
    #: round-1 semantics; the escalation round re-seeds with the
    #: uniform-seed pipeline, which only the flagship mapper wants
    ESCALATES = True

    def _escalated_params(self, round_i: int = 2, base=None):
        """Round-``round_i`` budgets (>= 2): each round is a superset
        of the previous round's search effort (ref: best_approx_inl.h
        rounds loop runs up to ``max_effort`` rounds with growing
        seed-hit budgets)."""
        from dataclasses import replace
        p = base or self.params
        f = 8 ** (round_i - 1)
        k = 2 ** (round_i - 1)
        return replace(
            p, max_range=p.max_range * f, locate_frac=1.0,
            mm_locate_frac=1.0, max_locate=min(p.max_locate * k, 128),
            max_candidates=min(p.max_candidates * k, 64),
            extend_frac=1.0,  # every surviving candidate is extended:
            # without this the superset claim above would be prose only
            # (a read could re-drop on the extension budget it already
            # overflowed in round 1); tested by
            # test_extension_budget_escalation_recovers
            max_effort=1)

    def _finish_handle(self, handle):
        """(results, fwd) for one dispatched chunk (escalation rounds;
        subclasses with different handle layouts override)."""
        seqs, lens, quals, fwd, res, walk, R = handle
        return self._finish(seqs, lens, quals, fwd, res, walk)[:R], fwd

    def _collect_chunk(self, handle):
        seqs, lens, quals, fwd, res, walk, R = handle
        if "locate_dropped" in fwd:
            self.locate_dropped += int(fwd["locate_dropped"])
        if "overflow" in fwd:
            self.overflowed += int(np.asarray(fwd["overflow"])[:R].sum())
        results = self._finish(seqs, lens, quals, fwd, res, walk)[:R]
        if self.ESCALATES and self.params.max_effort > 1:
            results = self._escalate_chunk(seqs, lens, quals, fwd,
                                           results, R)
        return results

    def _escalate_chunk(self, seqs, lens, quals, fwd, results, R):
        """Effort-escalation rounds (ref: best_approx_inl.h rounds
        loop): reads whose budgets overflowed re-map with escalated
        budgets, up to ``max_effort`` rounds total, each round a
        superset of the last — so the final round's best/second
        evidence subsumes every earlier round's.  Reads that stop
        overflowing exit the ladder early."""
        base = self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        overflow = np.asarray(fwd["overflow"])[:R].copy()
        for rnd in range(2, base.max_effort + 1):
            idx = np.flatnonzero(overflow)
            if idx.size == 0:
                break
            p2 = self._escalated_params(rnd, base)
            h2 = self._dispatch_chunk(
                seqs[:R][idx], lens[:R][idx],
                np.asarray(quals[:R])[idx], params=p2)
            # round >= 2 locate drops are NOT accumulated (the stat
            # counts round-1 pressure once per read)
            h2[3].pop("locate_dropped", None)
            fin2, fwd2 = self._finish_handle(h2)
            for j, r2 in zip(idx, fin2):
                if r2.aligned or not results[j].aligned:
                    results[j] = r2
            self.escalated += int(idx.size)
            overflow[:] = False
            if "overflow" in fwd2:
                overflow[idx] = np.asarray(fwd2["overflow"])[: idx.size]
        return results

    def _map_chunk(self, seqs, lens, quals):
        return self._collect_chunk(self._dispatch_chunk(seqs, lens, quals))

    def map_stream(self, packed_iter, depth: int = 2):
        """Double-buffered mapping over an iterator of
        (names, seqs, lens, quals) batches: batch k+1's device work is
        dispatched before batch k's host string-building — JAX's async
        dispatch overlaps them, replacing the reference's
        InputThread/ComputeThread pipeline (ref: input_thread.cpp,
        compute_thread.cpp; SURVEY.md §3.12).  Yields
        (names, seqs, lens, quals, results) per input batch.
        """
        from collections import deque

        pending: deque = deque()

        def drain():
            nm, sq, ln, ql, hs = pending.popleft()
            return nm, sq, ln, ql, [
                r for h in hs for r in self._collect_chunk(h)
            ]

        for names, seqs, lens, quals in packed_iter:
            seqs, quals = self._len_bucket(seqs, lens, quals)
            handles = [
                self._dispatch_chunk(
                    seqs[s0 : s0 + self.params.batch_size],
                    lens[s0 : s0 + self.params.batch_size],
                    quals[s0 : s0 + self.params.batch_size],
                )
                for s0 in range(0, seqs.shape[0], self.params.batch_size)
            ]
            pending.append((names, seqs, lens, quals, handles))
            while len(pending) >= depth:
                yield drain()
        while pending:
            yield drain()

    def _forward(self, jr, jl, jq, uniform_shift: int = -1, params=None):
        """The jitted forward mapping step; subclasses swap seeding."""
        return map_batch(
            self.fm, self.ssa, self.genome, jr, jl, jq,
            params=params or self.params, lut=self.lut, fm2=self.fm2,
            bi=self.bi, uniform_shift=uniform_shift,
        )

    @staticmethod
    def _corrected_pats(seqs, lens, strand):
        """Strand-corrected patterns (vectorized reverse-complement)."""
        R, L = seqs.shape
        idx = lens[:, None].astype(np.int64) - 1 - np.arange(L)
        ok = idx >= 0
        g = np.take_along_axis(
            seqs.astype(np.uint8), np.maximum(idx, 0).astype(np.int64),
            axis=1)
        rc = np.where(ok, np.where(g < 4, 3 - g, g), PAD).astype(np.uint8)
        return np.where(strand[:, None] == 1, rc, seqs.astype(np.uint8))

    def _finish(self, seqs, lens, quals, fwd, res, walk):
        """CIGAR/MD/NM from device-walked op streams (native C++ batch
        path with a Python fallback mirroring cigar.py)."""
        aligned = np.asarray(fwd["aligned"])
        strand = np.asarray(fwd["strand"])
        win_start = np.asarray(fwd["win_start"]).astype(np.int64)
        score = np.asarray(fwd["score"])
        second = np.asarray(fwd["second"])
        has_second = np.asarray(fwd["has_second"])
        mapq = np.asarray(fwd["mapq"])
        run_lens = np.where(aligned[:, None],
                            np.asarray(walk["run_lens"]), 0)
        ops = runs_to_packed(np.asarray(walk["run_ops"]), run_lens)
        p_start = np.asarray(walk["p_start"])
        t_start = np.asarray(walk["t_start"])
        is_global = self.params.atype == AlignmentType.GLOBAL
        pats = self._corrected_pats(seqs, lens, strand)

        native = self._finish_native(
            ops, p_start, t_start, aligned, pats, lens, win_start,
            is_global,
        )
        if native is not None:
            cigars, mds, nms, poss, spans = native
            return [
                MapResult(
                    aligned=True, ref_span=int(spans[r]), pos=int(poss[r]),
                    strand=int(strand[r]), score=int(score[r]),
                    second=int(second[r]) if has_second[r] else None,
                    mapq=int(mapq[r]), cigar=cigars[r], md=mds[r],
                    nm=int(nms[r]),
                ) if aligned[r] else MapResult(aligned=False)
                for r in range(seqs.shape[0])
            ]

        # Python fallback: decode 2-bit walk codes, reuse cigar helpers
        genome = self._genome_np
        W = self.params.band_w
        codes = np.stack(
            [(ops >> s) & 3 for s in (0, 2, 4, 6)], axis=-1
        ).reshape(ops.shape[0], -1)
        results = []
        opc = "\0MDI"
        for r in range(seqs.shape[0]):
            if not aligned[r]:
                results.append(MapResult(aligned=False))
                continue
            walk_codes = codes[r][codes[r] != 0][::-1]  # forward order
            fops = [opc[c] for c in walk_codes]
            ts = int(t_start[r])
            ps = int(p_start[r])
            if is_global and ts > 0:
                fops = ["D"] * ts + fops
                ts = 0
            cigar_ops = []
            for op in fops:
                if cigar_ops and cigar_ops[-1][0] == op:
                    cigar_ops[-1][1] += 1
                else:
                    cigar_ops.append([op, 1])
            cigar_ops = [(o, l) for o, l in cigar_ops]
            pat = pats[r]
            window = genome[win_start[r] : win_start[r] + lens[r] + 2 * W]
            md, nm = make_md_string(pat, window, ps, ts, cigar_ops)
            ref_span = sum(l for op, l in cigar_ops if op in "MD")
            results.append(
                MapResult(
                    aligned=True,
                    ref_span=ref_span,
                    pos=int(win_start[r] + ts),
                    strand=int(strand[r]),
                    score=int(score[r]),
                    second=int(second[r]) if has_second[r] else None,
                    mapq=int(mapq[r]),
                    cigar=cigar_to_string(cigar_ops, ps, int(lens[r])),
                    md=md,
                    nm=nm,
                )
            )
        return results

    def _finish_native(self, ops, p_start, t_start, aligned, pats, lens,
                       win_start, is_global):
        """C++ batch string builder; None if no toolchain."""
        from ..native import ops_batch_native

        return ops_batch_native(
            ops, p_start, t_start, aligned, pats, lens,
            self._genome_np, win_start, is_global,
        )

    def locate_contig(self, mr: MapResult):
        """Concat position -> (contig name, local pos); None if the
        alignment crosses a contig boundary (reported unmapped)."""
        from ..io.genome import concat_to_contig

        return concat_to_contig(
            mr.pos, max(mr.ref_span, 1),
            self.contigs["starts"], self.contigs["lens"],
            self.contigs["names"],
        )

    def to_sam_records(self, names, seqs, lens, quals,
                       results: list[MapResult]):
        """Convert MapResults to SamRecords (SEQ is the forward-strand
        read for FLAG 16 records, per SAM convention)."""
        recs = []
        for i, mr in enumerate(results):
            pat = seqs[i, : lens[i]].astype(np.uint8)
            q = quals[i, : lens[i]].astype(np.uint8)
            if mr.aligned and mr.strand == 1:
                pat = np.where(pat < 4, 3 - pat, pat)[::-1].astype(np.uint8)
                q = q[::-1]
            seq_str = dna_to_char(pat).tobytes().decode()
            qual_str = (q + 33).tobytes().decode()
            loc = self.locate_contig(mr) if mr.aligned else None
            if not mr.aligned or loc is None:
                recs.append(SamRecord(names[i], FLAG_UNMAPPED, "*", 0, 0,
                                      "*", seq_str, qual_str))
                continue
            rname, lpos = loc
            tags = [("AS", "i", mr.score), ("NM", "i", mr.nm),
                    ("MD", "Z", mr.md)]
            if mr.second is not None:
                tags.insert(1, ("XS", "i", mr.second))
            recs.append(
                SamRecord(
                    names[i],
                    FLAG_REVERSE if mr.strand else 0,
                    rname,
                    lpos + 1,
                    mr.mapq,
                    mr.cigar,
                    seq_str,
                    qual_str,
                    tags=tags,
                )
            )
        return recs

    def map_reads_all(self, seqs, lens, quals, max_alns: int = 8):
        """All-mappings mode (ref: nvBowtie --all): per read, up to
        max_alns distinct alignments above score-min, score-descending,
        each traced back to a full MapResult."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, quals = self._len_bucket(seqs, lens, quals)
        out: list[list[MapResult]] = []
        for s0 in range(0, R, B):
            out.extend(self._map_chunk_all(
                seqs[s0 : s0 + B], lens[s0 : s0 + B], quals[s0 : s0 + B],
                max_alns,
            ))
        return out

    def _map_chunk_all(self, seqs, lens, quals, k):
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr = jnp.asarray(seqs)
        jl = jnp.asarray(lens.astype(np.int32))
        jq = jnp.asarray(quals.astype(np.uint8))
        fwd = map_all_batch(
            self.fm, self.ssa, self.genome, jr, jl, jq,
            params=self.params, k=k, lut=self.lut, fm2=self.fm2,
            bi=self.bi,
        )
        K = fwd["score"].shape[1]
        # traceback every slot: flatten (B, K) -> (B*K) pseudo-batch
        rep = lambda a: jnp.repeat(a, K, axis=0)
        res, walk = traceback_walk_batch(
            self.genome, jnp.asarray(self.n, jnp.int32),
            rep(jr), jnp.repeat(jl, K), rep(jq),
            fwd["win_start"].reshape(-1), fwd["strand"].reshape(-1),
            params=self.params, active=fwd["valid"].reshape(-1),
        )
        flat_fwd = {
            "aligned": np.asarray(fwd["valid"]).reshape(-1),
            "strand": np.asarray(fwd["strand"]).reshape(-1),
            "win_start": np.asarray(fwd["win_start"]).reshape(-1),
            "score": np.asarray(fwd["score"]).reshape(-1),
            "second": np.zeros(B * K, np.int32),
            "has_second": np.zeros(B * K, bool),
            "mapq": np.zeros(B * K, np.int32),
        }
        results = self._finish(
            np.repeat(seqs, K, axis=0), np.repeat(lens, K),
            np.repeat(quals, K, axis=0), flat_fwd, res, walk,
        )
        return self._group_all(results, min(R, B), K)

    def to_sam_records_all(self, names, seqs, lens, quals,
                           all_results: list[list[MapResult]]):
        """Primary record per read + FLAG 0x100 secondary records."""
        from ..io.sam import FLAG_SECONDARY

        recs = []
        for i, alns in enumerate(all_results):
            primary = self.to_sam_records(
                [names[i]], seqs[i : i + 1], lens[i : i + 1],
                quals[i : i + 1],
                [alns[0] if alns else MapResult(aligned=False)],
            )
            recs.extend(primary)
            for a in alns[1:]:
                (sec,) = self.to_sam_records(
                    [names[i]], seqs[i : i + 1], lens[i : i + 1],
                    quals[i : i + 1], [a],
                )
                sec.flag |= FLAG_SECONDARY
                recs.append(sec)
        return recs


@functools.partial(jax.jit,
                   static_argnames=("params", "k", "bi"))
def map_all_batch(
    fm: FMIndex,
    ssa: SSA,
    genome,
    reads,
    lens,
    quals,
    *,
    params: MapperParams,
    k: int = 8,
    lut=None,
    fm2=None,
    bi: bool = False,
):
    """All-mappings forward step (ref: nvBowtie --all, all_inl.h).

    Returns the top-k distinct candidate alignments per read (score-
    descending), each with score/strand/win_start/t_end/p_end and a
    validity mask (score >= score-min).  "All" is bounded by the
    candidate capacity 2*max_candidates, the fixed-shape analog of the
    reference's effort limits (SURVEY.md §7.3(3)).
    """
    C = params.max_candidates
    k = min(k, 2 * C)
    cands = candidate_stage(
        fm, ssa, genome, reads, lens, quals,
        params=params, lut=lut, fm2=fm2, bi=bi,
    )
    sc = cands["score"]
    order = jnp.argsort(-sc, axis=1)[:, :k]  # (R, k) score-descending
    take = lambda a: jnp.take_along_axis(a, order, axis=1)
    scores = take(sc)
    smin = _score_min(lens, params)
    return {
        "score": scores,
        "valid": (scores >= smin[:, None]) & (lens[:, None] > 0),
        "strand": (order // C).astype(jnp.int32),
        "win_start": take(cands["win_start"]),
        "t_end": take(cands["t_end"]),
        "p_end": take(cands["p_end"]),
    }
