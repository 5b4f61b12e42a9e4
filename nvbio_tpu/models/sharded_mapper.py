"""Mapping against a sharded FM-index (beyond-int32 / beyond-HBM refs).

Design (fmindex/sharded.py): the genome is split into S shards, each
with its own int32 FM-index over [start, start + span + overlap).  Per
batch, the shared candidate stage runs against every shard with that
shard's genome slice (all positions stay shard-local int32 on device);
an **ownership rule** replaces cross-shard dedupe: a candidate belongs
to a shard iff its window start lies inside the shard's span, so
boundary-crossing alignments are found exactly once (in the left
shard, whose overlap >= one alignment window).  A cross-shard top-2
reduction picks best/second; traceback runs per shard and the winner's
op stream is selected on the host.  Positions globalize (start +
local) only on the host, in int64.

This is also the single-device schedule of the index-sharding layout
(SURVEY.md §5.8): on a mesh (models/mesh_sharded.py), each shard lives
on its own device with the read batch broadcast, and the same
reduction runs as a `jax.lax.pmax`-style tree.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..alignment.types import NEG_INF
from .mapper import (Mapper, MapResult, candidate_stage,
                     traceback_walk_windows, _score_min, _score_perfect,
                     PAD)
from ..alignment.batched import window_slices
from .mapq import mapq_v2
from .params import MapperParams


@functools.partial(jax.jit, static_argnames=("params",))
def _sharded_walk(gs, lengths, ws, shard, reads, lens, quals, strand, *,
                  params: MapperParams):
    """Winner-shard traceback in ONE walk: gather each lane's window
    text from its winning shard's slice (S cheap gathers + selects),
    then run a single winners-only DP + walk — instead of S full DP
    walks with host-side selection (S x the device work)."""
    L = reads.shape[1]
    LT = L + 2 * params.band_w
    texts = tlens = None
    for s in range(len(gs)):
        wsc = jnp.clip(ws, 0, lengths[s] - 1)
        t_s = window_slices(gs[s], wsc, LT)  # one slice per lane
        tl_s = jnp.clip(lengths[s] - wsc, 0, LT)
        if texts is None:
            texts, tlens = t_s, tl_s
        else:
            m = shard == s
            texts = jnp.where(m[:, None], t_s, texts)
            tlens = jnp.where(m, tl_s, tlens)
    return traceback_walk_windows(texts, tlens, reads, lens, quals,
                                  strand, params=params)


@functools.partial(jax.jit, static_argnames=("params", "k"))
def _shard_all(fm, ssa, genome_s, reads, lens, quals, lo, hi, *,
               params: MapperParams, k=8, lut=None, fm2=None):
    """Per-shard top-k candidates for --all mode (ownership-masked)."""
    C = params.max_candidates
    k = min(k, 2 * C)
    c = candidate_stage(fm, ssa, genome_s, reads, lens, quals,
                        params=params, lut=lut,
                        fm2=fm2)
    ws = c["win_start"]
    sc = jnp.where((ws >= lo) & (ws < hi), c["score"], NEG_INF)
    order = jnp.argsort(-sc, axis=1)[:, :k]
    take = lambda a: jnp.take_along_axis(a, order, axis=1)
    return {
        "score": take(sc),
        "strand": (order // C).astype(jnp.int32),
        "win_start": take(c["win_start"]),
    }


@functools.partial(jax.jit, static_argnames=("params", "k"))
def _sharded_all_merge(per_shard, lens, params: MapperParams, k=8):
    """Merge per-shard top-k lists into a global score-descending top-k
    with shard ids."""
    S = len(per_shard)
    sc = jnp.concatenate([p["score"] for p in per_shard], axis=1)
    ws = jnp.concatenate([p["win_start"] for p in per_shard], axis=1)
    st = jnp.concatenate([p["strand"] for p in per_shard], axis=1)
    kk = per_shard[0]["score"].shape[1]
    shard_id = jnp.repeat(jnp.arange(S, dtype=jnp.int32), kk)[None, :]
    order = jnp.argsort(-sc, axis=1)[:, :k]
    take = lambda a: jnp.take_along_axis(a, order, axis=1)
    scores = take(sc)
    smin = _score_min(lens, params)
    return {
        "score": scores,
        "valid": (scores >= smin[:, None]) & (lens[:, None] > 0),
        "strand": take(st),
        "win_start": take(ws),  # shard-local
        "shard": take(jnp.broadcast_to(shard_id, sc.shape)),
    }


@functools.partial(jax.jit, static_argnames=("params",))
def _shard_cands(fm, ssa, genome_s, reads, lens, quals, lo, hi, *,
                 params: MapperParams, lut=None, fm2=None, pre=None):
    c = candidate_stage(fm, ssa, genome_s, reads, lens, quals,
                        params=params, lut=lut,
                        fm2=fm2, pre=pre)
    # ownership interval [lo, hi): alignments starting in the overlap
    # tail belong to the next shard, and window origins clamped to the
    # shard's left edge (local 0, non-first shards) are clipped
    # duplicates of alignments the previous shard sees whole — mask
    # both so every alignment is counted exactly once, un-clipped
    ws = c["win_start"]
    sc = jnp.where((ws >= lo) & (ws < hi), c["score"], NEG_INF)
    return {**c, "score": sc}


@functools.partial(jax.jit, static_argnames=("params",))
def _sharded_top2(cands, lens, params: MapperParams):
    """cands: list of per-shard dicts with (R, 2C) arrays."""
    sc = jnp.concatenate([c["score"] for c in cands], axis=1)
    ws = jnp.concatenate([c["win_start"] for c in cands], axis=1)
    te = jnp.concatenate([c["t_end"] for c in cands], axis=1)
    pe = jnp.concatenate([c["p_end"] for c in cands], axis=1)
    out = _top2_concat(sc, ws, te, pe, lens, params)
    out["locate_dropped"] = sum(
        c.get("locate_dropped", jnp.int32(0)) for c in cands)
    # per-read budget-overflow evidence for the escalation round: a
    # read overflowed if ANY shard's budgets overflowed for it
    ovf = [c["overflow"] for c in cands if "overflow" in c]
    if ovf:
        out["overflow"] = functools.reduce(jnp.logical_or, ovf)
    return out


def _top2_concat(sc, ws, te, pe, lens, params: MapperParams):
    """Cross-shard top-2 reduce over shard-major concatenated
    candidate arrays (R, S * 2C).  Shared by the sequential
    single-device path (_sharded_top2) and the shard-per-chip mesh
    path (mesh_sharded.mesh_map_batch) so both are bit-identical:
    argmax ties resolve to the lowest (shard, strand, slot) index in
    both layouts."""
    R = lens.shape[0]
    C = params.max_candidates
    bi = jnp.argmax(sc, axis=1)
    best = jnp.take_along_axis(sc, bi[:, None], axis=1)[:, 0]
    cols_m = jnp.arange(sc.shape[1], dtype=jnp.int32)
    second = jnp.max(  # mask-by-compare: no scatter
        jnp.where(cols_m[None, :] == bi[:, None], NEG_INF, sc), axis=1)
    has_second = second > NEG_INF // 2
    smin = _score_min(lens, params)
    smax = _score_perfect(lens, params)
    aligned = (best >= smin) & (lens > 0)
    strand = ((bi // C) % 2).astype(jnp.int32)
    shard = (bi // (2 * C)).astype(jnp.int32)
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
        "shard": shard,
        "win_start": take(ws),  # shard-local
        "t_end": take(te),
        "p_end": take(pe),
        "mapq": mapq,
    }


@functools.partial(jax.jit, static_argnames=("params",))
def _sharded_pe_merge(shard_outs, l1, l2, rel, params: MapperParams):
    """Cross-shard reduction of per-shard pe_map_batch outputs.

    Mirrors the single-index decision ladder exactly: concordant pairs
    beat rescue pairs globally (not per shard); pair MAPQ uses the
    global concordant second-best (winner shard's second vs other
    shards' best); SE fallback fields merge over ownership-masked
    per-shard SE bests.  Pairs never split across shards (the overlap
    covers a full pair span), so per-shard pair scores partition the
    global pair set.

    `rel` is the (S, S) int32 shard-offset matrix
    rel[s, w] = starts[w] - starts[s] (INT32_MIN sentinel where the
    true offset overflows int32 — such shard pairs share no position).
    It converts the reported mate's shard-w-local window origin into
    shard s's frame so the XS merge can exclude the reported alignment
    itself from other shards' se_best contributions: for a proper pair
    whose reported mate is OWNED by a non-winner shard (boundary
    straddle), that shard's ownership-masked se_best IS the reported
    alignment, and without the exclusion XS == AS on uniquely-mapping
    mates."""
    stackf = lambda sel: jnp.stack([sel(o) for o in shard_outs])
    st1 = {k: stackf(lambda o: o[0][k]) for k in shard_outs[0][0]}
    st2 = {k: stackf(lambda o: o[1][k]) for k in shard_outs[0][1]}
    stp = {k: stackf(lambda o: o[2][k])
           for k in ("has_conc", "pair_score", "pair_second", "proper")}
    m1, m2, pair = _pe_merge_stacked(st1, st2, stp, l1, l2, rel, params)
    pair["locate_dropped"] = sum(
        o[2].get("locate_dropped", jnp.int32(0)) for o in shard_outs)
    return m1, m2, pair


def _pe_merge_stacked(st1, st2, stp, l1, l2, rel, params: MapperParams):
    """Core of _sharded_pe_merge over PRE-STACKED (S, R) arrays —
    shared verbatim by the sequential path (host-stacked list) and the
    shard-per-chip mesh path (all_gather over the ``shard`` axis), so
    both layouts reduce bit-identically."""
    has_conc = stp["has_conc"]  # (S, R)
    p_sc = stp["pair_score"]
    p_2nd = stp["pair_second"]
    proper_s = stp["proper"]
    S = has_conc.shape[0]
    conc_sc = jnp.where(has_conc, p_sc, NEG_INF)
    resc_sc = jnp.where(proper_s & ~has_conc, p_sc, NEG_INF)
    any_conc = has_conc.any(axis=0)
    w = jnp.where(any_conc, jnp.argmax(conc_sc, axis=0),
                  jnp.argmax(resc_sc, axis=0)).astype(jnp.int32)  # (R,)
    proper = any_conc | (jnp.max(resc_sc, axis=0) > NEG_INF // 2)
    takeS = lambda a: jnp.take_along_axis(a, w[None, :], axis=0)[0]
    pair_score = takeS(p_sc)
    sid = jnp.arange(S, dtype=jnp.int32)[:, None]
    conc_others = jnp.where(sid == w[None, :], NEG_INF, conc_sc)
    pair_second = jnp.where(
        any_conc,
        jnp.maximum(takeS(p_2nd), jnp.max(conc_others, axis=0)),
        NEG_INF,
    )
    sperf_p = _score_perfect(l1, params) + _score_perfect(l2, params)
    smin_p = _score_min(l1, params) + _score_min(l2, params)
    mq_pair = mapq_v2(pair_score, pair_second,
                      pair_second > NEG_INF // 2, smin_p, sperf_p)

    def merge_mate(st, lens):
        m = lambda key: st[key]
        se_best = m("se_best")
        se_sec = m("se_second")
        wg = jnp.argmax(se_best, axis=0).astype(jnp.int32)
        tG = lambda a: jnp.take_along_axis(a, wg[None, :], axis=0)[0]
        g_best = tG(se_best)
        others_se = jnp.where(sid == wg[None, :], NEG_INF, se_best)
        sec_se = jnp.maximum(tG(se_sec), jnp.max(others_se, axis=0))
        # XS for the proper path: the winner shard's own `second`
        # already excludes its reported alignment; other shards
        # contribute their SE best — EXCEPT when that se_best is the
        # reported alignment itself (same global origin + strand, seen
        # via `rel`), which happens whenever the reported mate's origin
        # is owned by a non-winner shard.  Rescue-placed mates are not
        # candidate-list entries, so no exclusion for them (single-index
        # parity: pe_map_batch pick() excludes idx only when ~resc).
        rep_ws = takeS(m("win_start"))
        rep_st = takeS(m("strand"))
        not_resc = ~takeS(m("resc"))
        same_rep = (not_resc[None, :]
                    & ((m("se_ws") - rep_ws[None, :]) == rel[:, w])
                    & (m("se_strand") == rep_st[None, :]))
        others_w = jnp.where((sid == w[None, :]) | same_rep, NEG_INF,
                             se_best)
        sec_rep = jnp.maximum(takeS(m("second")),
                              jnp.max(others_w, axis=0))
        g_second = jnp.where(proper, sec_rep, sec_se)
        smin = _score_min(lens, params)
        se_aligned = (g_best >= smin) & (lens > 0)
        strand = jnp.where(proper, takeS(m("strand")), tG(m("se_strand")))
        ws = jnp.where(proper, takeS(m("win_start")), tG(m("se_ws")))
        score = jnp.where(proper, takeS(m("score")), g_best)
        aligned = jnp.where(proper, True, se_aligned)
        shard = jnp.where(proper, w, wg)
        mq_se = mapq_v2(g_best, sec_se, sec_se >= smin, smin,
                        _score_perfect(lens, params))
        mq = jnp.where(proper, mq_pair, mq_se)
        return {
            "aligned": aligned & (lens > 0), "strand": strand,
            "win_start": ws, "score": score,
            "mapq": jnp.where(aligned, mq, 0),
            "second": g_second, "has_second": g_second > NEG_INF // 2,
            "shard": shard,
        }, se_aligned

    m1, a1 = merge_mate(st1, l1)
    m2, a2 = merge_mate(st2, l2)
    discordant = (~proper) & a1 & a2
    return m1, m2, {"proper": proper, "discordant": discordant}


class ShardedMapper(Mapper):
    """Host orchestration over a ShardedIndex; SAM emit shared with the
    flagship mapper (global positions appear only on the host)."""

    #: pair-BWT bytes across ALL shards below which fm2 is derived
    #: once at init and kept resident (fm2_mode="auto")
    FM2_RESIDENT_BUDGET = 2 << 30

    def __init__(self, sidx, genome_symbols: np.ndarray,
                 params: MapperParams = MapperParams(),
                 ref_name: str = "ref", contigs: dict | None = None,
                 device_state: bool = True,
                 fm2_mode: str = "auto", fuse: bool = True):
        ssa_k = int(getattr(sidx.shards[0][1], "k", 0) or 0)
        if ssa_k and params.sa_sample != ssa_k:
            from dataclasses import replace
            params = replace(params, sa_sample=ssa_k)
        self.params = params
        self.ref_name = ref_name
        self.n = int(len(genome_symbols))
        if contigs is None:
            contigs = {"names": [ref_name], "starts": np.zeros(1, np.int64),
                       "lens": np.array([self.n], np.int64)}
        self.contigs = contigs
        lt_pad = params.max_read_len + 2 * params.band_w + 8
        gp = np.full(self.n + lt_pad, PAD, dtype=np.int8)
        gp[: self.n] = genome_symbols
        self._genome_np = gp  # GLOBAL host copy (int64 indexing is free)
        self.locate_dropped = 0
        self.escalated = 0  # re-maps performed by escalation rounds
        self.overflowed = 0  # reads whose round-1 budgets overflowed
        self.lut = None
        # per-shard device state: genome slice (+pad) and index
        # (device_state=False: metadata only — MeshShardedMapper keeps
        # one stacked copy per device instead)
        from ..fmindex.index import fuse_occ
        self.shard_state = []
        for (fm, ssa, lut, start, length) in sidx.shards:
            g_s = None
            if device_state:
                g_s = jnp.asarray(gp[start : start + length + lt_pad])
                if fuse and getattr(fm, "fused", None) is None:
                    # fused block rows: 1 gather per rank/LF
                    # (index.py).  fuse=False trades the +0.6 B/bp
                    # away when device memory is tight (fm2's rank2
                    # is not fused, so a resident pair-BWT dominates)
                    fm = fuse_occ(fm)
            self.shard_state.append(dict(
                fm=fm if device_state else None,
                ssa=ssa if device_state else None,
                lut=lut if device_state else None,
                start=start, length=length,
                g=g_s,
            ))
        # owned span of shard i = next shard's start - this start (or
        # n - start for the last)
        starts = [s["start"] for s in self.shard_state] + [self.n]
        for i, st in enumerate(self.shard_state):
            st["span"] = starts[i + 1] - starts[i]
            # ownership interval [own_lo, own_hi) in local coords: the
            # left edge (local 0) of non-first shards holds clamped
            # duplicates owned by the previous shard (see _shard_cands)
            st["own_lo"] = 0 if i == 0 else 1
            st["own_hi"] = st["span"] + 1
        # shard-offset matrix for cross-shard position identity checks
        # (see _sharded_pe_merge): rel[s, w] = starts[w] - starts[s],
        # INT32_MIN where the true offset overflows int32 (such shard
        # pairs are too far apart to ever share a position)
        st64 = np.asarray(starts[:-1], np.int64)
        rel64 = st64[None, :] - st64[:, None]
        self._rel = jnp.asarray(
            np.where(np.abs(rel64) < 2**31 - 1, rel64,
                     np.int64(-(2**31))).astype(np.int32))

        # 2-step FM-index mode (fmindex/fm2.py): "resident" derives a
        # pair-BWT per shard at init (all stay in HBM — small/medium
        # genomes); "stream" holds ONE shard's pair-BWT at a time and
        # runs map_stream shard-major (hg-scale: ~3 bytes/row per
        # shard cannot all be resident); "off" disables fm2
        if not params.use_fm2 or not device_state:
            fm2_mode = "off"
        elif fm2_mode == "auto":
            total = sum(3 * int(st["fm"].bwt_words.shape[0]) * 128
                        for st in self.shard_state)
            fm2_mode = ("resident" if total <= self.FM2_RESIDENT_BUDGET
                        else "stream")
        self.fm2_mode = fm2_mode
        if fm2_mode == "resident":
            from ..fmindex import build_fm2_device
            for st in self.shard_state:
                st["fm2"] = build_fm2_device(st["fm"])
        else:
            for st in self.shard_state:
                st["fm2"] = None

    def _dispatch_chunk(self, seqs, lens, quals, params=None):
        params = params or self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        R = seqs.shape[0]
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr = jnp.asarray(seqs)
        jl = jnp.asarray(lens.astype(np.int32))
        jq = jnp.asarray(quals.astype(np.uint8))
        # strands + seed extraction are index-independent: run once,
        # reuse for every shard's stage (from mapper.stage_reads)
        from .mapper import stage_reads
        pre = stage_reads(jr, jl, jq, params=params)
        cands = [
            _shard_cands(st["fm"], st["ssa"], st["g"], jr, jl, jq,
                         jnp.asarray(st["own_lo"], jnp.int32),
                         jnp.asarray(st["own_hi"], jnp.int32),
                         params=params, lut=st["lut"], fm2=st["fm2"],
                         pre=pre)
            for st in self.shard_state
        ]
        fwd = _sharded_top2(cands, jl, params)
        res, walk = _sharded_walk(
            self._gs, self._glens, fwd["win_start"], fwd["shard"],
            jr, jl, jq, fwd["strand"], params=params,
            )
        return (seqs, lens, quals, fwd, walk, R)

    def map_stream(self, packed_iter, depth: int = 2):
        if self.fm2_mode != "stream":
            yield from super().map_stream(packed_iter, depth)
            return
        yield from self._map_stream_shard_major(packed_iter)

    def _map_stream_shard_major(self, packed_iter):
        """Shard-major streaming: ONE shard's pair-BWT in HBM at a
        time (hg-scale fm2; see __init__).

        Phase 1 buffers the input and runs the candidate stage for
        every chunk against shard s before moving to shard s+1 —
        deriving shard s's pair-BWT on device (build_fm2_device: the
        base index is already resident, nothing is uploaded), pulling
        each chunk's compact per-shard candidate dict to the host, and
        dropping the pair-BWT before the next shard.  Phase 2 replays
        the cross-shard top-2 merge + winner-shard walk per chunk —
        identical math to the batch-major path, so results are
        bit-identical to fm2_mode="off"/"resident" (tested).

        Tradeoffs vs batch-major: the whole input stream is buffered
        (host) before any output appears — a crash mid-run resumes
        from nothing — and per-chunk candidate dicts (~a few MB each)
        ride host RAM between phases.  The reference has no analog:
        its GPU held one whole-genome index (SURVEY.md §3.3); this
        bounds the device memory of hg-scale 2-step indexes on one
        device.
        """
        from ..fmindex import build_fm2_device

        B = self.params.batch_size
        batches = []  # (names, seqs, lens, quals, chunk indices)
        chunks = []  # (padded seqs, lens, quals, live row count)
        for names, seqs, lens, quals in packed_iter:
            seqs, quals = self._len_bucket(seqs, lens, quals)
            idxs = []
            for s0 in range(0, seqs.shape[0], B):
                c = self._pad_chunk(seqs[s0 : s0 + B],
                                    lens[s0 : s0 + B],
                                    quals[s0 : s0 + B])
                idxs.append(len(chunks))
                chunks.append((*c, min(B, seqs.shape[0] - s0)))
            batches.append((names, seqs, lens, quals, idxs))

        S = len(self.shard_state)
        cands = [[None] * S for _ in chunks]
        for s, st in enumerate(self.shard_state):
            fm2_s = build_fm2_device(st["fm"])
            handles = [
                _shard_cands(
                    st["fm"], st["ssa"], st["g"], jnp.asarray(cs),
                    jnp.asarray(cl.astype(np.int32)),
                    jnp.asarray(cq.astype(np.uint8)),
                    jnp.asarray(st["own_lo"], jnp.int32),
                    jnp.asarray(st["own_hi"], jnp.int32),
                    params=self.params, lut=st["lut"], fm2=fm2_s)
                for cs, cl, cq, _r in chunks
            ]
            for ci, h in enumerate(handles):
                cands[ci][s] = jax.device_get(h)
            del handles, fm2_s  # frees this shard's pair-BWT HBM

        for names, seqs, lens, quals, idxs in batches:
            results = []
            for ci in idxs:
                cs, cl, cq, live = chunks[ci]
                jr = jnp.asarray(cs)
                jl = jnp.asarray(cl.astype(np.int32))
                jq = jnp.asarray(cq.astype(np.uint8))
                fwd = _sharded_top2(cands[ci], jl, self.params)
                res, walk = _sharded_walk(
                    self._gs, self._glens, fwd["win_start"],
                    fwd["shard"], jr, jl, jq, fwd["strand"],
                    params=self.params)
                results.extend(self._collect_chunk(
                    (cs, cl, cq, fwd, walk, live)))
            yield names, seqs, lens, quals, results

    @property
    def _gs(self):
        return tuple(st["g"] for st in self.shard_state)

    @property
    def _glens(self):
        return tuple(jnp.asarray(st["length"], jnp.int32)
                     for st in self.shard_state)

    def _finish_sharded(self, seqs, lens, quals, fwd, walk, R):
        if "locate_dropped" in fwd:
            self.locate_dropped += int(fwd["locate_dropped"])
        shard = np.asarray(fwd["shard"])
        # globalize win_start on host (int64)
        starts = np.asarray([st["start"] for st in self.shard_state],
                            np.int64)
        fwd2 = dict(fwd)
        fwd2["win_start"] = (starts[shard]
                             + np.asarray(fwd["win_start"]).astype(np.int64))
        return self._finish(seqs, lens, quals, fwd2, None, walk)[:R]

    def _finish_handle(self, handle):
        """(results, fwd) for one dispatched chunk (escalation rounds;
        see Mapper._escalate_chunk)."""
        seqs, lens, quals, fwd, walk, R = handle
        return self._finish_sharded(seqs, lens, quals, fwd, walk, R), fwd

    def _collect_chunk(self, handle):
        seqs, lens, quals, fwd, walk, R = handle
        if "overflow" in fwd:
            self.overflowed += int(np.asarray(fwd["overflow"])[:R].sum())
        results = self._finish_sharded(seqs, lens, quals, fwd, walk, R)
        # escalation ladder (ref: best_approx_inl.h rounds loop; shared
        # with Mapper._escalate_chunk): re-map reads whose budgets
        # overflowed on ANY shard with escalated budgets, up to
        # max_effort rounds
        if (self.ESCALATES and self.params.max_effort > 1
                and "overflow" in fwd):
            results = self._escalate_chunk(seqs, lens, quals, fwd,
                                           results, R)
        return results

    def map_reads_all(self, seqs, lens, quals, max_alns: int = 8):
        """--all over a sharded index: per-shard top-k candidate lists
        merged into a global top-k (ownership keeps overlap-visible
        hits exactly once), per-shard traceback, winners picked on the
        host.  Same output contract as Mapper.map_reads_all."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, quals = self._len_bucket(seqs, lens, quals)
        out: list[list[MapResult]] = []
        for s0 in range(0, R, B):
            out.extend(self._map_chunk_all(
                seqs[s0:s0 + B], lens[s0:s0 + B], quals[s0:s0 + B],
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
        per_shard = [
            _shard_all(st["fm"], st["ssa"], st["g"], jr, jl, jq,
                       jnp.asarray(st["own_lo"], jnp.int32),
                       jnp.asarray(st["own_hi"], jnp.int32),
                       params=self.params, k=k, lut=st["lut"],
                       fm2=st["fm2"])
            for st in self.shard_state
        ]
        fwd = _sharded_all_merge(per_shard, jl, self.params, k=k)
        K = fwd["score"].shape[1]
        rep = lambda a: jnp.repeat(a, K, axis=0)
        ws_flat = fwd["win_start"].reshape(-1)
        st_flat = fwd["strand"].reshape(-1)
        res, walk = _sharded_walk(
            self._gs, self._glens, ws_flat, fwd["shard"].reshape(-1),
            rep(jr), jnp.repeat(jl, K), rep(jq), st_flat,
            params=self.params)
        shard = np.asarray(fwd["shard"]).reshape(-1)
        starts = np.asarray([s["start"] for s in self.shard_state],
                            np.int64)
        flat_fwd = {
            "aligned": np.asarray(fwd["valid"]).reshape(-1),
            "strand": np.asarray(st_flat),
            "win_start": starts[shard] + np.asarray(ws_flat).astype(np.int64),
            "score": np.asarray(fwd["score"]).reshape(-1),
            "second": np.zeros(B * K, np.int32),
            "has_second": np.zeros(B * K, bool),
            "mapq": np.zeros(B * K, np.int32),
        }
        results = self._finish(
            np.repeat(seqs, K, axis=0), np.repeat(lens, K),
            np.repeat(quals, K, axis=0), flat_fwd, None, walk,
        )
        return self._group_all(results, min(R, B), K)


class PairedShardedMapper(ShardedMapper):
    """Paired-end mapping over a sharded index: per-shard pe_map_batch
    (pair ownership by leftmost mate; see paired.pe_map_batch `span`)
    merged with _sharded_pe_merge, per-mate per-shard traceback with
    host winner selection.  SAM emission is shared with PairedMapper.

    One documented divergence from the single-index mapper: mate rescue
    anchors on each shard's own SE best, so when a read's best anchors
    tie across shards the rescued pair can only improve on the single-
    index result (which rescues around the one global anchor)."""

    # borrow the paired orchestration/record layer
    from .paired import PairedMapper as _PM
    map_pairs = _PM.map_pairs
    _pairs_stream_batch_major = _PM.map_pairs_stream
    _map_pair_chunk = _PM._map_pair_chunk
    to_sam_records_pe = _PM.to_sam_records_pe
    _pe_record = _PM._pe_record

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        need = (self.params.maxins + self.params.max_read_len
                + 2 * self.params.band_w + 8)
        for st in self.shard_state[:-1]:
            ov = st["length"] - st["span"]
            if ov < need:
                raise ValueError(
                    f"sharded PE needs shard overlap >= maxins + "
                    f"max_read_len + 2*band_w + 8 = {need}, got {ov}; "
                    "rebuild the index with --shard-overlap >= that")

    _stage_pair_batch = _PM._stage_pair_batch

    def _shard_pe_outs(self, args, st, fm2):
        from .paired import pe_map_batch
        return pe_map_batch(
            st["fm"], st["ssa"], st["g"], *args,
            params=self.params, lut=st["lut"], fm2=fm2,
            span=(jnp.asarray(st["own_lo"], jnp.int32),
                  jnp.asarray(st["own_hi"], jnp.int32)),
        )

    def _pe_merge_walk(self, staged, shard_outs, R):
        (s1p, l1p, q1p), (s2p, l2p, q2p), args = staged
        m1, m2, pair = _sharded_pe_merge(
            shard_outs, args[1], args[4], self._rel, params=self.params)
        walks = []
        for mate, (sp, lp, qp) in ((m1, (s1p, l1p, q1p)),
                                   (m2, (s2p, l2p, q2p))):
            res, walk = _sharded_walk(
                self._gs, self._glens, mate["win_start"], mate["shard"],
                jnp.asarray(sp), jnp.asarray(lp.astype(np.int32)),
                jnp.asarray(qp.astype(np.uint8)), mate["strand"],
                params=self.params)
            walks.append((mate, walk))
        return ((s1p, l1p, q1p), (s2p, l2p, q2p), walks, pair, R)

    def _dispatch_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        R = s1.shape[0]
        staged = self._stage_pair_batch(s1, l1, q1, s2, l2, q2)
        shard_outs = [self._shard_pe_outs(staged[2], st, st["fm2"])
                      for st in self.shard_state]
        return self._pe_merge_walk(staged, shard_outs, R)

    def map_pairs_stream(self, packed_iter, depth: int = 2):
        """PE streaming; fm2_mode="stream" runs shard-major with ONE
        shard's pair-BWT resident at a time (see ShardedMapper.
        _map_stream_shard_major — same phase structure and the same
        bit-identity with the batch-major path, per-mate)."""
        if self.fm2_mode != "stream":
            yield from self._pairs_stream_batch_major(packed_iter, depth)
            return
        from ..fmindex import build_fm2_device

        batches = []  # (names, bucketed arrays, staged, live rows)
        for names, s1, l1, q1, s2, l2, q2 in packed_iter:
            bl = np.concatenate([l1, l2])
            s1, q1 = self._len_bucket(s1, bl, q1)
            s2, q2 = self._len_bucket(s2, bl, q2)
            staged = self._stage_pair_batch(s1, l1, q1, s2, l2, q2)
            batches.append((names, (s1, l1, q1, s2, l2, q2), staged,
                            s1.shape[0]))

        S = len(self.shard_state)
        outs = [[None] * S for _ in batches]
        for s, st in enumerate(self.shard_state):
            fm2_s = build_fm2_device(st["fm"])
            handles = [self._shard_pe_outs(staged[2], st, fm2_s)
                       for _nm, _arrs, staged, _r in batches]
            for bi, h in enumerate(handles):
                outs[bi][s] = jax.device_get(h)
            del handles, fm2_s

        for bi, (names, arrs, staged, live) in enumerate(batches):
            handle = self._pe_merge_walk(staged, outs[bi], live)
            r1, r2, info = self._collect_pair_chunk(handle)
            yield (names, *arrs, r1, r2, info)

    def _collect_pair_chunk(self, handle):
        (p1, p2, walks, pair, R) = handle
        if "locate_dropped" in pair:
            self.locate_dropped += int(pair["locate_dropped"])
        starts = np.asarray([s["start"] for s in self.shard_state],
                            np.int64)
        res1, res2 = [], []
        for (mate, walk), (sp, lp, qp), out in (
                (walks[0], p1, res1), (walks[1], p2, res2)):
            shard = np.asarray(mate["shard"])
            fwd = dict(mate)
            fwd["win_start"] = (starts[shard]
                                + np.asarray(mate["win_start"]).astype(np.int64))
            out.extend(self._finish(sp, lp, qp, fwd, None, walk))
        proper = np.asarray(pair["proper"])
        discordant = np.asarray(pair["discordant"])
        info = [
            {"proper": bool(proper[i]), "discordant": bool(discordant[i])}
            for i in range(R)
        ]
        from .paired import apply_pair_policy
        return apply_pair_policy(res1[:R], res2[:R], info,
                                 p1[1], p2[1], self.params)
