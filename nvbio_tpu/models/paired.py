"""Paired-end mapping (Bowtie2-compatible semantics, FR orientation).

Ref parity: the paired pipeline inside
nvBowtie/bowtie2/cuda/best_approx_inl.h — concordant candidate pairing
by insert size, opposite-mate window rescue (``score_opposite`` with
``BestColumnSink``, ref: score_inl.h), discordant fallback, and pair
MAPQ.  Fixed-shape re-design: both mates run the shared ``candidate_stage``,
pairing is a dense (2C x 2C) score matrix per read pair (tiny: C is
16), and mate rescue is one wide-band semi-global DP over the insert
window — full-matrix search expressed in the same banded kernel.

Decision ladder per pair (matching Bowtie2's default behavior):
  1. best concordant candidate pair (each mate >= its score-min)
  2. rescue: anchor = best single-end mate; scan the insert window for
     the other mate
  3. discordant: both mates uniquely aligned but not concordant
  4. mixed: report each mate as single-end (or unmapped)
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

import math

from ..alignment.types import AlignmentType, NEG_INF
from ..ops.banded_dp import banded_score
from .params import MapperParams
from .mapper import (
    candidate_stage,
    traceback_walk_batch,
    _revcomp_batch,
    _score_min,
    score_min_host,
    _score_perfect,
    Mapper,
    MapResult,
    PAD,
)
from .mapq import mapq_v2
from ..basic.alphabet import dna_to_char
from ..io import sam as S


def _se_reduce(c, lens, params, span=None):
    """Top-2 single-end reduction over a candidate dict (R, 2C).
    With `span` = (lo, hi) (sharded PE), only candidates whose window
    origin lies in the shard's ownership interval count (overlap tails
    and left-edge clamp duplicates are masked; see
    sharded_mapper._shard_cands)."""
    R = c["score"].shape[0]
    C = params.max_candidates
    sc = c["score"]
    if span is not None:
        lo, hi = span
        ws = c["win_start"]
        sc = jnp.where((ws >= lo) & (ws < hi), sc, NEG_INF)
    bi = jnp.argmax(sc, axis=1)
    best = jnp.take_along_axis(sc, bi[:, None], axis=1)[:, 0]
    cols_m = jnp.arange(sc.shape[1], dtype=jnp.int32)
    second = jnp.max(  # mask-by-compare: no scatter
        jnp.where(cols_m[None, :] == bi[:, None], NEG_INF, sc), axis=1)
    smin = _score_min(lens, params)
    take = lambda a: jnp.take_along_axis(a, bi[:, None], axis=1)[:, 0]
    return {
        "best": best,
        "second": second,
        "bi": bi,
        "sc": sc,  # ownership-masked candidate scores (R, 2C)
        "aligned": (best >= smin) & (lens > 0),
        "strand": (bi // C).astype(jnp.int32),
        "win_start": take(c["win_start"]),
    }


def _chunk_plan(L: int, LT: int, params):
    """Static plan for chunked window rescue: cover the insert window
    with overlapping band-63 sub-windows instead of one window-wide
    band, so the DP work grows with a chunk's band (127 cells), not
    with the whole insert window (2 * rescue_w + 1 cells).

    Exactness: an alignment reported by rescue must score >= score-min,
    which bounds its total gap extension T <= (perfect - smin - go)/ge.
    A chunk with text origin b holds alignments starting at global
    position s >= b with start diagonal j0 = s - b <= w_c; the path
    drifts at most T, so it stays in band whenever j0 <= w_c - T.
    Chunk origins every sigma = w_c - T therefore cover every
    above-threshold alignment exactly as the full-width band does;
    sub-threshold scores may differ but are never consumed (rescue
    gates on score >= smin).
    Returns (w_c, CW, origins) or None when the margin is too thin
    (e.g. LOCAL's match bonus makes T large)."""
    if params.atype != AlignmentType.SEMI_GLOBAL:
        return None
    w_c = 63
    smin = score_min_host(L, params)
    budget = L * params.scheme.match - smin
    # conservative drift bound: the cheapest gap family affords the
    # most extension steps
    from ..alignment.types import gap_penalties
    _eo, _ee, _fo, _fe = gap_penalties(params.scheme)
    t_aff = (budget - min(_eo, _fo)) // min(_ee, _fe)
    margin = w_c - int(t_aff)
    if margin < 12:
        return None
    sigma = margin
    # cover alignment starts in [0, rescue_w] — the same row-0 reach as
    # the window-wide band (the window is gathered 2*rescue_w + L wide
    # but starts beyond rescue_w are out of insert range by definition)
    s_max = (LT - L) // 2
    n_chunks = max(1, math.ceil((s_max + 1) / sigma))
    origins = tuple(c * sigma for c in range(n_chunks))
    CW = L + w_c + 8  # max text consumed by a band-w_c semi-global
    return w_c, CW, origins


def _chunked_window_score(pats, lens, texts, tlens, quals, params, plan):
    """Window-wide best semi-global alignment via overlapping
    narrow-band chunks (see _chunk_plan), on the engine
    ``ops.select_banded_dp`` picks for the chunk band."""
    R, L = pats.shape
    LT = texts.shape[1]
    w_c, CW, origins = plan
    C = len(origins)
    bs = jnp.asarray(origins, jnp.int32)
    texts_p = jnp.pad(
        texts, ((0, 0), (0, max(0, origins[-1] + CW - LT))),
        constant_values=PAD,
    )
    # (R, C, CW) -> (R*C, CW); read-major so lane r*C+c is read r chunk c
    tc = jnp.stack(
        [texts_p[:, b:b + CW] for b in origins], axis=1
    ).reshape(R * C, CW)
    tlc = jnp.clip(tlens[:, None] - bs[None, :], 0, CW).reshape(R * C)
    rep = lambda a: jnp.repeat(a, C, axis=0)
    res = banded_score(
        rep(pats), rep(lens), tc, tlc, rep(quals),
        scheme=params.scheme, atype=params.atype, band_w=w_c,
    )
    sc = res["score"].reshape(R, C)
    te = (res["t_end"].reshape(R, C) + bs[None, :])
    best = jnp.max(sc, axis=1)
    # tie-break = smallest global t_end among best chunks (the twin's
    # smallest-k rule at window scale)
    t_end = jnp.min(jnp.where(sc == best[:, None], te, jnp.int32(1 << 30)),
                    axis=1)
    t_end = jnp.where(best > NEG_INF // 2, t_end, 0)
    return {"score": best, "t_end": t_end, "p_end": lens}


def _pair_cases(params: MapperParams, p1, e1, st1, p2, e2, st2):
    """Concordance predicate over broadcastable position/strand arrays
    (bowtie2 pair policy, ref: params.cpp --fr/--rf/--ff --dovetail
    --no-contain --no-overlap): returns (ok_a, ok_b) — case a = mate 1
    upstream, case b = mate 2 upstream.  Insert = downstream end -
    upstream start.  Positions are win_start approximations of the
    alignment start (accurate to gaps), so the insert bounds and the
    dovetail test carry band_w slack; by default overlapping and
    contained mates stay concordant, dovetailing (an alignment
    extending past its mate's far end) does not.  Shared by the
    concordant candidate matrix and the rescue-pair validation so a
    rescued pair cannot violate the same policy."""
    slack = params.band_w
    ins_a = e2 - p1  # mate1 upstream
    ins_b = e1 - p2  # mate2 upstream
    if params.pe_orient == "fr":
        str_a = (st1 == 0) & (st2 == 1)
        str_b = (st1 == 1) & (st2 == 0)
    elif params.pe_orient == "rf":
        str_a = (st1 == 1) & (st2 == 0)
        str_b = (st1 == 0) & (st2 == 1)
    elif params.pe_orient == "ff":
        str_a = (st1 == 0) & (st2 == 0)  # fwd fragment: mate1 upstream
        str_b = (st1 == 1) & (st2 == 1)  # RC fragment: mate2 upstream
    else:
        raise ValueError(f"unknown pe_orient {params.pe_orient!r}")

    def _geom_ok(up_s, up_e, dn_s, dn_e):
        ok = jnp.ones(jnp.broadcast_shapes(up_s.shape, dn_s.shape), bool)
        if not params.pe_dovetail:
            # dovetail = the "wrong" mate starts upstream (bowtie2
            # manual --dovetail); the upstream mate merely extending
            # past the downstream's END is containment, allowed by
            # default
            dovetail = dn_s < up_s - slack
            ok = ok & ~dovetail
        if params.pe_no_contain:
            contain = ((dn_s >= up_s) & (dn_e <= up_e)) | (
                (up_s >= dn_s) & (up_e <= dn_e))
            ok = ok & ~contain
        if params.pe_no_overlap:
            ok = ok & ~((dn_s < up_e) & (up_s < dn_e))
        return ok

    ok_a = str_a & (ins_a >= params.minins - slack) & (
        ins_a <= params.maxins + slack) & _geom_ok(p1, e1, p2, e2)
    ok_b = str_b & (ins_b >= params.minins - slack) & (
        ins_b <= params.maxins + slack) & _geom_ok(p2, e2, p1, e1)
    return ok_a, ok_b


def _rescue(genome, n, anchor_ws, anchor_strand, anchor_len, mate_reads,
            mate_lens, mate_quals, params, mate_is_2: bool = True):
    """Opposite-mate window search: semi-global DP of the mate (in the
    orientation implied by params.pe_orient) over the insert window of
    the anchor (ref: score_inl.h ``score_opposite`` + params.cpp
    --fr/--rf/--ff).

    Returns (score, win_start, strand, t_end, p_end) for the rescued
    mate; win_start is the window origin used (for traceback reuse)."""
    R, L = mate_reads.shape
    W = params.band_w
    rescue_w = params.maxins + 2 * W  # diagonals cover the whole window
    LT = L + 2 * rescue_w
    rc_reads, rc_quals = _revcomp_batch(mate_reads, mate_lens, mate_quals)
    # expected mate strand: fr/rf mates are opposite-strand, ff same
    if params.pe_orient == "ff":
        m_strand = anchor_strand.astype(jnp.int32)
    else:
        m_strand = jnp.where(anchor_strand == 0, 1, 0).astype(jnp.int32)
    pats = jnp.where(m_strand[:, None] == 1, rc_reads, mate_reads)
    pquals = jnp.where(m_strand[:, None] == 1, rc_quals, mate_quals)
    # window side: is the missing mate DOWNSTREAM of the anchor?
    #   fr: downstream iff anchor forward (fwd mate is upstream)
    #   rf: downstream iff anchor reverse (rev mate is upstream)
    #   ff: mate 1 upstream on the forward fragment — rescuing mate 2
    #       from a forward anchor looks downstream, mate 1 upstream
    #       (and mirrored when the fragment is reverse-complemented)
    if params.pe_orient == "fr":
        downstream = anchor_strand == 0
    elif params.pe_orient == "rf":
        downstream = anchor_strand == 1
    elif params.pe_orient == "ff":
        downstream = ((anchor_strand == 0) == bool(mate_is_2))
    else:
        raise ValueError(f"unknown pe_orient {params.pe_orient!r}")
    ws_down = anchor_ws  # mate downstream of the anchor
    ws_up = anchor_ws + anchor_len - params.maxins - 2 * W
    win_start = jnp.where(downstream, ws_down, ws_up)
    win_start = jnp.clip(win_start, 0, jnp.maximum(n - 1, 0)).astype(jnp.int32)
    gidx = win_start[:, None] + jnp.arange(LT, dtype=jnp.int32)
    texts = genome[gidx]
    tlens = jnp.clip(n - win_start, 0, LT)
    # the rescue window (maxins+2W of start positions) is covered with
    # overlapping narrow-band chunks (see _chunk_plan); window-wide
    # band only when no plan (LOCAL)
    plan = _chunk_plan(L, LT, params)
    if plan is not None:
        res = _chunked_window_score(pats, mate_lens, texts, tlens,
                                    pquals, params, plan)
    else:
        res = banded_score(
            pats, mate_lens, texts, tlens, pquals,
            scheme=params.scheme, atype=params.atype, band_w=rescue_w,
        )
    # tighten the window to the found alignment so the winners-only
    # traceback (band_w-banded) sees it near diagonal 0
    ws_tight = jnp.clip(
        win_start + res["t_end"] - res["p_end"], 0, jnp.maximum(n - 1, 0)
    ).astype(jnp.int32)
    return {
        "score": res["score"],
        "win_start": ws_tight,
        "strand": m_strand,
        "t_end": res["t_end"],
        "p_end": res["p_end"],
    }


@functools.partial(jax.jit,
                   static_argnames=("params", "bi"))
def pe_map_batch(
    fm, ssa, genome, r1, l1, q1, r2, l2, q2, *,
    params: MapperParams, lut=None, span=None, fm2=None, bi: bool = False,
):
    """Paired forward step.  Returns per-mate dicts (aligned, strand,
    win_start, score, mapq, second) + pair-level info (proper,
    discordant, pair scores).

    `span` = (lo, hi) (sharded PE): this index covers one shard of the
    genome with ownership interval [lo, hi) in local window origins;
    concordant pairs are owned by the shard holding their leftmost
    (forward) mate's origin, SE candidates by their own origin — the
    shard overlap must cover a full pair span so boundary pairs are
    found whole in the left shard (checked by PairedShardedMapper)."""
    R = r1.shape[0]
    C = params.max_candidates
    n = fm.n
    # one candidate stage over both mates (2R reads): halves the
    # fixed per-call costs and doubles every gather/sort batch
    cc = candidate_stage(
        fm, ssa, genome,
        jnp.concatenate([r1, r2]), jnp.concatenate([l1, l2]),
        jnp.concatenate([q1, q2]), params=params, lut=lut, fm2=fm2, bi=bi)
    split = lambda v: (v[:R], v[R:]) if getattr(v, "ndim", 0) else (v, v)
    c1 = {k: split(v)[0] for k, v in cc.items()}
    c2 = {k: split(v)[1] for k, v in cc.items()}
    c1["locate_dropped"] = cc.get("locate_dropped", jnp.int32(0))
    c2["locate_dropped"] = jnp.int32(0)
    smin1 = _score_min(l1, params)
    smin2 = _score_min(l2, params)

    # --- concordant pairing over the candidate matrix ---
    cols = jnp.arange(2 * C, dtype=jnp.int32)
    st1 = (cols // C)[None, :, None]  # strand of mate1 candidate
    st2 = (cols // C)[None, None, :]
    p1 = c1["win_start"][:, :, None]
    p2 = c2["win_start"][:, None, :]
    s1ok = (c1["score"] >= smin1[:, None])[:, :, None]
    s2ok = (c2["score"] >= smin2[:, None])[:, None, :]
    # Orientation + insert + geometry (bowtie2 --fr/--rf/--ff +
    # --dovetail/--no-contain/--no-overlap): case a = mate 1 upstream,
    # case b = mate 2 upstream — shared with the rescue-pair
    # validation below via _pair_cases.
    e1 = p1 + l1[:, None, None]
    e2 = p2 + l2[:, None, None]
    conc_a, conc_b = _pair_cases(params, p1, e1, st1, p2, e2, st2)
    if span is not None:
        # pair ownership: leftmost (forward) mate's origin inside the
        # shard's ownership interval
        lo, hi = span
        conc_a = conc_a & (p1 >= lo) & (p1 < hi)
        conc_b = conc_b & (p2 >= lo) & (p2 < hi)
    conc = (conc_a | conc_b) & s1ok & s2ok
    pair_sc = jnp.where(
        conc, c1["score"][:, :, None] + c2["score"][:, None, :], NEG_INF
    ).reshape(R, 4 * C * C)
    pbi = jnp.argmax(pair_sc, axis=1)
    pair_best = jnp.take_along_axis(pair_sc, pbi[:, None], axis=1)[:, 0]
    pair_second = jnp.max(
        jnp.where(jnp.arange(pair_sc.shape[1],
                             dtype=jnp.int32)[None, :] == pbi[:, None],
                  NEG_INF, pair_sc), axis=1
    )
    has_conc = pair_best > NEG_INF // 2
    i1 = pbi // (2 * C)
    i2 = pbi % (2 * C)

    se1 = _se_reduce(c1, l1, params, span=span)
    se2 = _se_reduce(c2, l2, params, span=span)
    # rescue anchoring must see candidates the ownership mask hides: a
    # reverse-strand anchor just right of a shard boundary has its
    # left-extending window clamped in its owning shard, while the
    # PREVIOUS shard (whose overlap holds the anchor un-clipped) can
    # rescue the pair — so anchor on the unmasked reduction and put
    # ownership on the rescued pair's leftmost coordinate instead
    if span is not None:
        an1 = _se_reduce(c1, l1, params)
        an2 = _se_reduce(c2, l2, params)
    else:
        an1, an2 = se1, se2

    # --- mate rescue (anchor = the better-aligned single mate) ---
    # Compacted: only pairs with no concordant candidate pair but at
    # least one aligned mate need the window search (a few % of real
    # batches), so both rescue directions run on a capacity bucket of
    # R/4 lanes instead of the full batch (the same fixed-capacity
    # compaction pattern as locate_compact).  Overflow pairs skip
    # rescue and are reported in pair info (rescue_dropped).
    if params.enable_rescue:
        needs = (~has_conc) & (an1["aligned"] | an2["aligned"])
        capR = max(min(R // 4, 4096), 64)
        cpos = jnp.cumsum(needs.astype(jnp.int32)) - 1
        slot_ok = needs & (cpos < capR)
        rescue_dropped = needs.sum() - slot_ok.sum()
        lane_idx = jnp.full((capR,), R, jnp.int32).at[
            jnp.where(slot_ok, cpos, capR)
        ].set(jnp.arange(R, dtype=jnp.int32), mode="drop")
        gi = jnp.minimum(lane_idx, R - 1)  # garbage rows for empty slots
        g = lambda a: a[gi]

        r2c = _rescue(genome, n, g(an1["win_start"]), g(an1["strand"]),
                      g(l1), g(r2), g(l2), g(q2), params, mate_is_2=True)
        r1c = _rescue(genome, n, g(an2["win_start"]), g(an2["strand"]),
                      g(l2), g(r1), g(l1), g(q1), params, mate_is_2=False)

        def scat(vals, fill):
            out = jnp.full((R + 1,), fill, vals.dtype)
            return out.at[lane_idx].set(vals, mode="drop")[:R]

        res2 = {"score": scat(r2c["score"], jnp.int32(NEG_INF)),
                "win_start": scat(r2c["win_start"], jnp.int32(0)),
                "strand": scat(r2c["strand"], jnp.int32(0))}
        res1 = {"score": scat(r1c["score"], jnp.int32(NEG_INF)),
                "win_start": scat(r1c["win_start"], jnp.int32(0)),
                "strand": scat(r1c["strand"], jnp.int32(0))}
        # a rescued pair must satisfy the same concordance predicate
        # (orientation / insert bounds / geometry policy) that admits
        # candidate pairs — otherwise --rf/--ff/--no-overlap etc.
        # would be re-admitted through the rescue window
        va, vb = _pair_cases(
            params, an1["win_start"], an1["win_start"] + l1,
            an1["strand"], res2["win_start"], res2["win_start"] + l2,
            res2["strand"])
        wa, wb = _pair_cases(
            params, res1["win_start"], res1["win_start"] + l1,
            res1["strand"], an2["win_start"], an2["win_start"] + l2,
            an2["strand"])
        resc2_ok = an1["aligned"] & (res2["score"] >= smin2) & (va | vb)
        resc1_ok = an2["aligned"] & (res1["score"] >= smin1) & (wa | wb)
        # prefer the rescue with the higher pair score
        rsc_a = jnp.where(resc2_ok, an1["best"] + res2["score"], NEG_INF)
        rsc_b = jnp.where(resc1_ok, an2["best"] + res1["score"], NEG_INF)
        if span is not None:
            lo, hi = span
            left_a = jnp.where(an1["strand"] == 0, an1["win_start"],
                               res2["win_start"])
            left_b = jnp.where(an2["strand"] == 0, an2["win_start"],
                               res1["win_start"])
            rsc_a = jnp.where((left_a >= lo) & (left_a < hi), rsc_a,
                              NEG_INF)
            rsc_b = jnp.where((left_b >= lo) & (left_b < hi), rsc_b,
                              NEG_INF)
        use_a = rsc_a >= rsc_b
        has_rescue = (rsc_a > NEG_INF // 2) | (rsc_b > NEG_INF // 2)
        rescue_pair = jnp.where(use_a, rsc_a, rsc_b)
    else:
        has_rescue = jnp.zeros(R, bool)
        use_a = jnp.ones(R, bool)
        rescue_pair = jnp.full(R, NEG_INF, jnp.int32)
        rescue_dropped = jnp.int32(0)
        res1 = res2 = None

    proper = has_conc | ((~has_conc) & has_rescue)
    discordant = (~proper) & se1["aligned"] & se2["aligned"]

    take1 = lambda a: jnp.take_along_axis(a, i1[:, None], axis=1)[:, 0]
    take2 = lambda a: jnp.take_along_axis(a, i2[:, None], axis=1)[:, 0]

    def pick(which):
        """Final per-mate fields by the decision ladder."""
        se, an, cand, i, take, smin, lens, res = (
            (se1, an1, c1, i1, take1, smin1, l1, res1)
            if which == 1
            else (se2, an2, c2, i2, take2, smin2, l2, res2)
        )
        # layer 1: concordant candidate
        strand = jnp.where(has_conc, (i // C).astype(jnp.int32), se["strand"])
        ws = jnp.where(has_conc, take(cand["win_start"]), se["win_start"])
        score = jnp.where(has_conc, take(cand["score"]), se["best"])
        aligned = jnp.where(has_conc, True, se["aligned"])
        resc_here = jnp.zeros_like(has_conc)
        # layer 2: rescue overrides when no concordant pair
        if params.enable_rescue:
            # mate1 is rescued when use_a is False (anchor = mate2)
            resc_here = (~has_conc) & has_rescue & (
                (~use_a) if which == 1 else use_a
            )
            strand = jnp.where(resc_here, res["strand"], strand)
            ws = jnp.where(resc_here, res["win_start"], ws)
            score = jnp.where(resc_here, res["score"], score)
            aligned = aligned | resc_here
            # this mate anchored the rescue: report the (unmasked)
            # anchor alignment, not the ownership-masked SE best
            anchor_here = (~has_conc) & has_rescue & (
                use_a if which == 1 else (~use_a)
            )
            strand = jnp.where(anchor_here, an["strand"], strand)
            ws = jnp.where(anchor_here, an["win_start"], ws)
            score = jnp.where(anchor_here, an["best"], score)
            aligned = aligned | anchor_here
        # XS = best alignment other than the reported one: exclude the
        # reported candidate's index (conc winner or SE best); a
        # rescued mate's alignment is not in the candidate list, so
        # nothing is excluded for it
        idx = jnp.where(has_conc, i, se["bi"])
        sc_excl = jnp.where(
            jnp.arange(se["sc"].shape[1],
                       dtype=jnp.int32)[None, :] == idx[:, None],
            NEG_INF, se["sc"])
        second = jnp.where(resc_here, jnp.max(se["sc"], axis=1),
                           jnp.max(sc_excl, axis=1))
        return aligned, strand, ws, score, second, resc_here

    a1, st1f, ws1, sc1, xs1, resc1 = pick(1)
    a2, st2f, ws2, sc2, xs2, resc2 = pick(2)

    # --- MAPQ: pair-level for proper pairs, SE otherwise ---
    sperf = _score_perfect(l1, params) + _score_perfect(l2, params)
    sminp = smin1 + smin2
    pair_best_eff = jnp.where(has_conc, pair_best, rescue_pair)
    pair_second_eff = jnp.where(has_conc, pair_second, NEG_INF)
    mq_pair = mapq_v2(pair_best_eff, pair_second_eff,
                      pair_second_eff > NEG_INF // 2, sminp, sperf)
    mq1_se = mapq_v2(se1["best"], se1["second"],
                     se1["second"] >= smin1, smin1, _score_perfect(l1, params))
    mq2_se = mapq_v2(se2["best"], se2["second"],
                     se2["second"] >= smin2, smin2, _score_perfect(l2, params))
    mq1 = jnp.where(proper, mq_pair, mq1_se)
    mq2 = jnp.where(proper, mq_pair, mq2_se)

    def mate_out(a, stf, ws, sc, mq, xs, se, lens, resc):
        return {
            "aligned": a & (lens > 0), "strand": stf, "win_start": ws,
            "score": sc, "mapq": jnp.where(a, mq, 0),
            "second": xs,
            "has_second": xs > NEG_INF // 2,
            # SE detail for cross-shard merging (sharded PE)
            "se_best": se["best"], "se_second": se["second"],
            "se_strand": se["strand"], "se_ws": se["win_start"],
            "se_aligned": se["aligned"],
            # whether this mate was placed by window rescue (its
            # reported alignment is then NOT a candidate-list entry, so
            # the cross-shard XS merge must not exclude it)
            "resc": resc,
        }

    return (
        mate_out(a1, st1f, ws1, sc1, mq1, xs1, se1, l1, resc1),
        mate_out(a2, st2f, ws2, sc2, mq2, xs2, se2, l2, resc2),
        {"proper": proper, "discordant": discordant & ~proper,
         # pair detail for cross-shard merging: the ladder key is
         # (has_conc, pair score); pair_second only among concordant
         "has_conc": has_conc,
         "pair_score": pair_best_eff,
         "pair_second": pair_second_eff,
         "locate_dropped": (c1.get("locate_dropped", jnp.int32(0))
                            + c2.get("locate_dropped", jnp.int32(0))),
         "rescue_dropped": rescue_dropped},
    )


def apply_pair_policy(res1, res2, info, l1, l2, params: MapperParams):
    """Bowtie2 pair-reporting policy as a pure host-side pass over
    finished MapResults (SURVEY.md §7.3(5): isolate PE policy from
    device compute; ref: params.cpp --no-mixed/--no-discordant +
    the discordant test in best_approx_inl.h):

    - `discordant` is refined to Bowtie2's definition: BOTH mates
      aligned UNIQUELY (no second alignment at/above score-min) but
      violating the pair constraints.  Non-unique non-proper pairs
      are `mixed` (mate-by-mate SE reports).
    - --no-discordant demotes discordant pairs to mixed.
    - --no-mixed suppresses SE fallback: any non-proper,
      non-reported-discordant pair has both mates reported unmapped.

    Mutates res1/res2/info in place; returns them.  Shared by the
    single-index, sharded and mesh PE collect paths so every layout
    applies identical policy."""
    for i, pi in enumerate(info):
        if pi["proper"]:
            pi["discordant"] = False
            continue
        r1, r2 = res1[i], res2[i]

        def unique(r, ln):
            if not r.aligned:
                return False
            return r.second is None or r.second < score_min_host(
                int(ln), params)

        disc = (pi["discordant"] and unique(r1, l1[i])
                and unique(r2, l2[i]))
        pi["discordant"] = disc and not params.no_discordant
        if not pi["discordant"] and params.no_mixed:
            res1[i] = MapResult(aligned=False)
            res2[i] = MapResult(aligned=False)
    return res1, res2, info


class PairedMapper(Mapper):
    """Paired-end orchestration: pe forward step + per-mate traceback +
    SAM with pair flags (ref: nvBowtie ComputeThreadPE + output)."""

    def map_pairs(self, seqs1, lens1, quals1, seqs2, lens2, quals2):
        """Returns (results1, results2, pair_info list of dicts)."""
        R = seqs1.shape[0]
        B = self.params.batch_size
        both_lens = np.concatenate([lens1, lens2])
        seqs1, quals1 = self._len_bucket(seqs1, both_lens, quals1)
        seqs2, quals2 = self._len_bucket(seqs2, both_lens, quals2)
        out1, out2, info = [], [], []
        for s0 in range(0, R, B):
            r1, r2, pi = self._map_pair_chunk(
                seqs1[s0:s0 + B], lens1[s0:s0 + B], quals1[s0:s0 + B],
                seqs2[s0:s0 + B], lens2[s0:s0 + B], quals2[s0:s0 + B],
            )
            out1.extend(r1)
            out2.extend(r2)
            info.extend(pi)
        return out1, out2, info

    def _stage_pair_batch(self, s1, l1, q1, s2, l2, q2):
        """Pad both mates to batch_size and stage device args (shared
        by the single-index and sharded PE dispatchers)."""
        B = self.params.batch_size

        def padto(a, fill):
            if a.shape[0] >= B:
                return a
            pad = np.full((B - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad])

        s1p, s2p = padto(s1, PAD), padto(s2, PAD)
        l1p, l2p = padto(l1, 0), padto(l2, 0)
        q1p, q2p = padto(q1, 0), padto(q2, 0)
        args = tuple(
            jnp.asarray(a.astype(np.int32) if a.dtype != np.int8 else a)
            for a in (s1p, l1p, q1p, s2p, l2p, q2p)
        )
        return (s1p, l1p, q1p), (s2p, l2p, q2p), args

    def _dispatch_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        """Launch forward + per-mate traceback device work (async)."""
        R = s1.shape[0]
        # per-chunk -i evaluation (Mapper._chunk_params): one interval
        # serves the pair, from the longer mate's max length
        params = self._chunk_params(
            max(l1.max() if len(l1) else 0,
                l2.max() if len(l2) else 0, 1),
            min(l1.min() if len(l1) else 1,
                l2.min() if len(l2) else 1))
        (s1p, l1p, q1p), (s2p, l2p, q2p), args = self._stage_pair_batch(
            s1, l1, q1, s2, l2, q2)
        m1, m2, pair = pe_map_batch(
            self.fm, self.ssa, self.genome, *args,
            params=params, lut=self.lut, fm2=self.fm2, bi=self.bi,
        )
        nj = jnp.asarray(self.n, jnp.int32)
        walks = []
        for mate, (sp, lp, qp) in ((m1, (s1p, l1p, q1p)),
                                   (m2, (s2p, l2p, q2p))):
            res, walk = traceback_walk_batch(
                self.genome, nj, jnp.asarray(sp),
                jnp.asarray(lp.astype(np.int32)),
                jnp.asarray(qp.astype(np.uint8)),
                mate["win_start"], mate["strand"], params=params,
                active=mate["aligned"],
            )
            walks.append((mate, res, walk))
        return ((s1p, l1p, q1p), (s2p, l2p, q2p), walks, pair, R)

    def _collect_pair_chunk(self, handle):
        (p1, p2, walks, pair, R) = handle
        if "locate_dropped" in pair:
            self.locate_dropped += int(pair["locate_dropped"])
        res1, res2 = [], []
        for (mate, res, walk), (sp, lp, qp), out in (
                (walks[0], p1, res1), (walks[1], p2, res2)):
            # per-mate XS = the mate's own second-best candidate score
            # (ref: nvBowtie reduce_inl.h best2 per mate; SE semantics)
            out.extend(self._finish(sp, lp, qp, dict(mate), res, walk))
        proper = np.asarray(pair["proper"])
        discordant = np.asarray(pair["discordant"])
        info = [
            {"proper": bool(proper[i]), "discordant": bool(discordant[i])}
            for i in range(R)
        ]
        return apply_pair_policy(res1[:R], res2[:R], info,
                                 p1[1], p2[1], self.params)

    def _map_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        return self._collect_pair_chunk(
            self._dispatch_pair_chunk(s1, l1, q1, s2, l2, q2))

    def map_pairs_stream(self, packed_iter, depth: int = 2):
        """Double-buffered PE mapping over an iterator of
        (names, s1, l1, q1, s2, l2, q2) batches (batch_size-sized);
        yields (names, s1, l1, q1, s2, l2, q2, res1, res2, info)."""
        from collections import deque

        pending: deque = deque()

        def drain():
            nm, arrs, h = pending.popleft()
            r1, r2, info = self._collect_pair_chunk(h)
            return (nm, *arrs, r1, r2, info)

        for names, s1, l1, q1, s2, l2, q2 in packed_iter:
            bl = np.concatenate([l1, l2])
            s1, q1 = self._len_bucket(s1, bl, q1)
            s2, q2 = self._len_bucket(s2, bl, q2)
            h = self._dispatch_pair_chunk(s1, l1, q1, s2, l2, q2)
            pending.append((names, (s1, l1, q1, s2, l2, q2), h))
            while len(pending) >= depth:
                yield drain()
        while pending:
            yield drain()

    def to_sam_records_pe(self, names, s1, l1, q1, s2, l2, q2,
                          res1, res2, info):
        """SAM records for both mates with pair flags/PNEXT/TLEN."""
        recs = []
        for i in range(len(names)):
            r1, r2, pi = res1[i], res2[i], info[i]
            recs.append(self._pe_record(names[i], s1[i], l1[i], q1[i],
                                        r1, r2, pi, first=True))
            recs.append(self._pe_record(names[i], s2[i], l2[i], q2[i],
                                        r2, r1, pi, first=False))
        return recs

    def _pe_record(self, name, seq, ln, qual, mine, other, pi, first):
        pat = seq[:ln].astype(np.uint8)
        q = qual[:ln].astype(np.uint8)
        if mine.aligned and mine.strand == 1:
            pat = np.where(pat < 4, 3 - pat, pat)[::-1].astype(np.uint8)
            q = q[::-1]
        seq_str = dna_to_char(pat).tobytes().decode()
        qual_str = (q + 33).tobytes().decode()
        flag = S.FLAG_PAIRED | (S.FLAG_READ1 if first else S.FLAG_READ2)
        if not mine.aligned:
            flag |= S.FLAG_UNMAPPED
        elif mine.strand:
            flag |= S.FLAG_REVERSE
        if not other.aligned:
            flag |= S.FLAG_MATE_UNMAPPED
        elif other.strand:
            flag |= S.FLAG_MATE_REVERSE
        if pi["proper"] and mine.aligned and other.aligned:
            flag |= S.FLAG_PROPER_PAIR
        loc = self.locate_contig(mine) if mine.aligned else None
        if not mine.aligned or loc is None:
            return S.SamRecord(name, flag, "*", 0, 0, "*", seq_str, qual_str)
        rname, lpos = loc
        tlen = 0
        rnext, pnext = "*", 0
        oloc = self.locate_contig(other) if other.aligned else None
        if oloc is not None:
            ornm, opos = oloc
            rnext = "=" if ornm == rname else ornm
            pnext = opos + 1
            if rnext == "=":
                left = min(lpos, opos)
                right = max(lpos + ln, opos + ln)  # approx frag end
                tlen = right - left
                if lpos > opos or (lpos == opos and not first):
                    tlen = -tlen
        tags = [("AS", "i", mine.score), ("NM", "i", mine.nm),
                ("MD", "Z", mine.md)]
        if mine.second is not None:
            tags.insert(1, ("XS", "i", mine.second))
        return S.SamRecord(name, flag, rname, lpos + 1,
                           mine.mapq, mine.cigar, seq_str, qual_str,
                           rnext=rnext, pnext=pnext, tlen=tlen, tags=tags)
