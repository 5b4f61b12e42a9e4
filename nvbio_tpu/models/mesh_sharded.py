"""Shard-per-device mapping: one FM-index shard per device over a mesh.

The scale-out layout from SURVEY.md §5.8 ("index sharded over the
interconnect with shard_map"): each shard of a beyond-memory/beyond-int32
reference lives in its own device's memory, the read batch is replicated,
and per-shard candidate stages run CONCURRENTLY — where the sequential
single-device ShardedMapper pays S x the candidate work per batch, the
mesh pays it once per chip in parallel (converting the hg38 3-shard
3x sequential tax into 3-chip parallelism).

Collective plan (one round each over the device interconnect; the mesh
is a flat 1-D ``shard`` axis):
  1. per-device candidate stage on the local shard (ownership-masked)
  2. `all_gather` of the (R, 2C) candidate arrays over the ``shard``
     axis -> every device reduces the same (R, S*2C) top-2, via the
     SAME `_top2_concat` as the sequential path (bit-identical ties)
  3. winner-shard window texts by masked `psum` (each device
     contributes its gathered windows only for reads it won)
  4. traceback walk sharded over reads (each device walks R/S reads)
     and `all_gather`-ed back

Positions stay shard-local int32 on device and globalize on the host
in int64, exactly like the sequential path (ShardedMapper._collect_
chunk is reused unchanged).

No reference equivalent: nvbio is single-GPU (SURVEY.md §3.12); this
is the green-field distributed design the survey calls for.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..alignment.types import NEG_INF
from ..fmindex.index import FMIndex, SSA
from ..fmindex.fm2 import FM2
from ..alignment.batched import window_slices
from .mapper import (candidate_stage, traceback_walk_windows, PAD,
                     _score_min)
from .params import MapperParams
from .sharded_mapper import (ShardedMapper, PairedShardedMapper,
                             _top2_concat, _pe_merge_stacked)


def device_bytes_limit(device) -> int:
    """Bytes the backend lets this process allocate on ``device``
    (``memory_stats()["bytes_limit"]``).  CPU devices report none and
    share the host's memory, so they get the host's physical memory;
    any other device that reports no limit is an error, not a guess."""
    stats = device.memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        import os
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise ValueError(
        f"{device.platform} device {device} reports no memory limit "
        "(memory_stats()['bytes_limit']); cannot size the shard layout")


def stack_sharded_index(sidx, genome_np: np.ndarray,
                        params: MapperParams):
    """Stack per-shard device structures along a leading shard axis.

    Shards are padded to common shapes (zeros for index tables — query
    rows never reach the pad because row indices are bounded by each
    shard's own n; PAD symbols for genome slices).  Returns
    (stacked dict of (S, ...) arrays, ssa_k, has_lut).
    """
    lt_pad = params.max_read_len + 2 * params.band_w + 8
    n = len(genome_np)
    gp = np.full(n + lt_pad, PAD, dtype=np.int8)
    gp[:n] = genome_np

    fms = [s[0] for s in sidx.shards]
    ssas = [s[1] for s in sidx.shards]
    luts = [s[2] for s in sidx.shards]
    starts = [s[3] for s in sidx.shards]
    lengths = [s[4] for s in sidx.shards]
    S = len(fms)

    def pad_stack(arrs, fill=0):
        # HOST arrays: the caller places each shard's slice directly
        # on its own device (one upload, no staging copy on device 0)
        arrs = [np.asarray(a) for a in arrs]
        m = max(a.shape[0] for a in arrs)
        out = np.full((S, m) + arrs[0].shape[1:], fill, arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
        return out

    stacked = {
        "bwt_words": pad_stack([f.bwt_words for f in fms]),
        "occ_abs": pad_stack([f.occ_abs for f in fms]),
        "occ_sub": pad_stack([f.occ_sub for f in fms]),
        "C": np.stack([np.asarray(f.C) for f in fms]),
        "primary": np.asarray([int(f.primary) for f in fms], np.int32),
        "n": np.asarray([int(f.n) for f in fms], np.int32),
        "mark_words": pad_stack([s.mark_words for s in ssas]),
        "mark_abs": pad_stack([s.mark_abs for s in ssas]),
        "vals": pad_stack([s.vals for s in ssas]),
        "g": pad_stack(
            [gp[st : st + ln + lt_pad] for st, ln in zip(starts, lengths)],
            fill=PAD),
        "own_lo": np.asarray(
            [0 if i == 0 else 1 for i in range(S)], np.int32),
        "own_hi": np.asarray(
            [(starts[i + 1] if i + 1 < S else n) - starts[i] + 1
             for i in range(S)], np.int32),
    }
    has_lut = all(l is not None for l in luts)
    if has_lut:
        stacked["lut_lo"] = np.stack([np.asarray(l[0]) for l in luts])
        stacked["lut_hi"] = np.stack([np.asarray(l[1]) for l in luts])
    ssa_k = int(getattr(ssas[0], "k", 0) or 0)
    return stacked, ssa_k, has_lut


@functools.partial(
    jax.jit,
    static_argnames=("params", "mesh", "ssa_k", "has_lut", "has_fm2"),
)
def mesh_map_batch(stacked, reads, lens, quals, *, params: MapperParams,
                   mesh: Mesh, ssa_k: int,
                   has_lut: bool, has_fm2: bool = False):
    """SE forward + traceback walk with one index shard per device.

    Output contract == ShardedMapper._dispatch_chunk's (fwd with
    shard-local win_start + "shard", walk dict), so the sequential
    host collection path is reused unchanged.
    """
    S = mesh.devices.size
    R, L = reads.shape
    assert R % S == 0, f"batch size {R} must divide by mesh size {S}"
    Rb = R // S
    LT = L + 2 * params.band_w

    def body(stk, reads, lens, quals):
        s = jax.lax.axis_index("shard")
        # per-device 2-step index over the LOCAL shard (mono-marked
        # SSA -> locate2_mono walk), derived in place at init
        fm, ssa, g, lut, fm2 = _local_index(
            stk, ssa_k, has_lut, has_fm2)
        c = candidate_stage(fm, ssa, g, reads, lens, quals,
                            params=params, lut=lut, fm2=fm2)
        ws = c["win_start"]
        sc = jnp.where((ws >= stk["own_lo"][0]) & (ws < stk["own_hi"][0]),
                       c["score"], NEG_INF)

        # shard-major concat == the sequential path's concatenate order
        gath = lambda a: jax.lax.all_gather(a, "shard")
        cat = lambda a: gath(a).transpose(1, 0, 2).reshape(R, -1)
        fwd = _top2_concat(cat(sc), cat(ws), cat(c["t_end"]),
                           cat(c["p_end"]), lens, params)
        fwd["locate_dropped"] = jax.lax.psum(
            c.get("locate_dropped", jnp.int32(0)), "shard")
        fwd["overflow"] = jax.lax.psum(
            c["overflow"].astype(jnp.int32), "shard") > 0

        texts, tlens = _winner_windows(
            g, fm.n, fwd["win_start"], fwd["shard"], s, LT)

        # traceback walk sharded over reads (R/S per device)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s * Rb, Rb, axis=0)
        _res, walk = traceback_walk_windows(
            sl(texts), sl(tlens), sl(reads), sl(lens), sl(quals),
            sl(fwd["strand"]), params=params)
        unslice = lambda a: gath(a).reshape((R,) + a.shape[1:])
        walk = {k: unslice(v) for k, v in walk.items()}
        return fwd, walk

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("shard"), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(stacked, reads, lens, quals)


def _local_index(stk, ssa_k: int, has_lut: bool, has_fm2: bool):
    """Per-device index views over this device's stacked slice
    (leading shard axis stripped; shared by the SE/PE/--all bodies)."""
    fm = FMIndex(stk["bwt_words"][0], stk["occ_abs"][0],
                 stk["occ_sub"][0], stk["C"][0], stk["primary"][0],
                 stk["n"][0],
                 fused=stk["fused"][0] if "fused" in stk else None)
    ssa = SSA(stk["mark_words"][0], stk["mark_abs"][0],
              stk["vals"][0], k=ssa_k)
    g = stk["g"][0]
    lut = (stk["lut_lo"][0], stk["lut_hi"][0]) if has_lut else None
    fm2 = (FM2(stk["p2_words"][0], stk["p2_abs"][0],
               stk["p2_sub"][0], stk["C2"][0], stk["row_a"][0],
               stk["row_b"][0]) if has_fm2 else None)
    return fm, ssa, g, lut, fm2


def _winner_windows(g, n, win_start, shard, mine_axis, LT):
    """Winner-shard window texts by masked psum: each device gathers
    from its own slice; only the winning shard's contribution survives
    the sum (the SE/PE/--all traceback front half)."""
    wsc = jnp.clip(win_start, 0, n - 1)
    t_s = window_slices(g, wsc, LT)  # one slice per lane
    tl_s = jnp.clip(n - wsc, 0, LT)
    mine = shard == mine_axis
    texts = jax.lax.psum(
        jnp.where(mine[:, None], t_s.astype(jnp.int32), 0), "shard"
    ).astype(jnp.int8)
    tlens = jax.lax.psum(jnp.where(mine, tl_s, 0), "shard")
    return texts, tlens


#: per-shard mate fields the cross-shard PE merge consumes
#: (sharded_mapper._pe_merge_stacked)
_PE_MATE_KEYS = ("se_best", "se_second", "se_strand", "se_ws",
                 "second", "strand", "win_start", "score", "resc")


@functools.partial(
    jax.jit,
    static_argnames=("params", "mesh", "ssa_k", "has_lut", "has_fm2"),
)
def mesh_pe_map_batch(stacked, rel, r1, l1, q1, r2, l2, q2, *,
                      params: MapperParams, mesh: Mesh, ssa_k: int,
                      has_lut: bool, has_fm2: bool = False):
    """Paired-end forward + per-mate traceback walk, one index shard
    per device (the PE leg of the shard-per-chip layout, SURVEY.md
    §3.8/§5.8).

    Collective plan: per-device ``pe_map_batch`` on the local shard
    (ownership-masked via ``span``), ``all_gather`` of the per-shard
    mate/pair evidence, then the SAME ``_pe_merge_stacked`` reduction
    as the sequential PairedShardedMapper (bit-identical ties), winner
    -shard windows by masked ``psum``, and per-mate traceback walks
    sharded over reads.  Output contract ==
    PairedShardedMapper._pe_merge_walk's (merged mate dicts with
    shard-local win_start + "shard", per-mate walk dicts, pair info).
    """
    from .paired import pe_map_batch

    S = mesh.devices.size
    R, L = r1.shape
    assert R % S == 0, f"batch size {R} must divide by mesh size {S}"
    Rb = R // S
    LT = L + 2 * params.band_w

    def body(stk, rel, r1, l1, q1, r2, l2, q2):
        s = jax.lax.axis_index("shard")
        fm, ssa, g, lut, fm2 = _local_index(
            stk, ssa_k, has_lut, has_fm2)
        m1, m2, pair = pe_map_batch(
            fm, ssa, g, r1, l1, q1, r2, l2, q2,
            params=params, lut=lut, fm2=fm2,
            span=(stk["own_lo"][0], stk["own_hi"][0]))

        gath = lambda a: jax.lax.all_gather(a, "shard")
        st1 = {k: gath(m1[k]) for k in _PE_MATE_KEYS}
        st2 = {k: gath(m2[k]) for k in _PE_MATE_KEYS}
        stp = {k: gath(pair[k]) for k in ("has_conc", "pair_score",
                                          "pair_second", "proper")}
        g1, g2, pr = _pe_merge_stacked(st1, st2, stp, l1, l2, rel,
                                       params)
        pr["locate_dropped"] = jax.lax.psum(
            pair.get("locate_dropped", jnp.int32(0)), "shard")

        def mate_walk(mate, reads, lens, quals):
            texts, tlens = _winner_windows(
                g, fm.n, mate["win_start"], mate["shard"], s, LT)
            sl = lambda a: jax.lax.dynamic_slice_in_dim(
                a, s * Rb, Rb, axis=0)
            _res, walk = traceback_walk_windows(
                sl(texts), sl(tlens), sl(reads), sl(lens), sl(quals),
                sl(mate["strand"]), params=params)
            unslice = lambda a: gath(a).reshape((R,) + a.shape[1:])
            return {k: unslice(v) for k, v in walk.items()}

        w1 = mate_walk(g1, r1, l1, q1)
        w2 = mate_walk(g2, r2, l2, q2)
        return g1, g2, pr, w1, w2

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("shard"), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )(stacked, rel, r1, l1, q1, r2, l2, q2)


@functools.partial(
    jax.jit,
    static_argnames=("params", "mesh", "ssa_k", "has_lut", "has_fm2", "k"),
)
def mesh_map_all_batch(stacked, reads, lens, quals, *,
                       params: MapperParams,
                       mesh: Mesh, ssa_k: int, has_lut: bool,
                       has_fm2: bool = False,
                       k: int = 8):
    """--all forward + per-slot walk with one index shard per device.

    Per-device top-k candidates on the local shard (ownership-masked,
    same math as sharded_mapper._shard_all), shard-major ``all_gather``
    concat + global top-k (identical ordering to _sharded_all_merge:
    stable argsort ties resolve to the lowest (shard, slot) index),
    winner-shard windows by masked ``psum``, walk sharded over the
    R*k slot lanes.
    """
    S = mesh.devices.size
    R, L = reads.shape
    C = params.max_candidates
    K = min(k, 2 * C)
    RK = R * K
    assert RK % S == 0
    Rb = RK // S
    LT = L + 2 * params.band_w

    def body(stk, reads, lens, quals):
        s = jax.lax.axis_index("shard")
        fm, ssa, g, lut, fm2 = _local_index(
            stk, ssa_k, has_lut, has_fm2)
        c = candidate_stage(fm, ssa, g, reads, lens, quals,
                            params=params, lut=lut, fm2=fm2)
        ws = c["win_start"]
        sc = jnp.where((ws >= stk["own_lo"][0]) & (ws < stk["own_hi"][0]),
                       c["score"], NEG_INF)
        order = jnp.argsort(-sc, axis=1)[:, :K]
        take = lambda a: jnp.take_along_axis(a, order, axis=1)
        p_sc = take(sc)
        p_st = (order // C).astype(jnp.int32)
        p_ws = take(c["win_start"])

        # shard-major concat == _sharded_all_merge's concatenate order
        gath = lambda a: jax.lax.all_gather(a, "shard")
        cat = lambda a: gath(a).transpose(1, 0, 2).reshape(R, S * K)
        sc_all, ws_all, st_all = cat(p_sc), cat(p_ws), cat(p_st)
        shard_id = jnp.repeat(jnp.arange(S, dtype=jnp.int32), K)[None, :]
        order2 = jnp.argsort(-sc_all, axis=1)[:, :K]
        take2 = lambda a: jnp.take_along_axis(a, order2, axis=1)
        scores = take2(sc_all)
        smin = _score_min(lens, params)
        fwd = {
            "score": scores,
            "valid": (scores >= smin[:, None]) & (lens[:, None] > 0),
            "strand": take2(st_all),
            "win_start": take2(ws_all),  # shard-local
            "shard": take2(jnp.broadcast_to(shard_id, sc_all.shape)),
        }

        # traceback every slot: (R, K) -> (R*K) lanes, sharded walk
        texts, tlens = _winner_windows(
            g, fm.n, fwd["win_start"].reshape(RK),
            fwd["shard"].reshape(RK), s, LT)
        repK = lambda a: jnp.repeat(a, K, axis=0)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s * Rb, Rb, axis=0)
        _res, walk = traceback_walk_windows(
            sl(texts), sl(tlens), sl(repK(reads)),
            sl(jnp.repeat(lens, K)), sl(repK(quals)),
            sl(fwd["strand"].reshape(RK)), params=params)
        unslice = lambda a: gath(a).reshape((RK,) + a.shape[1:])
        walk = {kk: unslice(v) for kk, v in walk.items()}
        return fwd, walk

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("shard"), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(stacked, reads, lens, quals)


class MeshShardedMapper(ShardedMapper):
    """ShardedMapper whose forward runs shard-per-device over a mesh.

    Bit-identical to the sequential ShardedMapper (same reduce, same
    walk); only the schedule changes.  SE and --all here; PE via
    MeshPairedShardedMapper.
    """

    def __init__(self, sidx, genome_symbols, params=MapperParams(),
                 ref_name="ref", contigs=None,
                 mesh: Mesh | None = None):
        super().__init__(sidx, genome_symbols, params=params,
                         ref_name=ref_name, contigs=contigs,
                         device_state=False)
        S = len(sidx.shards)
        if mesh is None:
            devs = jax.devices()
            if len(devs) < S:
                raise ValueError(
                    f"need >= {S} devices for {S} shards, have "
                    f"{len(devs)} (use the sequential ShardedMapper)")
            mesh = Mesh(np.array(devs[:S]), ("shard",))
        if mesh.devices.size != S:
            raise ValueError(
                f"mesh size {mesh.devices.size} != shard count {S}")
        if self.params.batch_size % S:
            raise ValueError(
                f"batch_size {self.params.batch_size} must divide by "
                f"the {S}-device mesh (traceback is read-sharded)")
        self.mesh = mesh
        stacked, self._ssa_k, self._has_lut = \
            stack_sharded_index(sidx, np.asarray(genome_symbols),
                                self.params)
        sh = NamedSharding(mesh, P("shard"))
        devs = list(mesh.devices.flat)
        # place each shard's slice DIRECTLY on its device (one upload),
        # then assemble the (S, ...) sharded arrays from the pieces
        per_shard = [dict() for _ in devs]
        self._stacked = {}
        for k, v in stacked.items():
            pieces = [jax.device_put(v[s : s + 1], devs[s])
                      for s in range(len(devs))]
            self._stacked[k] = jax.make_array_from_single_device_arrays(
                v.shape, sh, pieces)
            for s, pc in enumerate(pieces):
                per_shard[s][k] = pc
        # per-device pair-BWT: each chip derives fm2 from ITS resident
        # shard piece in place (build_fm2_device; nothing is uploaded)
        # — at hg scale one chip holds one shard + its ~3 B/row
        # pair-BWT, which the sequential single-chip path can only
        # stream
        self._has_fm2 = bool(self.params.use_fm2)
        self.device_bytes = min(device_bytes_limit(d) for d in devs)
        self._check_hbm_budget()  # BEFORE the fm2 derivation allocates
        if self._has_fm2:
            self._stacked.update(self._stack_fm2(per_shard, sh))
        # fused block rows per device (fmindex.index.fuse_occ: one
        # gather per rank/LF; derived in place like fm2, +0.6 B/bp)
        from ..fmindex.index import fuse_occ
        fpieces = []
        for ps in per_shard:
            fm = FMIndex(ps["bwt_words"][0], ps["occ_abs"][0],
                         ps["occ_sub"][0], ps["C"][0],
                         ps["primary"][0], ps["n"][0])
            fpieces.append(jax.jit(lambda f: fuse_occ(f).fused)(fm)[None])
        self._stacked["fused"] = jax.make_array_from_single_device_arrays(
            (len(fpieces),) + fpieces[0].shape[1:], sh, fpieces)

    #: fraction reserved for XLA scratch/fragmentation
    HBM_RESERVE = 0.15

    def hbm_budget(self, batch_size: int | None = None) -> dict:
        """Per-device HBM budget model for the shard-per-chip layout.

        Resident = this device's slice of every stacked index array
        (BWT words, blocked occ, SSA marks/vals, genome slice, LUT) +
        the derived pair-BWT (~3 B per BWT row: packed pair words
        0.5 B + int8 sub-block occ 1 B + absolute counts 1.5 B at the
        fm2 block geometry).  Transient = the dominant
        per-batch arrays: seed/locate matrices at (2R, max_locate*CAP),
        extension windows at (2R*C, L + LT), the traceback direction
        matrix at (R, Lp*(band+1)), and the all_gather-ed candidate
        stacks at (S, R, 2C).  Returns a dict of named byte counts;
        ``total`` must fit under device_bytes * (1 - HBM_RESERVE) —
        checked at init (SURVEY.md §5.8; VERDICT r2 weak #7).
        """
        p = self.params
        R = batch_size or p.batch_size
        S = len(self.shard_state)
        L = p.max_read_len
        W = p.band_w
        C = p.max_candidates
        LT = L + 2 * W
        resident = {
            k: int(v.nbytes) // S for k, v in self._stacked.items()
        }
        n_rows = max(int(st["length"]) for st in self.shard_state) + 1
        fm2_b = 3 * n_rows if self._has_fm2 else 0
        # fused block rows (index.fuse_occ): 80 B per 128-row block,
        # derived after this check when not yet in _stacked
        fused_b = (0 if "fused" in self._stacked
                   else ((n_rows + 127) // 128 + 1) * 80)
        from ..strings.seeds import num_uniform_seeds
        S_seeds = num_uniform_seeds(L, p.seed_len, p.seed_interval)
        KLOC = min(p.max_locate, S_seeds * p.max_hits_per_seed)
        transient = {
            "seed_select": 2 * R * S_seeds * p.max_hits_per_seed * 4 * 4,
            "locate_walk": 2 * R * KLOC * 4 * 4,
            "extension_windows": 2 * R * C * (L + LT) * 2,
            "dirs_matrix": R // S * ((L + 7) // 8 * 8) * (2 * W + 2),
            "allgather_cands": S * R * 2 * C * 4 * 4,
        }
        total = (sum(resident.values()) + fm2_b + fused_b
                 + sum(transient.values()))
        return {
            "resident_index": sum(resident.values()),
            "fm2_pair_bwt": fm2_b,
            "fused_rows": fused_b,
            "transient_batch": sum(transient.values()),
            "detail": {**resident, **transient},
            "total": total,
            "limit": int(self.device_bytes * (1 - self.HBM_RESERVE)),
        }

    def _check_hbm_budget(self):
        b = self.hbm_budget()
        if b["total"] > b["limit"]:
            rows = "\n".join(
                f"  {k:>22}: {v / 2**30:7.2f} GiB"
                for k, v in (("resident_index", b["resident_index"]),
                             ("fm2_pair_bwt", b["fm2_pair_bwt"]),
                             ("transient_batch", b["transient_batch"])))
            raise ValueError(
                f"per-device HBM budget exceeded: "
                f"{b['total'] / 2**30:.2f} GiB needed, "
                f"{b['limit'] / 2**30:.2f} GiB available "
                f"(device {self.device_bytes / 2**30:.0f} GiB - "
                f"{self.HBM_RESERVE:.0%} reserve):\n{rows}\n"
                "remedies: more shards (smaller slices per chip), "
                "use_fm2=False, or a smaller batch_size")

    def _stack_fm2(self, per_shard, sh):
        from ..fmindex import build_fm2_device

        S = len(per_shard)
        keys = ("p2_words", "p2_abs", "p2_sub", "C2", "row_a", "row_b")
        pieces = {k: [] for k in keys}
        for ps in per_shard:
            # FMIndex view of this device's resident piece (leading
            # shard axis stripped; block padding past the true n is
            # inert — rows are bounded by the shard's own n)
            fm = FMIndex(ps["bwt_words"][0], ps["occ_abs"][0],
                         ps["occ_sub"][0], ps["C"][0], ps["primary"][0],
                         ps["n"][0])
            f2 = build_fm2_device(fm)
            pieces["p2_words"].append(f2.pair_words[None])
            pieces["p2_abs"].append(f2.occ_abs[None])
            pieces["p2_sub"].append(f2.occ_sub[None])
            pieces["C2"].append(f2.C2[None])
            pieces["row_a"].append(f2.row_a.reshape(1))
            pieces["row_b"].append(f2.row_b.reshape(1))
        return {
            k: jax.make_array_from_single_device_arrays(
                (S,) + ps[0].shape[1:], sh, ps)
            for k, ps in pieces.items()
        }

    def _dispatch_chunk(self, seqs, lens, quals, params=None):
        R = seqs.shape[0]
        params = params or self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        fwd, walk = mesh_map_batch(
            self._stacked, jnp.asarray(seqs),
            jnp.asarray(lens.astype(np.int32)),
            jnp.asarray(quals.astype(np.uint8)),
            params=params, mesh=self.mesh, ssa_k=self._ssa_k,
            has_lut=self._has_lut, has_fm2=self._has_fm2)
        return (seqs, lens, quals, fwd, walk, R)

    def _map_chunk_all(self, seqs, lens, quals, k):
        """--all over the mesh: one mesh_map_all_batch dispatch; host
        collection mirrors ShardedMapper._map_chunk_all (globalized
        positions, shared _finish/_group_all)."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        fwd, walk = mesh_map_all_batch(
            self._stacked, jnp.asarray(seqs),
            jnp.asarray(lens.astype(np.int32)),
            jnp.asarray(quals.astype(np.uint8)),
            params=self.params, mesh=self.mesh, ssa_k=self._ssa_k,
            has_lut=self._has_lut,
            has_fm2=self._has_fm2, k=k)
        K = fwd["score"].shape[1]
        shard = np.asarray(fwd["shard"]).reshape(-1)
        starts = np.asarray([s["start"] for s in self.shard_state],
                            np.int64)
        ws_flat = np.asarray(fwd["win_start"]).reshape(-1)
        flat_fwd = {
            "aligned": np.asarray(fwd["valid"]).reshape(-1),
            "strand": np.asarray(fwd["strand"]).reshape(-1),
            "win_start": starts[shard] + ws_flat.astype(np.int64),
            "score": np.asarray(fwd["score"]).reshape(-1),
            "second": np.zeros(B * K, np.int32),
            "has_second": np.zeros(B * K, bool),
            "mapq": np.zeros(B * K, np.int32),
        }
        results = self._finish(
            np.repeat(seqs, K, axis=0), np.repeat(lens, K),
            np.repeat(quals, K, axis=0), flat_fwd, None, walk)
        return self._group_all(results, min(R, B), K)


class MeshPairedShardedMapper(MeshShardedMapper, PairedShardedMapper):
    """Paired-end mapping with one index shard per device: per-device
    pe_map_batch (pair ownership by leftmost mate), all_gather +
    _pe_merge_stacked cross-shard reduction (the same math as the
    sequential PairedShardedMapper — bit-identical, tested), winner
    -shard windows by masked psum, per-mate read-sharded walks.  The
    SAM/record layer is inherited from PairedShardedMapper."""

    def _dispatch_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        R = s1.shape[0]
        staged = self._stage_pair_batch(s1, l1, q1, s2, l2, q2)
        (s1p, l1p, q1p), (s2p, l2p, q2p), args = staged
        g1, g2, pr, w1, w2 = mesh_pe_map_batch(
            self._stacked, self._rel, *args,
            params=self.params, mesh=self.mesh, ssa_k=self._ssa_k,
            has_lut=self._has_lut,
            has_fm2=self._has_fm2)
        walks = [(g1, w1), (g2, w2)]
        return ((s1p, l1p, q1p), (s2p, l2p, q2p), walks, pr, R)

    def map_pairs_stream(self, packed_iter, depth: int = 2):
        """PE streaming over the mesh: per-device pair-BWTs are
        resident (one shard per chip), so the shard-major fm2
        streaming phase is unnecessary — always batch-major."""
        yield from self._pairs_stream_batch_major(packed_iter, depth)
