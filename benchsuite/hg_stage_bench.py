"""hg-scale per-stage mapping bench (BASELINE configs 3+5).

A repeat-structured genome (hgr protocol: 8 % planted
ALUs, segdups, tandems), sharded index (sa_sample 4, k=11 LUT),
16 384 x 100 bp reads/batch at 1 % error, and two phases:

  A. one chip holds ALL shards (sequential per-shard candidate
     stages + cross-shard top-2 + winner walk) -> reads/s/chip;
  B. ONE shard + resident device pair-BWT (fm2) -> the per-chip
     profile of the shard-per-chip mesh layout (config 5).

--substages additionally decomposes shard 0's candidate stage into
strands / seeds / backward search / select+locate / extension using
the SAME code the mapper runs (models/mapper.py seed_and_search /
select_and_locate / extend_candidates), each timed as its own jit
with materialized inputs — attribution for optimization work (the
sub-stage sum can exceed the fused total: separate jits lose XLA's
cross-stage fusion).

Device times are min-of-iters of calls that end in
``block_until_ready``, after a warm-up call.  All device state is
passed to the timed jits as ARGUMENTS — closing over it captures
multi-GB constants at lowering time.  Every printed rate names the
device it ran on.

Scale down with --bp/--shards for smoke runs; the graded run is
  python benchsuite/hg_stage_bench.py --bp 3200001024 --shards 2
(index build ~38 min single-core; cached under --cache; the 2-shard
layout halves phase A's sequential stage count vs round 4's 3-shard).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nvbio_tpu.utils.device import card_name
from nvbio_tpu.utils.jax_cache import enable_compilation_cache
enable_compilation_cache()

import jax
import jax.numpy as jnp


def make_timer(iters):
    def checksum_time(fn, *args):
        """min-of-iters wall of jit(checksum(fn(*args))).

        args are jit ARGUMENTS (not closed over) so multi-GB device
        state is never lowered as a captured constant."""
        f = jax.jit(lambda *a: jax.tree.reduce(
            lambda x, y: x + y,
            jax.tree.map(lambda t: t.astype(jnp.int32).sum(), fn(*a))))
        jax.block_until_ready(f(*args))  # compile
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts)
    return checksum_time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bp", type=float, default=100e6)
    p.add_argument("--shards", type=int, default=3)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--cache", default=".scratch/hgbench")
    p.add_argument("--skip-a", action="store_true")
    p.add_argument("--skip-b", action="store_true")
    p.add_argument("--substages", action="store_true",
                   help="decompose shard 0's candidate stage")
    p.add_argument("--lut-k", type=int, default=0,
                   help="override the index's k-mer LUT depth (rebuilt "
                   "from the shard text via the native histogram)")
    p.add_argument("--cpu", action="store_true",
                   help="pin to the CPU backend (smoke runs / CI)")
    p.add_argument("--extend-frac", type=float, default=None,
                   help="override params.extend_frac (budget sweep)")
    p.add_argument("--fuse-b", action="store_true",
                   help="fused block rows in phase B too (fits at "
                   "<= ~1.1 Gbp shards beside the pair-BWT; a "
                   "1.6 Gbp shard OOMs)")
    p.add_argument("--locate-frac", type=float, default=None,
                   help="override params.locate_frac (budget sweep)")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from nvbio_tpu.fmindex.sharded import (build_sharded_index,
                                           save_sharded_index,
                                           load_sharded_index)
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.sharded_mapper import (
        ShardedMapper, _shard_cands, _sharded_top2, _sharded_walk)
    from nvbio_tpu.utils.simulate import (repeat_structured_genome,
                                          simulate_reads)

    n = int(args.bp)
    scale = n / 3.2e9
    t0 = time.time()
    genome, _ = repeat_structured_genome(
        n, seed=args.seed, alu_frac=0.08,
        n_segdups=max(2, int(300 * scale)),
        segdup_len=min(100_000, n // 20),
        n_tandems=max(10, int(20_000 * scale)))
    print(f"[hg] genome {n/1e6:.0f} Mbp in {time.time()-t0:.0f}s",
          file=sys.stderr)

    os.makedirs(args.cache, exist_ok=True)
    prefix = os.path.join(args.cache,
                          f"hgr_{n//1_000_000}m_{args.shards}s")
    if not os.path.exists(prefix + ".manifest.json"):
        t0 = time.time()
        sidx = build_sharded_index(
            genome, shard_bp=(n + args.shards - 1) // args.shards,
            sa_sample=4, lut_k=11)
        save_sharded_index(prefix, sidx, genome, ["hgr"], [n])
        print(f"[hg] index built in {time.time()-t0:.0f}s",
              file=sys.stderr)
    if args.skip_a and not args.skip_b:
        # phase B only: load JUST shard 0 — load_sharded_index device-
        # puts every shard eagerly, and idle shard state beside the
        # ~3 B/bp pair-BWT OOMs the chip at 1.6 Gbp shards
        from nvbio_tpu.fmindex.sharded import ShardedIndex, _strip_bi_ssa
        from nvbio_tpu.io.index_file import load_index
        with open(prefix + ".manifest.json") as f:
            man = json.load(f)
        s0 = man["shards"][0]
        d = os.path.dirname(os.path.abspath(prefix + ".manifest.json"))
        fm0, ssa0, _g0, meta0 = load_index(os.path.join(d, s0["file"]))
        sidx = ShardedIndex(
            [(fm0, _strip_bi_ssa(ssa0), meta0.get("lut"),
              s0["start"], s0["length"])],
            man["n_total"], man["sa_sample"], man["lut_k"])
    else:
        loaded = load_sharded_index(prefix)
        sidx = loaded[0] if isinstance(loaded, tuple) else loaded

    sim = simulate_reads(genome, args.batch, read_len=args.read_len,
                         error_rate=0.01, seed=args.seed + 1)
    lens = np.full(args.batch, args.read_len, np.int32)

    dev = jax.devices()[0]
    device = card_name(dev)
    print(f"[hg] device {device}", file=sys.stderr)
    checksum_time = make_timer(args.iters)

    class _Rows(list):
        # every row also streams to stderr as it lands, so a killed
        # run (timeout) still leaves its measurements
        def append(self, row):
            print("ROW " + json.dumps(row), file=sys.stderr, flush=True)
            super().append(row)

    rows = _Rows()

    def maybe_deepen_lut(mapper, params):
        """--lut-k: rebuild each shard's LUT at a deeper k from the
        shard text (the SA-range boundaries of all k-mers are the
        cumsum of the sorted k-mer multiset — no suffix array needed;
        fmindex/build.py build_kmer_lut + native kmer_hist)."""
        if not args.lut_k:
            return params
        from nvbio_tpu.fmindex.build import build_kmer_lut
        for s, st in enumerate(mapper.shard_state):
            t0 = time.time()
            g_np = np.asarray(genome[st["start"]:
                                     st["start"] + st["length"]],
                              np.uint8)
            lo_l, hi_l = build_kmer_lut(g_np, k=args.lut_k)
            st["lut"] = (jnp.asarray(lo_l), jnp.asarray(hi_l))
            print(f"[hg] shard {s} k={args.lut_k} LUT rebuilt in "
                  f"{time.time()-t0:.0f}s", file=sys.stderr)
        from dataclasses import replace
        return replace(params, lut_k=args.lut_k)

    def run_substages(name, mapper, params, jr, jl, jq):
        """Decompose shard 0's candidate stage (VERDICT r4 item 1)."""
        from nvbio_tpu.models.mapper import (
            both_strands, seed_and_search, select_and_locate,
            extend_candidates)
        st = mapper.shard_state[0]
        fm, ssa, lut, fm2 = st["fm"], st["ssa"], st["lut"], st["fm2"]
        L = jr.shape[1]

        dt = checksum_time(
            lambda r, l, q: both_strands(r, l, q)[0], jr, jl, jq)
        rows.append({"phase": name, "stage": "sub:strands",
                     "ms": round(dt * 1e3, 1)})
        all_reads, all_quals, lens2 = jax.jit(both_strands)(jr, jl, jq)

        dt = checksum_time(
            lambda f, f2, ar, l2, lt: seed_and_search(
                f, ar, l2, params=params, lut=lt, fm2=f2)[:2],
            fm, fm2, all_reads, lens2, lut)
        rows.append({"phase": name, "stage": "sub:seeds+bsearch",
                     "ms": round(dt * 1e3, 1)})
        lo, hi, offsets, sval, flat_seeds = jax.jit(
            lambda f, f2, ar, l2, lt: seed_and_search(
                f, ar, l2, params=params, lut=lt, fm2=f2))(
            fm, fm2, all_reads, lens2, lut)

        # bsearch alone (materialized seeds -> LF chain only)
        from nvbio_tpu.fmindex import backward_search, backward_search2
        lut_k = params.lut_k if lut is not None else 0
        if fm2 is not None:
            dt = checksum_time(
                lambda f, f2, s, lt: backward_search2(
                    f, f2, s, lut=lt, lut_k=lut_k),
                fm, fm2, flat_seeds, lut)
        else:
            dt = checksum_time(
                lambda f, s, lt: backward_search(f, s, lut=lt,
                                                 lut_k=lut_k),
                fm, flat_seeds, lut)
        rows.append({"phase": name, "stage": "sub:bsearch",
                     "ms": round(dt * 1e3, 1)})

        dt = checksum_time(
            lambda f, s2, a, b, o, v, f2: select_and_locate(
                f, s2, a, b, o, v, L, params=params, fm2=f2,
                bi=False)[:2],
            fm, ssa, lo, hi, offsets, sval, fm2)
        rows.append({"phase": name, "stage": "sub:select+locate",
                     "ms": round(dt * 1e3, 1)})
        cand, _ovf, _nd = jax.jit(
            lambda f, s2, a, b, o, v, f2: select_and_locate(
                f, s2, a, b, o, v, L, params=params, fm2=f2,
                bi=False))(fm, ssa, lo, hi, offsets, sval, fm2)

        dt = checksum_time(
            lambda f, g, ar, aq, l2, c: {
                k: v for k, v in extend_candidates(
                    f, g, ar, aq, l2, c, params=params).items()
                if k != "cand_overflow"},
            fm, st["g"], all_reads, all_quals, lens2, cand)
        rows.append({"phase": name, "stage": "sub:extend",
                     "ms": round(dt * 1e3, 1)})
        sub_ms = sum(r["ms"] for r in rows
                     if r["phase"] == name and r["stage"] in
                     ("sub:strands", "sub:seeds+bsearch",
                      "sub:select+locate", "sub:extend"))
        print(f"[{name}] substage sum (strands+seeds+bsearch+"
              f"sel/loc+extend) {sub_ms:.0f} ms", file=sys.stderr)

    def run_phase(name, mapper, shard_ids, substages=False):
        params = mapper._chunk_params(args.read_len, args.read_len)
        params = maybe_deepen_lut(mapper, params)
        from dataclasses import replace
        if args.extend_frac is not None:
            params = replace(params, extend_frac=args.extend_frac)
        if args.locate_frac is not None:
            params = replace(params, locate_frac=args.locate_frac)
        seqs, ls, qs = mapper._pad_chunk(sim["seqs"], lens, sim["quals"])
        jr, jl = jnp.asarray(seqs), jnp.asarray(ls.astype(np.int32))
        jq = jnp.asarray(qs.astype(np.uint8))
        total = 0.0
        # hoisted strands + seed extraction (index-independent; runs
        # once per batch in production ShardedMapper._dispatch_chunk)
        from nvbio_tpu.models.mapper import stage_reads
        dt = checksum_time(
            lambda r, l, q: stage_reads(r, l, q, params=params)[3],
            jr, jl, jq)
        rows.append({"phase": name, "stage": "stage_reads_hoisted",
                     "ms": round(dt * 1e3, 1)})
        total += dt
        pre = jax.jit(lambda r, l, q: stage_reads(
            r, l, q, params=params))(jr, jl, jq)
        cands = []
        for s in shard_ids:
            st = mapper.shard_state[s]
            fn = lambda f, s2, g, r, l, q, lt, f2, lo_, hi_, pr: \
                _shard_cands(f, s2, g, r, l, q, lo_, hi_,
                             params=params, lut=lt, fm2=f2, pre=pr)
            fargs = (st["fm"], st["ssa"], st["g"], jr, jl, jq,
                     st["lut"], st["fm2"],
                     jnp.asarray(st["own_lo"], jnp.int32),
                     jnp.asarray(st["own_hi"], jnp.int32), pre)
            dt = checksum_time(fn, *fargs)
            print(f"[{name}] candidate stage shard {s}: "
                  f"{dt*1e3:.0f} ms", file=sys.stderr)
            rows.append({"phase": name, "stage": f"cands_shard{s}",
                         "ms": round(dt * 1e3, 1)})
            total += dt
            cands.append(jax.jit(fn)(*fargs))
        # honesty check for budget sweeps: reads whose budgets dropped
        # work re-run through escalation in production — a "faster"
        # budget that overflows broadly just moves cost off the bench
        ovf = np.zeros(args.batch, bool)
        ldrop = 0
        for cd in cands:
            if "overflow" in cd:
                ovf |= np.asarray(cd["overflow"])[:args.batch]
            ldrop += int(np.asarray(cd.get("locate_dropped", 0)))
        rows.append({"phase": name, "stage": "budget_drops",
                     "overflow_reads": int(ovf.sum()),
                     "locate_dropped": ldrop})
        if args.extend_frac is not None and args.extend_frac != 0.25:
            # attribution: how many of those overflows exist at the
            # DEFAULT extension budget too (max_range skips on
            # repetitive seeds escalate regardless)?
            p25 = replace(params, extend_frac=0.25)
            ovf25 = np.zeros(args.batch, bool)
            for s in shard_ids:
                st = mapper.shard_state[s]
                c25 = jax.jit(functools.partial(
                    _shard_cands, params=p25))(
                    st["fm"], st["ssa"], st["g"], jr, jl, jq,
                    jnp.asarray(st["own_lo"], jnp.int32),
                    jnp.asarray(st["own_hi"], jnp.int32),
                    lut=st["lut"], fm2=st["fm2"],
                    pre=pre)
                ovf25 |= np.asarray(c25["overflow"])[:args.batch]
            rows.append({"phase": name,
                         "stage": "budget_drops_at_default_0.25",
                         "overflow_reads": int(ovf25.sum())})
        dt = checksum_time(
            lambda l, *cs: _sharded_top2(list(cs), l, params), jl, *cands)
        rows.append({"phase": name, "stage": "top2", "ms":
                     round(dt * 1e3, 1)})
        total += dt
        fwd = _sharded_top2(cands, jl, params)
        dt = checksum_time(
            lambda gs, gl, ws, sh, r, l, q, sd: _sharded_walk(
                gs, gl, ws, sh, r, l, q, sd, params=params),
            mapper._gs, mapper._glens, fwd["win_start"], fwd["shard"],
            jr, jl, jq, fwd["strand"])
        rows.append({"phase": name, "stage": "walk",
                     "ms": round(dt * 1e3, 1)})
        total += dt
        rps = args.batch / total
        rows.append({"phase": name, "stage": "TOTAL",
                     "ms": round(total * 1e3, 1),
                     "reads_per_s_chip": rps, "device": device})
        print(f"[{name}] device total {total*1e3:.1f} ms -> "
              f"{rps:,.1f} reads/s on {device}", file=sys.stderr)
        if substages:
            run_substages(name, mapper, params, jr, jl, jq)

    if not args.skip_a:
        # phase A: all shards resident, fm2 off (HBM budget)
        mp = MapperParams(batch_size=args.batch, sa_sample=4,
                          use_fm2=False)
        mapper = ShardedMapper(sidx, genome, params=mp, fm2_mode="off")
        run_phase("A_all_shards", mapper,
                  list(range(len(mapper.shard_state))),
                  substages=args.substages)
        del mapper

    if not args.skip_b:
        # phase B: ONE shard + resident device pair-BWT — the mesh
        # per-chip profile.  Build a single-shard index over shard 0's
        # segment: fm2_mode="resident" on the FULL index would derive
        # a pair-BWT for every shard (~3 B/bp each) and OOM the chip;
        # a mesh chip holds exactly one shard + its pair-BWT.
        from nvbio_tpu.fmindex.sharded import ShardedIndex
        s0 = sidx.shards[0]
        st0_len = int(s0[4])
        sidx0 = ShardedIndex([s0], st0_len, sidx.sa_sample, sidx.lut_k)
        mp2 = MapperParams(batch_size=args.batch, sa_sample=4,
                           use_fm2=True)
        # --fuse-b adds the fused rows (+~0.6 B/bp); fm2's (unfused)
        # rank2 dominates phase B's LF chain either way
        mapper = ShardedMapper(sidx0, genome[:st0_len], params=mp2,
                               fm2_mode="resident", fuse=args.fuse_b)
        run_phase("B_one_shard_fm2", mapper, [0],
                  substages=args.substages)

    print(json.dumps(rows))


if __name__ == "__main__":
    main()
