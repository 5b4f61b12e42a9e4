"""hg-scale repeat campaign: per-class accuracy + MAPQ calibration.

The full-scale version of tests/test_repeat_campaign.py (its CI-sized
guard): a repeat-structured genome (hgr protocol, same parameters as
benchsuite/hg_stage_bench.py so the cached sharded index is shared),
--per-class reads per repeat class (unique / ALU / segdup / tandem)
at 1 % error sampled against the planted truth coordinates, mapped
with the ShardedMapper (escalation live), reporting per class:
aligned %, true-locus % (+-3 bp), MAPQ>=20 share, true-locus at
MAPQ>=20 — plus overall wrong-locus calibration at MAPQ >= 10/20/30.
Output: one JSON line.

Graded run (index cached by hg_stage_bench):
  python benchsuite/hg_campaign.py --bp 3200001024 --shards 2
Smoke: --cpu --bp 2e6 --shards 2 --per-class 64
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nvbio_tpu.utils.jax_cache import enable_compilation_cache
enable_compilation_cache()

import jax


def sample_class_reads(genome, info, per_class, read_len, rng):
    """(seqs, starts, labels): per-class read sampling with planted
    truth, mirroring tests/test_repeat_campaign.py's protocol."""
    n = len(genome)
    L = read_len
    classes = {}
    if len(info["alu_pos"]):
        classes["alu"] = (np.asarray(info["alu_pos"])[
            rng.integers(0, len(info["alu_pos"]), per_class)]
            + rng.integers(-120, 120, per_class))
    if len(info["segdups"]):
        classes["segdup"] = (np.asarray(
            [d for _s, d, _l in info["segdups"]])[
            rng.integers(0, len(info["segdups"]), per_class)]
            + rng.integers(0, min(50_000, max(
                l for *_x, l in info["segdups"])), per_class))
    if len(info["tandems"]):
        classes["tandem"] = (np.asarray(
            [p for p, _u, _c in info["tandems"]])[
            rng.integers(0, len(info["tandems"]), per_class)]
            + rng.integers(0, 400, per_class))
    # unique: outside every planted region (start AND end)
    occ = np.zeros(n + 1, np.int8)
    al = int(info["alu_len"])
    for p in info["alu_pos"]:
        occ[max(p - L, 0):p + al] = 1
    for s0, d0, ln in info["segdups"]:
        occ[max(s0 - L, 0):s0 + ln] = 1
        occ[max(d0 - L, 0):d0 + ln] = 1
    for p, u, c in info["tandems"]:
        occ[max(p - L, 0):p + u * c] = 1
    free = np.flatnonzero(occ[:n - L] == 0)
    classes["unique"] = free[rng.integers(0, len(free), per_class)]

    reads, starts, labels = [], [], []
    for cls, pos in classes.items():
        for s in np.clip(pos, 0, n - L - 1):
            frag = genome[s:s + L].copy()
            err = rng.random(L) < 0.01
            frag[err] = (frag[err] + 1
                         + rng.integers(0, 3, err.sum())) % 4
            if rng.integers(0, 2):
                frag = np.where(frag < 4, 3 - frag, frag)[::-1]
            reads.append(frag)
            starts.append(int(s))
            labels.append(cls)
    return (np.stack(reads).astype(np.uint8), np.asarray(starts),
            np.asarray(labels))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bp", type=float, default=100e6)
    p.add_argument("--shards", type=int, default=3)
    p.add_argument("--per-class", type=int, default=4096)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--cache", default=".scratch/hgbench")
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from nvbio_tpu.fmindex.sharded import (build_sharded_index,
                                           save_sharded_index,
                                           load_sharded_index)
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.sharded_mapper import ShardedMapper
    from nvbio_tpu.utils.simulate import repeat_structured_genome

    n = int(args.bp)
    scale = n / 3.2e9
    t0 = time.time()
    genome, info = repeat_structured_genome(
        n, seed=args.seed, alu_frac=0.08,
        n_segdups=max(2, int(300 * scale)),
        segdup_len=min(100_000, n // 20),
        n_tandems=max(10, int(20_000 * scale)))
    print(f"[campaign] genome {n/1e6:.0f} Mbp in {time.time()-t0:.0f}s",
          file=sys.stderr)

    os.makedirs(args.cache, exist_ok=True)
    prefix = os.path.join(args.cache,
                          f"hgr_{n//1_000_000}m_{args.shards}s")
    if not os.path.exists(prefix + ".manifest.json"):
        sidx = build_sharded_index(
            genome, shard_bp=(n + args.shards - 1) // args.shards,
            sa_sample=4, lut_k=11)
        save_sharded_index(prefix, sidx, genome, ["hgr"], [n])
    loaded = load_sharded_index(prefix)
    sidx = loaded[0] if isinstance(loaded, tuple) else loaded

    rng = np.random.default_rng(args.seed + 766)
    seqs, starts, labels = sample_class_reads(
        genome, info, args.per_class, args.read_len, rng)
    lens = np.full(len(seqs), args.read_len, np.int32)
    quals = np.full(seqs.shape, 35, np.uint8)

    mp = MapperParams(batch_size=args.batch, sa_sample=4,
                      use_fm2=False)
    mapper = ShardedMapper(sidx, genome, params=mp, fm2_mode="off")
    t0 = time.time()
    res = mapper.map_reads(seqs, lens, quals)
    wall = time.time() - t0
    print(f"[campaign] mapped {len(seqs)} reads in {wall:.1f}s "
          f"(escalated {mapper.escalated}, overflowed "
          f"{mapper.overflowed})", file=sys.stderr)

    aligned = np.array([r.aligned for r in res])
    right = np.array([r.aligned and abs(r.pos - s) <= 3
                      for r, s in zip(res, starts)])
    mapq = np.array([r.mapq if r.aligned else 0 for r in res])
    out = {"n_reads": len(seqs), "wall_s": round(wall, 1),
           "escalated": mapper.escalated, "classes": {},
           "calibration": {}}
    for cls in dict.fromkeys(labels):
        i = labels == cls
        hi = aligned[i] & (mapq[i] >= 20)
        out["classes"][cls] = {
            "aligned": round(float(aligned[i].mean()), 4),
            "true_locus": round(
                float(right[i][aligned[i]].mean())
                if aligned[i].any() else 0.0, 4),
            "mapq20_share": round(float(hi.mean()), 4),
            "true_at_mapq20": round(
                float(right[i][hi].mean()) if hi.any() else 1.0, 4),
        }
    for q in (10, 20, 30):
        h = aligned & (mapq >= q)
        out["calibration"][f"wrong_at_mapq{q}"] = round(
            float((~right[h]).mean()) if h.any() else 0.0, 5)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
