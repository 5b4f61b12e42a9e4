"""DP throughput microbenchmark (sw-benchmark equivalent).

Ref parity: sw-benchmark/sw-benchmark.cpp — GCUPS across aligners
(edit distance / SW / Gotoh) x alignment types x engines (every DP
engine ``ops.select_banded_dp`` can pick on this backend, and the XLA
twin), random near-match batches.  Times end in ``block_until_ready``
after a warm-up call; each row names the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="sw_benchmark", description=__doc__)
    p.add_argument("--batch", type=int, default=0,
                   help="alignments per run (default: backend-dependent)")
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--band", type=int, default=15)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--long", action="store_true",
                   help="also bench the long-read tiers on the twin "
                        "(long pattern, wide band, two-pass CIGAR)")
    p.add_argument("--long-len", type=int, default=10_000)
    p.add_argument("--wide-band", type=int, default=2000)
    from . import add_cpu_flag, maybe_cpu
    add_cpu_flag(p)
    args = p.parse_args(argv)
    maybe_cpu(args)

    from ..utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    from ..alignment import GotohScheme, AlignmentType, EDIT_DISTANCE_SCHEME
    from ..alignment.types import BOWTIE2_LOCAL_SCHEME
    from ..alignment.batched import banded_score_batch
    from ..ops.banded_dp import banded_score_triton, select_banded_dp

    from ..utils.device import card_name

    dev = jax.devices()[0]
    card = card_name(dev)
    print(f"[sw_benchmark] {card} x{len(jax.devices())}", file=sys.stderr)
    on_gpu = dev.platform == "gpu"
    NB = args.batch or (1 << 17 if on_gpu else 1 << 12)
    LP, W = args.read_len, args.band
    LT = LP + 2 * W
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 4, (NB, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int8)
    texts[:, W : W + LP] = pats
    plens = np.full(NB, LP, np.int32)
    tlens = np.full(NB, LT, np.int32)
    arr = tuple(map(jnp.asarray, (pats, plens, texts, tlens)))
    rows = []

    def timed(fn, *a):
        """Mean seconds per call after one warm-up (compile) call."""
        jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            jax.block_until_ready(fn(*a))
        return (time.perf_counter() - t0) / args.iters

    def report(aligner, engine, dt, cells, note=""):
        gcups = cells / dt / 1e9
        rows.append({"aligner": aligner, "engine": engine,
                     "gcups": gcups, "ms": dt * 1e3,
                     "device": card})
        print(f"{aligner:20s} {engine:8s} {gcups:8.2f} GCUPS "
              f"({dt*1e3:.3f} ms{note})", file=sys.stderr)

    cases = [
        ("edit_distance", EDIT_DISTANCE_SCHEME, AlignmentType.SEMI_GLOBAL),
        ("gotoh_semi_global", GotohScheme(), AlignmentType.SEMI_GLOBAL),
        ("gotoh_local", BOWTIE2_LOCAL_SCHEME, AlignmentType.LOCAL),
        ("gotoh_global", GotohScheme(), AlignmentType.GLOBAL),
    ]
    # every engine the selector can pick here, the twin always
    engines = [("xla", banded_score_batch)]
    if select_banded_dp(dev.platform, W) == "triton":
        engines.insert(0, ("triton", banded_score_triton))
    for cname, scheme, atype in cases:
        for ename, fn in engines:
            f = jax.jit(lambda *a, s=scheme, t=atype, e=fn:
                        e(*a, scheme=s, atype=t, band_w=W)["score"])
            report(cname, ename, timed(f, *arr), NB * LP * (2 * W + 1))

    # Myers bit-vector edit distance (full-matrix equivalent work)
    from ..alignment.myers import myers_edit_distance_batch

    fm_ = jax.jit(lambda p, pl, t, tl: myers_edit_distance_batch(
        p, pl, t, tl, atype=AlignmentType.SEMI_GLOBAL)[0])
    report("myers_edit_distance", "bitvec", timed(fm_, *arr),
           NB * LP * LT, ", full-matrix cells")

    if args.long:
        # ---- long-read tiers on the twin: a long pattern at a modest
        # band, a wide band, and the two-pass wide-band CIGAR
        # (alignment/wide.py) ----
        from ..alignment.wide import wide_band_cigar_batch

        LPL = args.long_len
        WL = max(args.band, 63)
        NBL = 1 << 10 if on_gpu else 4
        ltexts = rng.integers(0, 4, (NBL, LPL + 2 * WL)).astype(np.int8)
        lpats = rng.integers(0, 4, (NBL, LPL)).astype(np.int8)
        ltexts[:, WL : WL + LPL] = lpats
        larr = tuple(map(jnp.asarray, (
            lpats, np.full(NBL, LPL, np.int32), ltexts,
            np.full(NBL, LPL + 2 * WL, np.int32))))
        fl = jax.jit(lambda *a: banded_score_batch(
            *a, scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
            band_w=WL)["score"])
        report(f"gotoh_long_{LPL}", "xla", timed(fl, *larr),
               NBL * LPL * (2 * WL + 1), f", {NBL} x band {WL}")

        WW = args.wide_band
        NBW = 128 if on_gpu else 2
        LPW = min(LPL, 4000)
        wtexts = rng.integers(0, 4, (NBW, LPW + 2 * WW)).astype(np.int8)
        wpats = rng.integers(0, 4, (NBW, LPW)).astype(np.int8)
        off = rng.integers(0, WW, NBW)
        for b in range(NBW):
            wtexts[b, off[b] : off[b] + LPW] = wpats[b]
        wp = (wpats, np.full(NBW, LPW, np.int32), wtexts,
              np.full(NBW, LPW + 2 * WW, np.int32))
        fw = jax.jit(lambda *a: banded_score_batch(
            *a, scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
            band_w=WW)["score"])
        report(f"gotoh_wide_{WW}", "xla",
               timed(fw, *map(jnp.asarray, wp)),
               NBW * LPW * (2 * WW + 1), f", {NBW} x {LPW} bp")

        t0 = time.perf_counter()
        out = wide_band_cigar_batch(
            *wp, scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
            band_w=WW)
        dt = time.perf_counter() - t0
        n_cig = int(out["tb_ok"].sum())
        rows.append({"aligner": f"wide_cigar_{WW}", "engine": "two_pass",
                     "alignments_per_s": NBW / dt, "cigars": n_cig,
                     "ms": dt * 1e3, "device": card})
        print(f"{'wide_cigar_' + str(WW):20s} {'2pass':8s} "
              f"{NBW/dt:8.1f} aln/s ({dt*1e3:.1f} ms cold, "
              f"{n_cig}/{NBW} CIGARs)", file=sys.stderr)

    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
