"""Index builder CLI (nvBWT + nvSSA equivalent).

Ref parity: nvBWT/nvBWT.cpp (FASTA -> pack -> N-substitution -> BWT)
and nvSSA/nvSSA.cpp (sampled SA); both outputs land in one container.
Optionally also emits a BWA-layout .pac for interop (Appendix A).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="build_index", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("fasta", help="reference FASTA (.fa/.fa.gz)")
    p.add_argument("output", help="output index (.npz)")
    p.add_argument("--sa-sample", type=int, default=4,
                   help="SA sampling rate (nvSSA K): the locate walk "
                        "does <K LF steps per hit, so smaller is "
                        "faster at ~4/K bytes-per-bp of extra SSA "
                        "memory (K=4 halves the mapper's locate cost "
                        "vs 8; raise for memory-tight HBM)")
    p.add_argument("--sa-mono", action="store_true",
                   help="mark only SA %% K == 0 rows (legacy). Default "
                        "bi-marks SA %% K in {0,1} (2x SSA values) so "
                        "the mapper's 2-step-LF locate walk needs "
                        "floor((K-1)/2) gather rounds instead of K")
    p.add_argument("--n-seed", type=int, default=7,
                   help="RNG seed for ambiguous-base substitution")
    p.add_argument("--pac", help="also write a BWA-layout .pac here")
    p.add_argument("--lut-k", type=int, default=11,
                   help="seed-tail k-mer LUT width (0 = none)")
    p.add_argument("--shard-bp", type=int, default=0,
                   help="build a SHARDED index with this many bp per "
                   "shard (for >2 Gbp references; writes "
                   "<output>.manifest.json + per-shard files)")
    p.add_argument("--shard-overlap", type=int, default=1024)
    p.add_argument("--algorithm", choices=["auto", "sais", "pd", "device"],
                   default="auto",
                   help="suffix sort: native C++ SA-IS (any size), NumPy "
                   "prefix-doubling, or the on-device sort (bucketed "
                   "chunked lax.sort, HBM-bounded at shard scale; small "
                   "texts use whole-array device prefix-doubling)")
    p.add_argument("--device-occ", action="store_true",
                   help="compute the blocked occ tables on the "
                        "accelerator (packed BWT up, occ tables down; "
                        "bit-identical to the host path)")
    p.add_argument("--procs", type=int, default=0,
                   help="sharded builds: worker processes (0 = one "
                        "per core up to the shard count; shards build "
                        "independently)")
    args = p.parse_args(argv)

    from ..io.fasta import read_fasta
    from ..io.genome import prepare_genome
    from ..io.index_file import save_index, write_pac
    from ..fmindex import build_fm_index

    t0 = time.time()
    records = read_fasta(args.fasta)
    g = prepare_genome(records, n_sub_seed=args.n_seed)
    print(f"[build_index] {len(records)} contigs, "
          f"{len(g['symbols'])} bp, {len(g['amb'])} ambiguity runs",
          file=sys.stderr)
    if args.shard_bp > 0:
        from ..fmindex.sharded import (build_sharded_index,
                                       save_sharded_index)
        prefix = args.output[:-4] if args.output.endswith(".npz") \
            else args.output
        # sharded (multi-GB) indexes: the shard-per-chip mappers run
        # WITHOUT the fm2 pair-BWT (3+ derived copies would exceed
        # HBM), so bi-marking would double SSA memory for no LF^2
        # gain — shards default to mono marks
        import os as _os
        n_procs = args.procs or min(_os.cpu_count() or 1,
                                    1 + len(g["symbols"]) // args.shard_bp)
        sidx = build_sharded_index(
            g["symbols"], shard_bp=args.shard_bp,
            overlap=args.shard_overlap, sa_sample=args.sa_sample,
            lut_k=args.lut_k, bi_sample=False,
            occ_device=args.device_occ, n_procs=n_procs)
        save_sharded_index(prefix, sidx, g["symbols"].astype("int8"),
                           g["names"], g["lens"])
        print(f"[build_index] wrote {len(sidx.shards)}-shard index "
              f"{prefix}.manifest.json in {time.time()-t0:.1f}s",
              file=sys.stderr)
        return 0
    sa = None
    if args.algorithm != "auto":
        from ..sufsort import (suffix_array, suffix_array_pd,
                               suffix_array_device)
        t1 = time.time()
        if args.algorithm == "sais":
            from ..native import sais_native
            sa = sais_native(g["symbols"].astype("uint8"))
            if sa is None:
                print("[build_index] no C++ toolchain; using prefix "
                      "doubling", file=sys.stderr)
                sa = suffix_array_pd(g["symbols"])
        elif args.algorithm == "pd":
            sa = suffix_array_pd(g["symbols"])
        elif len(g["symbols"]) <= 8_000_000:
            # small enough for the whole-array device prefix doubling
            sa = suffix_array_device(g["symbols"])
        else:
            from ..sufsort import suffix_array_bucketed
            sa = suffix_array_bucketed(g["symbols"], verbose=True)
        n = len(g["symbols"])
        dt = time.time() - t1
        print(f"[build_index] suffix sort ({args.algorithm}): {dt:.1f}s "
              f"({n/max(dt,1e-9)/1e6:.1f} Mbp/s)", file=sys.stderr)
    fm, ssa = build_fm_index(g["symbols"], sa_sample=args.sa_sample, sa=sa,
                             bi_sample=not args.sa_mono,
                             occ_device=args.device_occ)
    lut = None
    if args.lut_k > 0:
        from ..fmindex.build import build_kmer_lut
        # ranges come from a key histogram — no SA needed (build.py)
        lut = build_kmer_lut(g["symbols"], k=args.lut_k)
    save_index(args.output, fm, ssa, g["symbols"].astype("int8"),
               g["names"], g["lens"], args.sa_sample,
               lut=lut, lut_k=args.lut_k, amb=g["amb"])
    if args.pac:
        write_pac(args.pac, g["symbols"])
    print(f"[build_index] wrote {args.output} in {time.time()-t0:.1f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
