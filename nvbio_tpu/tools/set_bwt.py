"""Set-BWT builder CLI (nvSetBWT equivalent).

Builds the BWT of a *collection of reads* (each read followed by its
own sentinel, sentinels ordered by read id) on device and writes it as
text or .npy symbols over the alphabet {A,C,G,T,$}.

Ref parity: the reference's set-BWT tool over nvbio/sufsort/bwte.h
(``BWTEContext`` — the incremental-merge algorithm of arXiv:1410.0562);
here the bounded suffix depth of short reads lets one fixed round of
LSD radix sorts replace the merge (see sufsort/device.py).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="set_bwt", description=__doc__)
    p.add_argument("reads", help="input FASTQ (.fq/.fq.gz)")
    p.add_argument("output", help="output BWT (.npy of uint8 symbols, "
                   "or .txt for ACGT$ text)")
    p.add_argument("--max-len", type=int, default=256)
    from . import add_cpu_flag, maybe_cpu
    add_cpu_flag(p)
    args = p.parse_args(argv)
    maybe_cpu(args)

    from ..io.fastq import read_fastq_packed
    from ..sufsort import set_bwt_device

    t0 = time.time()
    _names, reads, lens, _quals = read_fastq_packed(args.reads,
                                                    max_len=args.max_len)
    n_bases = int(lens.sum())
    bwt = set_bwt_device(np.where(reads < 4, reads, 0).astype(np.uint8),
                         lens)
    dt = time.time() - t0
    if args.output.endswith(".txt"):
        sym = np.frombuffer(b"ACGT$", dtype=np.uint8)
        with open(args.output, "wb") as f:
            f.write(sym[bwt].tobytes())
    else:
        np.save(args.output, bwt)
    print(f"[set_bwt] {len(lens)} reads, {n_bases} bases -> "
          f"{len(bwt)} BWT symbols in {dt:.1f}s "
          f"({n_bases/dt/1e6:.1f} Mbases/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
