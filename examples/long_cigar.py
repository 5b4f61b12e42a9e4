"""Wide-band long-read alignment with CIGAR — the two-pass tier.

Ref parity: the reference's warp-per-alignment wavefront scheduler +
checkpointed traceback (nvbio/alignment/batched.h; SURVEY.md §3.5,
§5.8(b-c)).  Here the wide-band score pass certifies a narrow
traceback band from the score gap, and a second pass emits the CIGAR
— see nvbio_tpu/alignment/wide.py for the math.

    python examples/long_cigar.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from nvbio_tpu.alignment import GotohScheme, AlignmentType
from nvbio_tpu.alignment.wide import wide_band_cigar_batch


def main():
    rng = np.random.default_rng(7)
    LP, BAND = 4000, 2000  # diagonal unknown within +-2000
    LT = LP + 2 * BAND

    # an ONT-style read: 5% substitutions + bursty indels, planted at
    # an unknown offset inside a wide text window
    pats = rng.integers(0, 4, (4, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (4, LT)).astype(np.int8)
    for b in range(4):
        s = list(pats[b])
        for _ in range(12):  # indel bursts up to 30 bp
            p = int(rng.integers(1, len(s) - 1))
            g = int(rng.integers(1, 31))
            if rng.random() < 0.5:
                s[p:p] = list(rng.integers(0, 4, g))
            else:
                del s[p : p + g]
        s = np.array(s, np.int8)
        idx = rng.integers(0, len(s), len(s) // 20)
        s[idx] = rng.integers(0, 4, len(idx))
        off = int(rng.integers(0, BAND - 200))
        texts[b, off : off + len(s)] = s[: LT - off]
    plens = np.full(4, LP, np.int32)
    tlens = np.full(4, LT, np.int32)

    out = wide_band_cigar_batch(
        pats, plens, texts, tlens,
        scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
        band_w=BAND)

    ops = "?MDI"
    for r in range(4):
        runs = [(int(o), int(l))
                for o, l in zip(out["run_ops"][r], out["run_lens"][r])
                if l > 0][::-1]
        cig = "".join(f"{l}{ops[o]}" for o, l in runs)
        print(f"read {r}: score {out['score'][r]:>6} "
              f"tb_band {out['tb_band'][r]:>4} "
              f"t [{out['t_start'][r]}, {out['t_end'][r]})  "
              f"CIGAR {cig[:60]}{'...' if len(cig) > 60 else ''}")


if __name__ == "__main__":
    main()
