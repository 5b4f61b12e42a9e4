"""Headline DP benchmark: banded Gotoh throughput (GCUPS) on one GPU.

BASELINE.md's graded metric for the DP engine ("GCUPS for banded SW
DP", config 1): 2^18 near-match extensions of 100 bp reads at band
half-width 15, quality-aware Bowtie2 scoring, semi-global.  Times the
engine ``ops.select_banded_dp`` picks on the card and the XLA twin,
each after a warm-up call, every call ending in ``block_until_ready``.

Fails without a GPU.  Prints the card's name and power limit and the
per-engine times to stderr, then ONE JSON line to stdout.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nvbio_tpu.alignment import AlignmentType, GotohScheme  # noqa: E402
from nvbio_tpu.alignment.batched import banded_score_batch  # noqa: E402
from nvbio_tpu.ops.banded_dp import banded_score  # noqa: E402
from nvbio_tpu.ops.banded_dp import select_banded_dp  # noqa: E402
from nvbio_tpu.utils.device import card_name  # noqa: E402
from nvbio_tpu.utils.jax_cache import enable_compilation_cache  # noqa: E402

REFERENCE_BANDED_GCUPS = 30.0  # nominal reference-era banded DP (BASELINE.md)


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    enable_compilation_cache()
    dev = jax.devices()[0]
    card = card_name(dev)
    NB, LP, W, iters = 1 << 18, 100, 15, 10
    LT = LP + 2 * W
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 4, (NB, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int8)
    texts[:, W : W + LP] = pats  # realistic near-match extensions
    for _ in range(3):  # sprinkle mutations
        ii = rng.integers(0, LT, NB)
        texts[np.arange(NB), ii] = rng.integers(0, 4, NB)
    args = tuple(map(jnp.asarray, (
        pats, np.full(NB, LP, np.int32), texts, np.full(NB, LT, np.int32),
        rng.integers(20, 41, (NB, LP)).astype(np.int32))))
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
              band_w=W)
    engine = select_banded_dp(dev.platform, W)
    cells = NB * LP * (2 * W + 1)
    times = {}
    for name, fn in ((engine, banded_score), ("xla", banded_score_batch)):
        f = jax.jit(lambda *a, fn=fn: fn(*a, **kw)["score"])
        jax.block_until_ready(f(*args))  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(f(*args))
        times[name] = (time.perf_counter() - t0) / iters
        print(f"[bench] {card} | {dev.device_kind}: {name} "
              f"{times[name] * 1e3:.3f} ms/call, "
              f"{cells / times[name] / 1e9:.2f} GCUPS", file=sys.stderr)
    gcups = cells / times[engine] / 1e9
    print(json.dumps({
        "metric": "banded_gotoh_gcups",
        "value": gcups,
        "unit": "GCUPS",
        "engine": engine,
        "device": dev.device_kind,
        "card": card,
        "vs_baseline": gcups / REFERENCE_BANDED_GCUPS,
    }))


if __name__ == "__main__":
    main()
