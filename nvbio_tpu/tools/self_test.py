"""Runnable install sanity check (nvbio-test equivalent).

Ref parity: nvbio-test/ (SURVEY.md §2 L7) — the reference ships a CLI
functional-test binary; this is the same capability without pytest:
build a small index in-process, map simulated reads (SE + PE), check
alignment rate and true-locus accuracy, and exercise the DP engines
(the twin, and the GPU kernel when a card is attached).

    python -m nvbio_tpu.tools.self_test [--cpu] [--quick]

Exit code 0 = all checks passed.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="self_test", description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="smaller genome/read count (~30 s on CPU)")
    from . import add_cpu_flag, maybe_cpu
    add_cpu_flag(p)
    args = p.parse_args(argv)
    maybe_cpu(args)

    from ..utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()
    import numpy as np
    import jax

    n_bp = 200_000 if args.quick else 1_000_000
    n_reads = 200 if args.quick else 2000
    failures = []

    def check(name, ok, detail=""):
        status = "ok" if ok else "FAIL"
        print(f"[self_test] {name:34s} {status}  {detail}",
              file=sys.stderr, flush=True)
        if not ok:
            failures.append(name)

    t0 = time.time()
    print(f"[self_test] backend: {jax.default_backend()}",
          file=sys.stderr)

    # 1. index build + SE mapping accuracy
    from ..utils.simulate import random_genome, simulate_reads
    from ..fmindex import build_fm_index
    from ..models import Mapper, MapperParams

    genome = random_genome(n_bp, seed=7)
    fm, ssa = build_fm_index(genome, sa_sample=4, bi_sample=True)
    sim = simulate_reads(genome, n_reads, 100, error_rate=0.01, seed=8)
    lens = np.full(n_reads, 100, np.int32)
    m = Mapper(fm, ssa, genome,
               params=MapperParams(batch_size=min(n_reads, 4096)))
    res = m.map_reads(sim["seqs"].astype(np.uint8), lens, sim["quals"])
    aligned = sum(r.aligned for r in res)
    true_locus = sum(
        r.aligned and abs(r.pos - int(tp)) <= 3
        for r, tp in zip(res, sim["true_pos"]))
    check("SE alignment rate", aligned >= 0.98 * n_reads,
          f"{aligned}/{n_reads}")
    check("SE true-locus accuracy", true_locus >= 0.97 * n_reads,
          f"{true_locus}/{n_reads}")

    # 2. PE proper pairs
    from ..utils.simulate import simulate_pairs
    from ..models.paired import PairedMapper

    np_pairs = max(n_reads // 4, 64)
    simp = simulate_pairs(genome, np_pairs, 100, insert_mean=300,
                          insert_sd=30, seed=9)
    lp = np.full(np_pairs, 100, np.int32)
    pm = PairedMapper(fm, ssa, genome,
                      params=MapperParams(batch_size=min(np_pairs, 4096),
                                          maxins=500))
    r1, r2, info = pm.map_pairs(simp["seqs1"].astype(np.uint8), lp,
                                simp["quals1"],
                                simp["seqs2"].astype(np.uint8), lp,
                                simp["quals2"])
    proper = sum(i["proper"] for i in info)
    check("PE proper pairs", proper >= 0.97 * np_pairs,
          f"{proper}/{np_pairs}")

    # 3. DP engine: score + CIGAR vs the scalar oracle
    from ..alignment import GotohScheme, AlignmentType
    from ..alignment.batched import banded_score_batch
    from ..alignment.oracle import align_oracle
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    pats = rng.integers(0, 4, (8, 100)).astype(np.int8)
    texts = rng.integers(0, 4, (8, 130)).astype(np.int8)
    texts[:, 15:115] = pats
    for r in range(8):
        texts[r, rng.integers(15, 115)] = rng.integers(0, 4)
    quals = np.full((8, 100), 35, np.int32)
    scheme = GotohScheme()
    out = banded_score_batch(
        jnp.asarray(pats), jnp.full(8, 100, jnp.int32),
        jnp.asarray(texts), jnp.full(8, 130, jnp.int32),
        jnp.asarray(quals), scheme=scheme,
        atype=AlignmentType.SEMI_GLOBAL, band_w=15)
    dp_ok = all(
        int(out["score"][r]) == align_oracle(
            pats[r], texts[r], scheme, AlignmentType.SEMI_GLOBAL,
            band=15, quals=quals[r]).score
        for r in range(8))
    check("banded Gotoh vs oracle", dp_ok)

    # 4. the DP engine the selector picks here (the GPU kernel on a
    # card, the twin elsewhere) agrees with the twin
    from ..ops.banded_dp import banded_score, select_banded_dp

    outp = banded_score(
        jnp.asarray(pats), jnp.full(8, 100, jnp.int32),
        jnp.asarray(texts), jnp.full(8, 130, jnp.int32),
        jnp.asarray(quals), scheme=scheme,
        atype=AlignmentType.SEMI_GLOBAL, band_w=15)
    check(f"{select_banded_dp(jax.default_backend(), 15)} DP == XLA twin",
          bool((np.asarray(outp["score"])
                == np.asarray(out["score"])).all()))

    # 5. suffix sorting: device prefix-doubling vs host SA-IS
    from ..sufsort import suffix_array
    from ..sufsort.device import suffix_array_device

    t = rng.integers(0, 4, 50_000).astype(np.uint8)
    check("device sufsort vs SA-IS",
          bool((suffix_array_device(t) == suffix_array(t)).all()))

    print(f"[self_test] {time.time() - t0:.1f}s, "
          f"{len(failures)} failure(s)", file=sys.stderr)
    if failures:
        print("FAILED: " + ", ".join(failures))
        return 1
    print("self_test: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
