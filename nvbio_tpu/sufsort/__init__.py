"""Suffix-array / BWT construction.

Covers the reference's ``nvbio/sufsort/`` capability (ref: sufsort.h —
``cuda::suffix_sort``, ``cuda::bwt``, ``blockwise_suffix_sort``; the
module behind nvBWT and arXiv:1410.0562).  Paths:

- ``suffix_array`` — host dispatch: native C++ SA-IS (linear time,
  int32/int64, hg-scale) with a vectorized NumPy prefix-doubling
  fallback (the moral analog of ``PrefixDoublingSufSort``).
- ``suffix_array_device`` — on-device prefix doubling over
  ``lax.sort`` for in-HBM references.
- ``suffix_array_bucketed`` — the shard-scale device sort (host
  8-symbol bucketing -> per-chunk device radix refinement ->
  compacted doubling; HBM use is O(chunk), the blockwise dcs.h /
  compression_sort.h capability re-thought for XLA).
- ``set_bwt_device`` — device set-BWT of read collections (the bwte.h /
  arXiv:1410.0562 capability) as a bounded-depth LSD radix sort.
"""

from .sa import suffix_array, suffix_array_pd, bwt_from_sa  # noqa: F401
from .device import (  # noqa: F401
    suffix_array_device,
    set_bwt_device,
    set_bwt_oracle,
)
from .bucketed import suffix_array_bucketed  # noqa: F401
