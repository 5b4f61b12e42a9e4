"""FM-index: blocked occurrence tables, backward search, SSA locate.

JAX re-design of the reference's ``nvbio/fmindex/`` layer (ref:
fmindex.h — ``fm_index``, ``rank()``, ``locate()``; rank_dictionary.h —
``rank_dictionary``, ``rank4``; ssa.h — ``SSA_index_multiple``;
filter.h — ``FMIndexFilter``).

The occurrence table uses the HBM-tuned blocked layout named in
BASELINE.md: absolute u32 counts per 128-symbol block + per-16-symbol
sub-block deltas + the 2-bit-packed BWT words, so one rank touches one
block row.  Queries are fully vectorized gathers (XLA path); the
scalar-prefetch Pallas kernel for the LF hot loop lives in
``nvbio_tpu.ops.fm_rank``.
"""

from .index import (  # noqa: F401
    FMIndex,
    SSA,
    rank,
    bwt_symbol,
    backward_search,
    locate,
)
from .build import build_fm_index  # noqa: F401
from .fm2 import (  # noqa: F401
    FM2,
    build_fm2,
    rank2,
    backward_search2,
    locate2,
    locate2_mono,
    build_fm2_device,
)
