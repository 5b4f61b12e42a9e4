"""Q-gram index and filter.

Ref parity: nvbio/qgram/ (qgram.h — ``QGramIndexDevice``; filter.h —
``QGramFilter`` with diagonal-binned hit merging).  The design here
keeps the index as (sorted keys, positions) arrays and answers batched
queries with `jnp.searchsorted` — the gather-friendly equivalent of the
reference's bucket tables.
"""

from .index import QGramIndex, build_qgram_index, qgram_filter  # noqa: F401
