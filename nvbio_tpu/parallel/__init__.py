"""Device-mesh scale-out.

The reference is single-node (multi-GPU = one host thread per device;
SURVEY.md §3.12).  The design here: a `jax.sharding.Mesh` with a
``dp`` axis, read batches sharded over it, FM-index + genome replicated
(hg-scale indexes fit per-chip HBM; ICI-sharded indexes are staged
work), and GSPMD propagating the rest — no hand-written collectives on
the mapping path, matching the embarrassingly-parallel structure of
read mapping.
"""

from .mesh import make_mesh, shard_reads, replicate  # noqa: F401
from .distributed import (  # noqa: F401
    init_distributed,
    shard_fastq,
    read_fastq_range,
    merge_sam_shards,
)
