"""CLI tools (the reference's L6 tool layer, SURVEY.md §2):

- ``build_index``   — nvBWT + nvSSA equivalent (FASTA -> index container)
- ``map_reads``     — nvBowtie equivalent (FASTQ -> SAM, SE + PE)
- ``sw_benchmark``  — sw-benchmark equivalent (DP GCUPS microbench)
- ``aln_diff``      — nvbio-aln-diff equivalent (SAM vs SAM report)
- ``extract_reads`` — nvExtractReads equivalent (FASTQ -> packed npz)
- ``fm_server``     — nvFM-server equivalent (shared index via /dev/shm)

Run as ``python -m nvbio_tpu.tools.<name> --help``.
"""


def add_cpu_flag(p):
    """--cpu for device-compute tools: select the XLA/CPU platform
    before any jax use (the same as JAX_PLATFORMS=cpu)."""
    p.add_argument("--cpu", action="store_true",
                   help="run on the XLA/CPU platform")


def maybe_cpu(args):
    if getattr(args, "cpu", False):
        import jax
        jax.config.update("jax_platforms", "cpu")
