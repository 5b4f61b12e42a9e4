"""nvbio_tpu — a JAX short-read alignment framework.

A from-scratch re-design of the capabilities of NVBIO
(``07350100647/nvbio-gpl``, a mirror of NVlabs/nvbio) for accelerators:
JAX / XLA / Pallas compute path, fixed-shape batched pipelines, and
`jax.sharding` meshes for scale-out.

Layer map (mirrors SURVEY.md §2):

- ``basic``      — packed 2-bit symbol streams, alphabets, bit tricks (ref: nvbio/basic/)
- ``strings``    — string sets, seed extraction (ref: nvbio/strings/)
- ``fmindex``    — FM-index: blocked occ tables, backward search, SSA locate
  (ref: nvbio/fmindex/)
- ``sufsort``    — suffix array / BWT construction (ref: nvbio/sufsort/)
- ``alignment``  — batched DP engine: edit distance / SW / Gotoh, full + banded,
  score + traceback (ref: nvbio/alignment/)
- ``qgram``      — q-gram index and filter (ref: nvbio/qgram/)
- ``io``         — FASTA/FASTQ readers, index container, SAM/BAM output (ref: nvbio/io/)
- ``models``     — end-to-end mapper pipelines, the flagship being the
  nvBowtie-equivalent seed-and-extend mapper (ref: nvBowtie/)
- ``ops``        — the GPU DP kernel and the backend-keyed engine choice
- ``parallel``   — device mesh, sharding, multi-host SAM merge
- ``utils``      — configs, stats, logging
- ``tools``      — CLI entry points (build_index, map_reads, ...)
"""

__version__ = "0.1.0"
