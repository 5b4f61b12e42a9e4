"""Multi-host scale-out: input sharding, distributed init, SAM merge.

The reference has NO multi-node layer (single node, one host thread
per GPU, shared-memory index server — SURVEY.md §3.12/§5.8); this is
green-field design for multi-host device meshes:

- every host calls :func:`init_distributed` (``jax.distributed``),
  builds the global mesh, and replicates the index into its chips'
  HBM (the multi-host analog of nvFM-server's shared-memory index);
- the *input* path needs no network: each host reads its own byte
  range of the FASTQ (:func:`shard_fastq`), mirroring nvBowtie's
  InputThread per device;
- the *output* path is made deterministic by construction: shard k
  writes SAM records in its input order, and
  :func:`merge_sam_shards` concatenates shards in shard order —
  record order equals single-host input order, so multi-host output
  is bit-identical to a single-host run (BASELINE.md correctness bar).
  Only shard-count metadata crosses hosts (over DCN); alignment data
  never does.

Elastic story (SURVEY.md §5.4): a failed host's byte range is simply
re-mapped — shards are the only state.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize jax.distributed from args or env
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), then return
    (process_index, process_count).  No-op when single-process."""
    import jax

    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes > 1:
        if process_id is None:
            process_id = int(os.environ["PROCESS_ID"])
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def shard_fastq(path: str, num_shards: int):
    """Byte ranges [(start, end)) splitting a FASTQ into record-aligned
    shards — each host reads only its range (no cross-host input).

    Boundaries snap forward to the next record start (an '@' line whose
    following structure matches FASTQ's 4-line framing, disambiguated
    from '@' inside quality strings by checking the '+' separator two
    lines down).
    """
    size = os.path.getsize(path)
    if num_shards <= 1:
        return [(0, size)]
    approx = size // num_shards
    cuts = [0]
    with open(path, "rb") as f:
        for k in range(1, num_shards):
            target = k * approx
            f.seek(target)
            f.readline()  # finish the partial line
            # scan forward to a verified record start
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    pos = size
                    break
                if line.startswith(b"@"):
                    f.readline()  # sequence
                    plus = f.readline()
                    if plus.startswith(b"+"):
                        break
                    f.seek(pos + len(line))
            cuts.append(pos)
    cuts.append(size)
    # degenerate shards (empty range) are fine: no records
    return [(cuts[i], cuts[i + 1]) for i in range(num_shards)]


def read_fastq_range(path: str, start: int, end: int):
    """Parse the FASTQ records fully contained in [start, end) ->
    (names, seqs, quals) lists, same types as io.fastq.read_fastq."""
    from ..basic.alphabet import char_to_dna

    names, seqs, quals = [], [], []
    with open(path, "rb") as f:
        f.seek(start)
        while f.tell() < end:
            h = f.readline()
            if not h or not h.startswith(b"@"):
                break
            s = f.readline().strip()
            f.readline()  # +
            q = f.readline().strip()
            names.append(h[1:].split()[0].decode())
            seqs.append(char_to_dna(np.frombuffer(s, dtype=np.uint8)))
            quals.append(np.frombuffer(q, dtype=np.uint8) - 33)
    return names, seqs, quals


def merge_sam_shards(shard_paths: list[str], out_path: str):
    """Ordered merge: header from shard 0, records concatenated in
    shard order.  Because shards partition the input in order and each
    mapper writes records in input order, the merged file's record
    order equals the single-run record order (deterministic multi-host
    output, SURVEY.md §7.3(6))."""
    import gzip

    def _open(p, mode):
        return gzip.open(p, mode) if str(p).endswith(".gz") else open(p, mode)

    n_records = 0
    with _open(out_path, "wt") as out:
        for k, sp in enumerate(shard_paths):
            with _open(sp, "rt") as f:
                for line in f:
                    if line.startswith("@"):
                        if k == 0:
                            out.write(line)
                        continue
                    out.write(line)
                    n_records += 1
    return n_records
