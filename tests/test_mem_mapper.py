"""MEM-seeded mapper (nvMem equivalent): end-to-end on simulated reads.

Same strategy as test_mapper: simulate reads with known origin, map,
check position/strand recovery and SAM record sanity.
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import MapperParams, MemMapper
from nvbio_tpu.strings import pack_reads
from nvbio_tpu.utils.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def mem_mapper():
    genome = random_genome(80_000, seed=21)
    params = MapperParams(batch_size=64, sa_sample=16, max_candidates=8,
                          max_smems=6)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    m = MemMapper(fm, ssa, genome, params=params)
    return m, genome


def test_mem_mapper_recovers_origins(mem_mapper):
    m, genome = mem_mapper
    sim = simulate_reads(genome, 64, 100, seed=5, error_rate=0.02)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    results = m.map_reads(reads, lens, quals.astype(np.int32))
    n_ok = 0
    for i, r in enumerate(results):
        if r.aligned and abs(r.pos - sim["true_pos"][i]) <= 2 \
                and r.strand == sim["true_strand"][i]:
            n_ok += 1
    assert n_ok >= 60  # >= 94% exact recovery with 2% substitutions


def test_mem_mapper_indels(mem_mapper):
    m, genome = mem_mapper
    # reads with one small planted deletion each
    rng = np.random.default_rng(9)
    seqs, starts = [], []
    for _ in range(32):
        s = int(rng.integers(0, len(genome) - 120))
        frag = genome[s : s + 104].copy()
        d = int(rng.integers(30, 70))
        seqs.append(np.concatenate([frag[:d], frag[d + 4 :]])[:100])
        starts.append(s)
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * 32
    )
    results = m.map_reads(reads, lens, quals.astype(np.int32))
    n_ok = sum(
        1 for i, r in enumerate(results)
        if r.aligned and abs(r.pos - starts[i]) <= 2 and "D" in r.cigar
    )
    assert n_ok >= 28


def test_mem_mapper_unmappable(mem_mapper):
    m, genome = mem_mapper
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, 100).astype(np.uint8) for _ in range(16)]
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * 16
    )
    results = m.map_reads(reads, lens, quals.astype(np.int32))
    # random 100-mers almost surely have no 19bp MEM in an 80kb genome
    assert sum(r.aligned for r in results) <= 2


def test_mem_sam_records(mem_mapper):
    m, genome = mem_mapper
    sim = simulate_reads(genome, 16, 100, seed=6)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    results = m.map_reads(reads, lens, quals.astype(np.int32))
    names = [f"r{i}" for i in range(16)]
    recs = m.to_sam_records(names, reads, lens, quals, results)
    assert len(recs) == 16
    for rec in recs:
        line = rec.to_line()
        fields = line.split("\t")
        assert len(fields) >= 11
