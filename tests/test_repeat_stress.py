"""Repeat-structure stress tests + effort-escalation regression.

Random genomes have no repeat structure, so the budget knobs
(max_range seed skipping, locate_frac drops, max_candidates
truncation) never bite in the other suites.  These tests plant
high-copy repeats and segmental duplications where they do — and pin
the nvBowtie-style escalation round (params.max_effort) recovering
reads that single-round budgets demonstrably lose.
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import Mapper, MapperParams
from nvbio_tpu.strings import pack_reads
from nvbio_tpu.utils.simulate import random_genome


def _pack(seqs):
    quals = [np.full(len(s), 35, np.uint8) for s in seqs]
    return pack_reads([s.astype(np.uint8) for s in seqs], quals,
                      max_len=128)


@pytest.fixture(scope="module")
def repeat_genome():
    """120 identical copies of a 400 bp element embedded in unique
    sequence: every seed inside the element has ~120 SA hits, beyond
    the default max_range=64."""
    rng = np.random.default_rng(44)
    element = rng.integers(0, 4, 400).astype(np.uint8)
    parts, copy_starts = [], []
    pos = 0
    for i in range(120):
        uniq = rng.integers(0, 4, 600).astype(np.uint8)
        parts.append(uniq)
        pos += 600
        copy_starts.append(pos)
        parts.append(element)
        pos += 400
    parts.append(rng.integers(0, 4, 5000).astype(np.uint8))
    genome = np.concatenate(parts)
    return genome, element, np.array(copy_starts)


def test_single_round_loses_repeat_reads_escalation_recovers(
        repeat_genome):
    genome, element, copy_starts = repeat_genome
    fm, ssa = build_fm_index(genome, sa_sample=8, bi_sample=True)
    reads = [element[50:150].copy() for _ in range(8)]  # inside element
    packed, lens, quals, _ = _pack(reads)

    base = dict(batch_size=8, sa_sample=8, max_candidates=8)
    m1 = Mapper(fm, ssa, genome,
                params=MapperParams(max_effort=1, **base))
    r1 = m1.map_reads(packed, lens, quals)
    # every seed exceeds max_range=64 -> no candidates in round 1
    assert all(not r.aligned for r in r1), \
        "expected single-round budgets to lose pure-repeat reads"

    m2 = Mapper(fm, ssa, genome,
                params=MapperParams(max_effort=2, **base))
    r2 = m2.map_reads(packed, lens, quals)
    assert m2.escalated == 8
    for r in r2:
        assert r.aligned, "escalation round must recover the read"
        # 120 equal copies: a perfect tie (score == second); the own
        # monotone MAPQ table reports <= 3 for ties
        assert r.second == r.score and r.mapq <= 3
        assert any(abs(r.pos - (cs + 50)) <= 2 for cs in copy_starts)


def test_segmental_duplication_accuracy():
    """Two 2 kb copies at 2% divergence: reads covering divergent
    sites must pick the right copy and carry XS evidence (second-best
    close to best)."""
    rng = np.random.default_rng(45)
    block = rng.integers(0, 4, 2000).astype(np.uint8)
    block2 = block.copy()
    div_sites = rng.choice(2000, 40, replace=False)
    for p in div_sites:
        block2[p] = (block2[p] + 1 + rng.integers(0, 3)) % 4
    g = np.concatenate([
        random_genome(30_000, seed=46), block,
        random_genome(30_000, seed=47), block2,
        random_genome(10_000, seed=48)])
    start1, start2 = 30_000, 30_000 + 2000 + 30_000
    fm, ssa = build_fm_index(g, sa_sample=8, bi_sample=True)
    m = Mapper(fm, ssa, g, params=MapperParams(
        batch_size=16, sa_sample=8, max_candidates=8))

    # reads from copy 2 covering >= 2 divergent sites
    reads, true_pos = [], []
    for p in sorted(div_sites)[:16]:
        s = int(np.clip(p - 50, 0, 1900))
        reads.append(g[start2 + s: start2 + s + 100].copy())
        true_pos.append(start2 + s)
    packed, lens, quals, _ = _pack(reads)
    res = m.map_reads(packed, lens, quals)
    n_right = sum(
        1 for r, tp in zip(res, true_pos)
        if r.aligned and abs(r.pos - tp) <= 4)
    assert n_right >= 14
    # the other copy must register as a close second for reads with
    # few covered divergence sites
    assert any(r.second is not None and r.second >= r.score - 12
               for r in res if r.aligned)


def test_tandem_repeat_locate_budget(repeat_genome):
    """Reads half-in half-out of the element: unique-flank seeds keep
    round 1 viable even when repeat seeds are skipped; positions must
    be exact (the diagonal dedupe + budget drops must not lose the
    true locus)."""
    genome, element, copy_starts = repeat_genome
    fm, ssa = build_fm_index(genome, sa_sample=8, bi_sample=True)
    m = Mapper(fm, ssa, genome, params=MapperParams(
        batch_size=16, sa_sample=8, max_candidates=8))
    # read spans the last 50 bp of a copy + 50 bp of its unique tail
    reads, true_pos = [], []
    for cs in copy_starts[5:21]:
        p = cs + 350
        reads.append(genome[p: p + 100].copy())
        true_pos.append(p)
    packed, lens, quals, _ = _pack(reads)
    res = m.map_reads(packed, lens, quals)
    for r, tp in zip(res, true_pos):
        assert r.aligned and abs(r.pos - tp) <= 2, (r.pos, tp)


def test_sharded_escalation_matches_single_index():
    """Sharded mapping escalates overflowed reads too (overflow is
    OR-ed across shards), recovering pure-repeat reads exactly like
    the single-index mapper.  All repeat copies live in ONE shard so
    per-shard SA ranges overflow like the single index's do (an even
    spread would divide the copy count below max_range — sharding
    accidentally *relieves* budget pressure in that case)."""
    from nvbio_tpu.fmindex.sharded import build_sharded_index
    from nvbio_tpu.models.sharded_mapper import ShardedMapper

    rng = np.random.default_rng(46)
    element = rng.integers(0, 4, 400).astype(np.uint8)
    parts = []
    for _ in range(120):  # 120 copies, all within the first shard
        parts.append(element)
        parts.append(rng.integers(0, 4, 100).astype(np.uint8))
    parts.append(rng.integers(0, 4, 120_000).astype(np.uint8))
    genome = np.concatenate(parts)
    copy_starts = np.arange(120) * 500

    reads = [element[50:150].copy() for _ in range(6)]
    reads += [genome[70_000:70_100].copy(),
              genome[130_000:130_100].copy()]
    packed, lens, quals, _ = _pack(reads)
    base = dict(batch_size=8, sa_sample=8, max_candidates=8)

    sidx = build_sharded_index(
        genome, shard_bp=(len(genome) + 2) // 3, overlap=2048,
        sa_sample=8)

    sh1 = ShardedMapper(sidx, genome,
                        params=MapperParams(max_effort=1, **base))
    r1 = sh1.map_reads(packed, lens, quals)
    assert all(not r.aligned for r in r1[:6])  # lost in round 1

    sh2 = ShardedMapper(sidx, genome,
                        params=MapperParams(max_effort=2, **base))
    r2 = sh2.map_reads(packed, lens, quals)
    assert sh2.escalated >= 6
    fm, ssa = build_fm_index(genome, sa_sample=8, bi_sample=True)
    single = Mapper(fm, ssa, genome,
                    params=MapperParams(max_effort=2, **base))
    rs = single.map_reads(packed, lens, quals)
    for i, (a, b) in enumerate(zip(rs, r2)):
        assert a.aligned == b.aligned, i
        if a.aligned:
            assert (a.pos, a.strand, a.cigar, a.score, a.mapq) == \
                   (b.pos, b.strand, b.cigar, b.score, b.mapq), i
    for r in r2[:6]:
        assert r.aligned and r.second == r.score and r.mapq <= 3
