"""Frozen repeat-dense accuracy regression (VERDICT r2 item 6).

A deterministic 1 Mbp repeat-structured slice (planted ALU-like
high-copy elements, segdups, tandem arrays — utils/simulate.py
repeat_structured_genome) with per-class reads; pins alignment rate,
true-locus accuracy, and MAPQ calibration so repeat handling cannot
regress silently.  This is the CI-sized guard for the full-scale
(3.2 Gbp) repeat campaign, benchsuite/hg_campaign.py.
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import Mapper, MapperParams
from nvbio_tpu.utils.simulate import repeat_structured_genome


@pytest.fixture(scope="module")
def campaign():
    g, info = repeat_structured_genome(
        1_000_000, seed=314, alu_frac=0.08, n_segdups=3,
        segdup_len=30_000, n_tandems=60)
    fm, ssa = build_fm_index(g, sa_sample=8, bi_sample=True)
    m = Mapper(fm, ssa, g, params=MapperParams(
        batch_size=512, sa_sample=8))

    rng = np.random.default_rng(777)
    n = len(g)
    L = 100
    classes = {
        "alu": np.asarray(info["alu_pos"])[
            rng.integers(0, len(info["alu_pos"]), 160)]
        + rng.integers(-120, 120, 160),
        "segdup": np.concatenate([
            np.asarray([d for _s, d, _l in info["segdups"]])[
                rng.integers(0, len(info["segdups"]), 160)]
            + rng.integers(0, 50_000, 160)]),
        "tandem": np.asarray([p for p, _u, _c in info["tandems"]])[
            rng.integers(0, len(info["tandems"]), 160)]
        + rng.integers(0, 400, 160),
        "unique": None,  # filled below: outside every planted region
    }
    # occupancy mask of planted structure (ALU / segdup / tandem):
    # 'unique' reads must start AND end outside it, or their truth is
    # genuinely ambiguous (a read inside a 1%-diverged segdup copy can
    # legitimately map to the other copy)
    occ = np.zeros(n + 1, np.int8)
    al = int(info["alu_len"])
    for p in info["alu_pos"]:
        occ[max(p - L, 0):p + al] = 1
    for s0, d0, ln in info["segdups"]:
        occ[max(s0 - L, 0):s0 + ln] = 1
        occ[max(d0 - L, 0):d0 + ln] = 1
    for p, u, c in info["tandems"]:
        occ[max(p - L, 0):p + u * c] = 1
    free = np.flatnonzero(occ[:n - L] == 0)
    classes["unique"] = free[rng.integers(0, len(free), 160)]
    reads, starts, labels, strands = [], [], [], []
    for cls, pos in classes.items():
        for s in np.clip(pos, 0, n - L - 1):
            frag = g[s:s + L].copy()
            err = rng.random(L) < 0.01
            frag[err] = (frag[err] + 1
                         + rng.integers(0, 3, err.sum())) % 4
            st = int(rng.integers(0, 2))
            if st:
                frag = np.where(frag < 4, 3 - frag, frag)[::-1]
            reads.append(frag)
            starts.append(int(s))
            labels.append(cls)
            strands.append(st)
    seqs = np.stack(reads).astype(np.uint8)
    quals = np.full(seqs.shape, 35, np.uint8)
    lens = np.full(len(reads), L, np.int32)
    res = m.map_reads(seqs, lens, quals)
    return (np.array(starts), np.array(labels), res, m)


def _stats(campaign, cls):
    starts, labels, res, _m = campaign
    i = np.flatnonzero(labels == cls)
    aligned = np.array([res[j].aligned for j in i])
    right = np.array([
        res[j].aligned and abs(res[j].pos - starts[j]) <= 3 for j in i])
    mapq = np.array([res[j].mapq if res[j].aligned else 0 for j in i])
    return aligned, right, mapq


def test_unique_class_near_perfect(campaign):
    aligned, right, _ = _stats(campaign, "unique")
    assert aligned.mean() >= 0.99
    assert right[aligned].mean() >= 0.98


def test_alu_class_accuracy(campaign):
    """5-15%-diverged ALU copies: confidently-placed reads
    (MAPQ >= 20) sit on the owning copy; reads whose window covers too
    few divergent sites are genuinely ambiguous and must NOT be
    confident."""
    aligned, right, mapq = _stats(campaign, "alu")
    assert aligned.mean() >= 0.97
    hi = aligned & (mapq >= 20)
    assert hi.mean() >= 0.5  # most ALU reads are resolvable
    assert right[hi].mean() >= 0.97


def test_segdup_class_xs_and_accuracy(campaign):
    """1-3%-diverged segdups: confident placements are right; copy-
    ambiguous reads demote to low MAPQ instead of guessing."""
    aligned, right, mapq = _stats(campaign, "segdup")
    assert aligned.mean() >= 0.97
    hi = aligned & (mapq >= 20)
    assert right[hi].mean() >= 0.95


def test_mapq_calibration(campaign):
    """High MAPQ must mean low error: wrong-locus rate at MAPQ >= 20
    stays under 5%, and under 1.5% at MAPQ >= 30 (across classes);
    ties (MAPQ <= 3) are allowed to be wrong."""
    starts, labels, res, _m = campaign
    aligned = np.array([r.aligned for r in res])
    right = np.array([
        r.aligned and abs(r.pos - s) <= 3 for r, s in zip(res, starts)])
    mapq = np.array([r.mapq if r.aligned else 0 for r in res])
    hi20 = aligned & (mapq >= 20)
    hi30 = aligned & (mapq >= 30)
    assert hi20.sum() >= 300  # calibration sample is meaningful
    assert (~right[hi20]).mean() <= 0.05
    assert (~right[hi30]).mean() <= 0.015


def test_overflow_surfaced():
    """Escalation under real pressure (VERDICT r3 weak #3): a
    high-copy exact tandem makes every seed exceed ``max_range`` (all
    skipped as repetitive -> round-1 budgets overflow and the reads
    cannot align); the escalation round (max_range x8, locate budgets
    lifted) must then place them.  Asserts the counters fire (> 0),
    flow into MappingStats JSON, and that escalation measurably
    improves placements vs max_effort=1."""
    from nvbio_tpu.utils.stats import MappingStats

    rng = np.random.default_rng(99)
    g = rng.integers(0, 4, 120_000, dtype=np.uint8)
    unit = rng.integers(0, 4, 60, dtype=np.uint8)
    copies, pos = 200, 50_000
    g[pos:pos + 60 * copies] = np.tile(unit, copies)
    fm, ssa = build_fm_index(g, sa_sample=8, bi_sample=True)

    L = 100
    n_reads = 16
    starts = pos + 120 + rng.integers(0, 60 * (copies - 4), n_reads)
    seqs = np.stack([g[s:s + L] for s in starts]).astype(np.uint8)
    lens = np.full(n_reads, L, np.int32)
    quals = np.full(seqs.shape, 35, np.uint8)

    base = dict(batch_size=n_reads, sa_sample=8, max_range=64)
    m1 = Mapper(fm, ssa, g, params=MapperParams(max_effort=1, **base))
    r1 = m1.map_reads(seqs, lens, quals)
    m2 = Mapper(fm, ssa, g, params=MapperParams(max_effort=2, **base))
    r2 = m2.map_reads(seqs, lens, quals)

    # round 1 overflows (every ~200-copy seed range > max_range=64)
    assert m2.overflowed >= n_reads
    assert m2.escalated >= n_reads
    assert m1.escalated == 0
    # escalation places reads the single round could not
    aligned1 = sum(r.aligned for r in r1)
    aligned2 = sum(r.aligned for r in r2)
    assert aligned1 == 0  # all seeds repetitive: round 1 finds nothing
    assert aligned2 >= n_reads - 1
    # every escalated placement lands on a tandem copy: same phase
    # within the unit (position ambiguity across copies is legitimate)
    for r, s in zip(r2, starts):
        if r.aligned:
            assert (r.pos - s) % 60 == 0
            assert pos <= r.pos < pos + 60 * copies

    # counters surface through MappingStats exactly as the CLI wires
    # them (tools/map_reads.py)
    stats = MappingStats()
    stats.observe(r2)
    stats.escalated = m2.escalated
    stats.overflowed = m2.overflowed
    j = stats.summary()
    assert j["escalated"] == m2.escalated > 0
    assert j["overflowed"] == m2.overflowed > 0


def test_extension_budget_escalation_recovers():
    """Extension-budget-ONLY drops must be recovered by escalation
    (VERDICT r4 weak #2): _escalated_params lifts extend_frac to 1.0 so
    each round is a true superset of the previous round's search
    effort.  Setup: 32 copies of a segment — 31 slightly diverged, the
    TRUE (exact) copy at the HIGHEST genome position, so after the
    position-sorted diagonal dedupe it always occupies the last
    candidate rank and is exactly what the slot-rank-major extension
    compaction drops under budget pressure.  With a tiny extend_frac
    the round-1 budget (floor 1024 lanes < ~29 candidates x 64 reads)
    drops the true copy for every read; without the extend_frac lift
    the escalated round would re-drop it (budget still 1024 < ~2100)
    and this test fails."""
    rng = np.random.default_rng(4242)
    g = rng.integers(0, 4, 60_000, dtype=np.uint8)
    L = 100
    seg = rng.integers(0, 4, L, dtype=np.uint8)
    n_copies = 32
    starts_c = 10_000 + 400 * np.arange(n_copies)
    for i, s in enumerate(starts_c[:-1]):  # diverged copies (2 mm each)
        c = seg.copy()
        for p in (45, 75):
            c[p] = (c[p] + 1 + rng.integers(0, 3)) % 4
        g[s:s + L] = c
    p_true = int(starts_c[-1])
    g[p_true:p_true + L] = seg  # exact copy, highest position
    fm, ssa = build_fm_index(g, sa_sample=8, bi_sample=True)

    n_reads = 64
    seqs = np.tile(seg, (n_reads, 1)).astype(np.uint8)
    lens = np.full(n_reads, L, np.int32)
    quals = np.full(seqs.shape, 35, np.uint8)

    base = dict(batch_size=n_reads, sa_sample=8, max_range=64,
                max_candidates=32, max_locate=32, max_hits_per_seed=32,
                locate_frac=1.0,  # keep locate clean: pressure must
                # come from the extension budget alone
                extend_frac=0.1)
    m1 = Mapper(fm, ssa, g, params=MapperParams(max_effort=1, **base))
    r1 = m1.map_reads(seqs, lens, quals)
    # round 1: true copy's candidate (last rank) dropped by the
    # extension budget -> reads settle on a diverged copy
    assert all(r.aligned for r in r1)
    assert all(r.pos != p_true for r in r1)
    assert m1.overflowed >= n_reads  # ext_dropped -> cand_overflow

    m2 = Mapper(fm, ssa, g, params=MapperParams(max_effort=2, **base))
    r2 = m2.map_reads(seqs, lens, quals)
    assert m2.escalated >= n_reads
    # escalated round extends EVERY candidate: exact copy wins
    assert all(r.aligned and r.pos == p_true for r in r2)
