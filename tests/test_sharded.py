"""Sharded FM-index mapping vs a single whole-genome index.

Primary alignments (position/strand/CIGAR/score) must match exactly;
boundary-crossing reads are the interesting case (the ownership rule +
overlap must find them exactly once).
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.fmindex.sharded import (
    build_sharded_index,
    save_sharded_index,
    load_sharded_index,
)
from nvbio_tpu.models import MapperParams
from nvbio_tpu.models.mapper import Mapper
from nvbio_tpu.models.sharded_mapper import ShardedMapper
from nvbio_tpu.strings import pack_reads
from nvbio_tpu.utils.simulate import random_genome


@pytest.fixture(scope="module")
def setup():
    genome = random_genome(150_000, seed=101)
    params = MapperParams(batch_size=64, sa_sample=16, max_candidates=8,
                          lut_k=8)
    rng = np.random.default_rng(102)
    # reads everywhere + deliberately straddling both shard boundaries
    starts = list(rng.integers(0, 150_000 - 100, 48))
    starts += [59_950, 59_990, 119_950, 119_990]  # cross 60k/120k cuts
    seqs = []
    for s in starts:
        frag = genome[s : s + 100].copy()
        p = int(rng.integers(10, 90))
        frag[p] = (frag[p] + 1) % 4
        seqs.append(frag)
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * len(seqs)
    )
    return genome, params, reads, lens, quals.astype(np.int32), starts


def test_sharded_matches_single_index(setup):
    genome, params, reads, lens, quals, starts = setup
    fm, ssa = build_fm_index(genome, sa_sample=16)
    single = Mapper(fm, ssa, genome, params=params)
    r_single = single.map_reads(reads, lens, quals)

    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    assert len(sidx.shards) == 3
    sharded = ShardedMapper(sidx, genome, params=params)
    r_sharded = sharded.map_reads(reads, lens, quals)

    for i, (a, b) in enumerate(zip(r_single, r_sharded)):
        assert a.aligned == b.aligned, i
        if a.aligned:
            assert (a.pos, a.strand, a.cigar, a.score, a.md, a.nm) == \
                   (b.pos, b.strand, b.cigar, b.score, b.md, b.nm), i
    # the boundary reads must be found at their true positions
    for i in range(len(starts) - 4, len(starts)):
        assert r_sharded[i].aligned
        assert r_sharded[i].pos == starts[i]


def test_sharded_all_mode_matches_single_index(setup):
    """--all on a sharded index: same per-read alignment sets as the
    whole-genome index (positions/strand/score), overlap-visible hits
    exactly once.  Uses a genome with a duplicated block so reads have
    genuine multi-mappings, including across shards."""
    genome, params, _, _, _, _ = setup
    # duplicate a 20k block from shard 0 into shard 2's territory
    g = genome.copy()
    g[125_000:145_000] = g[10_000:30_000]
    rng = np.random.default_rng(7)
    starts = list(rng.integers(10_000, 30_000 - 100, 12))  # multimappers
    starts += list(rng.integers(60_000, 100_000 - 100, 8))  # unique
    starts += [59_960, 119_980]  # boundary
    seqs = [g[s:s + 100].copy() for s in starts]
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * len(seqs)
    )
    quals = quals.astype(np.int32)

    fm, ssa = build_fm_index(g, sa_sample=16)
    single = Mapper(fm, ssa, g, params=params)
    a_single = single.map_reads_all(reads, lens, quals, max_alns=6)

    sidx = build_sharded_index(g, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    sharded = ShardedMapper(sidx, g, params=params)
    a_sharded = sharded.map_reads_all(reads, lens, quals, max_alns=6)

    key = lambda alns: sorted((a.pos, a.strand, a.score) for a in alns)
    n_multi = 0
    for i, (xs, ys) in enumerate(zip(a_single, a_sharded)):
        assert key(xs) == key(ys), f"read {i}"
        n_multi += len(ys) > 1
    assert n_multi >= 10  # the duplicated block must yield multimappers


def test_sharded_paired_matches_single_index(setup):
    """PE over a sharded index: pair decisions, positions, scores and
    MAPQ must match the single-index PairedMapper, including pairs
    whose fragments straddle shard boundaries."""
    from nvbio_tpu.models.paired import PairedMapper
    from nvbio_tpu.models.sharded_mapper import PairedShardedMapper
    from nvbio_tpu.utils.simulate import simulate_pairs

    genome, _, _, _, _, _ = setup
    params = MapperParams(batch_size=64, sa_sample=16, max_candidates=8,
                          lut_k=8, minins=0, maxins=400)
    rng = np.random.default_rng(5)
    sim = simulate_pairs(genome, 56, 100, insert_mean=250, insert_sd=25,
                         seed=12)
    s1, s2 = sim["seqs1"].copy(), sim["seqs2"].copy()
    # overwrite the last 8 pairs with boundary-straddling fragments
    for j, fs in enumerate([59_820, 59_900, 59_960, 59_990,
                            119_820, 119_900, 119_960, 119_990]):
        i = 48 + j
        ins = 250
        s1[i] = genome[fs:fs + 100]
        frag2 = genome[fs + ins - 100:fs + ins]
        s2[i] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    lens = np.full(56, 100, np.int32)
    q = np.full((56, 100), 35, np.uint8)

    fm, ssa = build_fm_index(genome, sa_sample=16)
    single = PairedMapper(fm, ssa, genome, params=params)
    r1s, r2s, infos = single.map_pairs(s1, lens, q, s2, lens, q)

    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    sh = PairedShardedMapper(sidx, genome, params=params)
    r1h, r2h, infoh = sh.map_pairs(s1, lens, q, s2, lens, q)

    for i in range(56):
        assert infos[i] == infoh[i], i
        for a, b in ((r1s[i], r1h[i]), (r2s[i], r2h[i])):
            assert a.aligned == b.aligned, i
            if a.aligned:
                assert (a.pos, a.strand, a.cigar, a.score, a.mapq,
                        a.md, a.nm, a.second) == \
                       (b.pos, b.strand, b.cigar, b.score, b.mapq,
                        b.md, b.nm, b.second), i
    # the straddling pairs must be proper at their true loci
    for j, fs in enumerate([59_820, 59_900, 59_960, 59_990,
                            119_820, 119_900, 119_960, 119_990]):
        i = 48 + j
        assert infoh[i]["proper"], i
        assert r1h[i].pos == fs, i


def test_sharded_paired_boundary_rescue(setup):
    """Rescue-only pairs whose reverse-strand anchor sits just right of
    a shard boundary: the anchor's rescue window extends left past the
    shard start, so the pair must be rescued by the PREVIOUS shard
    (anchoring on the unmasked reduction).  Regression for a confirmed
    round-1 review finding."""
    from nvbio_tpu.models.paired import PairedMapper
    from nvbio_tpu.models.sharded_mapper import PairedShardedMapper

    genome, _, _, _, _, _ = setup
    params = MapperParams(batch_size=64, sa_sample=16, max_candidates=8,
                          lut_k=8, minins=0, maxins=400)
    n_pairs, L, ins = 8, 100, 350
    # mate1 fwd at fs (left of boundary), mate2 rev anchored just right
    fss = [59_760, 59_700, 119_760, 119_700, 59_810, 119_810,
           30_000, 90_000]
    s1 = np.zeros((n_pairs, L), np.uint8)
    s2 = np.zeros((n_pairs, L), np.uint8)
    for i, fs in enumerate(fss):
        m1 = genome[fs:fs + L].copy()
        # corrupt mate1's seeds so only rescue can place it
        for k in range(4, L, 12):
            m1[k] = (m1[k] + 1) % 4
        s1[i] = m1
        frag2 = genome[fs + ins - L:fs + ins]
        s2[i] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    lens = np.full(n_pairs, L, np.int32)
    q = np.full((n_pairs, L), 35, np.uint8)

    fm, ssa = build_fm_index(genome, sa_sample=16)
    single = PairedMapper(fm, ssa, genome, params=params)
    r1s, r2s, infos = single.map_pairs(s1, lens, q, s2, lens, q)

    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    sh = PairedShardedMapper(sidx, genome, params=params)
    r1h, r2h, infoh = sh.map_pairs(s1, lens, q, s2, lens, q)

    for i, fs in enumerate(fss):
        assert infos[i]["proper"], f"single missed pair {i}"
        assert infoh[i]["proper"], f"sharded missed pair {i} (fs={fs})"
        assert r1h[i].aligned and r1h[i].pos == r1s[i].pos == fs, i
        assert (r1h[i].score, r1h[i].mapq, r2h[i].pos) == \
               (r1s[i].score, r1s[i].mapq, r2s[i].pos), i


def test_sharded_paired_overlap_guard(setup):
    from nvbio_tpu.models.sharded_mapper import PairedShardedMapper

    genome, _, _, _, _, _ = setup
    params = MapperParams(batch_size=64, sa_sample=16, maxins=400)
    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=256,
                               sa_sample=16, lut_k=0)
    with pytest.raises(ValueError, match="overlap"):
        PairedShardedMapper(sidx, genome, params=params)


def test_sharded_save_load_roundtrip(setup, tmp_path):
    genome, params, reads, lens, quals, starts = setup
    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    prefix = str(tmp_path / "sharded")
    save_sharded_index(prefix, sidx, genome, ["chr1"], [len(genome)])
    sidx2, genome2, man = load_sharded_index(prefix)
    np.testing.assert_array_equal(genome2, genome.astype(np.int8))
    assert man["lut_k"] == 8
    m = ShardedMapper(sidx2, genome2.astype(np.uint8), params=params)
    res = m.map_reads(reads, lens, quals)
    n_ok = sum(1 for i, r in enumerate(res)
               if r.aligned and r.pos == starts[i])
    assert n_ok >= len(starts) - 2


def test_strip_bi_ssa_preserves_locate():
    """A bi-marked SSA stripped to mono marks locates identically."""
    import jax.numpy as jnp
    from nvbio_tpu.fmindex import build_fm_index, locate
    from nvbio_tpu.fmindex.sharded import _strip_bi_ssa
    from nvbio_tpu.utils.simulate import random_genome

    g = random_genome(40_000, seed=91)
    fm, ssa_bi = build_fm_index(g, sa_sample=8, bi_sample=True)
    _, ssa_mono = build_fm_index(g, sa_sample=8, bi_sample=False)
    stripped = _strip_bi_ssa(ssa_bi)
    np.testing.assert_array_equal(np.asarray(stripped.mark_words),
                                  np.asarray(ssa_mono.mark_words))
    np.testing.assert_array_equal(np.asarray(stripped.vals),
                                  np.asarray(ssa_mono.vals))
    rows = jnp.asarray(
        np.random.default_rng(3).integers(0, len(g), 512).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(locate(fm, stripped, rows, k_sample=8)),
        np.asarray(locate(fm, ssa_mono, rows, k_sample=8)))


def test_sharded_fm2_modes_bit_identical(setup):
    """fm2_mode off / resident / stream (shard-major, one pair-BWT
    resident at a time) produce bit-identical SE results — the 2-step
    index is an acceleration, never a semantic change."""
    genome, params, reads, lens, quals, starts = setup
    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)

    def run(mode, stream):
        m = ShardedMapper(sidx, genome, params=params,
                          fm2_mode=mode)
        assert m.fm2_mode == mode
        if not stream:
            return m.map_reads(reads, lens, quals)
        it = iter([
            (["a"] * 30, reads[:30], lens[:30], quals[:30]),
            (["b"] * (len(lens) - 30), reads[30:], lens[30:],
             quals[30:]),
        ])
        out = []
        for _nm, _sq, _ln, _ql, res in m.map_stream(it):
            out.extend(res)
        return out

    base = run("off", False)
    for mode, stream in (("resident", False), ("off", True),
                         ("stream", True)):
        got = run(mode, stream)
        assert len(got) == len(base)
        for i, (a, b) in enumerate(zip(base, got)):
            assert a.aligned == b.aligned, (mode, stream, i)
            if a.aligned:
                assert (a.pos, a.strand, a.cigar, a.score, a.mapq,
                        a.md, a.nm) == \
                       (b.pos, b.strand, b.cigar, b.score, b.mapq,
                        b.md, b.nm), (mode, stream, i)


def test_sharded_pe_fm2_stream_matches(setup):
    """PE shard-major fm2 streaming == batch-major (off), per mate and
    per pair decision."""
    from nvbio_tpu.models.sharded_mapper import PairedShardedMapper
    from nvbio_tpu.utils.simulate import simulate_pairs

    genome, _, _, _, _, _ = setup
    params = MapperParams(batch_size=32, sa_sample=16, max_candidates=8,
                          lut_k=8, minins=0, maxins=400)
    sim = simulate_pairs(genome, 32, 100, insert_mean=250, insert_sd=25,
                         seed=21)
    s1, s2 = sim["seqs1"], sim["seqs2"]
    lens = np.full(32, 100, np.int32)
    q = np.full((32, 100), 35, np.uint8)
    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)

    def run(mode):
        m = PairedShardedMapper(sidx, genome, params=params,
                                fm2_mode=mode)
        it = iter([
            (["a"] * 16, s1[:16], lens[:16], q[:16], s2[:16],
             lens[:16], q[:16]),
            (["b"] * 16, s1[16:], lens[16:], q[16:], s2[16:],
             lens[16:], q[16:]),
        ])
        r1, r2, info = [], [], []
        for out in m.map_pairs_stream(it):
            r1.extend(out[-3])
            r2.extend(out[-2])
            info.extend(out[-1])
        return r1, r2, info

    b1, b2, binfo = run("off")
    g1, g2, ginfo = run("stream")
    assert binfo == ginfo
    for i in range(32):
        for a, b in ((b1[i], g1[i]), (b2[i], g2[i])):
            assert a.aligned == b.aligned, i
            if a.aligned:
                assert (a.pos, a.strand, a.cigar, a.score, a.mapq,
                        a.md, a.nm, a.second) == \
                       (b.pos, b.strand, b.cigar, b.score, b.mapq,
                        b.md, b.nm, b.second), i


def test_tail_sliver_folds_into_previous_shard(tmp_path):
    """A trailing segment no longer than the overlap must NOT become
    its own shard (a sliver shard costs a full per-batch candidate
    stage — batch-shaped, not text-shaped): its ownership folds into
    the previous shard, whose overlap already covers it.  Reads
    planted in the tail must still map exactly; older manifests with
    a sliver shard fold at load."""
    genome = random_genome(2 * 30_000 + 1024, seed=707)  # tail == ovl
    params = MapperParams(batch_size=32, sa_sample=16,
                          max_candidates=8, lut_k=8)
    sidx = build_sharded_index(genome, shard_bp=30_000, overlap=1024,
                               sa_sample=16, lut_k=8)
    assert len(sidx.shards) == 2  # NOT 3: the 1024 bp tail folded
    assert sidx.shards[-1][3] + sidx.shards[-1][4] == len(genome)

    fm, ssa = build_fm_index(genome, sa_sample=16)
    single = Mapper(fm, ssa, genome, params=params)
    sharded = ShardedMapper(sidx, genome, params=params)
    # reads inside and straddling the folded tail region
    starts = [60_000 - 80, 60_000 - 40, 60_000 + 900,
              len(genome) - 100, 15_000]
    seqs = [genome[s:s + 100].copy() for s in starts]
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * len(seqs))
    ra = single.map_reads(reads, lens, quals.astype(np.int32))
    rb = sharded.map_reads(reads, lens, quals.astype(np.int32))
    for i, (a, b) in enumerate(zip(ra, rb)):
        assert a.aligned and b.aligned, i
        assert (a.pos, a.strand, a.cigar, a.score) == \
               (b.pos, b.strand, b.cigar, b.score), i
        assert b.pos == starts[i], i

    # load-time folding of an OLD manifest that still has the sliver:
    # simulate by rebuilding with folding disabled via a direct
    # 3-entry manifest (save the 2-shard index, then append a fake
    # entry duplicating the covered tail is not constructible here,
    # so instead assert save/load round-trips the folded layout)
    save_sharded_index(str(tmp_path / "t"), sidx, genome, ["c"],
                       [len(genome)])
    idx2, g2, man = load_sharded_index(str(tmp_path / "t"))
    assert len(idx2.shards) == 2
