"""Shard-per-chip mesh mapping vs the sequential sharded mapper.

Runs on the 8-virtual-device CPU mesh (conftest.py) — the CI stand-in
for a real multi-chip slice, exercising the actual shard_map +
all_gather/psum collective layout of models/mesh_sharded.py.
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex.sharded import build_sharded_index
from nvbio_tpu.models.params import MapperParams
from nvbio_tpu.utils.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def setup():
    genome = random_genome(180_000, seed=31)
    sim = simulate_reads(genome, 96, 100, seed=32)
    lens = np.full(96, 100, np.int32)
    quals = np.full((96, 100), 35, np.uint8)
    return genome, sim["seqs"].astype(np.uint8), lens, quals, sim


def _map_both(genome, seqs, lens, quals, n_shards, params):
    from nvbio_tpu.models.sharded_mapper import ShardedMapper
    from nvbio_tpu.models.mesh_sharded import MeshShardedMapper

    sidx = build_sharded_index(
        genome, shard_bp=(len(genome) + n_shards - 1) // n_shards,
        overlap=2048, sa_sample=16, lut_k=8)
    assert len(sidx.shards) == n_shards
    seq = ShardedMapper(sidx, genome, params=params)
    mesh = MeshShardedMapper(sidx, genome, params=params)
    rs = seq.map_reads(seqs, lens, quals)
    rm = mesh.map_reads(seqs, lens, quals)
    return rs, rm, seq, mesh


@pytest.mark.parametrize("n_shards", [3, 4])
def test_mesh_matches_sequential(setup, n_shards):
    """Every field of every read's result is bit-identical between the
    shard-per-device mesh schedule and the sequential one."""
    genome, seqs, lens, quals, sim = setup
    params = MapperParams(batch_size=96, sa_sample=16, max_candidates=8,
                          lut_k=8)
    rs, rm, seq, mesh = _map_both(genome, seqs, lens, quals, n_shards,
                                  params)
    n_aligned = 0
    for i, (a, b) in enumerate(zip(rs, rm)):
        assert a.aligned == b.aligned, i
        if a.aligned:
            n_aligned += 1
            assert (a.pos, a.strand, a.cigar, a.score, a.mapq, a.md,
                    a.nm, a.second) == \
                   (b.pos, b.strand, b.cigar, b.score, b.mapq, b.md,
                    b.nm, b.second), i
    assert n_aligned >= 90
    # both schedules saw the same locate-budget pressure
    assert mesh.locate_dropped == seq.locate_dropped


def test_mesh_batch_not_divisible_rejected(setup):
    from nvbio_tpu.models.mesh_sharded import MeshShardedMapper

    genome, *_ = setup
    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    with pytest.raises(ValueError, match="divide"):
        MeshShardedMapper(sidx, genome,
                          params=MapperParams(batch_size=100,
                                              sa_sample=16))


def test_mesh_paired_matches_sequential(setup):
    """PE over the mesh: pair decisions, positions, scores, MAPQ and
    XS must be bit-identical to the sequential PairedShardedMapper
    (which itself matches the single-index PairedMapper — see
    test_sharded.py), including boundary-straddling fragments."""
    from nvbio_tpu.models.sharded_mapper import PairedShardedMapper
    from nvbio_tpu.models.mesh_sharded import MeshPairedShardedMapper
    from nvbio_tpu.utils.simulate import simulate_pairs

    genome, *_ = setup
    params = MapperParams(batch_size=48, sa_sample=16, max_candidates=8,
                          lut_k=8, minins=0, maxins=400)
    sim = simulate_pairs(genome, 56, 100, insert_mean=250, insert_sd=25,
                         seed=12)
    s1, s2 = sim["seqs1"].copy(), sim["seqs2"].copy()
    # boundary-straddling fragments across the 60 kb shard edges
    for j, fs in enumerate([59_820, 59_900, 59_960, 59_990,
                            119_820, 119_900, 119_960, 119_990]):
        i = 48 + j
        s1[i] = genome[fs:fs + 100]
        frag2 = genome[fs + 250 - 100:fs + 250]
        s2[i] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    lens = np.full(56, 100, np.int32)
    q = np.full((56, 100), 35, np.uint8)

    sidx = build_sharded_index(genome, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    seq = PairedShardedMapper(sidx, genome, params=params)
    r1s, r2s, infos = seq.map_pairs(s1, lens, q, s2, lens, q)
    mesh = MeshPairedShardedMapper(sidx, genome, params=params)
    r1m, r2m, infom = mesh.map_pairs(s1, lens, q, s2, lens, q)

    n_proper = 0
    for i in range(56):
        assert infos[i] == infom[i], i
        n_proper += infom[i]["proper"]
        for a, b in ((r1s[i], r1m[i]), (r2s[i], r2m[i])):
            assert a.aligned == b.aligned, i
            if a.aligned:
                assert (a.pos, a.strand, a.cigar, a.score, a.mapq,
                        a.md, a.nm, a.second) == \
                       (b.pos, b.strand, b.cigar, b.score, b.mapq,
                        b.md, b.nm, b.second), i
    assert n_proper >= 50
    # straddling pairs proper at their true loci on the mesh too
    for j, fs in enumerate([59_820, 119_990]):
        i = 48 + (0 if j == 0 else 7)
        assert infom[i]["proper"] and r1m[i].aligned


def test_mesh_all_matches_sequential(setup):
    """--all over the mesh: per-read alignment lists must match the
    sequential sharded --all exactly (count, order, positions)."""
    from nvbio_tpu.models.sharded_mapper import ShardedMapper
    from nvbio_tpu.models.mesh_sharded import MeshShardedMapper

    genome, seqs, lens, quals, _ = setup
    # plant a duplicated block so --all has multi-mapping work
    g = genome.copy()
    g[150_000:152_000] = g[30_000:32_000]
    params = MapperParams(batch_size=48, sa_sample=16, max_candidates=8,
                          lut_k=8)
    sidx = build_sharded_index(g, shard_bp=60_000, overlap=2048,
                               sa_sample=16, lut_k=8)
    # reads from the duplicated block + ordinary reads
    reads = np.stack([g[30_000 + 37 * i: 30_100 + 37 * i]
                      for i in range(24)]).astype(np.uint8)
    lens24 = np.full(24, 100, np.int32)
    quals24 = np.full((24, 100), 35, np.uint8)

    seq = ShardedMapper(sidx, g, params=params)
    mesh = MeshShardedMapper(sidx, g, params=params)
    alls = seq.map_reads_all(reads, lens24, quals24, max_alns=4)
    allm = mesh.map_reads_all(reads, lens24, quals24, max_alns=4)
    n_multi = 0
    for i, (xs, ys) in enumerate(zip(alls, allm)):
        assert len(xs) == len(ys), i
        n_multi += len(ys) > 1
        for a, b in zip(xs, ys):
            assert (a.pos, a.strand, a.cigar, a.score) == \
                   (b.pos, b.strand, b.cigar, b.score), i
    assert n_multi >= 20  # the duplicated block must yield multimappers


def test_mesh_partial_batch(setup):
    """Reads not filling batch_size (host-side pad path) still match."""
    genome, seqs, lens, quals, _ = setup
    params = MapperParams(batch_size=64, sa_sample=16, max_candidates=8,
                          lut_k=8)
    rs, rm, _, _ = _map_both(genome, seqs[:40], lens[:40], quals[:40],
                             4, params)
    for i, (a, b) in enumerate(zip(rs, rm)):
        assert (a.aligned, a.pos if a.aligned else 0,
                a.cigar if a.aligned else "") == \
               (b.aligned, b.pos if b.aligned else 0,
                b.cigar if b.aligned else ""), i
