"""FM-index vs brute force — exact equality (SURVEY.md §5.1:
fmindex_test pattern: build small index, match/locate vs brute force)."""

import numpy as np
import jax.numpy as jnp

from nvbio_tpu.fmindex import (
    build_fm_index,
    backward_search,
    rank,
    bwt_symbol,
    locate,
)
from nvbio_tpu.sufsort import suffix_array, bwt_from_sa


def _brute_sa(text):
    n = len(text)
    suf = sorted(range(n), key=lambda i: tuple(text[i:]))
    return np.array(suf, dtype=np.int64)


def test_suffix_array_small():
    rng = np.random.default_rng(0)
    for n in [1, 2, 5, 13, 100, 257]:
        t = rng.integers(0, 4, n).astype(np.uint8)
        np.testing.assert_array_equal(suffix_array(t), _brute_sa(t))


def test_suffix_array_repetitive():
    t = np.tile(np.array([0, 1, 0, 1, 0], dtype=np.uint8), 40)
    np.testing.assert_array_equal(suffix_array(t), _brute_sa(t))


def test_rank_matches_cumsum():
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    fm, ssa = build_fm_index(text)
    sa = suffix_array(text)
    bwt, primary = bwt_from_sa(text, sa)
    # true occ over BWT *excluding* the sentinel slot
    true_bwt = bwt.astype(np.int64).copy()
    true_bwt[primary] = -1
    qs = rng.integers(0, len(bwt) + 1, 300).astype(np.int32)
    cs = rng.integers(0, 4, 300).astype(np.int32)
    expect = np.array([(true_bwt[:q] == c).sum() for q, c in zip(qs, cs)])
    got = np.asarray(rank(fm, jnp.asarray(cs), jnp.asarray(qs)))
    np.testing.assert_array_equal(got, expect)
    # bwt_symbol readback
    idx = rng.integers(0, len(bwt), 100).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(bwt_symbol(fm, jnp.asarray(idx))), bwt[idx]
    )


def test_backward_search_and_locate():
    rng = np.random.default_rng(2)
    n = 20000
    text = rng.integers(0, 4, n).astype(np.uint8)
    fm, ssa = build_fm_index(text, sa_sample=16)

    L = 12
    n_seeds = 200
    # half sampled from the text (guaranteed hits), half random
    starts = rng.integers(0, n - L, n_seeds // 2)
    seeds = np.concatenate(
        [
            np.stack([text[s : s + L] for s in starts]),
            rng.integers(0, 4, (n_seeds // 2, L)),
        ]
    ).astype(np.int32)
    # one seed with an N: must return an empty range
    seeds[0, 3] = 4

    lo, hi = backward_search(fm, jnp.asarray(seeds))
    lo, hi = np.asarray(lo), np.asarray(hi)

    tb = text.tobytes()
    for s in range(n_seeds):
        pat = seeds[s].astype(np.uint8)
        if (pat > 3).any():
            assert hi[s] - lo[s] == 0
            continue
        # brute-force occurrence count
        pb = pat.tobytes()
        cnt = 0
        positions = []
        start = 0
        while True:
            p = tb.find(pb, start)
            if p < 0:
                break
            positions.append(p)
            cnt += 1
            start = p + 1
        assert hi[s] - lo[s] == cnt, f"seed {s}: {hi[s]-lo[s]} != {cnt}"
        if cnt:
            # locate every hit; as a set they must equal brute force
            idx = jnp.arange(lo[s], hi[s], dtype=jnp.int32)
            pos = np.asarray(locate(fm, ssa, idx, k_sample=16))
            assert sorted(pos.tolist()) == positions, f"seed {s}"


def test_locate_all_rows():
    rng = np.random.default_rng(3)
    n = 3000
    text = rng.integers(0, 4, n).astype(np.uint8)
    fm, ssa = build_fm_index(text, sa_sample=8)
    sa = suffix_array(text)
    sa_full = np.concatenate([[n], sa])
    idx = jnp.arange(n + 1, dtype=jnp.int32)
    pos = np.asarray(locate(fm, ssa, idx, k_sample=8))
    np.testing.assert_array_equal(pos, sa_full)


def test_kmer_lut_search_matches_plain():
    """LUT-seeded backward search == plain scan (SURVEY.md §7.3(2))."""
    import jax.numpy as jnp
    from nvbio_tpu.fmindex import build_fm_index, backward_search
    from nvbio_tpu.fmindex.build import build_kmer_lut

    rng = np.random.default_rng(8)
    n = 20000
    text = rng.integers(0, 4, n).astype(np.uint8)
    sa = suffix_array(text)
    fm, _ = build_fm_index(text, sa_sample=16, sa=sa)
    for k in (4, 8, 11):
        lut = build_kmer_lut(text, sa, k=k)
        lut_j = (jnp.asarray(lut[0]), jnp.asarray(lut[1]))
        L = 22
        seeds = rng.integers(0, 4, (200, L)).astype(np.int32)
        for i in range(0, 200, 2):
            s = rng.integers(0, n - L)
            seeds[i] = text[s : s + L]
        seeds[1, L - 2] = 4  # N in tail
        seeds[3, 0] = 4  # N in head
        lo1, hi1 = backward_search(fm, jnp.asarray(seeds))
        lo2, hi2 = backward_search(fm, jnp.asarray(seeds), lut=lut_j,
                                   lut_k=k)
        sz1 = np.asarray(hi1 - lo1)
        sz2 = np.asarray(hi2 - lo2)
        np.testing.assert_array_equal(sz1 > 0, sz2 > 0)
        ne = sz1 > 0
        np.testing.assert_array_equal(np.asarray(lo1)[ne],
                                      np.asarray(lo2)[ne])
        np.testing.assert_array_equal(np.asarray(hi1)[ne],
                                      np.asarray(hi2)[ne])


def test_mapper_with_lut_identical_results():
    import jax.numpy as jnp
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.fmindex.build import build_kmer_lut
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.mapper import Mapper
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads

    genome = random_genome(50_000, seed=61)
    sa = suffix_array(genome)
    params = MapperParams(batch_size=32, sa_sample=16, max_candidates=8,
                          lut_k=11)
    fm, ssa = build_fm_index(genome, sa_sample=16, sa=sa)
    lut_np = build_kmer_lut(genome, sa, k=11)
    lut = (jnp.asarray(lut_np[0]), jnp.asarray(lut_np[1]))
    sim = simulate_reads(genome, 32, 100, seed=62, error_rate=0.02)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    quals = quals.astype(np.int32)
    m0 = Mapper(fm, ssa, genome, params=params)
    m1 = Mapper(fm, ssa, genome, params=params, lut=lut)
    r0 = m0.map_reads(reads, lens, quals)
    r1 = m1.map_reads(reads, lens, quals)
    for a, b in zip(r0, r1):
        assert (a.aligned, a.pos, a.strand, a.cigar, a.score, a.mapq) == \
               (b.aligned, b.pos, b.strand, b.cigar, b.score, b.mapq)


def test_locate_compact_matches_direct_and_overflow():
    """locate_compact == direct locate for every kept slot; on
    capacity overflow the globally least-prioritized slots (highest
    slot-rank) are dropped, never mid-rank ones."""
    from nvbio_tpu.fmindex.index import locate
    from nvbio_tpu.models.mapper import locate_compact

    from nvbio_tpu.utils.simulate import random_genome as _rg
    genome = _rg(30_000, seed=71)
    fm, ssa = build_fm_index(genome, sa_sample=8)
    rng = np.random.default_rng(72)
    N, K = 256, 16
    rows = jnp.asarray(rng.integers(0, 30_000, (N, K), dtype=np.int32))
    ok = jnp.asarray(rng.random((N, K)) < 0.3)
    direct = np.asarray(locate(fm, ssa, rows.reshape(-1), k_sample=8)
                        ).reshape(N, K)
    # ample capacity: every valid slot located, values equal
    pos, kept, ndrop = locate_compact(fm, ssa, rows, ok, k_sample=8,
                                      capacity=N * K)
    kept = np.asarray(kept)
    assert int(ndrop) == 0
    np.testing.assert_array_equal(kept, np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(pos)[kept], direct[kept])
    # tight capacity: kept is a slot-rank-prefix of ok (rank-major)
    cap = int(np.asarray(ok).sum()) // 2
    pos2, kept2, ndrop2 = locate_compact(fm, ssa, rows, ok, k_sample=8,
                                         capacity=cap)
    kept2 = np.asarray(kept2)
    assert kept2.sum() == cap
    assert int(ndrop2) == int(np.asarray(ok).sum()) - cap
    assert (kept2 <= np.asarray(ok)).all()
    okT = np.asarray(ok).T.reshape(-1)
    keptT = kept2.T.reshape(-1)
    # the kept set is exactly the first `cap` valid slots in rank-major
    # order
    np.testing.assert_array_equal(
        np.nonzero(keptT)[0], np.nonzero(okT)[0][:cap])
    np.testing.assert_array_equal(np.asarray(pos2)[kept2], direct[kept2])


def test_fused_rank_paths_bit_identical():
    """The fused block-row rank/LF (FMIndex.fused, one gather per
    step) must be bit-identical to the 3-gather layout on rank,
    backward search (with and without LUT) and the SSA locate walk."""
    import numpy as np
    import jax.numpy as jnp
    from nvbio_tpu.fmindex import build_fm_index, backward_search, locate
    from nvbio_tpu.fmindex.index import fuse_occ, rank
    from nvbio_tpu.fmindex.build import build_kmer_lut

    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 30_011, dtype=np.uint8)
    fm, ssa = build_fm_index(g, sa_sample=8)
    fmf = fuse_occ(fm)

    ii = jnp.asarray(rng.integers(0, len(g) + 1, 512, dtype=np.int32))
    for c in range(4):
        cc = jnp.full(ii.shape, c, jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(rank(fm, cc, ii)), np.asarray(rank(fmf, cc, ii)))

    starts = rng.integers(0, len(g) - 22, 256)
    seeds = jnp.asarray(np.stack([g[s:s + 22] for s in starts])
                        .astype(np.int32))
    lo1, hi1 = backward_search(fm, seeds)
    lo2, hi2 = backward_search(fmf, seeds)
    np.testing.assert_array_equal(np.asarray(lo1), np.asarray(lo2))
    np.testing.assert_array_equal(np.asarray(hi1), np.asarray(hi2))
    lut = tuple(jnp.asarray(x) for x in build_kmer_lut(g, k=8))
    lo3, hi3 = backward_search(fmf, seeds, lut=lut, lut_k=8)
    np.testing.assert_array_equal(np.asarray(lo1), np.asarray(lo3))
    np.testing.assert_array_equal(np.asarray(hi1), np.asarray(hi3))

    rows = jnp.asarray(rng.integers(0, len(g) + 1, 512, dtype=np.int32))
    np.testing.assert_array_equal(
        np.asarray(locate(fm, ssa, rows, k_sample=8)),
        np.asarray(locate(fmf, ssa, rows, k_sample=8)))
