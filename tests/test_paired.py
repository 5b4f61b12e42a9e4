"""Paired-end pipeline: concordant pairing, rescue, SAM pair flags."""

import math

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import MapperParams
from nvbio_tpu.models.paired import PairedMapper
from nvbio_tpu.utils.simulate import random_genome, simulate_pairs

GENOME_N = 80_000
N_PAIRS = 32
READ_LEN = 80


@pytest.fixture(scope="module")
def pmapper():
    genome = random_genome(GENOME_N, seed=17)
    params = MapperParams(batch_size=N_PAIRS, sa_sample=16,
                          max_candidates=8, minins=0, maxins=400)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    return PairedMapper(fm, ssa, genome, params=params), genome


def test_paired_end_to_end(pmapper):
    m, genome = pmapper
    sim = simulate_pairs(genome, N_PAIRS, READ_LEN, insert_mean=250,
                         insert_sd=25, seed=4)
    l1 = np.full(N_PAIRS, READ_LEN, np.int32)
    res1, res2, info = m.map_pairs(
        sim["seqs1"], l1, sim["quals1"], sim["seqs2"], l1, sim["quals2"]
    )
    n_proper = sum(i["proper"] for i in info)
    assert n_proper >= int(0.9 * N_PAIRS), f"only {n_proper} proper pairs"

    correct = 0
    for r in range(N_PAIRS):
        if not (res1[r].aligned and res2[r].aligned):
            continue
        # FR: mate1 fwd at fragment start, mate2 rev at fragment end
        frag_start = int(sim["true_pos"][r])
        frag_end = frag_start + int(sim["insert"][r])
        ok1 = res1[r].strand == 0 and abs(res1[r].pos - frag_start) <= 5
        ok2 = res2[r].strand == 1 and abs(
            res2[r].pos + READ_LEN - frag_end) <= 5
        if ok1 and ok2:
            correct += 1
    assert correct >= int(0.85 * N_PAIRS), f"{correct}/{N_PAIRS} correct"


def test_paired_sam_flags(pmapper):
    m, genome = pmapper
    sim = simulate_pairs(genome, N_PAIRS, READ_LEN, insert_mean=250,
                         seed=6)
    l1 = np.full(N_PAIRS, READ_LEN, np.int32)
    res1, res2, info = m.map_pairs(
        sim["seqs1"], l1, sim["quals1"], sim["seqs2"], l1, sim["quals2"]
    )
    names = [f"p{i}" for i in range(N_PAIRS)]
    recs = m.to_sam_records_pe(
        names, sim["seqs1"], l1, sim["quals1"],
        sim["seqs2"], l1, sim["quals2"], res1, res2, info,
    )
    assert len(recs) == 2 * N_PAIRS
    for i in range(0, len(recs), 2):
        r1, r2 = recs[i], recs[i + 1]
        assert r1.flag & 0x1 and r2.flag & 0x1  # paired
        assert (r1.flag & 0x40) and (r2.flag & 0x80)  # read1/read2
        if r1.flag & 0x2:  # proper pair
            assert r2.flag & 0x2
            assert {r1.flag & 0x10, r2.flag & 0x10} == {0, 0x10}  # FR
            assert r1.tlen == -r2.tlen and r1.tlen != 0
            assert r1.rnext == "=" and r2.rnext == "="


def test_paired_xs_and_ambiguous_mapq():
    """Mates landing in a duplicated segment must carry XS (their own
    second-best, ref: reduce_inl.h best2 per mate) and a low pair-aware
    MAPQ; unique mates must have neither."""
    g0 = random_genome(60_000, seed=23)
    genome = np.concatenate([g0, g0[:20_000]])  # exact duplicate
    params = MapperParams(batch_size=N_PAIRS, sa_sample=16,
                          max_candidates=8, minins=0, maxins=400)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    m = PairedMapper(fm, ssa, genome, params=params)
    rng = np.random.default_rng(3)
    ins = 250
    # half the pairs from the duplicated prefix, half from unique middle
    starts = np.concatenate([
        rng.integers(0, 20_000 - ins - READ_LEN, N_PAIRS // 2),
        rng.integers(25_000, 55_000 - ins - READ_LEN, N_PAIRS // 2),
    ])
    r1 = np.stack([genome[s:s + READ_LEN] for s in starts])
    r2f = np.stack([genome[s + ins - READ_LEN:s + ins] for s in starts])
    r2 = np.where(r2f < 4, 3 - r2f, r2f)[:, ::-1].astype(r2f.dtype)
    q = np.full((N_PAIRS, READ_LEN), 35, np.uint8)
    lens = np.full(N_PAIRS, READ_LEN, np.int32)
    res1, res2, info = m.map_pairs(r1, lens, q, r2, lens, q)
    names = [f"p{i}" for i in range(N_PAIRS)]
    recs = m.to_sam_records_pe(names, r1, lens, q, r2, lens, q,
                               res1, res2, info)
    dup = {f"p{i}" for i in range(N_PAIRS // 2)}
    for r in recs:
        if r.flag & 0x4:
            continue
        has_xs = any(t[0] == "XS" for t in r.tags)
        if r.qname in dup:
            assert has_xs, f"{r.qname}: dup-region mate missing XS"
            xs = next(v for k, _, v in r.tags if k == "XS")
            as_ = next(v for k, _, v in r.tags if k == "AS")
            assert xs == as_  # exact duplicate: tied second-best
            assert r.mapq <= 3, f"ambiguous mate mapq={r.mapq}"
        else:
            assert not has_xs and r.mapq >= 20


def test_chunked_rescue_matches_wide_band():
    """The chunked window rescue must agree with the window-wide band
    for every above-score-min alignment (the only ones rescue
    consumes), including indel cases up to the gap budget."""
    import jax.numpy as jnp
    from nvbio_tpu.alignment.batched import banded_score_batch
    from nvbio_tpu.models.paired import _chunk_plan, _chunked_window_score
    from nvbio_tpu.ops.banded_dp import select_banded_dp
    params = MapperParams(maxins=400)
    L = 96
    W = params.band_w
    rescue_w = params.maxins + 2 * W
    LT = L + 2 * rescue_w
    plan = _chunk_plan(L, LT, params)
    assert plan is not None
    rng = np.random.default_rng(11)
    R = 48
    pats = rng.integers(0, 4, (R, L)).astype(np.int8)
    texts = rng.integers(0, 4, (R, LT)).astype(np.int8)
    # plant within the covered start range, clear of the band edge
    # (at the window boundary wide and chunked clip differently by
    # design; decisions still agree via the score-min gate)
    offs = rng.integers(0, rescue_w - 40, R)
    for b in range(R):  # plant with small indels + mismatches
        p = list(pats[b])
        ndel = rng.integers(0, 8)  # one contiguous deletion run
        if ndel:
            at = rng.integers(0, len(p) - ndel)
            del p[at:at + ndel]
        texts[b, offs[b]:offs[b] + len(p)] = p
        for _ in range(rng.integers(0, 3)):
            texts[b, offs[b] + rng.integers(0, len(p))] = rng.integers(0, 4)
    lens = np.full(R, L, np.int32)
    tlens = rng.integers(LT - 50, LT + 1, R).astype(np.int32)
    quals = np.full((R, L), 35, np.int32)
    args = (jnp.asarray(pats), jnp.asarray(lens), jnp.asarray(texts),
            jnp.asarray(tlens), jnp.asarray(quals))
    wide = banded_score_batch(
        *args, scheme=params.scheme, atype=params.atype, band_w=rescue_w
    )
    got = _chunked_window_score(*args, params, plan)
    # the chunk band is beyond the register kernel's reach, so the GPU
    # runs the same twin as the CPU (what makes their PE output agree)
    assert select_banded_dp("gpu", plan[0]) == "xla"
    smin = math.ceil(params.score_min_a + params.score_min_b * L)
    sw = np.asarray(wide["score"])
    sg = np.asarray(got["score"])
    above = sw >= smin
    assert above.sum() >= R // 2  # the test must exercise real rescues
    np.testing.assert_array_equal(sg[above], sw[above])
    np.testing.assert_array_equal(
        np.asarray(got["t_end"])[above], np.asarray(wide["t_end"])[above]
    )
    # sub-threshold lanes may differ in value but never in decision
    assert (sg[~above] < smin).all()


def test_rescue_recovers_mate(pmapper):
    """Corrupt mate2's seeds so only rescue can place it."""
    m, genome = pmapper
    sim = simulate_pairs(genome, N_PAIRS, READ_LEN, insert_mean=200,
                         insert_sd=10, error_rate=0.0, seed=8)
    # heavy uniform corruption of mate2: every seed_len-th base flipped
    # kills exact seeding but keeps the alignment score above score-min
    s2 = sim["seqs2"].copy()
    for k in range(4, READ_LEN, 12):
        s2[:, k] = (s2[:, k] + 1) % 4
    l1 = np.full(N_PAIRS, READ_LEN, np.int32)
    res1, res2, info = m.map_pairs(
        sim["seqs1"], l1, sim["quals1"], s2, l1, sim["quals2"]
    )
    n_proper = sum(i["proper"] for i in info)
    n2 = sum(r.aligned for r in res2)
    # without rescue these mates have no exact 22-mer seeds
    assert n2 >= int(0.8 * N_PAIRS), f"only {n2} mate2 aligned"
    assert n_proper >= int(0.8 * N_PAIRS)
