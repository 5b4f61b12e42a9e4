#!/usr/bin/env python3
"""Smoke run of the mapper's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--four]

Phase 0 refuses to run unless JAX's backend is the GPU, and prints the
card (``nvidia-smi`` name and power limit), the JAX version, the device
kind and the bytes JAX may allocate on it.

Phase 1 checks every banded DP engine ``ops.select_banded_dp`` can pick
on the GPU against the XLA twin and the scalar oracle, at the mapper's
widths (100 and 150 bp, band half-width 15, and the PE rescue chunk
band), for all three alignment types, scores, sink cells and direction
flags.  The DP is int32 throughout, so TF32 never enters and equality
is exact.  It then runs the test suite's card-only tests (``gpu``
marker) in this process.

Phase 2 is BASELINE config 3 at chr20 scale: a 64,444,167 bp
repeat-structured genome made from ``--seed``, indexed by
``build_index`` (host SA-IS; set-up time), then ``map_reads`` on the GPU
for 65,536 x 100 bp single-end reads at 1 % error (4 batches of 16,384)
and 16,384 read pairs (2 x 100 bp, insert 300 +- 30, Bowtie2's
``-I 0 -X 500``).  It checks the record counts, the aligned rate, the
rate at the simulator's true locus and strand (+-3 bp) and the proper-
pair rate, and maps the first 2,048 reads and 1,024 pairs again, with the
same flags and batch, in a CPU child process (``JAX_PLATFORMS=cpu``):
the two SAMs must be identical apart from ``@PG``.

``--four`` runs only the multi-device paths on four GPUs: the same reads
through ``map_reads --mesh on`` over a 4-shard index against the
sequential sharded mapper on one card (``--mesh off``), and the ``dp``
read-sharded layout against the single-device step; both must be
bit-identical.

A phase that fails raises; the last line of a passing run is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".scratch", "chip_smoke")

#: BASELINE config 3 at chr20 scale
GENOME_BP = 64_444_167
SE_READS = 65_536
PAIRS = 16_384
READ_LEN = 100
BATCH = 16_384
SUBSET_SE, SUBSET_PAIRS = 2_048, 1_024
#: the multi-device check maps one batch of each
FOUR_SE, FOUR_PAIRS = BATCH, BATCH // 4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0
def phase0():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU; JAX backend is "
                 f"{backend!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line)
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    log(f"[phase0] jax {jax.__version__}; {len(jax.devices())} x "
        f"{dev.device_kind}; bytes_limit {stats.get('bytes_limit')}")
    sys.path.insert(0, ROOT)
    from nvbio_tpu.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    return dev


# ---------------------------------------------------------------- phase 1
def _dp_batch(nb, lp, band_w, rng):
    """Near-match (pattern, window) pairs with substitutions, small
    indels, N symbols and ragged lengths."""
    import numpy as np

    lt = lp + 2 * band_w
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    plens = rng.integers(lp - lp // 5, lp + 1, nb).astype(np.int32)
    plens[: nb // 64] = 0  # empty patterns
    offs = rng.integers(0, 2 * band_w + 1, nb)
    for b in range(nb):
        p = list(pats[b, : plens[b]])
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(0, max(len(p), 1)))
            if rng.random() < 0.5 and len(p) > 4:
                del p[at]
            else:
                p.insert(at, int(rng.integers(0, 4)))
        seg = np.asarray(p[: lt - offs[b]], np.int8)
        texts[b, offs[b] : offs[b] + len(seg)] = seg
    texts[rng.random(texts.shape) < 0.01] = rng.integers(0, 4)
    pats[rng.random(pats.shape) < 0.005] = 4
    texts[rng.random(texts.shape) < 0.005] = 4
    tlens = rng.integers(lt - 2 * band_w, lt + 1, nb).astype(np.int32)
    quals = rng.integers(2, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals


def phase1(seed: int, nb: int = 8192, n_oracle: int = 8):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from nvbio_tpu.alignment import AlignmentType, GotohScheme
    from nvbio_tpu.alignment.batched import (banded_directions_batch,
                                             banded_score_batch)
    from nvbio_tpu.alignment.oracle import align_oracle
    from nvbio_tpu.alignment.types import BOWTIE2_LOCAL_SCHEME
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.paired import _chunk_plan
    from nvbio_tpu.ops.banded_dp import (banded_directions, banded_score,
                                         select_banded_dp)

    p = MapperParams()
    rescue_w = p.maxins + 2 * p.band_w
    w_chunk = _chunk_plan(READ_LEN, READ_LEN + 2 * rescue_w, p)[0]
    rng = np.random.default_rng(seed)
    cases = ((AlignmentType.SEMI_GLOBAL, GotohScheme()),
             (AlignmentType.LOCAL, BOWTIE2_LOCAL_SCHEME),
             (AlignmentType.GLOBAL, GotohScheme()))
    fields = ("score", "p_end", "t_end")
    cpu = jax.devices("cpu")[0]
    for lp in (100, 150):
        for band_w in (p.band_w, w_chunk):
            engine = select_banded_dp("gpu", band_w)
            batch = _dp_batch(nb, lp, band_w, rng)
            # GLOBAL ends at (plen, tlen): keep that cell inside the band
            g_tlens = np.clip(batch[1] + rng.integers(
                -band_w // 2, band_w // 2 + 1, nb), 0, lp + 2 * band_w)
            for atype, scheme in cases:
                if atype == AlignmentType.GLOBAL:
                    batch = batch[:3] + (g_tlens.astype(np.int32),
                                         batch[4])
                args = tuple(map(jnp.asarray, batch))
                kw = dict(scheme=scheme, atype=atype, band_w=band_w)
                t0 = time.perf_counter()
                sel = jax.block_until_ready(banded_score(*args, **kw))
                sel_d, sel_dirs = jax.block_until_ready(
                    banded_directions(*args, **kw))
                dt = time.perf_counter() - t0
                twin = banded_score_batch(*args, **kw)
                twin_d, twin_dirs = banded_directions_batch(*args, **kw)
                # the twin compiled for the host: the plain reference
                host = banded_directions_batch(
                    *jax.device_put(args, cpu), **kw)
                for f in fields:
                    for name, got in (("score pass", sel[f]),
                                      ("directions pass", sel_d[f]),
                                      ("twin on GPU", twin[f]),
                                      ("twin dirs on GPU", twin_d[f])):
                        np.testing.assert_array_equal(
                            np.asarray(got), np.asarray(host[0][f]),
                            err_msg=f"{engine} {name} {f}")
                np.testing.assert_array_equal(
                    np.asarray(sel_dirs), np.asarray(host[1]),
                    err_msg=f"{engine} direction flags")
                np.testing.assert_array_equal(
                    np.asarray(twin_dirs), np.asarray(host[1]),
                    err_msg="twin direction flags")
                pats, plens, texts, tlens, quals = batch
                sc = np.asarray(sel["score"])
                for b in range(nb // 64, nb // 64 + n_oracle):
                    o = align_oracle(pats[b, : plens[b]],
                                     texts[b, : tlens[b]], scheme, atype,
                                     band=band_w,
                                     quals=quals[b, : plens[b]],
                                     traceback=False)
                    assert o.score == sc[b], (engine, lp, band_w, atype,
                                              b, o.score, sc[b])
                log(f"[phase1] Lp {lp} band_w {band_w} {atype.name}: "
                    f"{engine} == twin == host twin on {nb} alignments "
                    f"(scores, sinks, flags), == oracle on {n_oracle}; "
                    f"int32 DP, exact ({dt * 1e3:.1f} ms incl. compile)")


class _Outcomes:
    """pytest plugin: counts the tests that passed and were skipped."""

    passed = skipped = 0

    def pytest_runtest_logreport(self, report):
        self.passed += report.when == "call" and report.passed
        self.skipped += report.skipped


def gpu_tests():
    """The suite's ``gpu``-marked tests, in this process (a second JAX
    process would find the card's memory taken); none may skip."""
    import pytest

    tests = os.path.join(ROOT, "tests")
    files = []
    for name in sorted(os.listdir(tests)):
        path = os.path.join(tests, name)
        if name.startswith("test_") and name.endswith(".py"):
            with open(path) as f:
                if "pytest.mark.gpu" in f.read():
                    files.append(path)
    env = dict(os.environ)  # conftest.py edits the environment
    outcomes = _Outcomes()
    try:
        rc = pytest.main([*files, "-q", "-m", "gpu", "-p", "no:cacheprovider"],
                         plugins=[outcomes])
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert rc == 0 and outcomes.passed and not outcomes.skipped, (
        rc, outcomes.passed, outcomes.skipped)
    log(f"[phase1] gpu-marked tests: {outcomes.passed} passed on the card")


# ---------------------------------------------------------------- phase 2
def _records(sam_path):
    """SAM body lines (everything but headers)."""
    with open(sam_path) as f:
        return [l for l in f if not l.startswith("@")]


def _sam_without_pg(sam_path):
    with open(sam_path) as f:
        return [l for l in f if not l.startswith("@PG")]


def _write_inputs(seed, genome_bp, n_se, n_pairs, work):
    import numpy as np

    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import (repeat_structured_genome,
                                          simulate_pairs, simulate_reads)

    t0 = time.perf_counter()
    g, _info = repeat_structured_genome(genome_bp, seed=seed)
    fa = os.path.join(work, "ref.fa")
    write_fasta(fa, [("chr20s", g)])
    se = simulate_reads(g, n_se, READ_LEN, error_rate=0.01,
                        seed=seed + 1)
    pe = simulate_pairs(g, n_pairs, READ_LEN, insert_mean=300,
                        insert_sd=30, error_rate=0.01, seed=seed + 2)
    paths = {"fa": fa}

    def fq(name, seqs, quals, prefix, n):
        path = os.path.join(work, name)
        write_fastq(path, ((f"{prefix}{i}", seqs[i], quals[i])
                           for i in range(n)))
        return path

    paths["se"] = fq("se.fq", se["seqs"], se["quals"], "r", n_se)
    paths["se_sub"] = fq("se_sub.fq", se["seqs"], se["quals"], "r",
                         min(SUBSET_SE, n_se))
    for m in (1, 2):
        s, q = pe[f"seqs{m}"], pe[f"quals{m}"]
        paths[f"pe{m}"] = fq(f"pe{m}.fq", s, q, "p", n_pairs)
        paths[f"pe{m}_sub"] = fq(f"pe{m}_sub.fq", s, q, "p",
                                 min(SUBSET_PAIRS, n_pairs))
    truth = {
        "se_pos": se["true_pos"], "se_strand": se["true_strand"],
        "pe_pos1": pe["true_pos"],
        "pe_pos2": pe["true_pos"] + pe["insert"] - READ_LEN,
    }
    log(f"[phase2] inputs: {genome_bp:,} bp genome (seed {seed}), "
        f"{n_se:,} SE reads, {n_pairs:,} pairs in "
        f"{time.perf_counter() - t0:.1f} s")
    return g, paths, truth


def _se_rates(sam_path, pos, strand):
    import numpy as np

    n = aligned = true = 0
    for line in _records(sam_path):
        f = line.split("\t", 4)
        i, flag = int(f[0][1:]), int(f[1])
        n += 1
        if flag & 4:
            continue
        aligned += 1
        st = 1 if flag & 16 else 0
        true += int(st == strand[i] and abs(int(f[3]) - 1 - pos[i]) <= 3)
    return n, aligned / max(n, 1), true / max(n, 1)


def _pe_rates(sam_path, pos1, pos2):
    n = aligned = true = proper = 0
    for line in _records(sam_path):
        f = line.split("\t", 4)
        i, flag = int(f[0][1:]), int(f[1])
        n += 1
        if flag & 4:
            continue
        aligned += 1
        mate1 = bool(flag & 64)
        want_pos, want_st = (pos1[i], 0) if mate1 else (pos2[i], 1)
        st = 1 if flag & 16 else 0
        true += int(st == want_st and abs(int(f[3]) - 1 - want_pos) <= 3)
        proper += int(mate1 and bool(flag & 2))
    return n, aligned / max(n, 1), true / max(n, 1), proper / max(n // 2, 1)


def _map_args(idx, out, se=None, pe=None):
    args = ["-x", idx, "-S", out, "--batch", str(BATCH)]
    if se:
        return args + ["-U", se]
    return args + ["-1", pe[0], "-2", pe[1]]


def _cpu_reference(jobs):
    """Map the subsets in one CPU child process per job, one after the
    other, in a background thread; returns the thread and its results."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    results = []

    def run():
        for args in jobs:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "nvbio_tpu.tools.map_reads", *args],
                cwd=ROOT, env=env, capture_output=True, text=True)
            results.append((args, r, time.perf_counter() - t0))

    th = threading.Thread(target=run)
    th.start()
    return th, results


def _memory_analysis(idx):
    """compiled.memory_analysis() of the SE mapper step at the run's
    batch and bucket width."""
    import numpy as np
    import jax.numpy as jnp

    from nvbio_tpu.io.index_file import load_index
    from nvbio_tpu.models import Mapper, MapperParams
    from nvbio_tpu.models.mapper import map_batch

    fm, ssa, genome, meta = load_index(idx)
    m = Mapper(fm, ssa, genome, params=MapperParams(
        batch_size=BATCH, sa_sample=meta["sa_sample"],
        lut_k=meta.get("lut_k", 0), max_read_len=320),
        lut=meta.get("lut"))
    L = 128  # _len_bucket of 100 bp reads
    reads = jnp.zeros((BATCH, L), jnp.int8)
    lens = jnp.full((BATCH,), READ_LEN, jnp.int32)
    quals = jnp.zeros((BATCH, L), jnp.uint8)
    compiled = map_batch.lower(
        m.fm, m.ssa, m.genome, reads, lens, quals, params=m.params,
        lut=m.lut, fm2=m.fm2, bi=m.bi,
        uniform_shift=L - READ_LEN).compile()
    log(f"[phase2] map_batch memory_analysis (batch {BATCH}, L {L}): "
        f"{compiled.memory_analysis()}")


def phase2(seed: int, genome_bp=GENOME_BP, n_se=SE_READS, n_pairs=PAIRS,
           work=WORK, min_rates=(0.95, 0.90, 0.90)):
    from nvbio_tpu.tools import build_index, map_reads

    os.makedirs(work, exist_ok=True)
    g, paths, truth = _write_inputs(seed, genome_bp, n_se, n_pairs, work)
    idx = os.path.join(work, "ref.npz")
    t0 = time.perf_counter()
    assert build_index.main([paths["fa"], idx, "--algorithm", "sais"]) == 0
    log(f"[phase2] build_index (host SA-IS): "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    out = lambda name: os.path.join(work, name)
    se_sub = _map_args(idx, out("cpu_se_sub.sam"), se=paths["se_sub"])
    pe_sub = _map_args(idx, out("cpu_pe_sub.sam"),
                       pe=(paths["pe1_sub"], paths["pe2_sub"]))
    th, cpu_results = _cpu_reference([se_sub, pe_sub])

    timings = {}
    for name, args in (
            ("se", _map_args(idx, out("se.sam"), se=paths["se"])),
            ("pe", _map_args(idx, out("pe.sam"),
                             pe=(paths["pe1"], paths["pe2"]))),
            ("se_sub", _map_args(idx, out("gpu_se_sub.sam"),
                                 se=paths["se_sub"])),
            ("pe_sub", _map_args(idx, out("gpu_pe_sub.sam"),
                                 pe=(paths["pe1_sub"], paths["pe2_sub"])))):
        t0 = time.perf_counter()
        assert map_reads.main(args) == 0
        timings[name] = time.perf_counter() - t0
        log(f"[phase2] map_reads {name} on the GPU: "
            f"{timings[name]:.1f} s wall (compile included)")

    n, al, tr = _se_rates(out("se.sam"), truth["se_pos"],
                          truth["se_strand"])
    log(f"[phase2] SE: {n} records for {n_se} reads; aligned "
        f"{al:.4f}; true locus+strand (+-3 bp) {tr:.4f}")
    assert n == n_se, (n, n_se)
    n2, al2, tr2, pp = _pe_rates(out("pe.sam"), truth["pe_pos1"],
                                 truth["pe_pos2"])
    log(f"[phase2] PE: {n2} records for {n_pairs} pairs; aligned "
        f"{al2:.4f}; true locus+strand (+-3 bp) {tr2:.4f}; proper pairs "
        f"{pp:.4f}")
    assert n2 == 2 * n_pairs, (n2, n_pairs)
    a_min, t_min, p_min = min_rates
    assert al >= a_min and tr >= t_min and al2 >= a_min and pp >= p_min, (
        al, tr, al2, pp)

    _memory_analysis(idx)

    th.join()
    for args, r, dt in cpu_results:
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
        assert r.returncode == 0, f"CPU reference failed: {args}"
        log(f"[phase2] CPU reference {os.path.basename(args[3])}: "
            f"{dt:.1f} s wall")
    for gpu, cpu, what in (("gpu_se_sub.sam", "cpu_se_sub.sam",
                            f"first {min(SUBSET_SE, n_se)} SE reads"),
                           ("gpu_pe_sub.sam", "cpu_pe_sub.sam",
                            f"first {min(SUBSET_PAIRS, n_pairs)} pairs")):
        a, b = _sam_without_pg(out(gpu)), _sam_without_pg(out(cpu))
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        assert len(a) == len(b) and not diff, (
            what, len(a), len(b), diff[:3], [a[i] for i in diff[:2]],
            [b[i] for i in diff[:2]])
        log(f"[phase2] {what}: GPU SAM == CPU SAM ({len(a)} lines, "
            "@PG excluded)")
    return timings


# ---------------------------------------------------------------- --four
def four(seed: int, genome_bp=GENOME_BP, n_se=FOUR_SE, n_pairs=FOUR_PAIRS,
         work=WORK, n_dev=4):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nvbio_tpu.tools import build_index, map_reads

    assert len(jax.devices()) >= n_dev, jax.devices()
    os.makedirs(work, exist_ok=True)
    g, paths, truth = _write_inputs(seed, genome_bp, n_se, n_pairs, work)
    log(f"[four] cut: {n_se:,} SE reads and {n_pairs:,} pairs (one "
        f"batch each) instead of {SE_READS:,} and {PAIRS:,}")
    prefix = os.path.join(work, "ref4")
    t0 = time.perf_counter()
    shard_bp = -(-genome_bp // n_dev)
    assert build_index.main([paths["fa"], prefix + ".npz", "--shard-bp",
                             str(shard_bp)]) == 0
    log(f"[four] {n_dev}-shard build_index: "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    out = lambda name: os.path.join(work, name)
    for kind, inp in (("se", dict(se=paths["se"])),
                      ("pe", dict(pe=(paths["pe1"], paths["pe2"])))):
        sams = {}
        for mesh in ("on", "off"):
            sams[mesh] = out(f"four_{kind}_mesh_{mesh}.sam")
            t0 = time.perf_counter()
            assert map_reads.main(
                _map_args(prefix, sams[mesh], **inp) + ["--mesh", mesh]) == 0
            log(f"[four] map_reads {kind} --mesh {mesh}: "
                f"{time.perf_counter() - t0:.1f} s wall")
        a, b = _sam_without_pg(sams["on"]), _sam_without_pg(sams["off"])
        assert a == b, (kind, len(a), len(b))
        log(f"[four] {kind}: {n_dev}-device mesh SAM == sequential "
            f"single-card sharded SAM ({len(a)} lines)")

    # dp layout: the read batch sharded over a flat 'dp' axis, index
    # (shard 0 of the build above) replicated, against the same step on
    # one device
    from nvbio_tpu.fmindex.sharded import load_sharded_index
    from nvbio_tpu.io.fastq import FastqBatchReader
    from nvbio_tpu.models import Mapper, MapperParams
    from nvbio_tpu.models.mapper import map_batch
    from nvbio_tpu.parallel import make_mesh, replicate, shard_reads
    from nvbio_tpu.strings import pack_reads

    sidx, genome_np, man = load_sharded_index(prefix)
    fm, ssa, lut, start, length = sidx.shards[0]
    m = Mapper(fm, ssa, genome_np[start : start + length],
               params=MapperParams(batch_size=BATCH,
                                   sa_sample=man["sa_sample"],
                                   lut_k=man["lut_k"], max_read_len=320),
               lut=lut)
    names, seqs, quals = next(iter(FastqBatchReader(paths["se"], BATCH)))
    reads, lens, qm, _ = pack_reads(seqs, quals, max_len=128)
    args = (jnp.asarray(reads), jnp.asarray(lens.astype(np.int32)),
            jnp.asarray(qm.astype(np.uint8)))
    step = lambda r, l, q, st: map_batch(
        st[0], st[1], st[2], r, l, q, params=m.params, lut=st[3],
        fm2=st[4], bi=m.bi)
    state = (m.fm, m.ssa, m.genome, m.lut, m.fm2)
    one = jax.jit(step)(*args, state)
    mesh = make_mesh(n_dev)
    dp = jax.jit(step, in_shardings=(NamedSharding(mesh, P("dp")),) * 3
                 + (NamedSharding(mesh, P()),))(
        *shard_reads(mesh, *args), replicate(mesh, state))
    for k in one:
        np.testing.assert_array_equal(np.asarray(one[k]),
                                      np.asarray(dp[k]), err_msg=k)
    log(f"[four] dp: {len(reads)} reads sharded over {n_dev} devices == "
        f"the single-device step ({int(np.asarray(one['aligned']).sum())}"
        " aligned)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh and dp checks")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev = phase0()
    import jax

    if args.four:
        four(args.seed)
    else:
        phase1(args.seed)
        gpu_tests()
        phase2(args.seed)
    log(f"[chip_smoke] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
