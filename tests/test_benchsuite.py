"""CI smokes for the graded measurement scripts in benchsuite/.

VERDICT r4 weak #6: nothing imported benchsuite/, so the scripts the
published BENCHMARKS numbers cite could silently rot the way the old
.scratch/ one-offs did.  Each smoke runs the real script entry point
at toy size on the CPU backend; timings are meaningless, the point is
that the code paths execute end-to-end.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = os.path.join(ROOT, "benchsuite")


def _run(script, *argv):
    """Run a benchsuite script in a subprocess (they pin their own
    backend; in-process jax.config mutation would leak into the
    suite's CPU session)."""
    r = subprocess.run(
        [sys.executable, os.path.join(BS, script), *argv],
        capture_output=True, text=True, timeout=560, cwd=ROOT)
    assert r.returncode == 0, (
        f"{script} failed\n--- stdout\n{r.stdout[-2000:]}\n"
        f"--- stderr\n{r.stderr[-2000:]}")
    return r.stdout


def test_hg_stage_bench_smoke(tmp_path):
    out = _run("hg_stage_bench.py", "--cpu", "--bp", "1e6",
               "--shards", "2", "--batch", "128", "--iters", "1",
               "--substages", "--cache", str(tmp_path))
    rows = json.loads(out.strip().splitlines()[-1])
    stages = {r["stage"] for r in rows}
    # both phases, the fused per-shard stage, and the sub-stage
    # decomposition must all have produced rows
    assert {"cands_shard0", "cands_shard1", "top2", "walk",
            "TOTAL"} <= stages
    assert {"sub:strands", "sub:seeds+bsearch", "sub:bsearch",
            "sub:select+locate", "sub:extend"} <= stages
    assert any(r.get("reads_per_s_chip", 0) > 0 for r in rows)
    phases = {r["phase"] for r in rows}
    assert {"A_all_shards", "B_one_shard_fm2"} <= phases


def test_hg_campaign_smoke(tmp_path):
    out = _run("hg_campaign.py", "--cpu", "--bp", "1e6", "--shards",
               "2", "--per-class", "16", "--batch", "128",
               "--cache", str(tmp_path))
    j = json.loads(out.strip().splitlines()[-1])
    assert set(j["classes"]) == {"unique", "alu", "segdup", "tandem"}
    assert j["classes"]["unique"]["aligned"] >= 0.95
    assert "wrong_at_mapq20" in j["calibration"]


def test_sa100_bench_smoke():
    _run("sa100_bench.py", "--smoke")  # asserts bit-identity itself
