"""Smoke-run scripts/bench_actor.py and scripts/roofline.py (CPU backend).

Asserting their JSON contracts here keeps them runnable when a hardware
number needs reproducing on the GPU.
"""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_script(name, *args, timeout=600):
    r = subprocess.run(
        [sys.executable, str(REPO / "scripts" / name), *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return [json.loads(l) for l in r.stdout.strip().splitlines()
            if l.startswith("{")]


@pytest.mark.slow
def test_bench_actor_smoke():
    recs = run_script(
        "bench_actor.py", "--platform", "cpu", "--num-envs", "32",
        "--chunk", "8", "--iters", "2", "--windows", "2",
        "--torsos", "mlp", "--policies", "greedy", "sample",
    )
    assert len(recs) == 2
    for rec in recs:
        assert rec["metric"] == "actor_steps_per_s"
        assert rec["value"] > 0
        assert rec["torso"] == "mlp"
    assert {r["policy"] for r in recs} == {"greedy", "sample"}


@pytest.mark.slow
def test_roofline_smoke():
    (rec,) = run_script(
        "roofline.py", "--platform", "cpu", "--num-envs", "32",
        "--chunk", "8", "--no-time",
    )
    assert rec["metric"] == "roofline"
    # XLA's cost model must report both axes for the bound arithmetic; a
    # CPU run has no device peak, so no bound is computed
    assert rec["flops_per_step_env"] > 0
    assert rec["bytes_per_step_env"] > 0
    assert "hbm_bound_steps_per_s" not in rec
