"""Smoke-run scripts/sweep_ppo.py — the harness behind the recorded PPO
quality results (docs/RESULTS.md cites it as the reproduce command).

Tiny shapes on the CPU backend; asserts the per-config JSON line and the
final summary parse and carry the expected keys.
"""

import json
import pathlib
import subprocess
import sys
import pytest


@pytest.mark.slow
def test_sweep_smoke_produces_summary(tmp_path):
    repo = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base",
            "--updates", "2",
            "--num-envs", "16",
            "--rollout-len", "8",
            "--eval-envs", "8",
            "--eval-steps", "32",
            "--platform", "cpu",
            "--torso", "mlp",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
        ],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [l for l in r.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) >= 2, r.stdout
    per_config = json.loads(lines[0])
    assert per_config["config"] == "base"
    assert "greedy_return" in per_config and "frames_per_s" in per_config
    summary = json.loads(lines[-1])
    assert summary["best"] == "base"
    # the best config's TrainState was checkpointed for cli.evaluate
    assert (tmp_path / "ckpt").exists()


@pytest.mark.slow
def test_sweep_checkpoint_every_saves_mid_run_steps(tmp_path):
    """--checkpoint-every leaves evaluable mid-run checkpoints (long-run
    insurance: a cut-short 1M-update run still yields its latest policy)."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    ckpt = tmp_path / "ckpt"
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base",
            "--updates", "5",
            "--num-envs", "16",
            "--rollout-len", "8",
            "--eval-envs", "8",
            "--eval-steps", "32",
            "--platform", "cpu",
            "--torso", "mlp",
            "--mlp-width", "32",
            "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "2",
        ],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    from blockpuzzle_tpu.utils import CheckpointManager

    steps = CheckpointManager(str(ckpt)).all_steps()
    # periodic saves at 2 and 4 plus the final forced save at 5
    assert steps == [2, 4, 5], steps


def test_sweep_checkpoint_every_rejects_multi_config(tmp_path):
    repo = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base", "anneal",
            "--updates", "2",
            "--platform", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--checkpoint-every", "1",
        ],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=str(repo),
    )
    assert r.returncode != 0
    assert "single --configs entry" in r.stderr


@pytest.mark.slow
def test_sweep_eval_kept_records_peak_step(tmp_path):
    """--eval-kept greedy-evals every kept checkpoint and records the argmax
    in run_meta.json (VERDICT r3 weak #1: on post-peak-regression curves the
    final state is systematically the wrong artifact).  Also exercises the
    round-4 LR schedule flags and the explicit --ent-every cadence."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    ckpt = tmp_path / "ckpt"
    jsonl = tmp_path / "metrics.jsonl"
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base",
            "--updates", "6",
            "--num-envs", "16",
            "--rollout-len", "8",
            "--eval-envs", "8",
            "--eval-steps", "32",
            "--platform", "cpu",
            "--torso", "mlp",
            "--mlp-width", "32",
            "--log-every", "2",
            "--ent-floor", "10.0",
            "--ent-every", "3",
            "--lr0", "3e-4",
            "--lr1", "3e-5",
            "--lr-decay-start", "0.5",
            "--lr-shape", "cosine",
            "--metrics-jsonl", str(jsonl),
            "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "2",
            "--eval-kept",
        ],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()
             if l.startswith("{")]
    rec = lines[0]
    assert rec["lr0_eff"] == 3e-4 and rec["lr1_eff"] == 3e-5
    assert rec["lr_decay_start"] == 0.5 and rec["lr_shape"] == "cosine"
    assert rec["ent_every"] == 3
    # per-checkpoint eval rows for every kept step + the summary row
    curve_rows = [l for l in lines if "checkpoint_step" in l]
    assert [l["checkpoint_step"] for l in curve_rows] == [2, 4, 6]
    kept = [l for l in lines if "kept_eval_best_step" in l]
    assert len(kept) == 1
    meta = json.loads((ckpt / "run_meta.json").read_text())
    assert meta["best_step"] == kept[0]["kept_eval_best_step"]
    assert len(meta["checkpoint_curve"]) == 3
    # VERDICT r4 weak #2: run_meta records the full recipe of the saved
    # config — reproduction must not require the raw sweep log
    recipe = meta["recipe"]
    assert recipe["config"] == "base"
    assert recipe["seed"] == 0
    assert recipe["updates"] == 6
    assert recipe["num_envs"] == 16 and recipe["rollout_len"] == 8
    assert recipe["lr0_eff"] == 3e-4 and recipe["lr1_eff"] == 3e-5
    assert recipe["lr_decay_start"] == 0.5 and recipe["lr_shape"] == "cosine"
    assert recipe["ent_floor"] == 10.0 and recipe["ent_every"] == 3
    # inputs only: recipe-equality must be usable as a same-input check,
    # so measured outcomes stay out of it
    for outcome in ("greedy_return", "train_s", "frames_per_s",
                    "eval_episodes", "final_train_return",
                    "ent_mult_final"):
        assert outcome not in recipe, outcome
    # full-precision metrics stream: one row per log boundary, floats
    # round-trip exactly (determinism-probe contract)
    rows = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert [row["update"] for row in rows] == [1, 2, 4, 6]
    assert all("entropy" in row and "loss" in row for row in rows)
    # cosine decay: lr constant through the first half, lower at the end
    assert rows[1]["lr"] == 3e-4
    assert rows[-1]["lr"] == pytest.approx(3e-5)


def test_sweep_eval_kept_requires_periodic_checkpoints(tmp_path):
    repo = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base",
            "--updates", "2",
            "--platform", "cpu",
            "--eval-kept",
        ],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=str(repo),
    )
    assert r.returncode != 0
    assert "--eval-kept requires" in r.stderr


@pytest.mark.slow
def test_sweep_entropy_floor_controller_raises_coef(tmp_path):
    """--ent-floor: the host-side controller multiplies entropy_coef when
    measured entropy sits below the floor (round-3 response to the 1M-probe
    entropy collapse, docs/RESULTS.md).  An unreachable floor must drive the
    multiplier up monotonically to the cap; ent-floor 0 must leave it 1.0."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [
            sys.executable,
            str(repo / "scripts" / "sweep_ppo.py"),
            "--configs", "base",
            "--updates", "6",
            "--num-envs", "16",
            "--rollout-len", "8",
            "--eval-envs", "8",
            "--eval-steps", "32",
            "--platform", "cpu",
            "--torso", "mlp",
            "--mlp-width", "32",
            "--log-every", "2",
            "--ent-floor", "10.0",   # unreachable: ln(A) < 10 nats
            "--ent-adapt", "5.0",
            "--ent-max-mult", "7.5",
        ],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(
        [l for l in r.stdout.strip().splitlines() if l.startswith("{")][0]
    )
    assert rec["ent_floor"] == 10.0
    assert rec["ent_mult_final"] == 7.5  # hit the cap
    # log lines surface the controller state
    assert "ent_mult" in r.stderr


@pytest.mark.slow
def test_sweep_kl_adaptive_clip_controller(tmp_path):
    """--kl-target: the host-side banded controller scales the clip
    multiplier (round-5 probe of the one untried quality lever named by
    RESULTS.md).  approx_kl below target/2 must grow clip_mult to the cap;
    above 2*target must shrink it to the floor; kl-target 0 leaves 1.0."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    common = [
        sys.executable, str(repo / "scripts" / "sweep_ppo.py"),
        "--configs", "base", "--updates", "6",
        "--num-envs", "16", "--rollout-len", "8",
        "--eval-envs", "8", "--eval-steps", "32",
        "--platform", "cpu", "--torso", "mlp", "--mlp-width", "32",
        "--log-every", "2", "--kl-adapt", "2.0",
        "--kl-min-mult", "0.125", "--kl-max-mult", "8.0",
    ]
    # unreachably HIGH target: every firing sees kl < target/2 -> cap
    r = subprocess.run(
        common + ["--kl-target", "1000.0"],
        capture_output=True, text=True, timeout=600, cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(
        [l for l in r.stdout.strip().splitlines() if l.startswith("{")][0]
    )
    assert rec["kl_target"] == 1000.0
    assert rec["clip_mult_final"] == 8.0  # hit the cap
    assert "clip_mult" in r.stderr  # log lines surface controller state
    # unreachably LOW target: every firing sees kl > 2*target -> floor
    r = subprocess.run(
        common + ["--kl-target", "1e-12"],
        capture_output=True, text=True, timeout=600, cwd=str(repo),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(
        [l for l in r.stdout.strip().splitlines() if l.startswith("{")][0]
    )
    assert rec["clip_mult_final"] == 0.125  # hit the floor
