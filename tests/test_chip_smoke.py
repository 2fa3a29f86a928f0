"""chip_smoke.py: its phases at tiny sizes on the CPU, its refusal to run
without a GPU, and (``gpu`` marker) the whole script on a GPU.

The phase functions are the ones the GPU run calls; only the sizes shrink
here.  Their timings on the CPU are never reported.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--platform", "cpu", "--num-envs", "16", "--rollout-len", "4",
        "--minibatches", "2"]


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]], ids=["one", "four"])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_phase_parity(preset):
    chip_smoke.phase_parity([preset], seeds=2, max_steps=128)


def test_phase_rollout():
    assert chip_smoke.phase_rollout(64, chunk_len=20, chunks=2) > 0


def test_phase_networks():
    errors = chip_smoke.phase_networks(256)
    assert set(errors) == {"actor_critic_conv", "actor_critic_mlp",
                           "q_network_conv", "q_network_dueling_mlp"}
    assert all(0.0 < e <= chip_smoke.NET_RTOL for e in errors.values())


def test_phase_networks_tolerance_bites(monkeypatch):
    """The bf16 forward really is compared: a tolerance below bf16's
    rounding fails."""
    monkeypatch.setattr(chip_smoke, "NET_RTOL", 1e-6)
    with pytest.raises(AssertionError, match="max error"):
        chip_smoke.phase_networks(64)


def test_phase_training_and_resume(tmp_path):
    """PPO conv + mlp and DQN through cli.train, then the update-2 resume
    and the greedy evaluate — the GPU phases at CPU-sized batches (DQN
    gets enough envs to pass its default min_buffer)."""
    rates = chip_smoke.phase_training(
        tmp_path, TINY,
        dqn_extra=["--num-envs", "2560", "--buffer-size", "12000",
                   "--torso", "mlp"],
        ppo_kw=dict(num_envs=16, rollout_len=4, num_minibatches=2),
        dqn_kw=dict(num_envs=2560, buffer_size=12000, torso="mlp"),
    )
    assert set(rates) == {"ppo_conv", "ppo_mlp", "dqn"}
    out = chip_smoke.phase_resume(
        tmp_path, TINY, eval_extra=["--platform", "cpu", "--num-envs", "16"]
    )
    # the CPU reduces in a fixed order: the resume is bit-exact here
    assert out["param_max_abs_diff"] == 0.0
    assert out["param_outlier_frac"] == 0.0


def test_phase_four_gpus_on_virtual_devices(tmp_path):
    """The --four-gpus path on the suite's 8 virtual CPU devices: the
    sharded==unsharded check on 4 of them, then cli.train over all."""
    out = chip_smoke.phase_four_gpus(
        tmp_path, per_card=4,
        extra=["--platform", "cpu", "--rollout-len", "4", "--minibatches",
               "2", "--torso", "mlp", "--mlp-width", "32"],
        ppo_kw=dict(rollout_len=4, num_minibatches=2, torso="mlp",
                    mlp_width=32),
        check_kw={},
    )
    assert out["frames_per_s"] > 0 and out["one_card_frames_per_s"] > 0


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_gpu(gpu_backend):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=1200, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1
