"""The main path imports nothing beyond jax, numpy, scipy, optax, chex and
einops: a child process with flax, orbax and gymnasium blocked imports the
engine, learners, dist/, the CLIs, bench.py and chip_smoke.py, then runs a
tiny PPO update and an oracle parity seed."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "gymnasium"):
    sys.modules[name] = None  # any import of these raises ImportError

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

import blockpuzzle_tpu
from blockpuzzle_tpu import dist
from blockpuzzle_tpu.cli import evaluate, parity, rollout, train
from blockpuzzle_tpu.dist.equivalence import check_sharded_equivalence
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig
from blockpuzzle_tpu.oracle import BlockPuzzleGame, record_trajectory
from blockpuzzle_tpu.utils import CheckpointManager
import bench
import chip_smoke

env = make_env()
ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, num_minibatches=2,
                         hidden=16, channels=(4,)))
state, metrics = ppo.update_jit(ppo.init(jax.random.key(0)))
assert np.isfinite(float(metrics["loss"]))
r = parity.check_seed(env.cfg, 0, 64, env=env)
assert not r["mismatches"] and r["oracle_return"] == r["device_return"], r

try:
    import blockpuzzle_tpu.oracle.env  # the gymnasium.Env wrapper
except ImportError:
    pass
else:
    raise SystemExit("gymnasium was importable")
loaded = [m for m in ("flax", "orbax", "gymnasium")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("MAIN_PATH_OK")
"""


def test_main_path_runs_without_flax_orbax_gymnasium():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "MAIN_PATH_OK" in r.stdout
