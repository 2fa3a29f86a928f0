"""Quickstart: every public surface in ~60 lines.

Run on any backend:  python examples/quickstart.py  (add --cpu without a GPU)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

p = argparse.ArgumentParser()
p.add_argument("--cpu", action="store_true")
args = p.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import gymnasium
import jax.numpy as jnp

import blockpuzzle_tpu  # registers the Gymnasium ids
from blockpuzzle_tpu.env import make_env

# ── 1. single env, Gymnasium API (the reference usage) ──────────────────
env = gymnasium.make("BlockPuzzleTpu/BlockPuzzle-v0", render_mode="ansi")
obs, info = env.reset(seed=42)
rng = np.random.default_rng(0)
while True:
    legal = np.flatnonzero(info["action_mask"])
    if legal.size == 0:
        break
    obs, r, term, trunc, info = env.step(int(rng.choice(legal)))
    if term or trunc:
        break
print("single env final board:")
print(env.render())

# ── 2. vectorized on device, still Gymnasium ────────────────────────────
venv = gymnasium.make_vec("BlockPuzzleTpu/BlockPuzzle-v0", num_envs=256)
obs, infos = venv.reset(seed=0)
for _ in range(50):
    mask = infos["action_mask"]
    actions = (np.random.default_rng(1).random(mask.shape) * mask).argmax(1)
    obs, rew, term, trunc, infos = venv.step(actions)
print(f"vector env: mean reward/step {rew.mean():.2f}")
venv.close()

# ── 3. the raw engine: pure functions, compose with scan/jit ────────────
engine = make_env()
state, ts = engine.init_jit(jax.random.key(0), 1024)


@jax.jit
def rollout(state, mask, key):
    def body(carry, _):
        state, mask, key = carry
        key, sub = jax.random.split(key)
        a = jax.random.categorical(sub, jnp.where(mask, 0.0, -1e9), axis=-1)
        state, ts = engine.step(state, a)
        return (state, ts.action_mask, key), ts.reward

    (state, mask, _), rewards = jax.lax.scan(
        body, (state, mask, key), None, length=100
    )
    return state, rewards


state, rewards = rollout(state, ts.action_mask, jax.random.key(1))
print(f"engine: 100x1024 steps, reward/step {float(rewards.mean()):.2f}")

# ── 3b. serving-side packed legal-words mask (env/words.py) ─────────────
# a consumer that wants the legal mask as (N, S*H) u32 row words instead
# of the (N, A) bool tensor — e.g. to ship it over a wire — samples
# uniform-legal actions via popcount rank-select (bit-parity-tested; NOT
# the step default; its rate on the GPU is not measured yet)
from blockpuzzle_tpu.env import words

wmask = words.legal_words(engine, state.board, state.queue)
acts = words.sample_uniform_legal(wmask, jax.random.key(2), engine.cfg.width)
print(f"words sampler: one uniform-legal action per env "
      f"(N={int(acts.shape[0])}), first id {int(acts[0])}")

# ── 4. training: see the CLIs ───────────────────────────────────────────
print("train:    python -m blockpuzzle_tpu.cli.train --algo ppo")
print("evaluate: python -m blockpuzzle_tpu.cli.evaluate --checkpoint-dir ...")
print("parity:   python -m blockpuzzle_tpu.cli.parity")
sys.exit(0)
