"""Piece-plane observation variant (EnvConfig.obs_planes) + planes torso.

Covers the CLAUDE.md invariant for new engine semantics: oracle change +
engine change + parity test in one commit.  The oracle renders planes from
the raw piece grids; the engine renders them with a one-hot matmul
against ``rules.piece_plane_table`` — these tests pin the two equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blockpuzzle_tpu.config import default_config, woodoku_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig
from blockpuzzle_tpu.oracle import BlockPuzzleOracleEnv


def planes_cfg(base):
    return dataclasses.replace(base, obs_planes=True)


@pytest.mark.parametrize(
    "base_cfg", [default_config(), woodoku_config()], ids=["default", "woodoku"]
)
def test_planes_parity_oracle_vs_engine(base_cfg):
    """Lockstep seeded episode: oracle obs planes == engine TimeStep planes.

    Queue parity is covered bit-exactly by test_parity.py; what is new here
    is the RENDERING on both sides, so the oracle's queue ids are replayed
    into the engine each step and the planes compared.
    """
    cfg = planes_cfg(base_cfg)
    oracle = BlockPuzzleOracleEnv(cfg)
    engine = make_env(cfg)
    rng = np.random.default_rng(3)

    obs, info = oracle.reset(seed=11)
    render = jax.jit(engine.piece_planes)
    for _ in range(40):
        got = np.asarray(render(jnp.asarray(obs["queue"][None])))[0]
        np.testing.assert_array_equal(got, obs["piece_planes"])
        legal = np.flatnonzero(info["action_mask"])
        if len(legal) == 0:
            break
        obs, _, term, trunc, info = oracle.step(int(rng.choice(legal)))
        if term or trunc:
            break


def test_engine_timestep_carries_planes():
    cfg = planes_cfg(default_config())
    env = make_env(cfg)
    state, ts = env.init_jit(jax.random.key(0), 8)
    s, h, w = cfg.queue_size, cfg.height, cfg.width
    assert ts.piece_planes.shape == (8, s, h, w)
    assert ts.piece_planes.dtype == jnp.uint8
    # plane content matches the queue ids' raw grids
    from blockpuzzle_tpu import rules

    table = rules.piece_plane_table(cfg)
    queue = np.asarray(ts.queue)
    expect = np.zeros((8, s, h * w), np.uint8)
    for i in range(8):
        for j in range(s):
            if queue[i, j] < env.num_pieces:
                expect[i, j] = table[queue[i, j]]
    np.testing.assert_array_equal(
        np.asarray(ts.piece_planes).reshape(8, s, h * w), expect
    )
    # planes track the queue through steps (and obs dict exposes them)
    a = jnp.argmax(ts.action_mask, axis=-1)
    state, ts2 = jax.jit(env.step)(state, a)
    assert "piece_planes" in ts2.obs
    got = np.asarray(ts2.piece_planes).reshape(8, s, h * w)
    q2 = np.asarray(ts2.queue)
    for i in range(8):
        for j in range(s):
            row = table[q2[i, j]] if q2[i, j] < env.num_pieces else 0
            np.testing.assert_array_equal(got[i, j], row)


def test_default_config_has_no_planes():
    """obs_planes=False keeps the TimeStep field None (HLO unchanged)."""
    env = make_env(default_config())
    _, ts = env.init_jit(jax.random.key(0), 4)
    assert ts.piece_planes is None
    assert "piece_planes" not in ts.obs


def test_oracle_env_checker_with_planes():
    from gymnasium.utils.env_checker import check_env

    check_env(
        BlockPuzzleOracleEnv(planes_cfg(default_config())),
        skip_render_check=True,
    )


def test_vector_env_planes_surface():
    from blockpuzzle_tpu.vector_env import BlockPuzzleVectorEnv

    venv = BlockPuzzleVectorEnv(num_envs=4, cfg=planes_cfg(default_config()))
    obs, info = venv.reset(seed=0)
    s, h, w = venv.cfg.queue_size, venv.cfg.height, venv.cfg.width
    assert obs["piece_planes"].shape == (4, s, h, w)
    assert "piece_planes" in venv.single_observation_space.spaces
    # run until some env finishes; final_obs must carry the pre-reset planes
    rng = np.random.default_rng(0)
    for _ in range(600):
        mask = info["action_mask"]
        acts = np.array(
            [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask]
        )
        obs, rew, term, trunc, info = venv.step(acts)
        if "final_obs" in info:
            assert info["final_obs"]["piece_planes"].shape == (4, s, h, w)
            break
    else:
        pytest.fail("no episode finished in 600 steps")


@pytest.mark.parametrize("torso", ["conv", "mlp"])
def test_ppo_planes_queue_mode_trains(torso):
    env = make_env(default_config())
    ppo = PPO(
        env,
        PPOConfig(
            num_envs=16, rollout_len=8, num_epochs=1, num_minibatches=2,
            hidden=32, channels=(8,), torso=torso, queue_mode="planes",
        ),
    )
    state = ppo.init(jax.random.key(0))
    # planes mode replaces the Embed gather entirely
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    assert not any("Embed" in str(p) for p, _ in flat)
    state, metrics = ppo.update_jit(state)
    assert np.isfinite(float(metrics["loss"]))


def test_dqn_planes_queue_mode_iteration():
    env = make_env(default_config())
    dqn = DQN(
        env,
        DQNConfig(
            num_envs=8, buffer_size=64, batch_size=8, collect_steps=2,
            min_buffer=4, hidden=16, channels=(4,), queue_mode="planes",
        ),
    )
    state = dqn.init(jax.random.key(0))
    state, metrics = jax.jit(dqn.iteration)(state)
    assert int(metrics["buffer_filled"]) == 16


def test_vector_reset_options_refresh_planes_and_validate_queue():
    """reset(options={'queue': ...}) must re-render planes and range-check
    ids (code-review r2 findings #1/#4)."""
    from blockpuzzle_tpu import rules
    from blockpuzzle_tpu.vector_env import BlockPuzzleVectorEnv

    venv = BlockPuzzleVectorEnv(num_envs=2, cfg=planes_cfg(default_config()))
    queue = np.array([[3], [7]], np.int32)
    obs, info = venv.reset(seed=0, options={"queue": queue})
    table = rules.piece_plane_table(venv.cfg)
    np.testing.assert_array_equal(
        obs["piece_planes"].reshape(2, 1, -1),
        table[queue.ravel()].reshape(2, 1, -1),
    )
    with pytest.raises(ValueError, match="out of range"):
        venv.reset(seed=0, options={"queue": np.full((2, 1), 99, np.int32)})
