"""Gymnasium VectorEnv adapter tests (device engine behind the Gym surface)."""

import numpy as np
import pytest

import gymnasium

import blockpuzzle_tpu  # noqa: F401 — registers ids
from blockpuzzle_tpu.config import default_config, tenten_config
from blockpuzzle_tpu.vector_env import BlockPuzzleVectorEnv


def test_make_vec_registered():
    env = gymnasium.make_vec("BlockPuzzleTpu/BlockPuzzle-v0", num_envs=8)
    assert isinstance(env.unwrapped, BlockPuzzleVectorEnv)
    obs, infos = env.reset(seed=0)
    assert obs["board"].shape == (8, 10, 10)
    assert infos["action_mask"].shape == (8, 100)
    env.close()


def test_vector_step_and_masking():
    env = BlockPuzzleVectorEnv(num_envs=16, cfg=default_config())
    obs, infos = env.reset(seed=1)
    rng = np.random.default_rng(0)
    for _ in range(20):
        mask = infos["action_mask"]
        # sample one legal action per env
        actions = np.array(
            [rng.choice(np.flatnonzero(m)) for m in mask], dtype=np.int64
        )
        obs, rewards, term, trunc, infos = env.step(actions)
        assert rewards.shape == (16,)
        assert (rewards > 0).all()  # legal actions always reward
    env.close()


def test_vector_autoreset_final_observation():
    env = BlockPuzzleVectorEnv(num_envs=32, cfg=default_config())
    obs, infos = env.reset(seed=2)
    rng = np.random.default_rng(1)
    saw_done = False
    for _ in range(120):
        mask = infos["action_mask"]
        actions = np.array(
            [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask],
            dtype=np.int64,
        )
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            saw_done = True
            assert "final_board" in infos
            i = int(np.flatnonzero(done)[0])
            # live obs for the done env is a fresh (empty) board...
            assert obs["board"][i].sum() == 0
            # ...while the final board is the dead position (non-empty)
            assert infos["final_board"][i].sum() > 0
            np.testing.assert_array_equal(infos["_final_board"], done)
            break
    assert saw_done, "no episode finished in 120 steps"
    env.close()


def test_vector_env_spaces_batched():
    env = BlockPuzzleVectorEnv(num_envs=4, cfg=tenten_config())
    assert env.single_action_space.n == 300
    assert env.action_space.shape == (4,)
    obs, infos = env.reset(seed=0)
    assert obs["queue"].shape == (4, 3)
    assert env.observation_space.contains(obs)
    env.close()


def test_vector_render_rgb():
    env = BlockPuzzleVectorEnv(num_envs=4, render_mode="rgb_array")
    env.reset(seed=0)
    img = env.render()
    assert img is not None and img.ndim == 3 and img.dtype == np.uint8
    env.close()


def test_vector_reset_options_override_state():
    env = BlockPuzzleVectorEnv(num_envs=4, cfg=default_config())
    boards = np.zeros((4, 10, 10), dtype=np.uint8)
    boards[:, 0, :9] = 1
    queues = np.zeros((4, 1), dtype=np.int32)  # piece 0 = 1x1
    obs, infos = env.reset(seed=0, options={"board": boards, "queue": queues})
    np.testing.assert_array_equal(obs["board"], boards)
    np.testing.assert_array_equal(obs["queue"], queues)
    # the recomputed mask must forbid the occupied cells
    assert not infos["action_mask"][:, :9].any()
    # completing row 0 clears it in every env
    obs, rewards, term, trunc, infos = env.step(np.full(4, 9))
    assert (infos["lines_cleared"] == 1).all()
    assert (obs["board"][:, 0].sum(axis=-1) == 0).all()
    env.close()


def _legal_actions(mask, rng):
    return np.array(
        [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask],
        dtype=np.int64,
    )


def test_vector_next_step_autoreset_semantics():
    """NEXT_STEP: terminal step shows the FINAL obs; the following step
    ignores the action and presents the reset obs with reward 0."""
    env = BlockPuzzleVectorEnv(
        num_envs=32, cfg=default_config(), autoreset_mode="next_step"
    )
    assert (
        env.metadata["autoreset_mode"]
        is gymnasium.vector.AutoresetMode.NEXT_STEP
    )
    obs, infos = env.reset(seed=4)
    rng = np.random.default_rng(3)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    # terminal step: the presented obs is the DEAD position, not a reset
    assert obs["board"][i].sum() > 0
    assert not infos["action_mask"][i].any()  # final mask: nothing legal
    # following step: action ignored (use an arbitrary id), env resets
    actions = _legal_actions(infos["action_mask"], rng)
    actions[i] = 0  # whatever — must be ignored for the resetting env
    obs2, rewards2, term2, trunc2, infos2 = env.step(actions)
    assert rewards2[i] == 0.0
    assert not term2[i] and not trunc2[i]
    assert obs2["board"][i].sum() == 0  # reset obs: empty board
    assert infos2["action_mask"][i].any()
    assert infos2["episode_return"][i] == 0.0
    # the step after that: the env plays normally from the reset state
    actions = _legal_actions(infos2["action_mask"], rng)
    obs3, rewards3, term3, trunc3, infos3 = env.step(actions)
    assert rewards3[i] > 0.0  # legal placement rewards
    env.close()


def test_vector_next_step_ignored_action_does_not_advance_rng():
    """The discarded transition of a resetting env must not consume RNG:
    two NEXT_STEP runs that differ only in the ignored action converge to
    identical queues afterwards."""
    outs = []
    for junk_action in (0, 7):
        env = BlockPuzzleVectorEnv(
            num_envs=16, cfg=default_config(), autoreset_mode="next_step"
        )
        obs, infos = env.reset(seed=11)
        rng = np.random.default_rng(5)
        done = np.zeros(16, dtype=bool)
        for _ in range(200):
            actions = _legal_actions(infos["action_mask"], rng)
            obs, rewards, term, trunc, infos = env.step(actions)
            done = term | trunc
            if done.any():
                break
        assert done.any()
        i = int(np.flatnonzero(done)[0])
        actions = _legal_actions(infos["action_mask"], rng)
        actions[i] = junk_action
        obs, rewards, term, trunc, infos = env.step(actions)
        outs.append((obs["queue"][i].copy(), obs["board"][i].copy()))
        env.close()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_vector_disabled_autoreset_and_partial_reset():
    env = BlockPuzzleVectorEnv(
        num_envs=32, cfg=default_config(), autoreset_mode="disabled"
    )
    obs, infos = env.reset(seed=6)
    rng = np.random.default_rng(7)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    dead_board = obs["board"][i].copy()
    assert dead_board.sum() > 0
    # no auto-reset: stepping again leaves the env terminal and unchanged
    actions = _legal_actions(infos["action_mask"], rng)
    obs2, rewards2, term2, trunc2, infos2 = env.step(actions)
    assert term2[i]
    assert rewards2[i] == 0.0  # illegal no-op (default penalty 0)
    np.testing.assert_array_equal(obs2["board"][i], dead_board)
    # partial reset: ONLY the flagged env resets
    j = int(np.flatnonzero(~done)[0])
    before_j = obs2["board"][j].copy()
    queue_j = obs2["queue"][j].copy()
    mask = np.zeros(32, dtype=bool)
    mask[i] = True
    obs3, infos3 = env.reset(options={"reset_mask": mask})
    assert obs3["board"][i].sum() == 0
    assert infos3["action_mask"][i].any()
    np.testing.assert_array_equal(obs3["board"][j], before_j)
    np.testing.assert_array_equal(obs3["queue"][j], queue_j)
    # the reset env steps normally again
    actions = _legal_actions(infos3["action_mask"], rng)
    obs4, rewards4, term4, trunc4, infos4 = env.step(actions)
    assert rewards4[i] > 0.0 and not term4[i]
    env.close()


def test_vector_disabled_freezes_dead_envs():
    """A dead env's step is a bit-exact no-op: no penalty re-application,
    no stat drift, sticky death flags (the engine alone would keep
    recomputing terminated=True from the empty mask and re-add
    terminal_penalty every step)."""
    env = BlockPuzzleVectorEnv(
        num_envs=32, autoreset_mode="disabled",
        terminal_penalty=-50.0, illegal_penalty=-1.0,
    )
    obs, infos = env.reset(seed=6)
    rng = np.random.default_rng(7)
    done = np.zeros(32, dtype=bool)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    dead_board = obs["board"][i].copy()
    dead_queue = obs["queue"][i].copy()
    dead_return = infos["episode_return"][i]
    dead_streak = infos["streak"][i]
    for _ in range(3):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        assert rewards[i] == 0.0  # NOT illegal_penalty + terminal_penalty
        assert term[i] and not trunc[i]  # sticky death flags
        assert infos["episode_return"][i] == dead_return  # no drift
        assert infos["streak"][i] == dead_streak
        assert infos["lines_cleared"][i] == 0
        np.testing.assert_array_equal(obs["board"][i], dead_board)
        np.testing.assert_array_equal(obs["queue"][i], dead_queue)
    # reset_mask revives it
    mask = np.zeros(32, dtype=bool)
    mask[i] = True
    obs, infos = env.reset(options={"reset_mask": mask})
    actions = _legal_actions(infos["action_mask"], rng)
    obs, rewards, term, trunc, infos = env.step(actions)
    assert rewards[i] > 0.0 and not term[i]
    env.close()


def test_vector_disabled_freezes_truncated_envs():
    """Truncated (not terminated) dead envs must freeze too: their mask is
    NOT empty, so without the freeze they would keep placing pieces and
    re-reporting truncated from a still-advancing step counter."""
    env = BlockPuzzleVectorEnv(
        num_envs=8, autoreset_mode="disabled", max_steps=5,
    )
    obs, infos = env.reset(seed=3)
    rng = np.random.default_rng(3)
    for _ in range(5):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
    assert trunc.all()
    frozen_board = obs["board"].copy()
    frozen_term = term.copy()
    for _ in range(3):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        assert trunc.all()
        np.testing.assert_array_equal(term, frozen_term)
        assert (rewards == 0.0).all()
        np.testing.assert_array_equal(obs["board"], frozen_board)
    env.close()


def test_vector_next_step_gymnasium_wrapper_interop():
    """gymnasium's own vector wrappers consume the NEXT_STEP convention."""
    from gymnasium.wrappers.vector import RecordEpisodeStatistics

    env = gymnasium.make_vec(
        "BlockPuzzleTpu/BlockPuzzle-v0", num_envs=16,
        autoreset_mode="next_step",
    )
    env = RecordEpisodeStatistics(env)
    obs, infos = env.reset(seed=0)
    rng = np.random.default_rng(0)
    finished = 0
    for _ in range(300):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rew, term, trunc, infos = env.step(actions)
        if "episode" in infos:
            finished += int(np.asarray(infos["_episode"]).sum())
    assert finished > 0
    env.close()


def test_vector_partial_reset_option_validation():
    env = BlockPuzzleVectorEnv(
        num_envs=4, cfg=default_config(), autoreset_mode="disabled"
    )
    with pytest.raises(RuntimeError):
        env.reset(options={"reset_mask": np.ones(4, bool)})  # before reset()
    env.reset(seed=0)
    with pytest.raises(ValueError):
        env.reset(options={"reset_mask": np.ones(3, bool)})  # wrong shape
    with pytest.raises(ValueError):
        env.reset(seed=1, options={"reset_mask": np.ones(4, bool)})
    with pytest.raises(ValueError):
        env.reset(options={"reset_mask": np.ones(4, bool), "queue": None})
    env.close()


def test_make_vec_accepts_autoreset_mode():
    env = gymnasium.make_vec(
        "BlockPuzzleTpu/BlockPuzzle-v0", num_envs=4, autoreset_mode="next_step"
    )
    assert (
        env.unwrapped.autoreset_mode
        is gymnasium.vector.AutoresetMode.NEXT_STEP
    )
    env.reset(seed=0)
    env.close()


def test_vector_autoreset_mode_rejects_unknown():
    with pytest.raises(ValueError):
        BlockPuzzleVectorEnv(num_envs=2, autoreset_mode="sometimes")


def test_vector_reset_options_rejects_unknown():
    env = BlockPuzzleVectorEnv(num_envs=2, cfg=default_config())
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"bogus": 1})
    env.close()


def test_vector_reset_options_rejects_bad_board():
    env = BlockPuzzleVectorEnv(num_envs=2, cfg=default_config())
    # wrong shape: a transposed/flattened array must not be silently
    # reinterpreted by a bare reshape (the oracle raises on shape mismatch)
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"board": np.zeros((100, 2), np.uint8)})
    # non-binary cells would desync engine count==size clears from the
    # oracle's .all()
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"board": np.full((2, 10, 10), 2, np.uint8)})
    # flat (N, H*W) remains accepted
    obs, infos = env.reset(seed=0, options={"board": np.zeros((2, 100), np.uint8)})
    assert obs["board"].shape == (2, 10, 10)
    env.close()
