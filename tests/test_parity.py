"""Seeded trajectory parity: batched device engine vs the CPU oracle.

BASELINE config 1 / SURVEY.md §3.5: record a seeded random-policy episode on
the oracle, replay the same actions into the jax engine with the oracle's
dealt-piece stream injected, and assert bit-equal boards, queues, masks,
rewards, and termination plus equal episode returns.

The reference mount was empty at build time (SURVEY.md §0), so parity is
asserted against the in-repo oracle, which pins the reference semantics.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blockpuzzle_tpu.config import (
    big_config,
    default_config,
    tenten_config,
    woodoku_config,
)
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.oracle import record_trajectory


def replay_and_compare(cfg, seed, max_steps=256):
    traj = record_trajectory(cfg, seed=seed, max_steps=max_steps)
    env = make_env(cfg)
    step = jax.jit(
        lambda s, a, d: env.step(s, a, deal_override=d, auto_reset=False)
    )
    state, ts = env.init(jax.random.key(0), 1, deal_override=traj.init_deals[None])

    np.testing.assert_array_equal(
        np.asarray(ts.board[0]).reshape(-1), traj.boards[0].reshape(-1)
    )
    np.testing.assert_array_equal(np.asarray(ts.queue[0]), traj.queues[0])
    np.testing.assert_array_equal(np.asarray(ts.action_mask[0]), traj.masks[0])

    total = 0.0
    for t in range(len(traj.actions)):
        state, ts = step(
            state,
            jnp.asarray([traj.actions[t]]),
            jnp.asarray(traj.deals[t][None]),
        )
        np.testing.assert_array_equal(
            np.asarray(ts.board[0]).reshape(-1),
            traj.boards[t + 1].reshape(-1),
            err_msg=f"board mismatch at t={t} (seed {seed})",
        )
        np.testing.assert_array_equal(
            np.asarray(ts.queue[0]), traj.queues[t + 1], f"queue t={t}"
        )
        np.testing.assert_array_equal(
            np.asarray(ts.action_mask[0]), traj.masks[t + 1], f"mask t={t}"
        )
        assert float(ts.reward[0]) == traj.rewards[t], f"reward t={t}"
        assert bool(ts.terminated[0]) == traj.terminated[t], f"term t={t}"
        assert bool(ts.truncated[0]) == traj.truncated[t], f"trunc t={t}"
        total += float(ts.reward[0])
    assert total == pytest.approx(traj.episode_return)
    return traj


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17])
def test_parity_default_config(seed):
    replay_and_compare(default_config(), seed)


@pytest.mark.parametrize("seed", [0, 5])
def test_parity_tenten_config(seed):
    replay_and_compare(tenten_config(), seed)


@pytest.mark.parametrize("seed", [0, 9])
def test_parity_woodoku_config(seed):
    replay_and_compare(woodoku_config(), seed)


def test_parity_big_config():
    replay_and_compare(big_config(), seed=0, max_steps=128)


def test_batched_parity_lockstep():
    """B oracle episodes replayed in ONE lockstep batch (config 2 semantics).

    Episodes have different lengths; shorter ones are padded with a held
    terminal comparison window (we stop comparing after each episode ends).
    """
    cfg = default_config()
    seeds = [0, 1, 2, 3]
    trajs = [record_trajectory(cfg, seed=s, max_steps=256) for s in seeds]
    T = max(len(tr.actions) for tr in trajs)
    B = len(trajs)
    env = make_env(cfg)
    step = jax.jit(
        lambda s, a, d: env.step(s, a, deal_override=d, auto_reset=False)
    )
    init_deals = np.stack([tr.init_deals for tr in trajs])
    state, ts = env.init(jax.random.key(0), B, deal_override=init_deals)

    for t in range(T):
        actions = np.array(
            [tr.actions[t] if t < len(tr.actions) else 0 for tr in trajs],
            dtype=np.int32,
        )
        deals = np.stack(
            [
                tr.deals[t] if t < len(tr.actions) else np.full(
                    cfg.queue_size, env.empty_id, np.int32
                )
                for tr in trajs
            ]
        )
        state, ts = step(state, jnp.asarray(actions), jnp.asarray(deals))
        for b, tr in enumerate(trajs):
            if t < len(tr.actions):
                np.testing.assert_array_equal(
                    np.asarray(ts.board[b]).reshape(-1),
                    tr.boards[t + 1].reshape(-1),
                    err_msg=f"env {b} t={t}",
                )
                assert float(ts.reward[b]) == tr.rewards[t]


def test_parity_with_truncation_horizon():
    """max_steps > 0: flags (incl. terminated+truncated overlap at the
    horizon) must match the oracle bit-for-bit."""
    from blockpuzzle_tpu.config import EnvConfig

    for seed in (0, 3):
        replay_and_compare(EnvConfig(max_steps=12), seed, max_steps=64)


def test_parity_mini5_piece_set():
    """Alternate piece library exercises the piece_set knob end-to-end."""
    from blockpuzzle_tpu.config import EnvConfig

    replay_and_compare(EnvConfig(piece_set="mini5"), seed=0, max_steps=200)
    replay_and_compare(
        EnvConfig(piece_set="mini5", queue_size=2, refill_batch=True),
        seed=1,
        max_steps=200,
    )


def test_parity_streak_bonus_config():
    """streak_bonus rewards must match the oracle bit-for-bit.  A 5x5
    mini5 board clears constantly under random play, so recorded episodes
    genuinely exercise consecutive-clear bonuses (asserted below, not
    assumed)."""
    import random as pyrandom

    from blockpuzzle_tpu.config import EnvConfig
    from blockpuzzle_tpu.oracle import BlockPuzzleOracleEnv

    cfg = EnvConfig(height=5, width=5, piece_set="mini5", streak_bonus=7.0)
    # sanity: the seeded episode actually reaches a streak >= 2 (bonus > 0)
    probe = BlockPuzzleOracleEnv(cfg)
    obs, info = probe.reset(seed=0)
    rng = pyrandom.Random(0)
    best = 0
    for _ in range(300):
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            obs, info = probe.reset()
            continue
        obs, r, term, trunc, info = probe.step(int(rng.choice(legal)))
        best = max(best, info["streak"])
        if term or trunc:
            obs, info = probe.reset()
    assert best >= 2, f"seed produced no streak bonus (max streak {best})"

    for seed in (0, 2):
        replay_and_compare(cfg, seed=seed, max_steps=300)
