"""Trajectory recording for the seeded parity harness (SURVEY.md §3.5).

Runs the CPU oracle with a seeded random policy (uniform over the legal-action
mask, drawn from the oracle's own ``random.Random`` so the whole trajectory is
reproducible from one seed) and records everything the batched device engine
must reproduce bit-for-bit: boards, queues, dealt pieces, actions, rewards, and
termination flags.

The dealt-piece stream is the key artifact: the device engine's parity mode
consumes it directly instead of re-deriving Python-MT19937 draws on device
(SURVEY.md §7.1 PR2 — "bit-exact vs Python MT19937" via piece-stream
injection).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np

from blockpuzzle_tpu.config import EnvConfig
from blockpuzzle_tpu.oracle.game import BlockPuzzleGame


@dataclasses.dataclass
class Trajectory:
    """One recorded oracle episode (arrays have leading time axis T)."""

    cfg: EnvConfig
    seed: int
    actions: np.ndarray        # (T,) int32
    boards: np.ndarray         # (T+1, H, W) uint8 — boards[t] is pre-action t
    queues: np.ndarray         # (T+1, S) int32
    masks: np.ndarray          # (T+1, S*H*W) bool
    rewards: np.ndarray        # (T,) float32
    terminated: np.ndarray     # (T,) bool
    truncated: np.ndarray      # (T,) bool
    deals: np.ndarray          # (T, S) int32 — pieces dealt AFTER action t,
                               # slot-order; empty sentinel where no deal
    init_deals: np.ndarray     # (S,) int32 — pieces dealt at reset
    episode_return: float


class RecordingOracle(BlockPuzzleGame):
    """Oracle that logs every RNG deal, for piece-stream injection."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.deal_log: List[int] = []

    def _deal(self) -> int:
        p = super()._deal()
        self.deal_log.append(p)
        return p


def record_trajectory(
    cfg: EnvConfig,
    seed: int,
    max_steps: int = 512,
    policy_seed: Optional[int] = None,
) -> Trajectory:
    """Roll out one episode with a seeded uniform-legal random policy.

    The policy stream defaults to ``seed + 1`` so it is decorrelated from
    the env's deal stream (two ``random.Random(seed)`` instances emit
    identical sequences, which narrows trajectory diversity).
    """
    env = RecordingOracle(cfg)
    policy_rng = random.Random(seed + 1 if policy_seed is None else policy_seed)

    obs, info = env.reset(seed=seed)
    init_deals = np.array(env.deal_log, dtype=np.int32)
    if init_deals.size < cfg.queue_size:  # batch refill pads nothing at reset
        pad = np.full(cfg.queue_size - init_deals.size, env._empty_id, np.int32)
        init_deals = np.concatenate([init_deals, pad])

    boards = [obs["board"]]
    queues = [obs["queue"]]
    masks = [info["action_mask"]]
    actions, rewards, terms, truncs, deals = [], [], [], [], []

    for _ in range(max_steps):
        mask = info["action_mask"]
        legal = np.where(mask)[0]
        if legal.size == 0:
            break
        a = int(legal[policy_rng.randrange(legal.size)])
        n_before = len(env.deal_log)
        obs, r, term, trunc, info = env.step(a)
        step_deals = env.deal_log[n_before:]
        padded = np.full(cfg.queue_size, env._empty_id, dtype=np.int32)
        padded[: len(step_deals)] = step_deals
        actions.append(a)
        rewards.append(r)
        terms.append(term)
        truncs.append(trunc)
        deals.append(padded)
        boards.append(obs["board"])
        queues.append(obs["queue"])
        masks.append(info["action_mask"])
        if term or trunc:
            break

    return Trajectory(
        cfg=cfg,
        seed=seed,
        actions=np.asarray(actions, dtype=np.int32),
        boards=np.stack(boards),
        queues=np.stack(queues),
        masks=np.stack(masks),
        rewards=np.asarray(rewards, dtype=np.float32),
        terminated=np.asarray(terms, dtype=bool),
        truncated=np.asarray(truncs, dtype=bool),
        deals=np.stack(deals) if deals else np.zeros((0, cfg.queue_size), np.int32),
        init_deals=init_deals,
        episode_return=float(np.sum(rewards)),
    )
