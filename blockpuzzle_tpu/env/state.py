"""Batched environment state and timestep pytrees.

All arrays carry a leading env axis N (SURVEY.md §1.2 layer T4).  State is a
frozen-dataclass pytree so it can flow through ``jit`` / ``lax.scan`` /
``donate_argnums`` and be sharded on an ``("env",)`` mesh axis unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose fields are all leaves
    (subtrees), with a ``.replace(**changes)`` copy method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@pytree_dataclass
class EnvState:
    """Per-env game state, leading axis N.

    Attributes:
      board: (N, H*W) uint8 flat occupancy grid.
      queue: (N, S) int32 piece ids; ``num_pieces`` is the empty-slot
        sentinel.
      base_key: (N,) typed PRNG keys — per-env stream roots; never change.
      rng_counter: (N,) int32 monotone per-env draw counter.  Folded into
        ``base_key`` for each step's deals; NEVER reset (auto-reset would
        otherwise replay the same piece stream every episode).  Together
        with ``base_key`` this is the counter-based RNG scheme from
        BASELINE.json ("Python random → jax.random").
      steps: (N,) int32 steps in the current episode (reset on episode end).
      score: (N,) float32 return accumulated in the current episode.
      streak: (N,) int32 consecutive-clear counter (``cfg.streak_bonus``
        mechanic; stays all-zero when the knob is 0.0).
    """

    board: jax.Array
    queue: jax.Array
    base_key: jax.Array
    rng_counter: jax.Array
    steps: jax.Array
    score: jax.Array
    streak: jax.Array

    @property
    def num_envs(self) -> int:
        return self.board.shape[0]


@pytree_dataclass
class TimeStep:
    """Output of one batched step: obs + reward/done + info, all (N, ...).

    obs fields (the reference packs board + queue into the observation,
    SURVEY.md §2.1 "Observation packing"; the legal-action mask rides along
    as the reference exposes masking, §2.1 "Legal-placement check"):
      board: (N, H, W) uint8
      queue: (N, S) int32
      action_mask: (N, S*H*W) bool
      piece_planes: (N, S, H, W) uint8 spatial queue rendering, present
        only when ``EnvConfig.obs_planes`` is set (None otherwise — the
        flag is static, so every TimeStep in a program agrees).
    """

    board: jax.Array
    queue: jax.Array
    action_mask: jax.Array
    reward: jax.Array       # (N,) float32
    terminated: jax.Array   # (N,) bool — game over (no legal placement)
    truncated: jax.Array    # (N,) bool — max_steps horizon hit
    info: Dict[str, Any]    # lines_cleared, legal, episode_return, ...
    piece_planes: Any = None

    @property
    def done(self) -> jax.Array:
        return jnp.logical_or(self.terminated, self.truncated)

    @property
    def obs(self) -> Dict[str, jax.Array]:
        out = {
            "board": self.board,
            "queue": self.queue,
            "action_mask": self.action_mask,
        }
        if self.piece_planes is not None:
            out["piece_planes"] = self.piece_planes
        return out
