"""Gymnasium surface of the CPU oracle (layer T0 of SURVEY.md §1.2).

``BlockPuzzleOracleEnv`` is the drop-in ``gym.make`` environment a user of
the reference (matthew9671/BlockPuzzle-gym) would reach for: the rules live
in ``oracle/game.py`` (NumPy only); this module adds the ``gymnasium.Env``
base class, its observation/action spaces and its seeding hook.  It is the
only oracle module that imports gymnasium.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

import gymnasium
from gymnasium import spaces

from blockpuzzle_tpu.config import EnvConfig
from blockpuzzle_tpu.oracle.game import BlockPuzzleGame


class BlockPuzzleOracleEnv(BlockPuzzleGame, gymnasium.Env):
    """Single BlockPuzzle environment (CPU, NumPy board, Python RNG)."""

    metadata = {"render_modes": ["ansi", "human", "rgb_array"], "render_fps": 4}

    def __init__(
        self,
        cfg: Optional[EnvConfig] = None,
        render_mode: Optional[str] = None,
        **overrides: Any,
    ) -> None:
        super().__init__(cfg, render_mode=render_mode, **overrides)
        cfg = self.cfg
        h, w, s = cfg.height, cfg.width, cfg.queue_size
        self.action_space = spaces.Discrete(cfg.num_actions())
        obs_spaces = {
            "board": spaces.Box(0, 1, shape=(h, w), dtype=np.uint8),
            # piece id per slot; num_pieces == empty-slot sentinel
            "queue": spaces.Box(
                0, self.tables.num_pieces, shape=(s,), dtype=np.int32
            ),
        }
        if cfg.obs_planes:
            # spatial queue rendering (one (H, W) plane per slot, piece at
            # the top-left; empty slot = zero plane) — computed from the raw
            # grids, independent of the engine's derived tables
            obs_spaces["piece_planes"] = spaces.Box(
                0, 1, shape=(s, h, w), dtype=np.uint8
            )
        self.observation_space = spaces.Dict(obs_spaces)

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        gymnasium.Env.reset(self, seed=seed)
        return BlockPuzzleGame.reset(self, seed=seed, options=options)
