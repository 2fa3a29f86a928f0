"""Frozen configuration dataclasses for the BlockPuzzle engine.

The reference (matthew9671/BlockPuzzle-gym) exposes its knobs as ``__init__``
kwargs on the env class (SURVEY.md §5 "Config / flag system"; the reference
mount was empty at build time — see SURVEY.md §0 — so the knob set below is the
canonical in-repo spec reconstructed from BASELINE.json's north_star: grid
size, queue length, piece set, reward constants, region-clear on/off).

Every field is a compile-time constant baked into the jitted step program:
``EnvConfig`` is frozen + hashable so it can be a ``static_argnum`` to
``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static game configuration shared by the CPU oracle and the device engine.

    Attributes:
      height, width: board dimensions (cells).
      queue_size: number of visible piece slots ("hand" size).
      refill_batch: if True (1010!-style) the hand refills only when ALL
        slots are empty; if False each slot refills immediately after its
        piece is placed.
      piece_set: name of the polyomino library ("classic19" or "mini5").
      region_clear: additionally clear full ``region_size``×``region_size``
        sub-squares (Woodoku variant; requires height % region_size == 0
        and width % region_size == 0).
      region_size: side of the clearable sub-squares.
      cell_reward: reward per cell of a successfully placed piece.
      line_base: base for the simultaneous-clear bonus
        ``line_base * k * (k + 1) / 2`` for ``k`` full rows+cols(+regions)
        cleared at once.
      streak_bonus: Woodoku-style consecutive-clear ("streak") bonus.  A
        legal placement that clears k>0 lines extends the env's streak
        counter and adds ``streak_bonus * (streak - 1)`` reward (the first
        clear of a streak adds nothing, the second adds 1×, the third 2×,
        ...); a legal placement that clears nothing resets the streak to 0;
        illegal no-ops leave it unchanged; episode end resets it.  0.0
        (default) disables the mechanic entirely (no extra compute in the
        jitted step).
      illegal_penalty: reward returned for an illegal action (the action is
        a no-op; the episode does not terminate).
      terminal_penalty: extra reward added on the transition that ends the
        episode (game over).
      max_steps: truncation horizon; 0 disables truncation (the game's own
        game-over rule is the only terminal).
      obs_planes: observation-mode variant — additionally expose the queue
        as ``piece_planes``: (S, H, W) binary planes with each slot's piece
        rendered at the board's top-left (empty slots are all-zero), for
        CNN-only policies.  The ``queue`` id vector stays in the
        observation either way.
    """

    height: int = 10
    width: int = 10
    queue_size: int = 1
    refill_batch: bool = False
    piece_set: str = "classic19"
    region_clear: bool = False
    region_size: int = 3
    cell_reward: float = 1.0
    line_base: float = 10.0
    streak_bonus: float = 0.0
    illegal_penalty: float = 0.0
    terminal_penalty: float = 0.0
    max_steps: int = 0
    obs_planes: bool = False

    def __post_init__(self) -> None:
        if self.height <= 0 or self.width <= 0:
            raise ValueError("board dimensions must be positive")
        if self.queue_size <= 0:
            raise ValueError("queue_size must be positive")
        # validate here rather than at make_env time so a bad name from any
        # construction path (--env piece_set=..., dataclasses.replace, direct
        # kwargs) fails as ValueError — which cli_env_config turns into a
        # clean SystemExit — instead of a raw traceback later.  Lazy import:
        # rules.py imports this module at its top.
        from blockpuzzle_tpu.rules import PIECE_SETS

        if self.piece_set not in PIECE_SETS:
            raise ValueError(
                f"unknown piece_set {self.piece_set!r}; "
                f"valid: {sorted(PIECE_SETS)}"
            )
        if self.region_clear and (
            self.height % self.region_size or self.width % self.region_size
        ):
            raise ValueError(
                "region_clear requires height and width divisible by region_size"
            )

    @property
    def num_cells(self) -> int:
        return self.height * self.width

    @property
    def board_shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def num_actions(self) -> int:
        """Flat action space size: slot-major, then row-major anchor."""
        return self.queue_size * self.height * self.width


def default_config() -> EnvConfig:
    """The PR1/parity config: 10×10 grid, single-piece queue, rows+cols clear."""
    return EnvConfig()


def tenten_config() -> EnvConfig:
    """1010!-style variant: 10×10 grid, hand of 3 with batch refill."""
    return EnvConfig(queue_size=3, refill_batch=True)


def woodoku_config() -> EnvConfig:
    """Woodoku variant: 9×9 grid, hand of 3, 3×3 region clears."""
    return EnvConfig(
        height=9, width=9, queue_size=3, refill_batch=True, region_clear=True
    )


def big_config() -> EnvConfig:
    """Larger-grid / multi-piece-queue variant (BASELINE config 3)."""
    return EnvConfig(height=16, width=16, queue_size=3, refill_batch=True)


PRESETS = {
    "default": default_config,
    "tenten": tenten_config,
    "woodoku": woodoku_config,
    "big": big_config,
}


def apply_env_overrides(cfg: EnvConfig, overrides) -> EnvConfig:
    """Apply CLI ``KEY=VALUE`` strings onto a (frozen) EnvConfig.

    Makes every config knob reachable from the CLIs without a dedicated
    flag per knob (``--env streak_bonus=5 --env queue_size=3``).  Values
    are coerced to the dataclass field's type; bools accept
    true/false/1/0/yes/no.  Unknown keys and malformed values raise
    ``ValueError`` with the valid key list.
    """
    if not overrides:
        return cfg
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    kwargs = {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"--env expects KEY=VALUE, got {item!r}")
        if key not in fields:
            raise ValueError(
                f"unknown EnvConfig field {key!r}; valid: {sorted(fields)}"
            )
        ftype = fields[key]
        # dataclass field types arrive as strings under
        # `from __future__ import annotations`
        tname = ftype if isinstance(ftype, str) else ftype.__name__
        if tname == "bool":
            low = raw.strip().lower()
            if low in ("1", "true", "yes"):
                kwargs[key] = True
            elif low in ("0", "false", "no"):
                kwargs[key] = False
            else:
                raise ValueError(f"--env {key}: not a bool: {raw!r}")
        elif tname == "int":
            kwargs[key] = int(raw)
        elif tname == "float":
            kwargs[key] = float(raw)
        else:
            kwargs[key] = raw
    return dataclasses.replace(cfg, **kwargs)


def cli_env_config(preset: str, overrides) -> EnvConfig:
    """Preset lookup + ``--env KEY=VALUE`` overrides, exiting on bad input.

    The shared entry point for every CLI (train/rollout/evaluate/parity):
    malformed overrides become a clean ``SystemExit`` with the ``ValueError``
    message instead of a traceback.
    """
    try:
        return apply_env_overrides(PRESETS[preset](), overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None
