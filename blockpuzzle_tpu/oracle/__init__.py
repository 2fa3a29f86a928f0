"""CPU oracle: reference-faithful game core + parity trajectory recorder.

``BlockPuzzleOracleEnv`` (the ``gymnasium.Env`` wrapper) is imported on
first access, so the game core and the recorder need no gymnasium.
"""

from blockpuzzle_tpu.oracle.game import BlockPuzzleGame
from blockpuzzle_tpu.oracle.recorder import (
    RecordingOracle,
    Trajectory,
    record_trajectory,
)


def __getattr__(name):
    if name == "BlockPuzzleOracleEnv":
        from blockpuzzle_tpu.oracle.env import BlockPuzzleOracleEnv

        return BlockPuzzleOracleEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BlockPuzzleGame",
    "BlockPuzzleOracleEnv",
    "RecordingOracle",
    "Trajectory",
    "record_trajectory",
]
