"""Vectorized device env engine (layer T4 of SURVEY.md §1.2)."""

from blockpuzzle_tpu.env.core import VecBlockPuzzle, make_env
from blockpuzzle_tpu.env.state import EnvState, TimeStep
from blockpuzzle_tpu.env.words import (
    legal_words,
    pack_bool_mask,
    sample_uniform_legal,
)

__all__ = [
    "VecBlockPuzzle", "make_env", "EnvState", "TimeStep",
    "legal_words", "pack_bool_mask", "sample_uniform_legal",
]
