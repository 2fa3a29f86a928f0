"""blockpuzzle_tpu: a vectorized BlockPuzzle RL engine on the accelerator.

Brand-new JAX/XLA implementation of the capabilities of the reference Gym
environment (matthew9671/BlockPuzzle-gym — mount empty at build time, see
SURVEY.md §0; semantics pinned by the in-repo CPU oracle): batched lockstep
``step``/``reset`` over (N, H, W) boards under one XLA program, counter-based
``jax.random`` piece dealing, fused bitboard action masking + auto-reset +
observation packing, on-device PPO/DQN, and multi-device env sharding via
``jax.sharding``.

Gymnasium is optional: the Gymnasium ids are registered on import only when
``gymnasium`` is installed; the engine, learners and CLIs never need it.
"""

from blockpuzzle_tpu.config import (
    EnvConfig,
    PRESETS,
    big_config,
    default_config,
    tenten_config,
    woodoku_config,
)

__version__ = "0.1.0"

_REGISTERED = False


def register_gym_envs() -> None:
    """Register Gymnasium ids mirroring the reference's ``gym.make`` surface.

    The reference registers its env id in its package ``__init__`` (SURVEY.md
    §1.1 L0).  Ids here: ``BlockPuzzleTpu/BlockPuzzle-v0`` (oracle CPU env)
    plus one id per preset variant.  Raises ImportError without gymnasium.
    """
    global _REGISTERED
    if _REGISTERED:
        return
    import gymnasium

    for name, preset in PRESETS.items():
        suffix = "" if name == "default" else f"-{name}"
        gymnasium.register(
            id=f"BlockPuzzleTpu/BlockPuzzle{suffix}-v0",
            entry_point="blockpuzzle_tpu.oracle.env:BlockPuzzleOracleEnv",
            vector_entry_point="blockpuzzle_tpu.vector_env:BlockPuzzleVectorEnv",
            kwargs={"cfg": preset()},
        )
    _REGISTERED = True


try:
    register_gym_envs()
except ImportError:  # gymnasium is the optional ``gym`` extra
    pass

__all__ = [
    "EnvConfig",
    "PRESETS",
    "default_config",
    "tenten_config",
    "woodoku_config",
    "big_config",
    "register_gym_envs",
    "__version__",
]
