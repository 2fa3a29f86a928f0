"""Aux subsystems: checkpointing, metrics, profiling (SURVEY.md §5)."""

from blockpuzzle_tpu.utils.checkpoint import CheckpointManager
from blockpuzzle_tpu.utils.compile_cache import enable_compilation_cache
from blockpuzzle_tpu.utils.debug import (
    debug_mode,
    enable_debug_mode,
    validate_env_state,
)
from blockpuzzle_tpu.utils.metrics import MetricsLogger, Throughput
from blockpuzzle_tpu.utils.platform import add_platform_arg, select_platform
from blockpuzzle_tpu.utils.profiling import ScopeTimer, device_trace

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "Throughput",
    "add_platform_arg",
    "select_platform",
    "ScopeTimer",
    "device_trace",
    "enable_compilation_cache",
    "debug_mode",
    "enable_debug_mode",
    "validate_env_state",
]
