"""Device mesh construction and multi-host initialization (SURVEY.md §2.4).

The reference is single-process with no communication backend; the target
equivalent is JAX's native runtime: ``jax.distributed.initialize`` for the
multi-process group, and XLA-compiled collectives (NCCL over NVLink between
the GPUs of a host) inside ``jit`` (BASELINE config 5).  The mesh carries two axes:

  * ``dp`` — the env/batch data-parallel axis (envs are independent, so the
    env step needs zero collectives; only learner gradients all-reduce).
  * ``tp`` — a spare tensor-parallel axis for oversized-model experiments
    (Megatron column/row sharding of the Dense layers, SURVEY.md §2.3).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "dp"
MODEL_AXIS = "tp"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-process rendezvous.  No-op when single-process.

    Nothing on a plain GPU machine tells JAX of a cluster, so a
    multi-process launch passes ``coordinator_address``
    (``host:port``), ``num_processes`` (or BLOCKPUZZLE_NUM_PROCESSES) and
    ``process_id`` explicitly.  Safe to call unconditionally: single-process
    runs skip initialization.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("BLOCKPUZZLE_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    tp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """(dp, tp) mesh over all devices; dp = num_devices // tp.

    The GPUs of a host are joined all to all (NVLink), so the layout
    follows the algorithm alone: ``tp`` is the minor axis (each tp group is
    a run of consecutive devices), ``dp`` spans the rest; across hosts only
    the once-per-update gradient all-reduce crosses the network.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    arr = np.array(devices).reshape(n // tp, tp)
    return Mesh(arr, (ENV_AXIS, MODEL_AXIS))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Leading env axis sharded over dp; everything else replicated."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_axis(mesh: Mesh, pytree):
    """Apply env-axis sharding to every array leaf with a leading batch dim."""
    sh = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), pytree)
