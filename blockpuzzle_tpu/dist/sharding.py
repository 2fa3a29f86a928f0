"""Partition-spec rules for train state pytrees (SURVEY.md §2.3).

Regex-over-parameter-path rules (the standard JAX "match partition rules"
pattern) mapped onto our (dp, tp) mesh:

  * env state, rollout batches, replay buffers: leading axis on ``dp``.
  * dense kernels named in PARAM_RULES: Megatron column/row split on
    ``tp`` — the only place the networks' tensor-parallel layout lives.
  * everything else (small conv kernels, biases, opt scalars): replicated.

At default model sizes tp=1 and every param replicates; the rules exist so
the same program scales when tp>1.
"""

from __future__ import annotations

import re
from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from blockpuzzle_tpu.dist.mesh import ENV_AXIS

# (regex over '/'-joined param path, PartitionSpec) — first match wins.
PARAM_RULES = [
    # column-parallel hidden projection: (in, hidden) -> shard hidden
    (r"Torso_0/hidden_proj/kernel", P(None, "tp")),
    # column-parallel mlp-torso input matmul: (cells, width) -> shard width
    (r"Torso_0/mlp_0/kernel", P(None, "tp")),
    # row-parallel output heads: (hidden, out) -> shard hidden.  \d+: the
    # dueling QNetwork has two heads (Head_0 value, Head_1 advantage), and
    # both must carry the rule at tp>1.
    (r"Head_\d+/kernel", P("tp", None)),
    (r".*", P()),
]


def _path_str(keypath) -> str:
    """'/'-joined names of a pytree key path (dict keys, attribute names)."""
    parts = []
    for k in keypath:
        for attr in ("name", "key", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def _rule_spec(path: str, leaf: Any) -> P:
    if hasattr(leaf, "ndim") and leaf.ndim > 1:
        for rule, s in PARAM_RULES:
            if re.search(rule, path):
                return s
    return P()


def param_spec(params: Any) -> Any:
    """Pytree of PartitionSpec for a param tree, via PARAM_RULES."""
    return jax.tree_util.tree_map_with_path(
        lambda kp, leaf: _rule_spec(_path_str(kp), leaf), params
    )


def batched_spec(pytree: Any) -> Any:
    """PartitionSpec pytree sharding every non-scalar leaf's axis 0 on dp."""

    def leaf_spec(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            return P(ENV_AXIS)
        return P()

    return jax.tree.map(leaf_spec, pytree)


def train_state_spec(train_state: Any, params_field: str = "params") -> Any:
    """Sharding spec for a PPO/DQN TrainState-like pytree.

    params + opt_state follow PARAM_RULES (they mirror the param tree);
    env_state / obs / replay shard on dp; scalars and keys replicate.
    """

    def spec_for(path, leaf):
        if path.startswith(("params", "opt_state", "target_params")):
            return _rule_spec(path, leaf)
        if path.startswith(("key", "update_count", "iter_count", "grad_count")):
            return P()
        if path.endswith(("cursor", "filled")):
            return P()
        if path.startswith("pending"):
            # DQN n-step window: (n-1, N, ...) — env axis is AXIS 1 (time
            # window leads); the (n-1,) validity vector replicates
            if hasattr(leaf, "ndim") and leaf.ndim >= 2:
                return P(None, ENV_AXIS)
            return P()
        if hasattr(leaf, "ndim") and leaf.ndim >= 1:
            return P(ENV_AXIS)
        return P()

    return jax.tree_util.tree_map_with_path(
        lambda kp, leaf: spec_for(_path_str(kp), leaf), train_state
    )


def to_named(mesh: Mesh, spec_tree: Any) -> Any:
    return jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        spec_tree,
        is_leaf=lambda x: isinstance(x, P),
    )
