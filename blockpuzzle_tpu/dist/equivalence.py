"""Sharded == unsharded check for the learners on a (dp, tp) mesh.

One PPO update on a mesh of ``devices`` with the project's real shardings
(env/batch axis on dp, Megatron column/row dense split on tp) must match the
same update on ``devices[0]`` alone; one DQN iteration (collection, replay
write, PER sampling, n-step window, dueling head) must run sharded and fill
the replay as expected.  Shared by the CPU dryrun (``__graft_entry__``, the
tests) and ``chip_smoke.py --four-gpus`` on real cards.

Sampling uses threefry: the default rbg PRNG's output is documented as
unstable across shardings of one computation.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import jax
import numpy as np

from blockpuzzle_tpu.dist.mesh import make_mesh
from blockpuzzle_tpu.dist.sharding import to_named, train_state_spec


def check_placement(tree: Any, mesh) -> None:
    """Every array of ``tree`` lives on exactly the mesh's devices, and
    every dp-sharded leading axis is split into one shard per dp row."""
    mesh_devices = set(mesh.devices.flat)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        where = jax.tree_util.keystr(path)
        if leaf.sharding.device_set != mesh_devices:
            raise AssertionError(
                f"{where} lives on {sorted(d.id for d in leaf.sharding.device_set)}"
                f", not on the mesh {sorted(d.id for d in mesh_devices)}"
            )
        spec = getattr(leaf.sharding, "spec", None)
        if spec and spec[0] == "dp":
            rows = {s.data.shape[0] for s in leaf.addressable_shards}
            if rows != {leaf.shape[0] // mesh.shape["dp"]}:
                raise AssertionError(
                    f"{where}: shard rows {rows} for {leaf.shape[0]} rows "
                    f"over dp={mesh.shape['dp']}"
                )


def _max_param_diff(a: Any, b: Any, rtol: float, atol: float):
    """(max |a-b|, fraction of elements outside rtol/atol) over a tree."""
    worst, bad, total = 0.0, 0, 0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        d = np.abs(x - y)
        worst = max(worst, float(d.max(initial=0.0)))
        bad += int((d > atol + rtol * np.abs(y)).sum())
        total += d.size
    return worst, bad / max(total, 1)


def check_sharded_equivalence(
    devices: Sequence[jax.Device],
    tp: int,
    envs_per_dp: int = 4,
    hidden: int = 64,
    channels=(8,),
    param_outlier_frac: float = 0.0,
) -> Dict[str, float]:
    """Run the PPO and DQN checks on a (len(devices)//tp, tp) mesh.

    PPO metrics must agree to 1e-3 relative.  Params must agree to
    rtol=1e-4 / atol=1e-5, except for at most ``param_outlier_frac`` of
    the elements, which may differ by up to one Adam step each way per
    gradient step (2 * lr * steps): a coordinate whose gradient is at
    rounding-noise level can take the opposite sign when the reduction
    order changes, and Adam moves it by about lr regardless of the
    gradient's size.  Returns the measured differences.
    """
    from blockpuzzle_tpu.config import default_config
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig

    mesh = make_mesh(tp=tp, devices=devices)
    dp = len(devices) // tp
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(
        num_envs=envs_per_dp * dp, rollout_len=4, num_epochs=1,
        num_minibatches=2, hidden=hidden, channels=tuple(channels),
        sample_rng_impl="threefry2x32",
    ))
    state = ppo.init(jax.random.key(0))
    sharded = jax.device_put(state, to_named(mesh, train_state_spec(state)))
    check_placement(sharded, mesh)
    # NO donation: `state` stays live as the unsharded reference input
    update = jax.jit(ppo.update)
    sharded_out, metrics = jax.block_until_ready(update(sharded))
    check_placement(sharded_out, mesh)
    single_out, single_metrics = jax.block_until_ready(
        update(jax.device_put(state, devices[0]))
    )
    out: Dict[str, float] = {"dp": dp, "tp": tp}
    for name in ("loss", "policy_loss", "value_loss", "entropy"):
        a, b = float(metrics[name]), float(single_metrics[name])
        if not np.isfinite(a):
            raise AssertionError(f"non-finite sharded PPO {name}: {a}")
        if abs(a - b) > 1e-3 * max(1.0, abs(b)):
            raise AssertionError(
                f"sharded vs unsharded PPO metric {name!r} diverged: "
                f"{a} vs {b}"
            )
        out[name] = a
    steps = ppo.cfg.num_epochs * ppo.cfg.num_minibatches
    worst, frac = _max_param_diff(
        sharded_out.params, single_out.params, rtol=1e-4, atol=1e-5
    )
    out["param_max_abs_diff"], out["param_outlier_frac"] = worst, frac
    if frac > param_outlier_frac or worst > 2 * ppo.cfg.lr * steps + 1e-5:
        raise AssertionError(
            f"sharded vs unsharded PPO params diverged: max |diff| {worst}, "
            f"{frac:.2e} of elements outside rtol=1e-4/atol=1e-5"
        )

    dqn = DQN(env, DQNConfig(
        num_envs=envs_per_dp * dp, buffer_size=16 * envs_per_dp * dp,
        batch_size=8,
        collect_steps=2, min_buffer=8, hidden=hidden // 2,
        channels=tuple(channels),
        # the n-step window shards on its env axis (axis 1), the dueling
        # head adds a second row-parallel head, PER adds the dp-sharded
        # priority buffer and its sampler
        n_step=2, dueling=True, per=True,
    ))
    dstate = dqn.init(jax.random.key(1))
    dstate = jax.device_put(dstate, to_named(mesh, train_state_spec(dstate)))
    check_placement(dstate, mesh)
    dqn_it = jax.jit(dqn.iteration, donate_argnums=(0,))
    dstate, dmetrics = jax.block_until_ready(dqn_it(dstate))
    n = envs_per_dp * dp
    # n_step=2: the first iteration's first emission is rooted at the
    # startup-invalid pending slot and drops -> 1 of 2 steps written
    if int(dmetrics["buffer_filled"]) != n:
        raise AssertionError(f"replay fill {int(dmetrics['buffer_filled'])}")
    dstate, dmetrics = jax.block_until_ready(dqn_it(dstate))
    if int(dmetrics["buffer_filled"]) != 3 * n:
        raise AssertionError(f"replay fill {int(dmetrics['buffer_filled'])}")
    if not np.isfinite(float(dmetrics["loss"])):
        raise AssertionError(f"non-finite DQN loss {float(dmetrics['loss'])}")
    check_placement(dstate, mesh)
    out["dqn_loss"] = float(dmetrics["loss"])
    out["dqn_buffer_filled"] = int(dmetrics["buffer_filled"])
    return out
