"""Evaluation CLI: roll out a trained checkpoint policy, report episode stats.

Completes the train → checkpoint → eval workflow: restores the latest (or a
given) checkpoint produced by ``cli.train``, runs N envs with the greedy (or
sampled) masked policy fully on device, and compares against the
uniform-random-legal baseline.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from blockpuzzle_tpu.config import PRESETS, cli_env_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import PPO, PPOConfig
from blockpuzzle_tpu.utils import (
    CheckpointManager,
    add_platform_arg,
    select_platform,
)


# network/env flags default to None = "take it from the checkpoint's
# run_meta.json"; an explicit flag always wins.  Fallbacks (pre-metadata
# checkpoints) match cli.train's defaults.
_META_DEFAULTS = {"algo": "ppo", "preset": "default", "torso": "conv",
                  "mlp_width": 512, "queue_mode": "embed", "dueling": False}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluate a trained policy")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, default=None, help="checkpoint step")
    p.add_argument("--algo", choices=["ppo", "dqn"], default=None,
                   help="which learner produced the checkpoint "
                        "(default: from the checkpoint's run_meta.json)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="env preset (default: from run_meta.json)")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VALUE",
                   help="override any EnvConfig field on top of --preset "
                        "(repeatable), e.g. --env streak_bonus=5 "
                        "--env queue_size=3; applied AFTER the checkpoint's "
                        "recorded overrides")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=1024, help="eval env steps")
    p.add_argument("--greedy", action="store_true",
                   help="argmax policy instead of sampling")
    p.add_argument("--torso", choices=["conv", "mlp"], default=None,
                   help="network torso (default: from run_meta.json)")
    p.add_argument("--mlp-width", type=int, default=None,
                   help="mlp-torso width (default: from run_meta.json)")
    p.add_argument("--queue-mode", choices=["embed", "planes"], default=None,
                   help="hand representation (default: from run_meta.json)")
    p.add_argument("--dueling", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="DQN dueling head — changes the param tree "
                        "(default: from run_meta.json)")
    p.add_argument("--state-impl", choices=["auto", "packed", "u8"],
                   default="auto", help="EnvState board layout "
                        "(auto = packed where supported)")
    p.add_argument("--seed", type=int, default=0)
    add_platform_arg(p)
    return p


def _fill_from_run_meta(args, mgr) -> None:
    """Fill unset network/env flags from the checkpoint's run_meta.json."""
    meta = mgr.load_run_meta() or {}
    detected = []
    for field, fallback in _META_DEFAULTS.items():
        if getattr(args, field) is None:
            if field in meta:
                detected.append(f"{field}={meta[field]}")
            setattr(args, field, meta.get(field, fallback))
    # checkpoint-recorded EnvConfig overrides apply first; explicit --env
    # flags come after so they win (cli_env_config applies in order)
    recorded = meta.get("env_overrides", [])
    if recorded:
        detected.append(f"env_overrides={recorded}")
    args.env = list(recorded) + args.env
    # peak selection (sweep_ppo --eval-kept): on post-peak-regression
    # curves the LATEST checkpoint is systematically worse than the
    # recorded argmax, so default --step to best_step when present
    if args.step is None and "best_step" in meta:
        args.step = int(meta["best_step"])
        detected.append(f"step={args.step} (best_step)")
    if detected:
        print(f"[run_meta] {' '.join(detected)}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    select_platform(args.platform)

    mgr = CheckpointManager(args.checkpoint_dir)
    _fill_from_run_meta(args, mgr)

    cfg = cli_env_config(args.preset, args.env)
    env = make_env(cfg, state_impl=None if args.state_impl == "auto"
                   else args.state_impl)
    cfg = env.cfg
    if args.algo == "ppo":
        net = PPO(
            env, PPOConfig(num_envs=args.num_envs, torso=args.torso,
                           mlp_width=args.mlp_width,
                           queue_mode=args.queue_mode)
        ).net
    else:
        from blockpuzzle_tpu.learn import DQN, DQNConfig

        net = DQN(
            env, DQNConfig(num_envs=args.num_envs, torso=args.torso,
                           mlp_width=args.mlp_width,
                           queue_mode=args.queue_mode,
                           dueling=bool(args.dueling))
        ).net
    # abstract params template via eval_shape — no device work, no env/opt
    # init
    params_template = jax.eval_shape(net.init, jax.random.key(0))
    # params-only restore: eval doesn't need the optimizer state, and this
    # stays compatible with checkpoints trained under any LR schedule
    params = mgr.restore_params(params_template, step=args.step)
    print(f"restored checkpoint step {args.step or mgr.latest_step()}")
    env_state, ts = env.init_jit(jax.random.key(args.seed + 1), args.num_envs)
    # chunk length adapts to short runs (--steps < 64 used to silently
    # round up to 64); the scan length is static per jit compile
    chunk_len = max(1, min(64, args.steps))

    # params enter as a JIT ARGUMENT, not a closure: device-resident
    # closure constants are copied device->host during lowering (see the
    # table note in env/core.py)
    @jax.jit
    def chunk(params, env_state, board, queue, mask, key):
        def body(carry, _):
            env_state, board, queue, mask, key = carry
            key, sub = jax.random.split(key)
            out = net.apply(params, board, queue, mask)
            # ActorCritic -> (logits, value); QNetwork -> masked q-values
            logits = out[0] if isinstance(out, tuple) else out
            if args.greedy or args.algo == "dqn":
                a = jnp.argmax(logits, axis=-1)
            else:
                a = jax.random.categorical(sub, logits, axis=-1)
            env_state, ts = env.step(env_state, a)
            done = ts.done
            out = (
                ts.reward.sum(),
                (ts.info["episode_return"] * done).sum(),
                (ts.info["episode_length"] * done).sum(),
                done.sum(),
            )
            return (env_state, ts.board, ts.queue, ts.action_mask, key), out

        (env_state, board, queue, mask, key), outs = jax.lax.scan(
            body, (env_state, board, queue, mask, key), None, length=chunk_len
        )
        return (env_state, board, queue, mask, key), [o.sum() for o in outs]

    carry = (
        env_state,
        ts.board,
        ts.queue,
        ts.action_mask,
        jax.random.key(args.seed + 2),
    )
    tot_r = tot_ep_r = tot_ep_len = tot_eps = 0.0
    n_chunks = max(-(-args.steps // chunk_len), 1)
    for _ in range(n_chunks):
        carry, (r, ep_r, ep_len, eps) = chunk(params, *carry)
        tot_r += float(r)
        tot_ep_r += float(ep_r)
        tot_ep_len += float(ep_len)
        tot_eps += float(eps)
    steps = n_chunks * chunk_len * args.num_envs
    mode = "greedy" if args.greedy else "sampled"
    print(
        f"[{mode}] {steps} env-steps | reward/step {tot_r / steps:.3f} | "
        f"episodes {int(tot_eps)} | mean return {tot_ep_r / max(tot_eps, 1):.1f} | "
        f"mean length {tot_ep_len / max(tot_eps, 1):.1f}"
    )
    print("(uniform-random-legal baseline on default preset: return ~78)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
