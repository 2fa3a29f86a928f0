"""Fused actor-step throughput: policy-in-the-loop rollout, no learning.

bench.py times the env alone and scripts/bench_learner.py the full PPO
update; this times the eval/serving axis — policy forward + masked action
selection + env step in ONE jitted program, the same program shape as
``__graft_entry__.entry`` and ``cli.evaluate`` — with bench.py's window
protocol (steady state, excluding compile, ``block_until_ready`` at the
end of each window).

Prints one JSON line per (torso, policy) combination:
  {"metric": "actor_steps_per_s", "torso": ..., "policy": ...,
   "num_envs": N, "value": steps_per_s}
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_one(env, ppo, params, num_envs: int, policy: str,
              chunk: int, iters: int, windows: int) -> float:
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_chunk(env_state, board, queue, mask, key):
        def body(carry, _):
            env_state, board, queue, mask, key = carry
            logits, _ = ppo.net.apply(params, board, queue, mask)
            if policy == "greedy":
                a = jnp.argmax(logits, axis=-1)
            else:
                key, sub = jax.random.split(key)
                a = jax.random.categorical(sub, logits, axis=-1)
            env_state, ts = env.step(env_state, a)
            return (
                (env_state, ts.board, ts.queue, ts.action_mask, key),
                ts.reward.sum(),
            )

        (env_state, board, queue, mask, key), r = jax.lax.scan(
            body, (env_state, board, queue, mask, key), None,
            length=chunk, unroll=4,
        )
        return env_state, board, queue, mask, key, r.sum()

    env_state, ts = env.init_jit(jax.random.key(0), num_envs)
    key = jax.random.key(1, impl="rbg")
    carry = (env_state, ts.board, ts.queue, ts.action_mask, key)
    *carry, r = run_chunk(*carry)  # compile + warmup
    jax.block_until_ready(r)
    rates = []
    for w in range(windows):
        t0 = time.time()
        for _ in range(iters):
            *carry, r = run_chunk(*carry)
        jax.block_until_ready(r)
        rate = iters * chunk * num_envs / (time.time() - t0)
        print(f"[actor] window {w}: {rate / 1e6:.2f}M steps/s",
              file=sys.stderr)
        rates.append(rate)
    rates.sort()
    return rates[len(rates) // 2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=49152,
                   help="bench.py's headline batch")
    p.add_argument("--torsos", nargs="*", default=["mlp", "conv"],
                   choices=["mlp", "conv"])
    p.add_argument("--policies", nargs="*", default=["greedy", "sample"],
                   choices=["greedy", "sample"])
    p.add_argument("--preset", default="default")
    p.add_argument("--mlp-width", type=int, default=512)
    p.add_argument("--queue-mode", choices=["embed", "planes"],
                   default="embed")
    p.add_argument("--chunk", type=int, default=400)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--windows", type=int, default=5)
    from blockpuzzle_tpu.utils import add_platform_arg, select_platform

    add_platform_arg(p)
    args = p.parse_args()

    import jax
    select_platform(args.platform)

    from blockpuzzle_tpu.config import PRESETS
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import PPO, PPOConfig
    from blockpuzzle_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    env = make_env(PRESETS[args.preset]())
    for torso in args.torsos:
        ppo = PPO(env, PPOConfig(
            num_envs=args.num_envs, rollout_len=8, torso=torso,
            mlp_width=args.mlp_width, queue_mode=args.queue_mode,
        ))
        params = ppo.init(jax.random.key(0)).params
        for policy in args.policies:
            rate = bench_one(
                env, ppo, params, args.num_envs, policy,
                args.chunk, args.iters, args.windows,
            )
            print(json.dumps({
                "metric": "actor_steps_per_s",
                "torso": torso,
                "policy": policy,
                "preset": args.preset,
                "num_envs": args.num_envs,
                "value": round(rate),
            }))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
