"""Rollout CLI: random or checkpoint policy, single-env render or batched.

Mirrors the reference's demo script role (SURVEY.md §2.1 "Demo / training
script(s)"): ``--render`` plays one env on the CPU oracle with ASCII frames;
otherwise runs a batched device rollout and reports episode statistics.
"""

from __future__ import annotations

import argparse

import numpy as np

from blockpuzzle_tpu.config import PRESETS, cli_env_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BlockPuzzle rollout driver")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VALUE",
                   help="override any EnvConfig field on top of --preset "
                        "(repeatable), e.g. --env streak_bonus=5 "
                        "--env queue_size=3")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--state-impl", choices=["auto", "packed", "u8"],
                   default="auto", help="EnvState board layout "
                        "(auto = packed where supported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render", action="store_true",
                   help="single oracle env with ASCII rendering")
    p.add_argument("--render-delay", type=float, default=0.0)
    return p


def run_render(args) -> int:
    import random
    import time

    from blockpuzzle_tpu.oracle import BlockPuzzleOracleEnv

    cfg = cli_env_config(args.preset, args.env)
    env = BlockPuzzleOracleEnv(cfg, render_mode="human")
    obs, info = env.reset(seed=args.seed)
    rng = random.Random(args.seed)
    for t in range(args.steps):
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            break
        obs, r, term, trunc, info = env.step(int(rng.choice(legal)))
        env.render()
        if args.render_delay:
            time.sleep(args.render_delay)
        if term or trunc:
            print(f"episode over after {t + 1} steps, score {env.score:.1f}")
            break
    return 0


def run_batched(args) -> int:
    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.utils import Throughput, enable_compilation_cache

    enable_compilation_cache()

    cfg = cli_env_config(args.preset, args.env)
    env = make_env(cfg, state_impl=None if args.state_impl == "auto"
                   else args.state_impl)
    state, ts = env.init_jit(jax.random.key(args.seed), args.num_envs)

    @jax.jit
    def chunk(state, mask, key):
        def body(carry, _):
            state, mask, key = carry
            key, sub = jax.random.split(key)
            a = jax.random.categorical(
                sub, jnp.where(mask, 0.0, -1e9), axis=-1
            )
            state, ts = env.step(state, a)
            done = ts.done
            return (state, ts.action_mask, key), (
                ts.reward.sum(),
                (ts.info["episode_return"] * done).sum(),
                done.sum(),
            )

        (state, mask, key), outs = jax.lax.scan(
            body, (state, mask, key), None, length=100, unroll=4
        )
        return state, mask, key, [o.sum() for o in outs]

    meter = Throughput()
    key = jax.random.key(args.seed + 1, impl="rbg")  # fast PRNG for sampling
    mask = ts.action_mask
    # warmup chunk: compiles the program and arms the throughput meter, so
    # even a single measured chunk reports a real steady-state rate
    state, mask, key, (r0, _, _) = chunk(state, mask, key)
    jax.block_until_ready(r0)
    meter.tick(0)
    total_r = total_ep_r = total_eps = 0.0
    chunks = max(round(args.steps / 100), 1)
    for i in range(chunks):
        state, mask, key, (r, ep_r, eps) = chunk(state, mask, key)
        jax.block_until_ready(r)  # completion barrier before the tick
        sps = meter.tick(100 * args.num_envs)
        total_r += float(r)
        total_ep_r += float(ep_r)
        total_eps += float(eps)
    steps = chunks * 100 * args.num_envs
    print(
        f"{steps} env-steps (chunks of 100) | {sps / 1e6:.2f}M steps/s steady | "
        f"reward/step {total_r / steps:.3f} | "
        f"episodes {int(total_eps)} | "
        f"mean episode return "
        f"{total_ep_r / max(total_eps, 1):.1f}"
    )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run_render(args) if args.render else run_batched(args)


if __name__ == "__main__":
    raise SystemExit(main())
