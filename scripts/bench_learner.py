"""Learner-throughput bench: PPO frames/s across program variants.

The update, not the env, bounds wall-clock-to-reward, so this measures
the learner levers head-to-head on the device:

  * ``base``     — conv torso, one update per dispatch.
  * ``dispatchK``— conv torso, ``multi_update`` scanning K updates per
                   dispatch (amortizes the host round trip per dispatch).
  * ``mlp``      — MLP torso: one wide matmul in place of the small 10×10
                   spatial convs (the board is only 100 cells flattened).
  * ``mlp_dispatchK`` — both.

Each variant is timed over windows of whole dispatches ending in
``block_until_ready``.  One process, sequential variants; each variant's
compile is reported separately.

Prints one JSON line per variant and a final summary table on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# allow `python scripts/<name>.py` without PYTHONPATH (the package is
# not pip-installed; the interpreter puts scripts/, not the repo root,
# on sys.path)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

VARIANTS = ("base", "dispatch", "mlp", "mlp_dispatch")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=VARIANTS)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--dispatch", type=int, default=8,
                   help="K updates per dispatch for the *dispatch variants")
    p.add_argument("--updates", type=int, default=48,
                   help="measured updates per variant (multiple of K)")
    p.add_argument("--windows", type=int, default=3)
    from blockpuzzle_tpu.utils import add_platform_arg, select_platform

    add_platform_arg(p)
    args = p.parse_args()

    import jax
    select_platform(args.platform)
    import numpy as np

    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import PPO, PPOConfig, ppo as ppo_mod
    from blockpuzzle_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    env = make_env()
    frames_per_update = args.num_envs * args.rollout_len
    results = []

    for name in args.variants:
        torso = "mlp" if name.startswith("mlp") else "conv"
        k = args.dispatch if name.endswith("dispatch") else 1
        ppo = PPO(env, PPOConfig(
            num_envs=args.num_envs, rollout_len=args.rollout_len, torso=torso,
        ))
        hypers = ppo_mod.default_hypers(ppo.cfg)
        if k > 1:
            stack = {kk: np.full(k, v, np.float32) for kk, v in hypers.items()}
            step = lambda s: ppo.multi_update_jit(s, stack)
        else:
            step = lambda s: ppo.update_jit(s, hypers)

        state = ppo.init(jax.random.key(0))
        t0 = time.time()
        state, metrics = step(state)
        jax.block_until_ready(metrics)
        compile_s = time.time() - t0

        per_window = max(1, args.updates // args.windows // k)
        rates = []
        for w in range(args.windows):
            t0 = time.time()
            for _ in range(per_window):
                state, metrics = step(state)
            jax.block_until_ready(metrics)
            dt = time.time() - t0
            rates.append(per_window * k * frames_per_update / dt)
        rates.sort()
        rec = {
            "variant": name,
            "torso": torso,
            "dispatch": k,
            "num_envs": args.num_envs,
            "rollout_len": args.rollout_len,
            "compile_s": round(compile_s, 1),
            "frames_per_s": round(rates[len(rates) // 2]),
            "best_frames_per_s": round(rates[-1]),
        }
        print(json.dumps(rec))
        sys.stdout.flush()
        print(f"[learner] {name}: {rec['frames_per_s'] / 1e6:.2f}M frames/s "
              f"(compile {compile_s:.0f}s)", file=sys.stderr)
        results.append(rec)

    print("| variant | compile (s) | frames/s |", file=sys.stderr)
    print("|---|---|---|", file=sys.stderr)
    for r in results:
        print(f"| {r['variant']} | {r['compile_s']} | "
              f"{r['frames_per_s'] / 1e6:.2f}M |", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
