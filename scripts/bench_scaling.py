"""Multi-device scaling-efficiency bench (BASELINE config 5 harness).

Measures batched env-steps/s with the env axis sharded over 1, 2, 4, ... K
devices of a (dp,) mesh and reports scaling efficiency vs the single-device
number.  On a multi-GPU host this is the ≥80%-efficiency measurement;
``--cpu-sim`` runs it on a CPU-simulated 8-device mesh, which validates the
sharded program and the harness itself — CPU numbers do not represent GPU
scaling.

Envs are independent, so the step program contains zero collectives; the
expected efficiency loss is only dispatch overhead (docs/ARCHITECTURE.md
"Distribution model").

Usage:
    python scripts/bench_scaling.py --cpu-sim          # 8 simulated devices
    python scripts/bench_scaling.py                    # all real devices
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-sim", action="store_true",
                   help="force 8 simulated CPU devices")
    p.add_argument("--envs-per-device", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()

    import jax

    if args.cpu_sim:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import jax.numpy as jnp

    from blockpuzzle_tpu import dist
    from blockpuzzle_tpu.env import make_env

    n_dev = jax.device_count()
    env = make_env()
    results = {}
    d = 1
    sizes = []
    while d <= n_dev:
        sizes.append(d)
        d *= 2

    for nd in sizes:
        mesh = dist.make_mesh(devices=jax.devices()[:nd])
        n = args.envs_per_device * nd
        state, ts = env.init_jit(jax.random.key(0), n)
        state = dist.shard_batch_axis(mesh, state)
        mask = jax.device_put(ts.action_mask, dist.env_sharding(mesh))

        @functools.partial(jax.jit, donate_argnums=(0,))
        def chunk(state, mask, key):
            def body(carry, _):
                state, mask, key = carry
                key, sub = jax.random.split(key)
                a = jax.random.categorical(
                    sub, jnp.where(mask, 0.0, -1e9), axis=-1
                )
                state, ts2 = env.step(state, a)
                return (state, ts2.action_mask, key), ts2.reward.sum()

            (state, mask, key), r = jax.lax.scan(
                body, (state, mask, key), None, length=args.chunk, unroll=4
            )
            return state, mask, key, r.sum()

        out = chunk(state, mask, jax.random.key(1))
        state, mask, key, r = out
        jax.block_until_ready(r)
        t0 = time.time()
        for _ in range(args.iters):
            state, mask, key, r = chunk(state, mask, key)
        jax.block_until_ready(r)
        sps = args.iters * args.chunk * n / (time.time() - t0)
        results[nd] = sps
        base = results[sizes[0]] * nd / sizes[0]
        eff = sps / base
        print(
            f"devices={nd}: {sps / 1e6:8.2f}M steps/s "
            f"(efficiency vs linear: {eff * 100:5.1f}%)"
        )

    print(json.dumps({
        "metric": "scaling_efficiency",
        "devices": sizes,
        "steps_per_s": {str(k): round(v) for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
