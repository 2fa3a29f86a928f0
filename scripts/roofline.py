"""Roofline accounting for the headline env-step bench.

Bounds the measured steps/s against the GPU's published peaks:

  * builds bench.py's EXACT chunk program (same make_env knobs, same
    bits-argmax uniform-legal sampler, same scan/unroll),
  * asks the compiled executable for XLA's own cost model numbers
    (``Compiled.cost_analysis()``: flops, bytes accessed),
  * optionally re-times the chunk (same window protocol as bench.py),
  * prints bytes/step/env, FLOPs/step/env, the memory-bound and
    compute-bound step-time floors, and the achieved fraction of each.

The peaks come from ``PEAKS``, keyed by ``device_kind``; a device that is
not in the table is an error, never an assumed peak.

Usage:
  python scripts/roofline.py [--num-envs 49152] [--no-time]
  (--platform cpu --no-time for a program-shape smoke run: XLA's cost
  numbers only, no device peak.)
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks per device_kind (NVIDIA H100 data sheet, SXM part;
# the rates assume the card's full 700 W power limit): bf16 tensor-core
# FLOP/s and HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    """The PEAKS row of ``device_kind``; ValueError for an unknown device."""
    if device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add a row "
            f"to PEAKS (known: {sorted(PEAKS)})"
        )
    return PEAKS[device_kind]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=49152)
    p.add_argument("--chunk", type=int, default=400)
    p.add_argument("--preset", default="default")
    p.add_argument("--mask-impl", default="bitboard")
    p.add_argument("--mask-dtype", default="bf16")
    p.add_argument("--no-time", action="store_true",
                   help="cost analysis only (no timed windows)")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--windows", type=int, default=3)
    from blockpuzzle_tpu.utils import add_platform_arg, select_platform

    add_platform_arg(p)
    args = p.parse_args()
    select_platform(args.platform)

    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.config import PRESETS
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    # the device's peaks, or None for a CPU shape-only run
    peak = peaks_for(dev.device_kind) if dev.platform == "gpu" else None
    env = make_env(
        PRESETS[args.preset](),
        mask_dtype=args.mask_dtype,
        mask_impl=args.mask_impl,
    )
    num_envs, chunk_len = args.num_envs, args.chunk
    state, ts = env.init_jit(jax.random.key(0), num_envs)
    policy_key = jax.random.key(1, impl="rbg")

    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk(state, mask, key):
        def body(carry, _):
            state, mask, key = carry
            key, sub = jax.random.split(key)
            bits = jax.random.bits(sub, mask.shape, jnp.uint32)
            a = jnp.argmax(
                jnp.where(mask, bits | jnp.uint32(1), jnp.uint32(0)), axis=-1
            )
            state, ts = env.step(state, a)
            return (state, ts.action_mask, key), ts.reward.sum()

        (state, mask, key), r = jax.lax.scan(
            body, (state, mask, key), None, length=chunk_len, unroll=4
        )
        return state, mask, key, r.sum()

    lowered = chunk.lower(state, ts.action_mask, policy_key)
    compiled = lowered.compile()
    ca = compiled.cost_analysis() or {}
    # cost_analysis may return a list (one per computation) on some versions
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    steps = num_envs * chunk_len
    flops = float(ca.get("flops", 0.0))
    byt = float(ca.get("bytes accessed", 0.0))
    out = {
        "metric": "roofline",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "num_envs": num_envs,
        "chunk": chunk_len,
        "mask_impl": args.mask_impl,
        "flops_per_step_env": flops / steps if flops else None,
        "bytes_per_step_env": byt / steps if byt else None,
    }
    # per-memory-space byte counts when the backend exposes them
    spaces = {k: v for k, v in ca.items() if k.startswith("bytes accessed")}
    for k, v in sorted(spaces.items()):
        print(f"[roofline] {k}: {float(v) / steps:.1f} B/step/env",
              file=sys.stderr)
    print(f"[roofline] flops: {flops / steps:.1f} FLOP/step/env, "
          f"total bytes: {byt / steps:.1f} B/step/env", file=sys.stderr)

    # hardware floors for one batched step of N envs
    if peak and byt:
        t_hbm = (byt / chunk_len) / peak["hbm_bytes_per_s"]
        out["hbm_floor_us_per_batched_step"] = t_hbm * 1e6
        out["hbm_bound_steps_per_s"] = num_envs / t_hbm
    if peak and flops:
        t_fl = (flops / chunk_len) / peak["bf16_flops"]
        out["bf16_floor_us_per_batched_step"] = t_fl * 1e6
        out["compute_bound_steps_per_s"] = num_envs / t_fl

    if not args.no_time:
        if peak is None:
            raise SystemExit("timed roofline windows need a GPU")
        state, mask, key, r = jax.block_until_ready(
            chunk(state, ts.action_mask, policy_key)
        )  # compile + warmup
        rates = []
        for w in range(args.windows):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                state, mask, key, r = chunk(state, mask, key)
            jax.block_until_ready(r)
            rates.append(
                args.iters * chunk_len * num_envs / (time.perf_counter() - t0)
            )
            print(f"[roofline] window {w}: {rates[-1]:,.0f} steps/s",
                  file=sys.stderr)
        rates.sort()
        measured = rates[len(rates) // 2]
        out["measured_steps_per_s"] = round(measured)
        t_meas = num_envs / measured
        out["measured_us_per_batched_step"] = t_meas * 1e6
        if byt:
            out["pct_of_hbm_bound"] = round(
                100.0 * out["hbm_floor_us_per_batched_step"]
                / (t_meas * 1e6), 1)
        if flops:
            out["pct_of_compute_bound"] = round(
                100.0 * out["bf16_floor_us_per_batched_step"]
                / (t_meas * 1e6), 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
