"""Headline benchmark: batched env-steps/s per GPU (BASELINE.md).

Runs the batched engine with a uniform-legal random policy (the honest
rollout workload: every step samples from the legal-action mask the env
emits), steady-state, excluding compile, in one process on one GPU.

Prints ONE JSON line on stdout:
  {"metric": "env_steps_per_s_per_chip", "value": N, "unit": "steps/s",
   "vs_baseline": N / 10_000_000, "platform": ..., "device_kind": ...,
   "device_count": ...}

vs_baseline divides by the 10M steps/s/chip north-star target from
BASELINE.json — the reference publishes no numbers of its own
(BASELINE.md: `published: {}`; the single-env CPU oracle's rate is printed
on stderr for context).  The device, its count and ``nvidia-smi``'s name and
power limit go to stderr before the timed windows.

Exits non-zero, printing no JSON line, when JAX's backend is not the GPU,
when a knob is malformed, or on any error.

Knobs (environment variables): BP_BENCH_NUM_ENVS (49152), BP_BENCH_PRESET
(default), BP_BENCH_STATE_IMPL (auto|u8|packed), BP_BENCH_MASK_IMPL
(bitboard|shift|matmul), BP_BENCH_MASK_DTYPE (bf16|int8, read by the
matmul mask only), BP_BENCH_SAMPLER (argmax|words).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

BASELINE_STEPS_PER_S = 10_000_000  # BASELINE.json north_star target
# read at import, validated in main() (a malformed value exits non-zero
# with a message instead of an import-time traceback)
NUM_ENVS_RAW = os.environ.get("BP_BENCH_NUM_ENVS", "49152")
MASK_DTYPE = os.environ.get("BP_BENCH_MASK_DTYPE", "bf16")
PRESET = os.environ.get("BP_BENCH_PRESET", "default")
MASK_IMPL = os.environ.get("BP_BENCH_MASK_IMPL", "bitboard")
# "auto" resolves to the packed (N, H) u32 row-word layout wherever rows
# fit a u32 word; "u8" ((N, HW) cells) is selectable for the shift and
# matmul mask formulations
STATE_IMPL = os.environ.get("BP_BENCH_STATE_IMPL", "auto")
# uniform-legal sampler: "argmax" (iid u32 draw over the (N, A) bool mask +
# argmax — the headline protocol) or "words" (popcount rank-select over
# (N, S*H) packed legal words, env/words.py — needs the packed engine)
SAMPLER = os.environ.get("BP_BENCH_SAMPLER", "argmax")
CHUNK = 400                        # long chunks amortize dispatch latency
ITERS = 8                          # chunks per timed window
WINDOWS = 5                        # the median window is the headline


def bench_oracle(max_steps: int = 2000) -> float:
    """Single-env CPU oracle steps/s (the reference-shaped baseline)."""
    import random

    import numpy as np

    from blockpuzzle_tpu.config import default_config
    from blockpuzzle_tpu.oracle import BlockPuzzleGame

    env = BlockPuzzleGame(default_config())
    rng = random.Random(0)
    obs, info = env.reset(seed=0)
    t0 = time.perf_counter()
    steps = 0
    while steps < max_steps:
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            obs, info = env.reset()
            continue
        obs, r, term, trunc, info = env.step(int(rng.choice(legal)))
        steps += 1
        if term or trunc:
            obs, info = env.reset()
    return steps / (time.perf_counter() - t0)


def bench_device() -> float:
    """Median env-steps/s over the timed windows on JAX's default device."""
    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.config import PRESETS
    from blockpuzzle_tpu.env import make_env

    num_envs = int(NUM_ENVS_RAW)
    env = make_env(PRESETS[PRESET](), mask_dtype=MASK_DTYPE,
                   mask_impl=MASK_IMPL,
                   state_impl=None if STATE_IMPL == "auto" else STATE_IMPL)
    if SAMPLER == "words" and env.state_impl != "packed":
        raise ValueError("BP_BENCH_SAMPLER=words needs the packed engine")
    state, ts = env.init_jit(jax.random.key(0), num_envs)
    policy_key = jax.random.key(1, impl="rbg")  # fast PRNG for sampling
    if SAMPLER == "words":
        from blockpuzzle_tpu.env.words import legal_words, sample_uniform_legal

    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk(state, mask, key):
        def body(carry, _):
            state, mask, key = carry
            key, sub = jax.random.split(key)
            if SAMPLER == "words":
                # popcount rank-select over (N, S*H) packed legal words —
                # one (N,) uniform instead of an (N, A) u32 draw
                a = sample_uniform_legal(mask, sub, env.cfg.width)
                state, ts = env.step(state, a)
                return (
                    (state, legal_words(env, state.board, state.queue), key),
                    ts.reward.sum(),
                )
            # uniform-legal sampling WITHOUT gumbel noise: iid u32 per
            # action, argmax over legal slots picks uniformly (tie odds
            # ~2^-32).  categorical() would spend two transcendentals
            # (log/exp) per (N, A) element for the same distribution.
            # `| 1` keeps every legal draw strictly above the illegal 0s,
            # so even an all-zero draw row cannot argmax onto an illegal
            # action.
            bits = jax.random.bits(sub, mask.shape, jnp.uint32)
            a = jnp.argmax(
                jnp.where(mask, bits | jnp.uint32(1), jnp.uint32(0)), axis=-1
            )
            state, ts = env.step(state, a)
            return (state, ts.action_mask, key), ts.reward.sum()

        # unroll=4: lets XLA overlap consecutive steps
        (state, mask, key), r = jax.lax.scan(
            body, (state, mask, key), None, length=CHUNK, unroll=4
        )
        return state, mask, key, r.sum()

    carry0 = (
        legal_words(env, state.board, state.queue)
        if SAMPLER == "words"
        else ts.action_mask
    )
    t0 = time.perf_counter()
    state, mask, key, r = jax.block_until_ready(
        chunk(state, carry0, policy_key)
    )  # compile + warmup
    print(f"[bench] compile + first chunk: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    rates = []
    for w in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, mask, key, r = chunk(state, mask, key)
        jax.block_until_ready(r)
        rate = ITERS * CHUNK * num_envs / (time.perf_counter() - t0)
        print(f"[bench] window {w}: {rate:,.0f} steps/s", file=sys.stderr)
        rates.append(rate)
    rates.sort()
    median = rates[len(rates) // 2]
    print(
        f"[bench] median {median:,.0f}, best {rates[-1]:,.0f} steps/s over "
        f"{WINDOWS} windows",
        file=sys.stderr,
    )
    return median


def knob_error() -> "str | None":
    """A message for the first malformed or contradictory knob, else None."""
    from blockpuzzle_tpu.config import PRESETS

    for name, value, allowed in (
        ("BP_BENCH_PRESET", PRESET, sorted(PRESETS)),
        ("BP_BENCH_MASK_IMPL", MASK_IMPL, ["matmul", "shift", "bitboard"]),
        ("BP_BENCH_MASK_DTYPE", MASK_DTYPE, ["bf16", "int8"]),
        ("BP_BENCH_STATE_IMPL", STATE_IMPL, ["auto", "u8", "packed"]),
        ("BP_BENCH_SAMPLER", SAMPLER, ["argmax", "words"]),
    ):
        if value not in allowed:
            return f"{name}={value!r} not in {allowed}"
    if STATE_IMPL == "packed" and MASK_IMPL != "bitboard":
        return ("BP_BENCH_STATE_IMPL=packed implies BP_BENCH_MASK_IMPL="
                f"bitboard (got {MASK_IMPL!r})")
    if SAMPLER == "words" and (STATE_IMPL == "u8" or MASK_IMPL != "bitboard"):
        return ("BP_BENCH_SAMPLER=words needs the packed engine "
                "(BP_BENCH_STATE_IMPL auto/packed, BP_BENCH_MASK_IMPL="
                f"bitboard); got state_impl={STATE_IMPL!r} "
                f"mask_impl={MASK_IMPL!r}")
    try:
        if int(NUM_ENVS_RAW) <= 0:
            return f"BP_BENCH_NUM_ENVS={NUM_ENVS_RAW!r} must be positive"
    except ValueError:
        return f"BP_BENCH_NUM_ENVS={NUM_ENVS_RAW!r} is not an integer"
    return None


def main() -> int:
    error = knob_error()
    if error is not None:
        print(f"[bench] bad knob: {error}", file=sys.stderr)
        return 2

    import jax

    from blockpuzzle_tpu.utils import enable_compilation_cache
    from blockpuzzle_tpu.utils.platform import gpu_name_and_power_limit

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"[bench] needs a GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(f"[bench] platform={dev.platform} device_kind={dev.device_kind} "
          f"device_count={len(jax.devices())}", file=sys.stderr)
    print(f"[bench] nvidia-smi: {gpu_name_and_power_limit()}",
          file=sys.stderr)
    print(f"[bench] compile cache: {enable_compilation_cache()}",
          file=sys.stderr)
    print(f"[bench] preset={PRESET} num_envs={NUM_ENVS_RAW} "
          f"state_impl={STATE_IMPL} mask_impl={MASK_IMPL} "
          f"mask_dtype={MASK_DTYPE} sampler={SAMPLER}", file=sys.stderr)

    oracle_sps = bench_oracle()
    print(f"[bench] oracle single-env: {oracle_sps:,.0f} steps/s (1 CPU core)",
          file=sys.stderr)
    value = bench_device()
    print(f"[bench] device batched: {value / oracle_sps:,.0f}x oracle",
          file=sys.stderr)
    print(json.dumps({
        "metric": "env_steps_per_s_per_chip",
        "value": round(value),
        "unit": "steps/s",
        "vs_baseline": round(value / BASELINE_STEPS_PER_S, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
