"""End-to-end smoke run of the main path on one GPU (``--four-gpus``: four).

    python chip_smoke.py              # one GPU: phases 1-7 below
    python chip_smoke.py --four-gpus  # four GPUs: the multi-device path only

One process runs every phase in order and stops at the first failure with a
non-zero exit (no phase's exception is caught).  The last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`` and
nothing else; it is printed only when every phase passed.  Without a GPU the
script exits non-zero before any phase.

Phases (one GPU):
  1. device: JAX's backend is the GPU; device kind/count, ``nvidia-smi``'s
     name and power limit, the compile-cache directory.
  2. parity: the engine on the card replays seeded oracle episodes (the
     oracle's deals injected) for every preset, one episode per program and
     a lockstep batch; boards, queues, masks, rewards and terminations must
     be bit-identical.  The engine path is integer and bitwise, and its only
     products are bf16 one-hot products of integers <= 1024, which bf16
     holds exactly: neither TF32 nor summation order can change a bit, so
     the tolerance is zero.
  3. rollout: ``make_env()`` (default preset, packed state, rbg dealing) at
     N=49152 under ``lax.scan`` with a uniform-legal policy: every sampled
     action legal, rewards finite, episodes end; steps/s printed.
  4. networks: ActorCritic (conv, mlp) and QNetwork forwards on the card at
     batch 4096 and default sizes against a float32 reference of the same
     params run on the CPU backend at precision HIGHEST (``NET_RTOL``);
     illegal logits exactly NEG_INF.
  5. training: ``cli.train.main`` in-process — PPO conv and mlp at the CLI
     defaults for 3 updates, DQN at buffer_size=200_000 past min_buffer;
     losses finite, params moved; frames/s printed.
  6. resume: the PPO conv checkpoint of update 2, resumed in a fresh run,
     reproduces update 3 (env state bit-exact, params within the
     ``RESUME_*`` tolerance);
     ``cli.evaluate`` runs greedily on the checkpoint.
  7. the JSON line.

With ``--four-gpus``: the sharded == unsharded PPO update and DQN
iterations (``blockpuzzle_tpu.dist.equivalence``) at dp=4,tp=1 and
dp=2,tp=2, then ``cli.train`` for 3 PPO updates over all four cards beside
the same update timed on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

ROLLOUT_ENVS = 49152          # bench.py's batch
NET_BATCH = 4096              # cli.train's default --num-envs
# Network tolerance, relative to the reference output's largest magnitude
# (and at least 1).  Set by the bf16 operands, not by TF32 (no float32
# product runs on the learner path): every layer rounds its input and
# weight to bf16 (relative error up to 2^-8 each) and the torso layers
# round their outputs to bf16 too, so each of the up to four layers of the
# deepest path (conv, conv, hidden, head) adds a few 2^-8 of relative
# error.  8 * 2^-8 bounds that sum; accumulation order (CPU vs GPU) moves
# results far less.
NET_RTOL = 8 * 2.0**-8
# Resume tolerance for params.  The env state must come back bit-exact, but
# the GPU does not reduce in a fixed order from run to run (atomic
# scatter-adds, e.g. the embedding gradient), so the same update from the
# same saved state can differ in the last bits of the gradients, and Adam
# can carry such a difference on a coordinate with near-zero gradients up
# to a whole step (lr = 3e-4).  Measured on the H100: max 1.4e-5 and 2.1e-5.
# So: at most RESUME_OUTLIER_FRAC of the params may differ by more than
# RESUME_ATOL (+1e-4 relative), and none by more than one Adam step.  A
# lost or stale optimizer state moves most params by whole steps.
RESUME_ATOL = 1e-6
RESUME_OUTLIER_FRAC = 1e-3
RESUME_MAX_DIFF = 3e-4
PARITY_SEEDS = 4
PARITY_MAX_STEPS = 512


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# -- 1. device ---------------------------------------------------------------


def phase_device(count: int) -> dict:
    from blockpuzzle_tpu.utils import enable_compilation_cache
    from blockpuzzle_tpu.utils.platform import gpu_name_and_power_limit

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's backend is {backend!r}")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs, found {len(devices)}")
    dev = devices[0]
    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"device_count={len(devices)}")
    smi = gpu_name_and_power_limit()
    log(f"nvidia-smi: {smi}")
    log(f"compile cache: {enable_compilation_cache()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}, smi


# -- 2. parity ---------------------------------------------------------------


def phase_parity(presets, seeds: int, max_steps: int) -> None:
    from blockpuzzle_tpu.cli.parity import check_batched_lockstep, check_seed
    from blockpuzzle_tpu.config import PRESETS
    from blockpuzzle_tpu.env import make_env

    for name in presets:
        cfg = PRESETS[name]()
        env = make_env(cfg)
        steps = 0
        for seed in range(seeds):
            r = check_seed(cfg, seed, max_steps, env=env)
            if r["mismatches"] or r["oracle_return"] != r["device_return"]:
                raise AssertionError(f"parity {name} seed {seed}: {r}")
            steps += r["steps"]
        b = check_batched_lockstep(cfg, env, list(range(seeds)), max_steps)
        if b["mismatches"] or not b["returns_equal"]:
            raise AssertionError(f"lockstep parity {name}: {b}")
        log(f"parity {name}: {seeds} seeds ({steps} steps) + lockstep batch "
            f"bit-exact")


# -- 3. rollout --------------------------------------------------------------


def phase_rollout(num_envs: int, chunk_len: int = 200, chunks: int = 3,
                  card: str = "") -> float:
    """Uniform-legal rollout of ``make_env()``; returns steady steps/s
    (``card``: the nvidia-smi line to print beside it)."""
    from blockpuzzle_tpu.env import make_env

    env = make_env()
    assert env.state_impl == "packed" and env.rng_impl == "rbg"
    state, ts = env.init_jit(jax.random.key(0), num_envs)

    @jax.jit
    def chunk(state, mask, key):
        def body(carry, _):
            state, mask, key = carry
            key, sub = jax.random.split(key)
            bits = jax.random.bits(sub, mask.shape, jnp.uint32)
            a = jnp.argmax(
                jnp.where(mask, bits | jnp.uint32(1), jnp.uint32(0)), axis=-1
            )
            state, ts = env.step(state, a)
            return (state, ts.action_mask, key), (
                jnp.all(ts.info["legal"]),
                jnp.all(jnp.isfinite(ts.reward)),
                ts.done.sum(),
            )

        (state, mask, key), (legal, finite, dones) = jax.lax.scan(
            body, (state, mask, key), None, length=chunk_len
        )
        return state, mask, key, jnp.all(legal), jnp.all(finite), dones.sum()

    key = jax.random.key(1, impl="rbg")
    mask = ts.action_mask
    total_done = 0
    rate = 0.0
    for i in range(chunks):
        t0 = time.perf_counter()
        state, mask, key, legal, finite, dones = jax.block_until_ready(
            chunk(state, mask, key)
        )
        dt = time.perf_counter() - t0
        if not bool(legal):
            raise AssertionError("a sampled uniform-legal action was illegal")
        if not bool(finite):
            raise AssertionError("non-finite reward in the rollout")
        total_done += int(dones)
        if i > 0:  # chunk 0 includes compilation
            rate = chunk_len * num_envs / dt
    if total_done == 0:
        raise AssertionError("no episode ended in the rollout")
    log(f"rollout N={num_envs}: {chunks} x {chunk_len} steps, all actions "
        f"legal, {total_done} episodes ended, {rate:,.0f} env-steps/s "
        f"[{card}]")
    return rate


# -- 4. networks -------------------------------------------------------------


def reference_forward(net, params, board, queue, mask):
    """float32 forward of ActorCritic/QNetwork params at precision HIGHEST,
    written independently of learn/networks.py (the plain reference)."""
    hi = jax.lax.Precision.HIGHEST
    p = params["params"]
    t = p["Torso_0"]
    cfg = net.cfg

    def dense(q, x):
        return jnp.dot(x, q["kernel"], precision=hi) + q["bias"]

    x = board.astype(jnp.float32)
    if net.arch == "mlp":
        x = jax.nn.relu(dense(t["mlp_0"], x.reshape(x.shape[0], -1)))
    else:
        x = x[..., None]
        for i in range(len(net.channels)):
            q = t[f"Conv_{i}"]
            x = jax.lax.conv_general_dilated(
                x, q["kernel"], (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=hi,
            )
            x = jax.nn.relu(x + q["bias"])
        x = x.reshape(x.shape[0], -1)
    emb = t["Embed_0"]["embedding"][queue].reshape(queue.shape[0], -1)
    h = jax.nn.relu(dense(t["hidden_proj"], jnp.concatenate([x, emb], -1)))
    if hasattr(net, "dueling") and net.dueling:
        v, adv = dense(p["Head_0"], h), dense(p["Head_1"], h)
        legal = mask.astype(jnp.float32)
        n = jnp.maximum(legal.sum(-1, keepdims=True), 1.0)
        out = v + adv - (adv * legal).sum(-1, keepdims=True) / n
        return (jnp.where(mask, out, -1e9),)
    head = dense(p["Head_0"], h)
    if hasattr(net, "dueling"):
        return (jnp.where(mask, head, -1e9),)
    return jnp.where(mask, head, -1e9), dense(p["Head_1"], h)[..., 0]


def _observations(env, n: int, steps: int = 24):
    """(board, queue, mask) of n envs after a few uniform-legal steps."""
    state, ts = env.init_jit(jax.random.key(5), n)

    @jax.jit
    def walk(state, mask, key):
        def body(carry, k):
            state, mask = carry
            bits = jax.random.bits(k, mask.shape, jnp.uint32)
            a = jnp.argmax(jnp.where(mask, bits | 1, 0), axis=-1)
            state, ts = env.step(state, a)
            return (state, ts.action_mask), None

        (state, mask), _ = jax.lax.scan(
            body, (state, mask), jax.random.split(key, steps)
        )
        return env.board_obs(state.board), state.queue, mask

    return walk(state, ts.action_mask, jax.random.key(6))


def phase_networks(batch: int, net_kwargs=None) -> dict:
    """Card forward vs the float32 CPU reference; returns max rel errors."""
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn.networks import NEG_INF, ActorCritic, QNetwork

    env = make_env()
    kw = dict(net_kwargs or {})
    obs = _observations(env, batch)
    cpu = jax.devices("cpu")[0]
    obs_cpu = jax.device_put(obs, cpu)
    errors = {}
    nets = {
        "actor_critic_conv": ActorCritic(env.cfg, env.num_pieces, **kw),
        "actor_critic_mlp": ActorCritic(env.cfg, env.num_pieces, arch="mlp",
                                        **kw),
        "q_network_conv": QNetwork(env.cfg, env.num_pieces, **kw),
        "q_network_dueling_mlp": QNetwork(env.cfg, env.num_pieces,
                                          arch="mlp", dueling=True, **kw),
    }
    for name, net in nets.items():
        params = jax.jit(net.init)(jax.random.key(7))
        out = jax.jit(net.apply)(params, *obs)
        out = out if isinstance(out, tuple) else (out,)
        with jax.default_device(cpu):
            ref = jax.jit(reference_forward, static_argnums=0)(
                net, jax.device_put(params, cpu), *obs_cpu
            )
        mask = np.asarray(obs[2])
        worst = 0.0
        for o, r in zip(out, ref):
            o, r = np.asarray(o), np.asarray(r)
            if o.shape != r.shape:
                raise AssertionError(f"{name}: shape {o.shape} != {r.shape}")
            if o.ndim == 2:  # logits / Q: illegal slots exactly NEG_INF
                if not (o[~mask] == np.float32(NEG_INF)).all():
                    raise AssertionError(f"{name}: illegal logit not NEG_INF")
                o, r = o[mask], r[mask]
            if not np.isfinite(o).all():
                raise AssertionError(f"{name}: non-finite output")
            scale = max(1.0, float(np.abs(r).max()))
            worst = max(worst, float(np.abs(o - r).max()) / scale)
        if worst > NET_RTOL:
            raise AssertionError(
                f"{name}: max error {worst:.3e} of the reference scale > "
                f"{NET_RTOL:.3e}"
            )
        errors[name] = worst
        log(f"network {name} batch {batch}: max |card - f32 ref| = "
            f"{worst:.3e} x scale (tolerance {NET_RTOL:.3e})")
    return errors


# -- 5/6. training, resume, evaluate ----------------------------------------


def _read_log(log_dir: pathlib.Path, run: str) -> list:
    return [json.loads(line) for line in (log_dir / f"{run}.jsonl").open()]


def _train(workdir: pathlib.Path, name: str, args: list) -> list:
    """``cli.train.main`` with logs + checkpoints under workdir/name."""
    from blockpuzzle_tpu.cli import train

    run = workdir / name
    rc = train.main(args + [
        "--log-every", "1", "--log-dir", str(run / "logs"),
        "--checkpoint-dir", str(run / "ckpt"), "--checkpoint-every", "2",
    ])
    if rc != 0:
        raise AssertionError(f"train {name} returned {rc}")
    algo = "dqn" if "dqn" in args else "ppo"
    return _read_log(run / "logs", f"{algo}-default")


def _params_moved(workdir: pathlib.Path, name: str, learner, seed: int) -> float:
    """Largest change of any param between the fresh init (same seed as
    cli.train) and the final checkpoint."""
    from blockpuzzle_tpu.utils import CheckpointManager

    init = jax.jit(learner.net.init)(
        jax.random.split(jax.random.key(seed), 3)[1]
    )
    final = CheckpointManager(str(workdir / name / "ckpt")).restore_params(init)
    return max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(final))
    )


def phase_training(workdir: pathlib.Path, extra=(), dqn_extra=(),
                   ppo_kw=None, dqn_kw=None) -> dict:
    """PPO conv, PPO mlp and DQN through ``cli.train`` at the CLI defaults.
    ``extra`` is appended to every command line and ``dqn_extra`` to the
    DQN one; ``ppo_kw``/``dqn_kw`` describe the resulting learner configs
    (tests shrink the sizes with these)."""
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig

    rates = {}
    env = make_env()
    runs = {
        "ppo_conv": (["--algo", "ppo"], PPO(env, PPOConfig(**(ppo_kw or {})))),
        "ppo_mlp": (["--algo", "ppo", "--torso", "mlp"],
                    PPO(env, PPOConfig(torso="mlp", **(ppo_kw or {})))),
        "dqn": (["--algo", "dqn"], DQN(env, DQNConfig(**(dqn_kw or {})))),
    }
    for name, (args, learner) in runs.items():
        t0 = time.perf_counter()
        args = args + ["--updates", "3", *extra]
        if name == "dqn":
            args += list(dqn_extra)  # after `extra`: the last flag wins
        rows = _train(workdir, name, args)
        wall = time.perf_counter() - t0
        losses = [r["loss"] for r in rows]
        if len(rows) != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: losses {losses}")
        if name == "dqn":  # past min_buffer, TD updates taken
            warm = rows[-1]["buffer_filled"] >= learner.cfg.min_buffer
            if not warm or losses[-1] <= 0.0:
                raise AssertionError(f"{name}: no TD update taken: {rows}")
        moved = _params_moved(workdir, name, learner, seed=0)
        if not moved > 0.0:
            raise AssertionError(f"{name}: params did not change")
        rates[name] = rows[-1]["env_steps_per_s"]
        log(f"train {name}: 3 updates in {wall:.1f} s (compile included), "
            f"losses {[f'{x:.4g}' for x in losses]}, max param change "
            f"{moved:.3e}, {rates[name]:,.0f} frames/s (update 3)")
    return rates


def phase_resume(workdir: pathlib.Path, extra=(), eval_extra=()) -> dict:
    """Resume the PPO conv run from its update-2 checkpoint and compare
    update 3 with the uninterrupted run; then evaluate the checkpoint.
    ``extra`` must repeat phase_training's; ``eval_extra`` goes to
    ``cli.evaluate``."""
    from blockpuzzle_tpu.cli import evaluate, train

    full = workdir / "ppo_conv" / "ckpt"
    part = workdir / "ppo_conv_resumed" / "ckpt"
    part.mkdir(parents=True)
    shutil.copy(full / "2.npz", part / "2.npz")
    shutil.copy(full / "run_meta.json", part / "run_meta.json")
    rc = train.main(["--algo", "ppo", "--updates", "3", "--resume",
                     "--checkpoint-dir", str(part)] + list(extra))
    if rc != 0:
        raise AssertionError(f"resumed train returned {rc}")
    a, b = np.load(full / "3.npz"), np.load(part / "3.npz")
    if sorted(a.files) != sorted(b.files):
        raise AssertionError("resumed checkpoint has other leaves")
    env_leaves = [k for k in a.files if k.startswith(".env_state")]
    for k in env_leaves + [".key", ".update_count"]:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"resumed {k} differs from the full run")
    params = [k for k in a.files if k.startswith(".params")]
    diffs = [np.abs(a[k].astype(np.float64) - b[k]) for k in params]
    param_diff = max(float(d.max()) for d in diffs)
    outside = sum(
        int((d > RESUME_ATOL + 1e-4 * np.abs(a[k])).sum())
        for k, d in zip(params, diffs)
    ) / sum(d.size for d in diffs)
    if outside > RESUME_OUTLIER_FRAC or param_diff > RESUME_MAX_DIFF:
        raise AssertionError(
            f"resumed params differ: max |diff| {param_diff:.3e}, "
            f"{outside:.2e} of elements outside atol={RESUME_ATOL}"
        )
    log(f"resume: update 3 from the update-2 checkpoint matches the full run "
        f"(env state bit-exact over {len(env_leaves)} leaves; params max "
        f"|diff| {param_diff:.3e} <= {RESUME_MAX_DIFF}, {outside:.2e} of "
        f"elements beyond {RESUME_ATOL} (+1e-4 rel) <= {RESUME_OUTLIER_FRAC})")
    rc = evaluate.main(["--checkpoint-dir", str(full), "--greedy",
                        "--steps", "256", *eval_extra])
    if rc != 0:
        raise AssertionError(f"evaluate returned {rc}")
    return {"param_max_abs_diff": param_diff, "param_outlier_frac": outside}


# -- four GPUs ---------------------------------------------------------------


def phase_four_gpus(workdir: pathlib.Path, per_card: int = 4096,
                    extra=(), ppo_kw=None, check_kw=None) -> dict:
    """Sharded == unsharded on four devices at dp=4,tp=1 and dp=2,tp=2,
    then ``cli.train`` over all devices beside the same update on one.
    ``per_card``, ``extra`` (cli.train flags), ``ppo_kw`` (the matching
    PPOConfig fields) and ``check_kw`` shrink it for the CPU test."""
    from blockpuzzle_tpu.config import default_config
    from blockpuzzle_tpu.dist.equivalence import check_sharded_equivalence
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import PPO, PPOConfig

    devices = jax.devices()[:4]
    kw = check_kw if check_kw is not None else dict(
        envs_per_dp=256, hidden=256, channels=(32, 64),
        param_outlier_frac=1e-3)
    for tp in (1, 2):
        r = check_sharded_equivalence(devices, tp=tp, **kw)
        log(f"sharded == unsharded at dp={r['dp']}, tp={tp}: "
            + ", ".join(f"{k}={v:.6g}" for k, v in r.items()
                        if k not in ("dp", "tp")))
    n_dev = len(jax.devices())
    rows = _train(workdir, "ppo_4gpu",
                  ["--algo", "ppo", "--updates", "3", *extra,
                   "--num-envs", str(n_dev * per_card)])
    if not np.isfinite([r["loss"] for r in rows]).all():
        raise AssertionError(f"multi-device train losses {rows}")
    four = rows[-1]["env_steps_per_s"]
    # the same update (cli.train's defaults, per-card batch) on one card
    ppo = PPO(make_env(default_config()),
              PPOConfig(num_envs=per_card, **(ppo_kw or {})))
    state = jax.device_put(ppo.init(jax.random.key(0)), devices[0])
    for _ in range(2):
        state, m = jax.block_until_ready(ppo.update_jit(state))
    t0 = time.perf_counter()
    state, m = jax.block_until_ready(ppo.update_jit(state))
    one = per_card * ppo.cfg.rollout_len / (time.perf_counter() - t0)
    log(f"cli.train PPO over {n_dev} devices ({per_card} envs per card): "
        f"{four:,.0f} frames/s total, {four / n_dev:,.0f} per card; one "
        f"card alone: {one:,.0f} frames/s; scaling efficiency "
        f"{four / (n_dev * one):.3f}")
    return {"frames_per_s": four, "one_card_frames_per_s": one}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-GPU sharded path and its check")
    args = p.parse_args(argv)
    count = 4 if args.four_gpus else 1
    device, smi = phase_device(count)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        workdir = pathlib.Path(tmp)
        if args.four_gpus:
            phases = [("four_gpus", lambda: phase_four_gpus(workdir))]
        else:
            phases = [
                ("parity", lambda: phase_parity(
                    ["default", "tenten", "woodoku", "big"],
                    PARITY_SEEDS, PARITY_MAX_STEPS)),
                ("rollout", lambda: phase_rollout(ROLLOUT_ENVS, card=smi)),
                ("networks", lambda: phase_networks(NET_BATCH)),
                ("training", lambda: phase_training(workdir)),
                ("resume", lambda: phase_resume(workdir)),
            ]
        for name, run in phases:
            t0 = time.perf_counter()
            run()
            log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s "
                f"(compilation included)")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
