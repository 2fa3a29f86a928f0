"""PPO hyperparameter sweep in ONE process with ONE compiled update program.

Closes the PPO quality gap against DQN on the default preset.  A sweep is
cheap in device time per update, but every distinct constant would cost a
PPO-update compile — so every sweep point shares one program.  ``PPO.update(state, hypers)`` takes
lr / entropy_coef / clip_eps / gamma / gae_lambda / value_coef as runtime
scalars (learn/ppo.py ``default_hypers``); this script linearly interpolates
each config's schedules on the host and feeds them in per update.

Per config: init -> train --updates -> greedy eval (argmax policy, mean
completed-episode return over --eval-steps x --eval-envs, the same metric
as ``cli.evaluate --greedy``).  Prints one JSON line per config and a final
summary; optionally checkpoints the best config's final TrainState for
``cli.evaluate``.
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

# name -> (lr start/end, entropy start/end, clip, gamma, gae lambda,
# value coef); schedules interpolate linearly over the run
CONFIGS = {
    "base": dict(lr0=3e-4, lr1=3e-4, ent0=0.01, ent1=0.01,
                 clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "anneal": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                   clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "hot": dict(lr0=1e-3, lr1=0.0, ent0=0.01, ent1=0.01,
                clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "lowent": dict(lr0=3e-4, lr1=0.0, ent0=0.003, ent1=0.0,
                   clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "gamma99": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                    clip=0.2, gamma=0.99, lam=0.95, vc=0.5),
    "widelam": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                    clip=0.2, gamma=0.995, lam=0.8, vc=0.5),
}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--configs", nargs="*", default=list(CONFIGS),
                   choices=sorted(CONFIGS), help="subset to run")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--eval-envs", type=int, default=2048)
    p.add_argument("--eval-steps", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the best config's final TrainState here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the in-progress TrainState every N "
                        "updates (single-config long runs: a cut-short run "
                        "still leaves an evaluable policy; requires "
                        "--checkpoint-dir)")
    p.add_argument("--keep", type=int, default=3,
                   help="checkpoints retained (orbax max_to_keep); raise for "
                        "peak-hunting runs where the best policy is NOT the "
                        "last one (the 1M probe showed regression past ~350k "
                        "updates — docs/RESULTS.md)")
    p.add_argument("--torso", choices=["conv", "mlp"], default="conv")
    p.add_argument("--mlp-width", type=int, default=512,
                   help="mlp-torso matmul width (ignored by conv)")
    p.add_argument("--preset", choices=["default", "tenten", "woodoku", "big"],
                   default="default")
    p.add_argument("--queue-mode", choices=["embed", "planes"],
                   default="embed")
    p.add_argument("--shuffle", choices=["roll", "perm", "none"],
                   default="roll",
                   help="PPO minibatch scheme (quality A/B: roll saves ~27%% "
                        "update time but leaves minibatches time-contiguous)")
    # Entropy-floor controller (round 3): the 1M-update probe showed the
    # base recipe REGRESSES past ~350k updates as policy entropy collapses
    # (0.17 -> 0.03 under a constant coefficient; docs/RESULTS.md).  Because
    # entropy_coef is a RUNTIME scalar, the fix needs no learner change and
    # no recompile: a host-side multiplicative controller at each log
    # boundary (where metrics are device_get anyway) raises the coefficient
    # whenever measured entropy sits below the floor.  The multiplier never
    # drops below 1.0, so the configured schedule is a lower bound.
    p.add_argument("--ent-floor", type=float, default=0.0,
                   help="target policy entropy in nats (0 = controller off); "
                        "the 300k peak ran at ~0.17, collapse sets in "
                        "below ~0.12")
    p.add_argument("--ent-adapt", type=float, default=1.0,
                   help="controller rate: ent multiplier *= "
                        "exp(rate * (floor - entropy)) per log boundary")
    p.add_argument("--ent-max-mult", type=float, default=20.0,
                   help="cap on the controller's coefficient multiplier")
    # Round 4: the controller used to update only at log boundaries, which
    # silently made --log-every a controller hyperparameter (a run logging
    # 5x less often got a 5x slower controller).  --ent-every makes the
    # cadence explicit; 0 keeps the legacy log-boundary coupling.
    p.add_argument("--ent-every", type=int, default=0,
                   help="entropy-controller cadence in updates (0 = at log "
                        "boundaries, the pre-round-4 behavior); each firing "
                        "costs one device_get sync of the update metrics")
    # KL-adaptive clipping (round 5): the one quality lever VERDICT r4 /
    # RESULTS.md named but never measured.  clip_eps is already a RUNTIME
    # scalar (learn/ppo.py default_hypers), so — like the entropy floor —
    # this is a host-side controller, no learner change, no recompile.
    # Standard banded rule (adaptive-KL PPO): when measured approx_kl
    # leaves [target/2, 2*target], the clip multiplier is divided/
    # multiplied by --kl-adapt (tighter clip <=> smaller policy steps).
    # Measured scale on this task: approx_kl sits ~1e-3..2e-3 in steady
    # state at lr 3e-4 (runs/w2048_300k_metrics.jsonl), ~0.09 on the
    # first update.
    p.add_argument("--kl-target", type=float, default=0.0,
                   help="target approx_kl per update (0 = controller off); "
                        "steady state here measures ~1e-3..2e-3")
    p.add_argument("--kl-adapt", type=float, default=1.5,
                   help="band factor: clip multiplier /= adapt when "
                        "approx_kl > 2*target, *= adapt when < target/2")
    p.add_argument("--kl-min-mult", type=float, default=0.25,
                   help="floor on the clip multiplier")
    p.add_argument("--kl-max-mult", type=float, default=2.0,
                   help="cap on the clip multiplier")
    p.add_argument("--kl-every", type=int, default=0,
                   help="KL-controller cadence in updates (0 = at log "
                        "boundaries); each firing costs one device_get sync")
    # Round 4: piecewise LR schedule (VERDICT r3 item 1).  Every long run so
    # far used constant 3e-4; the 1M probe's post-350k collapse is the
    # textbook case for late LR decay.  --lr0/--lr1 override the chosen
    # config's endpoints; --lr-decay-start holds lr0 constant until that
    # fraction of the run, then decays to lr1 by the end (linear or cosine).
    p.add_argument("--lr0", type=float, default=None,
                   help="override the config's starting learning rate")
    p.add_argument("--lr1", type=float, default=None,
                   help="override the config's final learning rate")
    p.add_argument("--lr-decay-start", type=float, default=0.0,
                   help="fraction of the run before LR decay begins "
                        "(0.0 = decay over the whole run, the old behavior)")
    p.add_argument("--lr-shape", choices=["linear", "cosine"],
                   default="linear", help="decay shape past --lr-decay-start")
    # Round 4: full-precision metrics stream (the printed log rounds to
    # 0.1, useless for the run-to-run determinism probe — VERDICT r3 item 3)
    p.add_argument("--metrics-jsonl", default=None,
                   help="append one full-precision JSON metrics row per log "
                        "boundary to this path")
    p.add_argument("--eval-kept", action="store_true",
                   help="after training, greedy-eval EVERY kept checkpoint "
                        "and record the argmax step in run_meta.json (on "
                        "post-peak-regression curves the final state is "
                        "systematically the wrong artifact — the round-3 "
                        "entfloor run saved 644.3 while its kept 350k "
                        "checkpoint measured 671.2)")
    from blockpuzzle_tpu.utils import add_platform_arg, select_platform

    add_platform_arg(p)
    args = p.parse_args()
    select_platform(args.platform)

    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.config import PRESETS
    from blockpuzzle_tpu.env import make_env
    from blockpuzzle_tpu.learn import PPO, PPOConfig
    from blockpuzzle_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    env = make_env(PRESETS[args.preset]())
    ppo = PPO(env, PPOConfig(
        num_envs=args.num_envs, rollout_len=args.rollout_len,
        torso=args.torso, mlp_width=args.mlp_width,
        queue_mode=args.queue_mode, shuffle=args.shuffle,
    ))
    update = ppo.update_jit

    # one greedy-eval program for all configs: params passed as an argument
    eval_chunk_len = 64

    @jax.jit
    def eval_chunk(params, env_state, board, queue, mask):
        def body(carry, _):
            env_state, board, queue, mask = carry
            logits, _ = ppo.net.apply(params, board, queue, mask)
            a = jnp.argmax(logits, axis=-1)
            env_state, ts = env.step(env_state, a)
            out = (
                (ts.info["episode_return"] * ts.done).sum(),
                ts.done.sum(),
            )
            return (env_state, ts.board, ts.queue, ts.action_mask), out

        (env_state, board, queue, mask), (ep_r, eps) = jax.lax.scan(
            body, (env_state, board, queue, mask), None, length=eval_chunk_len
        )
        return (env_state, board, queue, mask), ep_r.sum(), eps.sum()

    def greedy_return(params, seed):
        env_state, ts = env.init_jit(jax.random.key(seed), args.eval_envs)
        carry = (env_state, ts.board, ts.queue, ts.action_mask)
        tot_r = tot_eps = 0.0
        for _ in range(max(1, args.eval_steps // eval_chunk_len)):
            carry, ep_r, eps = eval_chunk(params, *carry)
            tot_r += float(ep_r)
            tot_eps += float(eps)
        return tot_r / max(tot_eps, 1.0), int(tot_eps)

    def interp(a, b, frac):
        return a + (b - a) * frac

    import math

    def lr_at(c, frac):
        """Piecewise LR: lr0 until --lr-decay-start, then decay to lr1."""
        lr0 = args.lr0 if args.lr0 is not None else c["lr0"]
        lr1 = args.lr1 if args.lr1 is not None else c["lr1"]
        s = args.lr_decay_start
        if frac <= s:
            return lr0
        t = (frac - s) / max(1.0 - s, 1e-9)
        if args.lr_shape == "cosine":
            return lr1 + (lr0 - lr1) * 0.5 * (1.0 + math.cos(math.pi * t))
        return lr0 + (lr1 - lr0) * t

    # validate the flag combination BEFORE constructing the manager (a
    # usage error must not leave an empty checkpoint dir behind)
    if args.checkpoint_every and not args.checkpoint_dir:
        p.error("--checkpoint-every requires --checkpoint-dir")
    if args.checkpoint_every and len(args.configs) > 1:
        # periodic step numbers would collide across configs
        p.error("--checkpoint-every supports a single --configs entry")
    if args.eval_kept and not (args.checkpoint_dir and args.checkpoint_every):
        p.error("--eval-kept requires --checkpoint-dir and --checkpoint-every")
    mgr = None
    run_meta = None
    if args.checkpoint_dir:
        from blockpuzzle_tpu.utils import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, max_to_keep=args.keep)
        # self-describing checkpoint dir (cli.evaluate auto-fills from it)
        run_meta = {
            "algo": "ppo", "preset": args.preset, "env_overrides": [],
            "torso": args.torso, "mlp_width": args.mlp_width,
            "queue_mode": args.queue_mode,
            "state_impl": env.state_impl,  # cli.train --resume must match
        }
        mgr.save_run_meta(run_meta)

    ent_cadence = args.ent_every if args.ent_every > 0 else args.log_every
    kl_cadence = args.kl_every if args.kl_every > 0 else args.log_every
    metrics_f = open(args.metrics_jsonl, "a") if args.metrics_jsonl else None

    results = []
    best = None  # (greedy_return, name, host TrainState copy)
    for ci, name in enumerate(args.configs):
        c = CONFIGS[name]
        state = ppo.init(jax.random.key(args.seed * 131 + ci))
        t0 = time.time()
        last_ret = 0.0
        ent_mult = 1.0  # entropy-floor controller state (host-side)
        clip_mult = 1.0  # KL-adaptive clip controller state (host-side)
        for u in range(args.updates):
            frac = u / max(args.updates - 1, 1)
            hypers = {
                "lr": lr_at(c, frac),
                "entropy_coef": ent_mult * interp(c["ent0"], c["ent1"], frac),
                "clip_eps": clip_mult * c["clip"],
                "gamma": c["gamma"],
                "gae_lambda": c["lam"],
                "value_coef": c["vc"],
            }
            state, metrics = update(state, hypers)
            log_now = (u + 1) % args.log_every == 0 or u == 0
            ent_now = args.ent_floor > 0.0 and (
                (u + 1) % ent_cadence == 0 or u == 0
            )
            kl_now = args.kl_target > 0.0 and (
                (u + 1) % kl_cadence == 0 or u == 0
            )
            if log_now or ent_now or kl_now:
                last_ret = float(metrics["episode_return"])
                entropy = float(metrics["entropy"])
                # the multipliers THIS update actually ran with — the
                # controllers below advance the state for the NEXT update,
                # and the logged row must describe this one (otherwise
                # clip_eps != clip_mult*clip within a row whenever a
                # controller fires on a log boundary)
                applied_ent_mult, applied_clip_mult = ent_mult, clip_mult
                if ent_now:
                    ent_mult = min(
                        max(1.0, ent_mult
                            * math.exp(args.ent_adapt
                                       * (args.ent_floor - entropy))),
                        args.ent_max_mult,
                    )
                if kl_now:
                    kl = float(metrics["approx_kl"])
                    if kl > 2.0 * args.kl_target:
                        clip_mult = max(
                            clip_mult / args.kl_adapt, args.kl_min_mult
                        )
                    elif kl < 0.5 * args.kl_target:
                        clip_mult = min(
                            clip_mult * args.kl_adapt, args.kl_max_mult
                        )
                if log_now and metrics_f is not None:
                    # full precision: json floats round-trip exactly, so
                    # two runs' streams can be compared bit-for-bit
                    row = {"config": name, "update": u + 1,
                           "ent_mult": applied_ent_mult, "lr": hypers["lr"],
                           "entropy_coef": hypers["entropy_coef"],
                           "clip_mult": applied_clip_mult,
                           "clip_eps": hypers["clip_eps"]}
                    row.update(
                        (k, float(v)) for k, v in sorted(metrics.items())
                    )
                    metrics_f.write(json.dumps(row) + "\n")
                    metrics_f.flush()
                if log_now:
                    print(
                        f"[{name}] update {u + 1}/{args.updates}: "
                        f"train return {last_ret:.1f} "
                        f"entropy {entropy:.3f}"
                        + (f" ent_mult {ent_mult:.2f}"
                           if args.ent_floor > 0.0 else "")
                        + (f" clip_mult {clip_mult:.3f}"
                           if args.kl_target > 0.0 else "")
                        + (f" lr {hypers['lr']:.2e}"
                           if args.lr_decay_start > 0.0 else ""),
                        file=sys.stderr,
                    )
            if (args.checkpoint_every
                    and (u + 1) % args.checkpoint_every == 0
                    and u + 1 < args.updates):  # final save happens below
                mgr.save(u + 1, state)  # syncs the device queue
                print(f"[{name}] checkpointed update {u + 1}", file=sys.stderr)
        # timing barrier: without it train_s/frames_per_s would exclude
        # updates still queued past the last log line
        last_ret = float(jax.block_until_ready(metrics)["episode_return"])
        train_s = time.time() - t0
        ret, n_eps = greedy_return(state.params, seed=10_000 + ci)
        frames = args.updates * args.num_envs * args.rollout_len
        rec = {
            "config": name,
            "seed": args.seed,
            "num_envs": args.num_envs,
            "rollout_len": args.rollout_len,
            "preset": args.preset,
            "torso": args.torso,
            "mlp_width": args.mlp_width,
            "queue_mode": args.queue_mode,
            "shuffle": args.shuffle,
            **c,
            # effective LR schedule (CLI overrides + shape) — the config's
            # lr0/lr1 above are superseded by these when set
            "lr0_eff": args.lr0 if args.lr0 is not None else c["lr0"],
            "lr1_eff": args.lr1 if args.lr1 is not None else c["lr1"],
            "lr_decay_start": args.lr_decay_start,
            "lr_shape": args.lr_shape,
            "ent_floor": args.ent_floor,
            "ent_every": ent_cadence if args.ent_floor > 0.0 else 0,
            "ent_mult_final": round(ent_mult, 3),
            "kl_target": args.kl_target,
            "kl_adapt": args.kl_adapt,
            "kl_min_mult": args.kl_min_mult,
            "kl_max_mult": args.kl_max_mult,
            "kl_every": kl_cadence if args.kl_target > 0.0 else 0,
            "clip_mult_final": round(clip_mult, 4),
            "updates": args.updates,
            "greedy_return": round(ret, 1),
            "eval_episodes": n_eps,
            "final_train_return": round(last_ret, 1),
            "train_s": round(train_s, 1),
            "frames_per_s": round(frames / train_s),
        }
        print(json.dumps(rec))
        sys.stdout.flush()
        results.append(rec)
        if best is None or ret > best[0]:
            best = (ret, name, jax.device_get(state), rec)

    results.sort(key=lambda r: -r["greedy_return"])
    print(json.dumps({"summary": results, "best": results[0]["config"]}))
    if mgr is not None and best is not None:
        mgr.save(args.updates, best[2])
        # run_meta carries the FULL training recipe of the saved config
        # (seed, update count, LR schedule, entropy flags, batch shape), so
        # reproduction/extension is a metadata read, not log archaeology.
        # INPUT fields only: measured outcomes (returns, timings, the
        # controller's final multiplier) stay out so recipe-equality IS a
        # same-input check.
        outcome_keys = {
            "greedy_return", "eval_episodes", "final_train_return",
            "train_s", "frames_per_s", "ent_mult_final", "clip_mult_final",
        }
        run_meta["recipe"] = {
            k: v for k, v in best[3].items() if k not in outcome_keys
        }
        mgr.save_run_meta(run_meta)
        print(f"[sweep] saved best ({best[1]}) to {args.checkpoint_dir}",
              file=sys.stderr)
        if args.eval_kept:
            # Peak selection (VERDICT r3 weak #1): greedy-eval every kept
            # checkpoint under ONE eval seed and record the argmax step.
            # On post-peak-regression curves (the measured shape of every
            # run past ~350k updates) the final state is systematically
            # worse than the best kept one; cli.evaluate defaults to the
            # recorded best_step.
            curve = []
            for s in mgr.all_steps():
                params = mgr.restore_params(best[2].params, step=s)
                ret, n_eps = greedy_return(params, seed=20_000)
                row = {"checkpoint_step": s, "greedy_return": round(ret, 1),
                       "eval_episodes": n_eps}
                curve.append(row)
                print(json.dumps(row))
                sys.stdout.flush()
            top = max(curve, key=lambda r: r["greedy_return"])
            run_meta["best_step"] = top["checkpoint_step"]
            run_meta["checkpoint_curve"] = curve
            mgr.save_run_meta(run_meta)
            print(json.dumps({"kept_eval_best_step": top["checkpoint_step"],
                              "kept_eval_best_return": top["greedy_return"]}))
            print(f"[sweep] kept-checkpoint peak: step "
                  f"{top['checkpoint_step']} greedy "
                  f"{top['greedy_return']} (recorded in run_meta.json)",
                  file=sys.stderr)
        mgr.close()
    if metrics_f is not None:
        metrics_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
