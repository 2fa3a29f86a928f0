"""Training CLI: on-device PPO or DQN over the batched env (layer T7).

Usage:
    python -m blockpuzzle_tpu.cli.train --algo ppo --updates 100 \
        --num-envs 4096 --preset default --log-dir /tmp/bp_logs

Covers BASELINE configs 4-5: the (dp, tp) mesh spans every visible device
(one GPU by default; ``--tp`` splits the model axis), and ``--distributed``
adds the jax.distributed multi-process rendezvous.  The env axis is sharded
over dp and XLA inserts the gradient all-reduce.
"""

from __future__ import annotations

import argparse

import jax

from blockpuzzle_tpu import dist
from blockpuzzle_tpu.config import PRESETS, cli_env_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig
from blockpuzzle_tpu.utils import (
    CheckpointManager,
    MetricsLogger,
    Throughput,
    add_platform_arg,
    select_platform,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BlockPuzzle trainer")
    p.add_argument("--algo", choices=["ppo", "dqn"], default="ppo")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VALUE",
                   help="override any EnvConfig field on top of --preset "
                        "(repeatable), e.g. --env streak_bonus=5 "
                        "--env queue_size=3")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=2, help="PPO epochs/update")
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--entropy-coef", type=float, default=0.01)
    p.add_argument("--entropy-final", type=float, default=None,
                   help="linear-anneal entropy coef to this over --updates")
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=0.995)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--value-coef", type=float, default=0.5)
    p.add_argument("--anneal", type=int, default=0,
                   help="linear-decay LR to 0 over this many updates")
    p.add_argument("--buffer-size", type=int, default=200_000,
                   help="DQN replay capacity (transitions)")
    p.add_argument("--eps-decay", type=int, default=2000,
                   help="DQN epsilon decay horizon (iterations)")
    p.add_argument("--target-update", type=int, default=500,
                   help="DQN target-net sync period (gradient steps)")
    p.add_argument("--n-step", type=int, default=1,
                   help="DQN n-step returns (1 = classic 1-step TD)")
    p.add_argument("--dueling", action="store_true",
                   help="DQN dueling value/advantage head")
    p.add_argument("--per", action="store_true",
                   help="DQN prioritized replay (proportional, "
                        "Gumbel-top-k sampling; beta anneals to 1 over "
                        "--eps-decay)")
    p.add_argument("--torso", choices=["conv", "mlp"], default="conv",
                   help="network torso: CNN or pure-matmul MLP")
    p.add_argument("--mlp-width", type=int, default=512,
                   help="mlp-torso matmul width (ignored by conv)")
    p.add_argument("--queue-mode", choices=["embed", "planes"],
                   default="embed",
                   help="hand representation: id embedding or spatial "
                        "piece planes (networks.Torso)")
    p.add_argument("--dispatch-updates", type=int, default=1,
                   help="PPO: scan this many updates per device dispatch "
                        "(amortizes host round trips; --updates must be a "
                        "multiple)")
    p.add_argument("--state-impl", choices=["auto", "packed", "u8"],
                   default="auto",
                   help="EnvState board layout: packed (u32 row words, the "
                        "default) or u8 (older checkpoint layout).  auto = "
                        "packed for new runs; on --resume it matches the "
                        "checkpoint's recorded layout (missing field = u8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel width")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: run jax.distributed.initialize first")
    p.add_argument("--profile-dir", default=None,
                   help="capture a device trace for updates 2-4")
    add_platform_arg(p)
    p.add_argument("--debug", action="store_true",
                   help="NaN trapping + per-log-step env-state validation")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    select_platform(args.platform)
    from blockpuzzle_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    if args.debug:
        from blockpuzzle_tpu.utils import enable_debug_mode

        enable_debug_mode()
    if args.distributed:
        dist.init_distributed()

    cfg = cli_env_config(args.preset, args.env)
    # one manager instance for the whole run (created before the env so
    # --resume can match the checkpoint's recorded EnvState layout)
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    state_impl = None if args.state_impl == "auto" else args.state_impl
    if args.state_impl == "auto" and args.resume and ckpt is not None:
        # run_meta records state_impl; dirs without it hold u8 states
        state_impl = (ckpt.load_run_meta() or {}).get("state_impl", "u8")
    env = make_env(cfg, state_impl=state_impl)
    mesh = dist.make_mesh(tp=args.tp)

    if args.algo == "ppo":
        learner = PPO(env, PPOConfig(
            num_envs=args.num_envs, rollout_len=args.rollout_len, lr=args.lr,
            num_epochs=args.epochs, num_minibatches=args.minibatches,
            entropy_coef=args.entropy_coef, clip_eps=args.clip_eps,
            gamma=args.gamma, torso=args.torso, mlp_width=args.mlp_width,
            queue_mode=args.queue_mode,
        ))

        # lr/entropy schedules are computed HERE and passed as runtime
        # scalars (ppo.default_hypers): every sweep point / anneal shape
        # shares one compiled update program
        def ppo_hypers(update: int) -> dict:
            lr = args.lr
            if args.anneal > 0:
                lr *= max(0.0, 1.0 - update / args.anneal)
            ent = args.entropy_coef
            if args.entropy_final is not None and args.updates > 1:
                frac = min(1.0, update / (args.updates - 1))
                ent = args.entropy_coef + frac * (
                    args.entropy_final - args.entropy_coef
                )
            return {
                "lr": lr, "entropy_coef": ent, "clip_eps": args.clip_eps,
                "gamma": args.gamma, "gae_lambda": args.gae_lambda,
                "value_coef": args.value_coef,
            }

        if args.dispatch_updates > 1:
            import numpy as np

            def step_fn(state, update):
                # K updates in one device dispatch (amortizes host RTT);
                # metrics reported from the LAST update of the group
                stack = [ppo_hypers(u)
                         for u in range(update, update + args.dispatch_updates)]
                hypers = {
                    k: np.asarray([h[k] for h in stack], np.float32)
                    for k in stack[0]
                }
                state, metrics = learner.multi_update_jit(state, hypers)
                return state, {k: v[-1] for k, v in metrics.items()}

        else:
            step_fn = lambda state, update: learner.update_jit(
                state, ppo_hypers(update)
            )
        steps_per_call = (
            args.num_envs * args.rollout_len * args.dispatch_updates
        )
    else:
        learner = DQN(env, DQNConfig(
            num_envs=args.num_envs, lr=args.lr,
            buffer_size=args.buffer_size, eps_decay_iters=args.eps_decay,
            target_update_every=args.target_update, torso=args.torso,
            mlp_width=args.mlp_width, queue_mode=args.queue_mode,
            n_step=args.n_step, dueling=args.dueling, per=args.per,
        ))
        from blockpuzzle_tpu.learn import default_dqn_hypers

        dqn_step = learner.iteration_jit
        # lr/eps/gamma as runtime scalars (host-computed schedule): every
        # eps/lr sweep point shares one compiled program (cf. PPO hypers)
        step_fn = lambda state, update: dqn_step(
            state, default_dqn_hypers(learner.cfg, update)
        )
        steps_per_call = args.num_envs * learner.cfg.collect_steps

    state = learner.init(jax.random.key(args.seed))
    shardings = dist.to_named(mesh, dist.train_state_spec(state))
    state = jax.device_put(state, shardings)

    if ckpt:
        # operational flags that do not define the training trajectory —
        # everything else in argparse IS the recipe and gets recorded.
        # "tp" sits with "distributed": both only change the SHARDING of
        # a bit-equivalent computation (test_dist pins sharded==unsharded),
        # so recipe-equality stays a same-trajectory check across them.
        non_recipe = {
            "log_dir", "log_every", "checkpoint_dir", "checkpoint_every",
            "resume", "profile_dir", "platform", "debug", "distributed",
            "tp",
        }
        # self-describing checkpoint dir: cli.evaluate auto-fills its
        # network/env flags from this (utils/checkpoint.py:save_run_meta)
        ckpt.save_run_meta({
            "algo": args.algo, "preset": args.preset,
            "env_overrides": list(args.env), "torso": args.torso,
            "mlp_width": args.mlp_width, "queue_mode": args.queue_mode,
            "dueling": args.dueling,  # changes the DQN param tree
            "state_impl": env.state_impl,  # --resume must match the layout
            # the full recipe: exact reproduction/extension is a metadata
            # read, not log archaeology.  New argparse flags are recorded
            # automatically unless listed in non_recipe above.
            "recipe": {k: v for k, v in sorted(vars(args).items())
                       if k not in non_recipe},
        })
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        try:
            state = ckpt.restore(state)
        except Exception as e:
            # Checkpoints that merely PREDATE a new state field (e.g.
            # EnvState.streak) are handled inside restore() by filling the
            # new field from the template.  Reaching here means a harder
            # mismatch — most commonly an optimizer-layout change (e.g.
            # DQN's adam -> scale_by_adam refactor changed the opt_state
            # pytree structure). Surface that instead of a bare traceback.
            raise SystemExit(
                f"--resume failed: checkpoint at {args.checkpoint_dir} does "
                f"not match the current TrainState layout (often an "
                f"optimizer-layout change between versions). Weights are "
                f"still usable: cli.evaluate restores params-only from "
                f"mismatched checkpoints. Original error: {e}"
            )
        print(f"resumed from update {start}")

    logger = MetricsLogger(args.log_dir, run_name=f"{args.algo}-{args.preset}")
    meter = Throughput()


    stride = args.dispatch_updates if args.algo == "ppo" else 1
    if (args.updates - start) % stride != 0:
        raise SystemExit(
            f"--updates ({args.updates}) minus resume point ({start}) must "
            f"be a multiple of --dispatch-updates ({stride})"
        )

    profiling_active = profiled_once = False
    # Host/device sync policy: the loop waits for the device ONLY at
    # log/checkpoint/final boundaries, letting jax async dispatch queue the
    # updates in between (a per-update wait serializes the host round trip
    # with compute).  --profile-dir and --debug force per-update syncs so
    # trace windows bracket real device work and validation sees every
    # logged state.
    force_sync = bool(args.profile_dir) or args.debug
    pending_steps = 0  # env steps enqueued since the last device sync
    sps = 0.0
    for update in range(start, args.updates, stride):
        # capture a device trace spanning updates 2-4 (post-compile,
        # steady-state)
        if (args.profile_dir and not profiling_active and not profiled_once
                and update - start >= 2):
            jax.profiler.start_trace(args.profile_dir)
            profiling_active = profiled_once = True
        state, metrics = step_fn(state, update)
        done = update + stride  # updates completed so far
        pending_steps += steps_per_call
        at_log = done % args.log_every == 0 or update == start
        at_ckpt = ckpt is not None and done % args.checkpoint_every == 0
        if force_sync or at_log or at_ckpt or done >= args.updates:
            jax.block_until_ready(metrics)  # drains the dispatch queue
            sps = meter.tick(pending_steps)
            pending_steps = 0
        if profiling_active and (done >= start + 4 or done >= args.updates):
            jax.profiler.stop_trace()
            profiling_active = False
        if at_log:
            metrics = dict(metrics)
            metrics["env_steps_per_s"] = sps
            host = logger.log(done, metrics)
            print(
                f"update {done}: return={host.get('episode_return', 0):.1f} "
                f"loss={host.get('loss', 0):.4f} steps/s={sps / 1e6:.2f}M"
            )
        if args.debug and at_log:
            from blockpuzzle_tpu.utils import validate_env_state

            validate_env_state(env, state.env_state)
        if at_ckpt:
            ckpt.save(done, state)
    if ckpt:
        if ckpt.latest_step() != args.updates:  # periodic save may have hit it
            ckpt.save(args.updates, state)
        ckpt.close()
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
