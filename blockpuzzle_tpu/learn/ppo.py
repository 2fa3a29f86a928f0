"""On-device PPO actor-learner (BASELINE config 4; SURVEY.md §3.4).

The whole update — T-step rollout via ``lax.scan`` driving the batched env,
GAE (reverse scan), and PPO minibatch epochs — is ONE jitted program.  The
host dispatches once per update and reads back already-reduced scalar
metrics.  Under a device mesh (``blockpuzzle_tpu.dist``) the env/batch axis
is sharded over "dp" and XLA inserts the gradient all-reduce automatically;
the env step itself needs zero collectives (envs are independent — SURVEY.md
§5 "Distributed communication backend").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from blockpuzzle_tpu.env import EnvState, VecBlockPuzzle
from blockpuzzle_tpu.env.state import pytree_dataclass
from blockpuzzle_tpu.learn import networks
from blockpuzzle_tpu.learn.networks import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static PPO hyperparameters (hashable; baked into the jitted update)."""

    num_envs: int = 4096
    rollout_len: int = 64
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 2
    num_minibatches: int = 4
    # Minibatch shuffle scheme.  "roll": one random rotation of the flat
    # (T*N) batch per epoch, then contiguous minibatch slices — each
    # minibatch still spans T/num_minibatches timesteps of ALL N independent
    # envs, and the whole scheme is gather-free.  "perm": classic random
    # permutation with per-minibatch row gathers.  "none": debugging.
    shuffle: str = "roll"
    anneal_updates: int = 0  # >0: linear LR decay to 0 over this many updates
    hidden: int = 256
    channels: Tuple[int, ...] = (32, 64)
    torso: str = "conv"  # "conv" | "mlp" (see networks.Torso)
    mlp_width: int = 512  # mlp-torso matmul width (ignored by conv)
    queue_mode: str = "embed"  # "embed" | "planes" (see networks.Torso)
    # PRNG impl for action sampling: "rbg" (fast path) or "threefry2x32"
    # (sharding-stable — required when comparing sharded vs unsharded runs;
    # see networks.reroot_key)
    sample_rng_impl: str = "rbg"


def default_hypers(cfg: PPOConfig) -> Dict[str, float]:
    """Runtime-tunable hyperparameters at their config values.

    ``PPO.update`` accepts these as TRACED scalars, so the host can change
    them every update (LR anneal, entropy schedule, sweeps) without
    recompiling the update.
    """
    return {
        "lr": cfg.lr,
        "entropy_coef": cfg.entropy_coef,
        "clip_eps": cfg.clip_eps,
        "gamma": cfg.gamma,
        "gae_lambda": cfg.gae_lambda,
        "value_coef": cfg.value_coef,
    }


@pytree_dataclass
class Batch:
    """One rollout's transitions, time-major (T, N, ...)."""

    board: jax.Array
    queue: jax.Array
    action_mask: jax.Array
    action: jax.Array
    log_prob: jax.Array
    value: jax.Array
    reward: jax.Array
    done: jax.Array
    terminated: jax.Array
    # V(final obs) for truncation bootstrapping; zeros when the env config
    # cannot truncate (max_steps == 0)
    final_value: jax.Array


@pytree_dataclass
class TrainState:
    """Everything PPO needs to run and resume bit-exactly (SURVEY.md §5).

    The current observation is NOT stored: it is derived from ``env_state``
    at rollout start (one extra mask matmul per update).  Storing it would
    alias ``env_state.board`` (reshape view) and break ``donate_argnums``.
    """

    params: Any
    opt_state: Any
    env_state: EnvState
    key: jax.Array
    update_count: jax.Array


class PPO:
    """Factory for the jitted PPO update over a ``VecBlockPuzzle`` engine."""

    def __init__(self, env: VecBlockPuzzle, cfg: Optional[PPOConfig] = None):
        self.env = env
        self.cfg = cfg or PPOConfig()
        self.net = ActorCritic(
            env.cfg,
            env.num_pieces,
            channels=self.cfg.channels,
            hidden=self.cfg.hidden,
            arch=self.cfg.torso,
            mlp_width=self.cfg.mlp_width,
            queue_mode=self.cfg.queue_mode,
        )
        # Direction-only optimizer: the learning rate is applied manually in
        # ``update`` so it can be a RUNTIME input (see ``default_hypers``) —
        # sweeping lr / annealing from the host then reuses ONE compiled
        # program instead of a compile per constant.
        self.tx = optax.chain(
            optax.clip_by_global_norm(self.cfg.max_grad_norm),
            optax.scale_by_adam(),
        )

    # ------------------------------------------------------------------

    def init(self, key: jax.Array) -> TrainState:
        cfg = self.cfg
        k_env, k_net, k_run = jax.random.split(key, 3)
        # jitted env init: one program instead of many eager dispatches
        env_state, ts = self.env.init_jit(k_env, cfg.num_envs)
        params = jax.jit(self.net.init)(k_net)
        opt_state = self.tx.init(params)
        # re-root the run key under the configured sampling PRNG (fast rbg
        # by default — same trick as VecBlockPuzzle.init)
        k_run = networks.reroot_key(k_run, self.cfg.sample_rng_impl)
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            key=k_run,
            update_count=jnp.zeros((), jnp.int32),
        )

    def observe(self, env_state: EnvState):
        """(board3d, queue, action_mask) derived from the env state."""
        board = self.env.board_obs(env_state.board)
        mask = self.env.action_mask(env_state.board, env_state.queue)
        return board, env_state.queue, mask

    # ------------------------------------------------------------------

    def _rollout(
        self, state: TrainState
    ) -> Tuple[TrainState, Batch, jax.Array, Dict[str, jax.Array]]:
        """T-step on-device rollout; returns batch + bootstrap value."""

        params = state.params  # fixed during the rollout

        def body(carry, _):
            env_state, board, queue, mask, key = carry
            key, k_act = jax.random.split(key)
            logits, value = self.net.apply(params, board, queue, mask)
            action = networks.masked_categorical(k_act, logits)
            logp = networks.log_prob(logits, action)
            env_state, ts = self.env.step(env_state, action)
            if self.env.cfg.max_steps > 0:
                # truncating config: value the PRE-reset final observation
                # (the value head ignores the mask, so the live mask is fine)
                _, v_final = self.net.apply(
                    params,
                    ts.info["final_board"],
                    ts.info["final_queue"],
                    ts.action_mask,
                )
            else:
                v_final = jnp.zeros_like(value)
            transition = Batch(
                board=board,
                queue=queue,
                action_mask=mask,
                action=action,
                log_prob=logp,
                value=value,
                reward=ts.reward,
                done=ts.done,
                terminated=ts.terminated,
                final_value=v_final,
            )
            ep_stats = (
                ts.info["episode_return"] * ts.done,
                ts.info["episode_length"] * ts.done,
                ts.done,
                ts.info["lines_cleared"],
                ts.info["legal"],
            )
            return (
                env_state,
                ts.board,
                ts.queue,
                ts.action_mask,
                key,
            ), (transition, ep_stats)

        board0, queue0, mask0 = self.observe(state.env_state)
        (env_state, board, queue, mask, key), (batch, ep_stats) = jax.lax.scan(
            body,
            (state.env_state, board0, queue0, mask0, state.key),
            None,
            length=self.cfg.rollout_len,
        )
        _, last_value = self.net.apply(state.params, board, queue, mask)
        new_state = state.replace(env_state=env_state, key=key)
        ep_ret, ep_len, dones, lines, legal = ep_stats
        n_done = jnp.maximum(dones.sum(), 1)
        stats = {
            "episode_return": ep_ret.sum() / n_done,
            "episode_length": ep_len.sum() / n_done,
            "episodes_finished": dones.sum(),
            # SURVEY.md §5 observability: clear rate + illegal-action rate
            "lines_per_step": lines.mean(),
            "illegal_action_rate": 1.0 - legal.mean(),
        }
        return new_state, batch, last_value, stats

    # ------------------------------------------------------------------

    def _gae(
        self, batch: Batch, last_value: jax.Array,
        gamma=None, gae_lambda=None,
    ) -> Tuple[jax.Array, jax.Array]:
        """Generalized advantage estimation over the time axis.

        Terminated steps stop the bootstrap; truncated steps bootstrap from
        V(final observation) — NOT the post-auto-reset observation's value
        (auto-reset is same-step, so ``next_value`` at a truncation belongs
        to the NEXT episode).
        """
        cfg = self.cfg
        gamma = cfg.gamma if gamma is None else gamma
        gae_lambda = cfg.gae_lambda if gae_lambda is None else gae_lambda

        def body(carry, xs):
            gae, next_value = carry
            reward, value, done, terminated, final_value = xs
            truncated = jnp.logical_and(done, jnp.logical_not(terminated))
            next_v = jnp.where(
                terminated,
                0.0,
                jnp.where(truncated, final_value, next_value),
            )
            delta = reward + gamma * next_v - value
            gae = delta + gamma * gae_lambda * jnp.where(
                done, 0.0, gae
            )
            return (gae, value), gae

        (_, _), advantages = jax.lax.scan(
            body,
            (jnp.zeros_like(last_value), last_value),
            (batch.reward, batch.value, batch.done, batch.terminated,
             batch.final_value),
            reverse=True,
        )
        returns = advantages + batch.value
        return advantages, returns

    # ------------------------------------------------------------------

    def _loss(
        self, params, minibatch, advantages, returns,
        entropy_coef=None, clip_eps=None, value_coef=None,
    ):
        cfg = self.cfg
        entropy_coef = cfg.entropy_coef if entropy_coef is None else entropy_coef
        clip_eps = cfg.clip_eps if clip_eps is None else clip_eps
        value_coef = cfg.value_coef if value_coef is None else value_coef
        logits, value = self.net.apply(
            params, minibatch.board, minibatch.queue, minibatch.action_mask
        )
        logp = networks.log_prob(logits, minibatch.action)
        ratio = jnp.exp(logp - minibatch.log_prob)
        adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * adv
        policy_loss = -jnp.minimum(pg1, pg2).mean()
        value_loss = 0.5 * jnp.square(value - returns).mean()
        entropy = networks.masked_entropy(logits).mean()
        total = (
            policy_loss
            + value_coef * value_loss
            - entropy_coef * entropy
        )
        metrics = {
            "loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
            "approx_kl": ((ratio - 1) - jnp.log(ratio)).mean(),
        }
        return total, metrics

    # ------------------------------------------------------------------

    def update(
        self, state: TrainState, hypers: Optional[Dict[str, Any]] = None
    ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        """One full PPO update: rollout + GAE + epochs of minibatch SGD.

        ``hypers`` (see ``default_hypers``) carries lr / entropy_coef /
        clip_eps as runtime scalars; when omitted they resolve to config
        constants (including the ``anneal_updates`` linear LR decay,
        evaluated per UPDATE from ``state.update_count``).
        """
        cfg = self.cfg
        if hypers is None:
            lr = cfg.lr
            if cfg.anneal_updates > 0:
                frac = jnp.maximum(
                    0.0,
                    1.0
                    - state.update_count.astype(jnp.float32)
                    / cfg.anneal_updates,
                )
                lr = cfg.lr * frac
            entropy_coef: Any = cfg.entropy_coef
            clip_eps: Any = cfg.clip_eps
            gamma: Any = cfg.gamma
            gae_lambda: Any = cfg.gae_lambda
            value_coef: Any = cfg.value_coef
        else:
            lr = hypers["lr"]
            entropy_coef = hypers["entropy_coef"]
            clip_eps = hypers["clip_eps"]
            gamma = hypers["gamma"]
            gae_lambda = hypers["gae_lambda"]
            value_coef = hypers["value_coef"]
        state, batch, last_value, ep_stats = self._rollout(state)
        advantages, returns = self._gae(batch, last_value, gamma, gae_lambda)

        # flatten (T, N) -> (T*N,)
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        batch_flat = jax.tree.map(flat, batch)
        adv_flat = flat(advantages)
        ret_flat = flat(returns)
        total = cfg.rollout_len * cfg.num_envs
        mb_size = total // cfg.num_minibatches

        def epoch(carry, _):
            params, opt_state, key = carry
            key, k_shuf = jax.random.split(key)

            if cfg.shuffle == "perm":
                perm = jax.random.permutation(k_shuf, total)
                idxs = perm[: mb_size * cfg.num_minibatches].reshape(
                    cfg.num_minibatches, mb_size
                )

                def get_mb(i):
                    take = lambda x: jnp.take(x, idxs[i], axis=0)
                    return (
                        jax.tree.map(take, batch_flat),
                        take(adv_flat),
                        take(ret_flat),
                    )

            else:
                if cfg.shuffle == "roll":
                    shift = jax.random.randint(k_shuf, (), 0, total)
                    reorder = lambda x: jnp.roll(x, shift, axis=0)
                elif cfg.shuffle == "none":
                    reorder = lambda x: x
                else:
                    raise ValueError(f"unknown shuffle {cfg.shuffle!r}")
                shuf_batch = jax.tree.map(reorder, batch_flat)
                shuf_adv = reorder(adv_flat)
                shuf_ret = reorder(ret_flat)

                def get_mb(i):
                    sl = lambda x: jax.lax.dynamic_slice_in_dim(
                        x, i * mb_size, mb_size, axis=0
                    )
                    return jax.tree.map(sl, shuf_batch), sl(shuf_adv), sl(shuf_ret)

            def minibatch_step(carry, i):
                params, opt_state = carry
                mb, adv_mb, ret_mb = get_mb(i)
                grads, metrics = jax.grad(self._loss, has_aux=True)(
                    params, mb, adv_mb, ret_mb,
                    entropy_coef, clip_eps, value_coef,
                )
                # tx is direction-only (scale_by_adam); apply -lr here so lr
                # stays a runtime input (no recompile on anneal/sweep)
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(
                    params, jax.tree.map(lambda u: -lr * u, updates)
                )
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                minibatch_step,
                (params, opt_state),
                jnp.arange(cfg.num_minibatches),
            )
            return (params, opt_state, key), metrics

        (params, opt_state, key), metrics = jax.lax.scan(
            epoch,
            (state.params, state.opt_state, state.key),
            None,
            length=cfg.num_epochs,
        )
        metrics = jax.tree.map(lambda x: x.mean(), metrics)
        metrics.update(ep_stats)
        metrics["reward_per_step"] = batch.reward.mean()
        new_state = state.replace(
            params=params,
            opt_state=opt_state,
            key=key,
            update_count=state.update_count + 1,
        )
        return new_state, metrics

    def multi_update(
        self, state: TrainState, hypers_stack: Dict[str, jax.Array]
    ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        """K updates in ONE dispatch: ``lax.scan`` over stacked hypers.

        ``hypers_stack`` is a ``default_hypers``-shaped dict whose leaves
        carry a leading (K,) axis (host-precomputed schedules).  Scanning K
        updates per dispatch amortizes the host round trip of each
        dispatch.  Compile cost matches a single update (scan traces the
        body once).  Returns metrics stacked (K,).
        """
        return jax.lax.scan(self.update, state, hypers_stack)

    # ------------------------------------------------------------------

    @functools.cached_property
    def update_jit(self):
        return jax.jit(self.update, donate_argnums=(0,))

    @functools.cached_property
    def multi_update_jit(self):
        return jax.jit(self.multi_update, donate_argnums=(0,))
