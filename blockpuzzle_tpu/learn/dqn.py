"""On-device DQN learner (the "PPO/DQN" alternative of BASELINE's north_star).

Double-DQN with an on-device circular replay buffer: collection (K batched
env steps with epsilon-greedy over the legal-action mask), buffer writes,
uniform sampling, TD update, and periodic target sync all run inside one
jitted program — the host only dispatches and reads scalar metrics, mirroring
the PPO design (SURVEY.md §3.4).
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
from blockpuzzle_tpu.learn.networks import (
    QNetwork,
    reroot_key,
    select_along_last,
)


def default_dqn_hypers(cfg: "DQNConfig", iteration: int = 0) -> Dict[str, float]:
    """Runtime-tunable DQN hyperparameters at their config values.

    Mirrors ``ppo.default_hypers``: pass (host-computed) schedules to
    ``DQN.iteration(state, hypers)`` every iteration without recompiling.
    ``eps`` follows the config's linear decay at ``iteration``.
    """
    # eps_decay_iters <= 0 means "no decay": jump straight to eps_end
    # (matches the old device-side it/0 -> inf -> clip -> 1.0 behavior
    # without the host ZeroDivisionError).
    if cfg.eps_decay_iters <= 0:
        frac = 1.0
    else:
        frac = min(max(iteration / cfg.eps_decay_iters, 0.0), 1.0)
    return {
        "lr": cfg.lr,
        "eps": cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start),
        "gamma": cfg.gamma,
        # PER importance exponent (ignored unless cfg.per); standard anneal
        # beta -> 1 over the run, reusing the eps decay horizon
        "beta": cfg.per_beta + frac * (1.0 - cfg.per_beta),
    }


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    num_envs: int = 1024
    buffer_size: int = 200_000     # transitions (across all envs)
    batch_size: int = 4096
    gamma: float = 0.995
    lr: float = 1e-4
    collect_steps: int = 4         # env steps per iteration
    grad_steps: int = 1            # gradient steps per iteration
    target_update_every: int = 500  # in gradient steps
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 2_000
    min_buffer: int = 10_000
    max_grad_norm: float = 10.0
    hidden: int = 256
    channels: Tuple[int, ...] = (32, 64)
    torso: str = "conv"  # "conv" | "mlp" (see networks.Torso)
    mlp_width: int = 512  # mlp-torso matmul width (ignored by conv)
    queue_mode: str = "embed"  # "embed" | "planes" (see networks.Torso)
    sample_rng_impl: str = "rbg"  # see PPOConfig.sample_rng_impl
    # n-step returns: each stored transition aggregates up to n rewards
    # (R = sum_i gamma^i r_{t+i}, truncated at the first episode end) and
    # bootstraps gamma^m * Q(s_{t+m}).  Computed at COLLECTION time via a
    # pending window carried in DQNState; the replay stays packed (2 blobs,
    # see Replay) with one extra u8 byte (m) per row when n > 1.
    # n_step=1 is bit-identical to the original path.
    n_step: int = 1
    # dueling value/advantage head (networks.QNetwork.dueling); advantage
    # mean is over legal actions only
    dueling: bool = False
    # Prioritized experience replay (Schaul et al. 2016), proportional
    # variant.  Default sampler draws WITH replacement by inverse-CDF over
    # the alpha-scaled priorities (cumsum + one device sort — no sum-tree,
    # whose sequential walk suits a host, not a batched device); p_i is then the exact per-draw
    # probability, so the (1/(n_filled*p_i))^beta importance weights are
    # unbiased.  per_replacement=False switches to Gumbel-top-k (exact
    # Plackett-Luce WITHOUT replacement — see _per_sample for the IS-weight
    # approximation that entails).  New rows enter at the running max
    # priority; sampled rows' priorities update to raw |td| (per_eps is
    # added exactly once, at sampling time).
    per: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4     # runtime-overridable via hypers["beta"]
    per_eps: float = 1e-3
    per_replacement: bool = True


@pytree_dataclass
class Replay:
    """Circular on-device replay buffer (capacity B transitions).

    Transitions are PACKED into two row blobs so a write is 2 scatters and
    a sample is 2 gathers (a 9-buffer layout was far slower to compile on
    the previous accelerator; ROADMAP R3 re-decides it on the GPU).  u8 row layout:
    [board(HW) | next_board(HW) | queue(S) | next_queue(S) | mask(A) |
     next_mask(A) | terminated(1)]; f32 row: [reward, action].
    """

    bytes_buf: jax.Array    # (B, L8) uint8 packed
    float_buf: jax.Array    # (B, 2) float32: [reward, action]
    cursor: jax.Array       # () int32 — next write slot
    filled: jax.Array       # () int32 — number of valid entries
    # PER only (None otherwise — empty pytree subtree, layout unchanged):
    prio: Any = None        # (B,) float32 raw |td| priorities
    max_prio: Any = None    # () float32 running max priority


@pytree_dataclass
class DQNState:
    """Learner + env + replay state.  The current observation is derived
    from ``env_state`` at iteration start (see PPO.TrainState note on
    donation-safe aliasing)."""

    params: Any
    target_params: Any
    opt_state: Any
    env_state: EnvState
    replay: Replay
    key: jax.Array
    iter_count: jax.Array
    grad_count: jax.Array
    # n_step > 1 only: the last (n-1) per-step transitions (dict of
    # (n-1, N, ...) stacked arrays + a (n-1,) validity vector), carried
    # across iterations so n-step windows span iteration boundaries.
    # None when n_step == 1 (empty pytree subtree; layout unchanged).
    pending: Any = None


class DQN:
    def __init__(self, env: VecBlockPuzzle, cfg: Optional[DQNConfig] = None):
        if env.num_pieces >= 256:
            raise ValueError(
                f"packed-u8 replay stores piece ids as uint8; "
                f"piece library has {env.num_pieces} >= 256 pieces"
            )
        self.env = env
        self.cfg = cfg or DQNConfig()
        if self.cfg.n_step < 1:
            raise ValueError(f"n_step must be >= 1, got {self.cfg.n_step}")
        if self.cfg.n_step >= 256:
            raise ValueError("n_step is stored as a u8 byte; must be < 256")
        if self.cfg.per and self.cfg.min_buffer < self.cfg.batch_size:
            # Gumbel-top-k samples WITHOUT replacement: fewer filled rows
            # than batch_size would select unfilled (-inf logit) slots
            raise ValueError("per requires min_buffer >= batch_size")
        self.net = QNetwork(
            env.cfg, env.num_pieces,
            channels=self.cfg.channels, hidden=self.cfg.hidden,
            arch=self.cfg.torso, mlp_width=self.cfg.mlp_width,
            queue_mode=self.cfg.queue_mode, dueling=self.cfg.dueling,
        )
        # Direction-only optimizer: lr is applied in the iteration so it
        # can be a RUNTIME scalar (``hypers`` — same one-compile-per-sweep
        # pattern as PPO.update; see ppo.default_hypers)
        self.tx = optax.chain(
            optax.clip_by_global_norm(self.cfg.max_grad_norm),
            optax.scale_by_adam(),
        )

    def init(self, key: jax.Array) -> DQNState:
        cfg, env_cfg = self.cfg, self.env.cfg
        k_env, k_net, k_run = jax.random.split(key, 3)
        env_state, ts = self.env.init_jit(k_env, cfg.num_envs)
        params = jax.jit(self.net.init)(k_net)
        b = cfg.buffer_size
        row_len = (
            2 * env_cfg.num_cells + 2 * env_cfg.queue_size
            + 2 * env_cfg.num_actions() + 1
        )
        if cfg.n_step > 1:
            row_len += 1  # the per-row step count m (see DQNConfig.n_step)
        replay = Replay(
            bytes_buf=jnp.zeros((b, row_len), jnp.uint8),
            float_buf=jnp.zeros((b, 2), jnp.float32),
            cursor=jnp.zeros((), jnp.int32),
            filled=jnp.zeros((), jnp.int32),
            prio=jnp.zeros((b,), jnp.float32) if cfg.per else None,
            max_prio=jnp.ones((), jnp.float32) if cfg.per else None,
        )
        del ts
        pending = None
        if cfg.n_step > 1:
            w = cfg.n_step - 1
            n, hw = cfg.num_envs, env_cfg.num_cells
            s, a = env_cfg.queue_size, env_cfg.num_actions()
            pending = {
                "board": jnp.zeros((w, n, hw), jnp.uint8),
                "queue": jnp.zeros((w, n, s), jnp.int32),
                "action_mask": jnp.zeros((w, n, a), bool),
                "action": jnp.zeros((w, n), jnp.int32),
                "reward": jnp.zeros((w, n), jnp.float32),
                "next_board": jnp.zeros((w, n, hw), jnp.uint8),
                "next_queue": jnp.zeros((w, n, s), jnp.int32),
                "next_mask": jnp.zeros((w, n, a), bool),
                "terminated": jnp.zeros((w, n), bool),
                "done": jnp.zeros((w, n), bool),
                "valid": jnp.zeros((w,), bool),
            }
        # fast PRNG for epsilon-greedy sampling (see PPOConfig note)
        k_run = reroot_key(k_run, self.cfg.sample_rng_impl)
        return DQNState(
            params=params,
            # deep copy: sharing buffers with params would make state
            # donation fail ("donate the same buffer twice")
            target_params=jax.tree.map(jnp.copy, params),
            opt_state=self.tx.init(params),
            env_state=env_state,
            replay=replay,
            key=k_run,
            iter_count=jnp.zeros((), jnp.int32),
            grad_count=jnp.zeros((), jnp.int32),
            pending=pending,
        )

    def observe(self, env_state: EnvState):
        board = self.env.board_obs(env_state.board)
        mask = self.env.action_mask(env_state.board, env_state.queue)
        return board, env_state.queue, mask

    # ------------------------------------------------------------------

    def _epsilon(self, it: jax.Array) -> jax.Array:
        cfg = self.cfg
        frac = jnp.clip(it / cfg.eps_decay_iters, 0.0, 1.0)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def _act(self, params, board, queue, mask, key, eps) -> jax.Array:
        """Epsilon-greedy over LEGAL actions only."""
        k_eps, k_rand = jax.random.split(key)
        q = self.net.apply(params, board, queue, mask)
        greedy = jnp.argmax(q, axis=-1)
        # uniform over legal via bits-argmax (same distribution as
        # gumbel-max over the mask but no log/exp over (N, A) — the
        # sampler bench.py uses); `| 1`
        # keeps legal draws above illegal 0s even on an all-zero draw row
        bits = jax.random.bits(k_rand, mask.shape, jnp.uint32)
        rand = jnp.argmax(
            jnp.where(mask, bits | jnp.uint32(1), jnp.uint32(0)), axis=-1
        )
        explore = jax.random.uniform(k_eps, greedy.shape) < eps
        return jnp.where(explore, rand, greedy)

    def _pack(self, trans: Dict[str, jax.Array]) -> Tuple[jax.Array, jax.Array]:
        """Transitions dict -> (u8 rows (n, L8), f32 rows (n, 2))."""
        parts = [
            trans["board"],
            trans["next_board"],
            trans["queue"].astype(jnp.uint8),
            trans["next_queue"].astype(jnp.uint8),
            trans["action_mask"].astype(jnp.uint8),
            trans["next_mask"].astype(jnp.uint8),
            trans["terminated"].astype(jnp.uint8)[:, None],
        ]
        if "m" in trans:  # n-step row: bootstrap exponent byte
            parts.append(trans["m"].astype(jnp.uint8)[:, None])
        rows = jnp.concatenate(parts, axis=1)
        floats = jnp.stack(
            [trans["reward"], trans["action"].astype(jnp.float32)], axis=1
        )
        return rows, floats

    def _unpack(self, rows: jax.Array, floats: jax.Array) -> Dict[str, jax.Array]:
        cfg = self.env.cfg
        hw, s, a = cfg.num_cells, cfg.queue_size, cfg.num_actions()
        o = 0

        def take(width):
            nonlocal o
            part = rows[:, o : o + width]
            o += width
            return part

        out = {
            "board": take(hw),
            "next_board": take(hw),
            "queue": take(s).astype(jnp.int32),
            "next_queue": take(s).astype(jnp.int32),
            "action_mask": take(a).astype(bool),
            "next_mask": take(a).astype(bool),
            "terminated": take(1)[:, 0].astype(bool),
            "reward": floats[:, 0],
            "action": floats[:, 1].astype(jnp.int32),
        }
        if self.cfg.n_step > 1:
            out["m"] = take(1)[:, 0].astype(jnp.int32)
        return out

    def _write_replay(self, replay: Replay, trans: Dict[str, jax.Array]) -> Replay:
        n = trans["action"].shape[0]
        idx = (replay.cursor + jnp.arange(n)) % self.cfg.buffer_size
        rows, floats = self._pack(trans)
        return replay.replace(
            bytes_buf=replay.bytes_buf.at[idx].set(rows),
            float_buf=replay.float_buf.at[idx].set(floats),
            cursor=(replay.cursor + n) % self.cfg.buffer_size,
            filled=jnp.minimum(replay.filled + n, self.cfg.buffer_size),
            # PER: fresh transitions enter at the running max priority
            prio=(replay.prio.at[idx].set(replay.max_prio)
                  if self.cfg.per else None),
            max_prio=replay.max_prio,
        )

    def _write_replay_masked(
        self, replay: Replay, trans: Dict[str, jax.Array], valid: jax.Array
    ) -> Replay:
        """Write only rows flagged in ``valid`` ((M,) bool), densely packed.

        Invalid rows (start-up n-step windows rooted in not-yet-collected
        pending slots) scatter to an out-of-bounds index under
        ``mode="drop"`` — the buffer never sees them and the cursor
        advances by the VALID count only, so the circular layout stays
        dense.  One scatter per blob, same as the 1-step path.
        """
        b = self.cfg.buffer_size
        rows, floats = self._pack(trans)
        pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
        idx = jnp.where(valid, (replay.cursor + pos) % b, b)  # b == dropped
        n_valid = valid.sum().astype(jnp.int32)
        return replay.replace(
            bytes_buf=replay.bytes_buf.at[idx].set(rows, mode="drop"),
            float_buf=replay.float_buf.at[idx].set(floats, mode="drop"),
            cursor=(replay.cursor + n_valid) % b,
            filled=jnp.minimum(replay.filled + n_valid, b),
            prio=(replay.prio.at[idx].set(replay.max_prio, mode="drop")
                  if self.cfg.per else None),
            max_prio=replay.max_prio,
        )

    def _nstep_aggregate(
        self, comb: Dict[str, jax.Array], gamma
    ) -> Dict[str, jax.Array]:
        """n-step transitions from (T', N, ...) per-step transitions.

        ``comb`` holds T' = collect_steps + n - 1 time-stacked 1-step
        transitions (pending window first).  Emission t (t < collect_steps)
        aggregates rewards over the window [t, t+n) truncated at the first
        episode end (``done``; auto-reset means later rows belong to the
        NEXT episode), records m = steps actually included, and takes the
        bootstrap observation from the window's final included row (its
        pre-reset "final" obs).  All selection is static n-loops of
        ``where`` — no gathers (CLAUDE.md hot-path rule).
        """
        n = self.cfg.n_step
        k = self.cfg.collect_steps
        out = []
        for t in range(k):
            alive = jnp.ones_like(comb["done"][t])          # (N,) bool
            r_acc = jnp.zeros_like(comb["reward"][t])
            m = jnp.zeros(r_acc.shape, jnp.int32)
            for i in range(n):
                af = alive.astype(jnp.float32)
                r_acc = r_acc + af * (gamma ** i) * comb["reward"][t + i]
                m = m + alive.astype(jnp.int32)
                alive = jnp.logical_and(alive, ~comb["done"][t + i])
            nb = comb["next_board"][t]
            nq = comb["next_queue"][t]
            nm = comb["next_mask"][t]
            term = comb["terminated"][t]
            for i in range(1, n):
                sel = m == i + 1                              # (N,) bool
                nb = jnp.where(sel[:, None], comb["next_board"][t + i], nb)
                nq = jnp.where(sel[:, None], comb["next_queue"][t + i], nq)
                nm = jnp.where(sel[:, None], comb["next_mask"][t + i], nm)
                term = jnp.where(sel, comb["terminated"][t + i], term)
            out.append({
                "board": comb["board"][t],
                "queue": comb["queue"][t],
                "action_mask": comb["action_mask"][t],
                "action": comb["action"][t],
                "reward": r_acc,
                "next_board": nb,
                "next_queue": nq,
                "next_mask": nm,
                "terminated": term,
                "m": m,
            })
        return {key: jnp.stack([o[key] for o in out]) for key in out[0]}

    # ------------------------------------------------------------------

    def _per_sample(
        self, replay: Replay, key: jax.Array, beta
    ) -> Tuple[jax.Array, jax.Array]:
        """(idx (batch,), is_weights (batch,)) — proportional PER draw.

        Two samplers, selected by ``cfg.per_replacement``:

        * True (default): WITH replacement via inverse-CDF over the
          alpha-scaled priorities (cumsum + ``searchsorted(method="sort")``
          — one device sort per grad step, no sum-tree; the tree's
          sequential structure suits a host, not a batched device).  Each
          draw is independent with probability exactly p_i, so Schaul et
          al.'s w = (1 / (n * p_i))^beta IS-correction is unbiased.
        * False: WITHOUT replacement via Gumbel-top-k over alpha-scaled
          log-priorities (exact Plackett-Luce top-k; one ``lax.top_k``).
          CAVEAT: the IS weights below still plug the single-draw p_i into
          Schaul's formula, but the *inclusion* probability of a
          without-replacement top-k draw is not p_i — it saturates toward
          1 for high-priority rows as batch_size/filled grows, so the beta
          correction is approximate, worst just after warm-up when filled
          is close to batch_size.  Kept for experiments wanting duplicate-
          free batches; raise min_buffer well above batch_size with it.

        Unfilled slots are never drawn (zero mass / -inf logits).  Weights
        are normalized by the batch max (standard).  The idx gather is
        learner-path (batch rows), not env hot-path, so the CLAUDE.md
        no-gather rule does not apply.
        """
        cfg = self.cfg
        b = cfg.buffer_size
        valid = jnp.arange(b) < replay.filled
        # priorities are stored as RAW |td|; per_eps enters exactly here
        palpha = jnp.where(
            valid, jnp.power(replay.prio + cfg.per_eps, cfg.per_alpha), 0.0
        )
        if cfg.per_replacement:
            # inverse CDF: scale u by the cumsum's OWN tail, not by
            # palpha.sum() — f32 reduction order makes the two differ by
            # ~2e-7 relative, and a draw landing in the gap
            # [cdf[-1], sum) would hit an unfilled slot with p=0 whose IS
            # weight max-normalizes every real sample to ~0 (advisor r4:
            # with u < cdf[-1] every draw's inclusion probability and IS
            # weight are exact; the clamp below is a pure backstop for
            # u == cdf[-1] under side="right").  The cdf is flat past
            # `filled` (palpha=0 there), so unfilled slots are unreachable.
            cdf = jnp.cumsum(palpha)
            total = jnp.maximum(cdf[-1], 1e-30)  # p_i normalizer must match
            u = jax.random.uniform(key, (cfg.batch_size,)) * total
            idx = jnp.searchsorted(cdf, u, side="right", method="sort")
            idx = jnp.minimum(idx, replay.filled - 1).astype(jnp.int32)
        else:
            total = jnp.maximum(palpha.sum(), 1e-30)
            logits = jnp.where(valid, jnp.log(palpha), -jnp.inf)
            g = jax.random.gumbel(key, (b,))
            _, idx = jax.lax.top_k(logits + g, cfg.batch_size)
        p = palpha[idx] / total
        n_filled = jnp.maximum(replay.filled.astype(jnp.float32), 1.0)
        w = jnp.power(1.0 / (n_filled * jnp.maximum(p, 1e-30)), beta)
        return idx, w / jnp.maximum(w.max(), 1e-30)

    def _td_loss(
        self, params, target_params, sample, gamma=None, weights=None
    ) -> Tuple[jax.Array, Dict]:
        cfg, env_cfg = self.cfg, self.env.cfg
        gamma = cfg.gamma if gamma is None else gamma
        h, w = env_cfg.board_shape
        q = self.net.apply(
            params,
            sample["board"].reshape(-1, h, w),
            sample["queue"],
            sample["action_mask"],
        )
        q_sa = select_along_last(q, sample["action"])  # gather-free (CLAUDE.md)
        # Double DQN: online net argmax, target net evaluation
        next_board = sample["next_board"].reshape(-1, h, w)
        q_next_online = self.net.apply(
            params, next_board, sample["next_queue"], sample["next_mask"]
        )
        a_star = jnp.argmax(q_next_online, axis=-1)
        q_next_target = self.net.apply(
            target_params, next_board, sample["next_queue"], sample["next_mask"]
        )
        q_next = select_along_last(q_next_target, a_star)
        # terminal states (no legal action) bootstrap to 0
        q_next = jnp.where(sample["terminated"], 0.0, q_next)
        if self.cfg.n_step > 1:
            # n-step: reward already aggregates gamma^i r_{t+i} over the m
            # included steps; the bootstrap discounts by gamma^m
            gamma_n = jnp.power(gamma, sample["m"].astype(jnp.float32))
        else:
            gamma_n = gamma
        target = sample["reward"] + gamma_n * q_next
        td = q_sa - jax.lax.stop_gradient(target)
        if weights is None:
            loss = jnp.square(td).mean()
        else:
            loss = (weights * jnp.square(td)).mean()  # PER IS-correction
        aux = {"loss": loss, "q_mean": q_sa.mean(), "td_abs": jnp.abs(td).mean()}
        if weights is not None:
            # per-sample |td| for the PER priority update (not a metric)
            aux["td_abs_per"] = jax.lax.stop_gradient(jnp.abs(td))
        return loss, aux

    # ------------------------------------------------------------------

    def iteration(
        self, state: DQNState, hypers: Optional[Dict[str, Any]] = None
    ) -> Tuple[DQNState, Dict[str, jax.Array]]:
        """collect_steps env steps + grad_steps TD updates, all on device.

        ``hypers`` (see ``default_dqn_hypers``) optionally carries lr /
        epsilon / gamma as runtime scalars so schedules and sweeps reuse
        one compiled program; omitted values fall back to the config
        constants (epsilon then follows the built-in linear decay).
        """
        cfg = self.cfg
        if hypers is None:
            lr: Any = cfg.lr
            eps: Any = self._epsilon(state.iter_count)
            # the barrier keeps the constant out of XLA's algebraic
            # rewrites of the TD target, so this program computes it
            # exactly as the runtime-hypers one does (tested bit-equal)
            gamma: Any = jax.lax.optimization_barrier(jnp.float32(cfg.gamma))
            beta: Any = cfg.per_beta
        else:
            lr = hypers["lr"]
            eps = hypers["eps"]
            gamma = hypers["gamma"]
            beta = hypers.get("beta", cfg.per_beta)  # PER IS exponent

        def collect(carry, _):
            env_state, board, queue, mask, replay, key = carry
            key, k_act = jax.random.split(key)
            action = self._act(state.params, board, queue, mask, k_act, eps)
            env_state, ts = self.env.step(env_state, action)
            # next obs = the PRE-auto-reset ("final") observation: for done
            # envs ts.board/queue/mask already belong to the next episode,
            # which would corrupt the truncation bootstrap
            trans = {
                "board": board.reshape(board.shape[0], -1),
                "queue": queue,
                "action_mask": mask,
                "action": action,
                "reward": ts.reward,
                "next_board": ts.info["final_board"].reshape(
                    board.shape[0], -1
                ),
                "next_queue": ts.info["final_queue"],
                "next_mask": ts.info["final_action_mask"],
                "terminated": ts.terminated,
            }
            if cfg.n_step > 1:
                # emit the 1-step transition (plus the episode-boundary
                # flag the n-step window truncates on); the write happens
                # after aggregation, outside the scan
                trans["done"] = ts.done
                y = trans
            else:
                replay = self._write_replay(replay, trans)
                y = None
            ep = (ts.info["episode_return"] * ts.done, ts.done)
            return (
                (env_state, ts.board, ts.queue, ts.action_mask, replay, key),
                (y, ep),
            )

        board0, queue0, mask0 = self.observe(state.env_state)
        (env_state, board, queue, mask, replay, key), (fresh, (ep_ret, dones)) = (
            jax.lax.scan(
                collect,
                (state.env_state, board0, queue0, mask0,
                 state.replay, state.key),
                None,
                length=cfg.collect_steps,
            )
        )
        pending = state.pending
        if cfg.n_step > 1:
            # pending window first, then this iteration's fresh steps
            comb = {
                k: jnp.concatenate([pending[k], fresh[k]], axis=0)
                for k in fresh
            }
            agg = self._nstep_aggregate(comb, gamma)
            # emission t is rooted at combined row t: valid iff that row is
            # real (pending slots start invalid for the first n-1 rows ever)
            comb_valid = jnp.concatenate(
                [pending["valid"], jnp.ones((cfg.collect_steps,), bool)]
            )                                                   # (K + n - 1,)
            valid_t = comb_valid[: cfg.collect_steps]           # (K,)
            n_envs = ep_ret.shape[1]
            flat = {
                k: v.reshape((cfg.collect_steps * n_envs,) + v.shape[2:])
                for k, v in agg.items()
            }
            valid = jnp.repeat(valid_t, n_envs)
            replay = self._write_replay_masked(replay, flat, valid)
            pending = {
                k: comb[k][cfg.collect_steps:] for k in fresh
            }
            pending["valid"] = comb_valid[cfg.collect_steps:]

        def grad_step(carry, _):
            params, target_params, opt_state, grad_count, key, rep = carry
            key, k_samp = jax.random.split(key)
            if cfg.per:
                idx, weights = self._per_sample(rep, k_samp, beta)
            else:
                idx = jax.random.randint(
                    k_samp, (cfg.batch_size,), 0, jnp.maximum(rep.filled, 1)
                )
                weights = None
            sample = self._unpack(rep.bytes_buf[idx], rep.float_buf[idx])
            grads, aux = jax.grad(self._td_loss, has_aux=True)(
                params, target_params, sample, gamma, weights
            )
            if cfg.per:
                # sampled rows take their fresh RAW |td| as priority
                # (per_eps is added once, in _per_sample — adding it here
                # too flattened the priority distribution)
                new_prio = aux.pop("td_abs_per")
                rep = rep.replace(
                    prio=rep.prio.at[idx].set(new_prio),
                    max_prio=jnp.maximum(rep.max_prio, new_prio.max()),
                )
            metrics = aux
            updates, opt_state = self.tx.update(grads, opt_state, params)
            # tx is direction-only (scale_by_adam); apply -lr here so lr
            # stays a runtime input (no recompile on anneal/sweep)
            params = optax.apply_updates(
                params, jax.tree.map(lambda u: -lr * u, updates)
            )
            grad_count = grad_count + 1
            target_params = jax.tree.map(
                lambda t, p: jnp.where(
                    grad_count % cfg.target_update_every == 0, p, t
                ),
                target_params,
                params,
            )
            return (
                (params, target_params, opt_state, grad_count, key, rep),
                metrics,
            )

        warm = replay.filled >= cfg.min_buffer

        def do_updates(operand):
            carry, metrics = jax.lax.scan(
                grad_step, operand, None, length=cfg.grad_steps
            )
            return carry, jax.tree.map(lambda x: x.mean(), metrics)

        def skip_updates(operand):
            zero = {
                "loss": jnp.zeros(()), "q_mean": jnp.zeros(()),
                "td_abs": jnp.zeros(()),
            }
            return operand, zero

        (params, target_params, opt_state, grad_count, key, replay), metrics = (
            jax.lax.cond(
                warm,
                do_updates,
                skip_updates,
                (state.params, state.target_params, state.opt_state,
                 state.grad_count, key, replay),
            )
        )

        n_done = jnp.maximum(dones.sum(), 1)
        metrics = dict(metrics)
        metrics.update(
            episode_return=ep_ret.sum() / n_done,
            episodes_finished=dones.sum(),
            epsilon=eps,
            buffer_filled=replay.filled,
        )
        new_state = state.replace(
            params=params,
            target_params=target_params,
            opt_state=opt_state,
            env_state=env_state,
            replay=replay,
            key=key,
            iter_count=state.iter_count + 1,
            grad_count=grad_count,
            pending=pending,
        )
        return new_state, metrics

    @functools.cached_property
    def iteration_jit(self):
        return jax.jit(self.iteration, donate_argnums=(0,))
