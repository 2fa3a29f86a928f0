"""Gymnasium VectorEnv adapter over the batched device engine.

A user of the reference env who wants vectorization gets Gym's generic
``VectorEnv`` wrappers (per-env Python loops — SURVEY.md §2.3 "vectorization
is the caller's problem").  This adapter is the batched replacement: a
``gymnasium.vector.VectorEnv`` whose whole batch steps as ONE jitted XLA
program on device, with NumPy in/out at the host boundary.

All three gymnasium autoreset conventions are supported via the
``autoreset_mode`` constructor argument:

* ``SAME_STEP`` (default — the convention of JAX env suites): the returned
  observation for a finished env is already the reset observation; the
  pre-reset observation is exposed as ``infos["final_board"]`` /
  ``infos["final_queue"]`` with the standard gymnasium ``_final_board``
  presence mask.
* ``NEXT_STEP`` (gymnasium ≥1.0's default convention): the terminal step
  returns the FINAL (pre-reset) observation, and the env resets on the
  following step, whose action is ignored for that env (reward 0, both
  done flags False, obs = reset observation).  Implemented adapter-side:
  the engine still auto-resets in-step, and a jitted combine substitutes
  the held-back reset state/obs for pending envs.
* ``DISABLED``: no automatic reset; finished envs are FROZEN — stepping
  them is a no-op (state, observation, and episode stats bit-unchanged;
  reward 0; the death-time terminated/truncated flags re-presented
  sticky, so no penalty is re-applied and no bogus episodes accrue) until
  the caller partially resets them with
  ``reset(options={"reset_mask": bool_(N,)})`` — the engine's
  ``partial_reset``, which re-deals ONLY the flagged envs from their own
  counter-based RNG streams and passes the rest through bit-untouched.
  Note: ``partial_reset`` deals from a different (tag-1) substream than
  the fused in-step auto-reset, so for the same seed a DISABLED-mode
  trajectory diverges from a SAME_STEP/NEXT_STEP one after the first
  reset.  Both are deterministic and alias-free; they are just distinct
  substreams (see ``env/core.py:partial_reset``).

Documented deviation from gymnasium's SAME_STEP convention:
``infos["final_obs"]`` is a dict of BATCHED arrays (``{"board": (N, H, W),
"queue": (N, S)}``, plus ``"piece_planes": (N, S, H, W)`` when
``cfg.obs_planes``) rather than a ``(N,)`` object array of per-env obs
dicts.  Batched arrays are the only layout that stays a single device
transfer; generic wrappers that index ``final_obs[i]`` should use
``{k: v[i] for k, v in infos["final_obs"].items()}`` (or the flat
``final_board``/``final_queue`` fields).

Registered so that ``gymnasium.make_vec("BlockPuzzleTpu/BlockPuzzle-v0",
num_envs=N)`` returns this class.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

import gymnasium
from gymnasium import spaces
from gymnasium.vector import VectorEnv
from gymnasium.vector.utils import batch_space

import jax
import jax.numpy as jnp

from blockpuzzle_tpu.config import EnvConfig, default_config
from blockpuzzle_tpu.env import make_env


def _w(p, a, b):
    """Per-env where: broadcast (N,) predicate over trailing dims of a/b."""
    return jnp.where(p.reshape(p.shape + (1,) * (a.ndim - 1)), a, b)


class BlockPuzzleVectorEnv(VectorEnv):
    """N lockstep BlockPuzzle envs on one XLA device program."""

    metadata = {
        "render_modes": ["rgb_array"],
        "autoreset_mode": gymnasium.vector.AutoresetMode.SAME_STEP,
    }

    def __init__(
        self,
        num_envs: int = 1024,
        cfg: Optional[EnvConfig] = None,
        render_mode: Optional[str] = None,
        autoreset_mode: "str | gymnasium.vector.AutoresetMode" = "same_step",
        **overrides: Any,
    ) -> None:
        if cfg is None:
            cfg = default_config()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.engine = make_env(cfg)
        self.num_envs = num_envs
        self.render_mode = render_mode
        Mode = gymnasium.vector.AutoresetMode
        if isinstance(autoreset_mode, str):
            try:
                autoreset_mode = Mode[autoreset_mode.upper()]
            except KeyError:
                raise ValueError(
                    f"autoreset_mode {autoreset_mode!r} not one of "
                    f"{[m.name.lower() for m in Mode]}"
                ) from None
        elif not isinstance(autoreset_mode, Mode):
            # a wrong-typed value would otherwise silently degrade to
            # SAME_STEP behavior with bogus metadata
            raise TypeError(
                f"autoreset_mode must be a str or AutoresetMode, got "
                f"{autoreset_mode!r}"
            )
        self.autoreset_mode = autoreset_mode
        # per-instance copy: wrappers inspect metadata["autoreset_mode"]
        self.metadata = {**type(self).metadata, "autoreset_mode": autoreset_mode}

        h, w, s = cfg.height, cfg.width, cfg.queue_size
        obs_spaces = {
            "board": spaces.Box(0, 1, shape=(h, w), dtype=np.uint8),
            "queue": spaces.Box(
                0, self.engine.num_pieces, shape=(s,), dtype=np.int32
            ),
        }
        if cfg.obs_planes:
            obs_spaces["piece_planes"] = spaces.Box(
                0, 1, shape=(s, h, w), dtype=np.uint8
            )
        self.single_observation_space = spaces.Dict(obs_spaces)
        self.single_action_space = spaces.Discrete(cfg.num_actions())
        self.observation_space = batch_space(
            self.single_observation_space, num_envs
        )
        self.action_space = batch_space(self.single_action_space, num_envs)

        self._state = None
        self._last_ts = None
        self._pending = None  # NEXT_STEP: envs that finished last step
        self._raw_obs = None  # NEXT_STEP/DISABLED: engine obs field carry
        self._dead = None  # DISABLED: envs frozen awaiting reset_mask
        self._dead_term = None  # DISABLED: terminated flag at death
        self._dead_trunc = None  # DISABLED: truncated flag at death
        # plain jit (no donation): callers may hold references across steps
        self._step_fn = jax.jit(
            lambda st, a: self.engine.step(st, a, auto_reset=True)
        )
        self._partial_reset_fn = jax.jit(self.engine.partial_reset)
        # mask/plane recompute for reset(options=...) state overrides
        self._mask_fn = jax.jit(
            lambda b, q: self.engine.action_mask(b, q)
        )
        self._planes_fn = jax.jit(lambda q: self.engine.piece_planes(q))

        # NEXT_STEP / DISABLED: engine step + convention combine fused
        # into ONE jitted program — a second dispatch per step would
        # double the per-step host->device round trips
        def _step_next(old_state, actions, old_raw, pending):
            new_state, ts = self.engine.step(old_state, actions,
                                             auto_reset=True)
            return self._next_step_combine(
                new_state, ts, old_state, old_raw, pending
            )

        def _step_disabled(old_state, actions, old_raw, dead, dterm, dtrunc):
            new_state, ts = self.engine.step(old_state, actions,
                                             auto_reset=False)
            return self._disabled_combine(
                new_state, ts, old_state, old_raw, dead, dterm, dtrunc
            )

        self._step_next_fn = jax.jit(_step_next)
        self._step_disabled_fn = jax.jit(_step_disabled)

    # ------------------------------------------------------------------

    def _next_step_combine(self, new_state, new_ts, old_state, old_raw, pending):
        """NEXT_STEP autoreset: substitute held-back resets for ``pending``.

        Pending envs (finished on the PREVIOUS step) did not really take
        this step: their pre-step state — which the fused auto-reset
        already re-initialized — is restored wholesale (including
        ``rng_counter``, so the discarded transition's draws are simply
        re-made identically later), and their presented obs is the reset
        observation with reward 0 / done False.  Envs finishing THIS step
        present the final (pre-reset) observation instead of the reset one.
        """
        w = _w
        done_now = jnp.logical_and(new_ts.done, jnp.logical_not(pending))
        info = new_ts.info
        state = new_state.replace(
            board=w(pending, old_state.board, new_state.board),
            queue=w(pending, old_state.queue, new_state.queue),
            rng_counter=jnp.where(
                pending, old_state.rng_counter, new_state.rng_counter
            ),
            steps=jnp.where(pending, old_state.steps, new_state.steps),
            score=jnp.where(pending, old_state.score, new_state.score),
            streak=jnp.where(pending, old_state.streak, new_state.streak),
        )
        # engine (post-reset) obs rows carried to the NEXT combine
        raw = {
            "board": w(pending, old_raw["board"], new_ts.board),
            "queue": w(pending, old_raw["queue"], new_ts.queue),
            "mask": w(pending, old_raw["mask"], new_ts.action_mask),
        }
        presented = {
            "board": w(pending, old_raw["board"],
                       w(done_now, info["final_board"], new_ts.board)),
            "queue": w(pending, old_raw["queue"],
                       w(done_now, info["final_queue"], new_ts.queue)),
            "mask": w(pending, old_raw["mask"],
                      w(done_now, info["final_action_mask"],
                        new_ts.action_mask)),
        }
        if self.cfg.obs_planes:
            raw["planes"] = w(
                pending, old_raw["planes"], new_ts.piece_planes
            )
            presented["planes"] = w(
                pending, old_raw["planes"],
                w(done_now, info["final_piece_planes"], new_ts.piece_planes),
            )
        presented["reward"] = jnp.where(pending, 0.0, new_ts.reward)
        presented["terminated"] = jnp.where(
            pending, False, new_ts.terminated
        )
        presented["truncated"] = jnp.where(pending, False, new_ts.truncated)
        presented["lines_cleared"] = jnp.where(
            pending, 0, info["lines_cleared"]
        )
        presented["episode_return"] = jnp.where(
            pending, 0.0, info["episode_return"]
        )
        presented["streak"] = jnp.where(pending, 0, info["streak"])
        return state, raw, presented, done_now

    # ------------------------------------------------------------------

    def _disabled_combine(
        self, new_state, new_ts, old_state, old_raw, dead, dterm, dtrunc
    ):
        """DISABLED autoreset: freeze envs that already finished.

        A dead env's step must be a bit-exact no-op: without this, the
        engine would keep recomputing ``terminated`` from the (still
        empty) mask and re-apply ``terminal_penalty`` every step, and a
        dead env under ``max_steps`` would keep counting toward a bogus
        truncation — episode stats would drift one phantom episode per
        step.  Dead rows restore their pre-step state wholesale (only
        ``rng_counter`` keeps advancing, preserving the monotone-counter
        invariant; its draws are unused while frozen), present reward 0,
        and re-present the terminated/truncated flags recorded at death.
        """
        w = _w
        state = new_state.replace(
            board=w(dead, old_state.board, new_state.board),
            queue=w(dead, old_state.queue, new_state.queue),
            steps=jnp.where(dead, old_state.steps, new_state.steps),
            score=jnp.where(dead, old_state.score, new_state.score),
            streak=jnp.where(dead, old_state.streak, new_state.streak),
        )
        raw = {
            "board": w(dead, old_raw["board"], new_ts.board),
            "queue": w(dead, old_raw["queue"], new_ts.queue),
            "mask": w(dead, old_raw["mask"], new_ts.action_mask),
        }
        presented = dict(raw)
        if self.cfg.obs_planes:
            raw["planes"] = w(dead, old_raw["planes"], new_ts.piece_planes)
            presented["planes"] = raw["planes"]
        info = new_ts.info
        term_out = jnp.where(dead, dterm, new_ts.terminated)
        trunc_out = jnp.where(dead, dtrunc, new_ts.truncated)
        presented["reward"] = jnp.where(dead, 0.0, new_ts.reward)
        presented["terminated"] = term_out
        presented["truncated"] = trunc_out
        presented["lines_cleared"] = jnp.where(
            dead, 0, info["lines_cleared"]
        )
        presented["episode_return"] = jnp.where(
            dead, old_state.score, info["episode_return"]
        )
        presented["streak"] = jnp.where(dead, old_state.streak, info["streak"])
        dead_out = jnp.logical_or(dead, jnp.logical_or(term_out, trunc_out))
        return state, raw, presented, dead_out, term_out, trunc_out

    # ------------------------------------------------------------------

    def _raw_from_ts(self, ts) -> Dict[str, Any]:
        raw = {
            "board": ts.board,
            "queue": ts.queue,
            "mask": ts.action_mask,
        }
        if self.cfg.obs_planes:
            raw["planes"] = ts.piece_planes
        return raw

    def _obs(self, ts) -> Dict[str, np.ndarray]:
        out = {
            "board": np.asarray(ts.board),
            "queue": np.asarray(ts.queue),
        }
        if ts.piece_planes is not None:
            out["piece_planes"] = np.asarray(ts.piece_planes)
        return out

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        if options and "reset_mask" in options:
            # partial reset (gymnasium AutoresetMode.DISABLED contract)
            if len(options) > 1:
                raise ValueError(
                    "options['reset_mask'] cannot be combined with other "
                    "reset options"
                )
            if seed is not None:
                raise ValueError(
                    "seed= with reset_mask is unsupported: flagged envs "
                    "re-deal from their own counter-based RNG streams"
                )
            if self._state is None:
                raise RuntimeError("full reset() required before reset_mask")
            m = np.asarray(options["reset_mask"])
            if m.shape != (self.num_envs,):
                raise ValueError(
                    f"reset_mask shape {m.shape} != {(self.num_envs,)}"
                )
            m_dev = jnp.asarray(m, dtype=bool)
            self._state, ts = self._partial_reset_fn(self._state, m_dev)
            self._last_ts = ts
            Mode = gymnasium.vector.AutoresetMode
            alive = jnp.logical_not(m_dev)
            if self.autoreset_mode is Mode.NEXT_STEP:
                self._pending = jnp.logical_and(self._pending, alive)
                self._raw_obs = self._raw_from_ts(ts)
            elif self.autoreset_mode is Mode.DISABLED:
                self._dead = jnp.logical_and(self._dead, alive)
                self._dead_term = jnp.logical_and(self._dead_term, alive)
                self._dead_trunc = jnp.logical_and(self._dead_trunc, alive)
                self._raw_obs = self._raw_from_ts(ts)
            return self._obs(ts), {"action_mask": np.asarray(ts.action_mask)}
        if seed is None:
            # gymnasium convention: unseeded resets draw fresh entropy
            import os as _os

            seed = int.from_bytes(_os.urandom(4), "little")
        key = jax.random.key(seed)
        # jitted init: one program instead of many eager dispatches
        self._state, ts = self.engine.init_jit(key, self.num_envs)
        if options:
            # batched analogue of the oracle's reset options: override the
            # fresh boards and/or hands, then recompute the legal mask
            unknown = set(options) - {"board", "queue"}
            if unknown:
                raise ValueError(f"unknown reset options: {sorted(unknown)}")
            board, queue = self._state.board, self._state.queue
            if "board" in options:
                b_host = np.asarray(options["board"], dtype=np.uint8)
                want = (
                    (self.num_envs, self.cfg.height, self.cfg.width),
                    (self.num_envs, self.cfg.num_cells),
                )
                if b_host.shape not in want:
                    # a bare reshape would silently reinterpret e.g. a
                    # transposed (HW, N) array as N wrong boards — the
                    # oracle's reset raises on shape mismatch, so do we
                    raise ValueError(
                        f"options['board'] shape {b_host.shape} not in {want}"
                    )
                if np.any(b_host > 1):
                    # non-binary cells would desync the engine's
                    # count==size clear test from the oracle's .all()
                    raise ValueError("options['board'] cells must be 0/1")
                board = self.engine.encode_board(b_host)
            if "queue" in options:
                q_host = np.asarray(options["queue"], dtype=np.int32)
                if q_host.shape != (self.num_envs, self.cfg.queue_size):
                    raise ValueError(
                        f"options['queue'] shape {q_host.shape} != "
                        f"{(self.num_envs, self.cfg.queue_size)}"
                    )
                # same contract as the oracle's reset(options=...): bogus
                # ids would otherwise act as silent dead slots (all-zero
                # one-hot -> all-false mask, zero plane)
                if np.any((q_host < 0) | (q_host > self.engine.empty_id)):
                    raise ValueError("options['queue'] ids out of range")
                queue = jnp.asarray(q_host)
            self._state = self._state.replace(board=board, queue=queue)
            ts = ts.replace(
                board=self.engine.board_obs(board),
                queue=queue,
                action_mask=self._mask_fn(board, queue),
                piece_planes=(
                    self._planes_fn(queue) if self.cfg.obs_planes else None
                ),
            )
        self._last_ts = ts
        self._pending = jnp.zeros(self.num_envs, dtype=bool)
        self._dead = jnp.zeros(self.num_envs, dtype=bool)
        self._dead_term = jnp.zeros(self.num_envs, dtype=bool)
        self._dead_trunc = jnp.zeros(self.num_envs, dtype=bool)
        self._raw_obs = self._raw_from_ts(ts)
        infos = {"action_mask": np.asarray(ts.action_mask)}
        return self._obs(ts), infos

    def step(self, actions) -> Tuple[
        Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]
    ]:
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        actions = jnp.asarray(np.asarray(actions), dtype=jnp.int32)
        Mode = gymnasium.vector.AutoresetMode
        if self.autoreset_mode is Mode.NEXT_STEP:
            return self._step_next_step(actions)
        if self.autoreset_mode is Mode.DISABLED:
            return self._step_disabled(actions)
        self._state, ts = self._step_fn(self._state, actions)
        self._last_ts = ts
        terminated = np.asarray(ts.terminated)
        truncated = np.asarray(ts.truncated)
        done = terminated | truncated
        infos: Dict[str, Any] = {
            "action_mask": np.asarray(ts.action_mask),
            "lines_cleared": np.asarray(ts.info["lines_cleared"]),
            "episode_return": np.asarray(ts.info["episode_return"]),
            "streak": np.asarray(ts.info["streak"]),
        }
        if done.any() and "final_board" in ts.info:
            final_board = np.asarray(ts.info["final_board"])
            final_queue = np.asarray(ts.info["final_queue"])
            # gymnasium SAME_STEP convention key...
            infos["final_obs"] = {"board": final_board, "queue": final_queue}
            if "final_piece_planes" in ts.info:
                infos["final_obs"]["piece_planes"] = np.asarray(
                    ts.info["final_piece_planes"]
                )
            infos["_final_obs"] = done
            # ...plus flat per-field arrays for vectorized consumers
            infos["final_board"] = final_board
            infos["final_queue"] = final_queue
            infos["_final_board"] = done
            infos["_final_queue"] = done
        return (
            self._obs(ts),
            np.asarray(ts.reward),
            terminated,
            truncated,
            infos,
        )

    def _present(self, out: Dict[str, Any]) -> Tuple[
        Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]
    ]:
        """Shared host-side packing for the NEXT_STEP/DISABLED step paths."""
        self._last_ts = self._last_ts.replace(
            board=out["board"], queue=out["queue"], action_mask=out["mask"]
        )
        obs = {
            "board": np.asarray(out["board"]),
            "queue": np.asarray(out["queue"]),
        }
        if self.cfg.obs_planes:
            obs["piece_planes"] = np.asarray(out["planes"])
        infos = {
            "action_mask": np.asarray(out["mask"]),
            "lines_cleared": np.asarray(out["lines_cleared"]),
            "episode_return": np.asarray(out["episode_return"]),
            "streak": np.asarray(out["streak"]),
        }
        return (
            obs,
            np.asarray(out["reward"]),
            np.asarray(out["terminated"]),
            np.asarray(out["truncated"]),
            infos,
        )

    def _step_next_step(self, actions) -> Tuple[
        Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]
    ]:
        self._state, self._raw_obs, out, done_now = self._step_next_fn(
            self._state, actions, self._raw_obs, self._pending
        )
        self._pending = done_now
        return self._present(out)

    def _step_disabled(self, actions) -> Tuple[
        Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]
    ]:
        (
            self._state,
            self._raw_obs,
            out,
            self._dead,
            self._dead_term,
            self._dead_trunc,
        ) = self._step_disabled_fn(
            self._state, actions, self._raw_obs,
            self._dead, self._dead_term, self._dead_trunc,
        )
        return self._present(out)

    def render(self):
        if self.render_mode != "rgb_array" or self._last_ts is None:
            return None
        # tile the first <=16 boards into a grid image
        boards = np.asarray(self._last_ts.board[:16])
        n = boards.shape[0]
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        h, w = self.cfg.height, self.cfg.width
        canvas = np.zeros((rows * (h + 1), cols * (w + 1), 3), dtype=np.uint8)
        for i in range(n):
            r, c = divmod(i, cols)
            img = np.zeros((h, w, 3), np.uint8)
            img[boards[i] == 0] = (24, 24, 32)
            img[boards[i] == 1] = (90, 170, 255)
            canvas[r * (h + 1) : r * (h + 1) + h, c * (w + 1) : c * (w + 1) + w] = img
        return np.kron(canvas, np.ones((8, 8, 1), dtype=np.uint8))

    def close_extras(self, **kwargs):
        self._state = None
