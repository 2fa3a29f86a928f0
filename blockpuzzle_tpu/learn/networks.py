"""Policy/value networks for the on-device learners (SURVEY.md §7.1 PR4).

Small CNN torso over the board + an embedding of the piece queue, with policy
and value heads.  The reference has no learner (it is an environment; the
learner is a BASELINE target capability, configs 4-5), so the architecture is
free to suit the accelerator:

  * bfloat16 activations, float32 params; the heads take bf16 operands and
    accumulate in float32 (``_dense_f32_out``).
  * Plain-JAX ``init``/``apply`` pairs over a nested param dict.  Param
    paths follow the ``params/Torso_0/hidden_proj/kernel`` layout, and the
    tensor-parallel split of the dense kernels lives in one place:
    ``blockpuzzle_tpu.dist.sharding.PARAM_RULES`` matches those paths.  At
    the default sizes every param replicates.
  * Illegal actions are masked to a large negative logit — masking lives in
    the network so every consumer (PPO, DQN, eval) gets it fused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from blockpuzzle_tpu import rules
from blockpuzzle_tpu.config import EnvConfig

NEG_INF = -1e9

Params = Dict[str, Any]

_he_normal = jax.nn.initializers.he_normal()
_lecun_normal = jax.nn.initializers.lecun_normal()
# fan-in scaled over the embedding width (rows are lookups, not inputs)
_embed_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0
)


def _dense_params(key, fan_in: int, features: int, init) -> Params:
    return {
        "kernel": init(key, (fan_in, features), jnp.float32),
        "bias": jnp.zeros((features,), jnp.float32),
    }


def _dense_bf16(p: Params, x: jax.Array) -> jax.Array:
    """Dense layer computed and returned in bf16 (torso layers)."""
    y = jax.lax.dot_general(
        x.astype(jnp.bfloat16),
        p["kernel"].astype(jnp.bfloat16),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    return y + p["bias"].astype(jnp.bfloat16)


def _dense_f32_out(p: Params, x: jax.Array) -> jax.Array:
    """Dense with bf16 operands and float32 accumulation and output.

    A bf16 output keeps ~3 significant digits — too coarse for PPO logits,
    whose clipped ratios are exp of logit differences — while float32
    operands would leave the tensor cores' bf16 rate.  bf16 operands with
    ``preferred_element_type=float32`` keep both.
    """
    y = jax.lax.dot_general(
        x.astype(jnp.bfloat16),
        p["kernel"].astype(jnp.bfloat16),
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return y + p["bias"]


def _conv_bf16(p: Params, x: jax.Array) -> jax.Array:
    """3x3 SAME conv over (..., H, W, C) in bf16 (any leading batch dims)."""
    lead = x.shape[:-3]
    x4 = x.reshape((-1,) + x.shape[-3:])
    y = jax.lax.conv_general_dilated(
        x4.astype(jnp.bfloat16),
        p["kernel"].astype(jnp.bfloat16),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = y + p["bias"].astype(jnp.bfloat16)
    return y.reshape(lead + y.shape[1:])


@dataclasses.dataclass(frozen=True)
class Torso:
    """Shared representation: board features ⊕ queue features.

    ``arch="conv"`` (default): small CNN over the board.  ``arch="mlp"``:
    flatten the board into a single wide matmul — trades parameter count
    for one large matrix product in place of small spatial convs (selected
    per experiment; both are parity-free learner internals).

    ``queue_mode`` selects the hand representation:
      * "embed": learned id embedding concatenated onto the board features.
        The embed lookup is a (small) gather.
      * "planes": spatialize the hand via ``one_hot(queue) @ plane_table``
        (``rules.piece_plane_table`` — a matmul, gather-free) and feed the
        planes as EXTRA INPUT CHANNELS alongside the board (conv arch) or as
        extra flattened inputs (mlp arch).  The policy then sees board and
        hand in the same spatial frame — the network-internal analogue of
        the ``EnvConfig.obs_planes`` observation variant.
    """

    cfg: EnvConfig
    num_pieces: int
    channels: Tuple[int, ...] = (32, 64)
    hidden: int = 256
    embed_dim: int = 16
    arch: str = "conv"
    mlp_width: int = 512
    queue_mode: str = "embed"

    def __post_init__(self):
        if self.arch not in ("conv", "mlp"):
            raise ValueError(f"unknown torso arch {self.arch!r}")
        if self.queue_mode not in ("embed", "planes"):
            raise ValueError(f"unknown queue_mode {self.queue_mode!r}")

    def init(self, key: jax.Array) -> Params:
        cfg = self.cfg
        hw, s = cfg.num_cells, cfg.queue_size
        planes = s if self.queue_mode == "planes" else 0
        keys = iter(jax.random.split(key, len(self.channels) + 3))
        p: Params = {}
        if self.arch == "mlp":
            p["mlp_0"] = _dense_params(
                next(keys), hw * (1 + planes), self.mlp_width, _he_normal
            )
            feat = self.mlp_width
        else:
            cin = 1 + planes
            for i, ch in enumerate(self.channels):
                p[f"Conv_{i}"] = {
                    "kernel": _he_normal(
                        next(keys), (3, 3, cin, ch), jnp.float32
                    ),
                    "bias": jnp.zeros((ch,), jnp.float32),
                }
                cin = ch
            feat = hw * cin
        if self.queue_mode == "embed":
            # empty sentinel gets its own embedding row (num_pieces + 1)
            p["Embed_0"] = {
                "embedding": _embed_init(
                    next(keys), (self.num_pieces + 1, self.embed_dim),
                    jnp.float32,
                )
            }
            feat += s * self.embed_dim
        p["hidden_proj"] = _dense_params(
            next(keys), feat, self.hidden, _he_normal
        )
        return p

    def __call__(
        self, p: Params, board: jax.Array, queue: jax.Array
    ) -> jax.Array:
        if self.queue_mode == "planes":
            # (P, H*W) host constant; one-hot of the empty sentinel is the
            # zero vector, so empty slots become all-zero planes
            table = jnp.asarray(
                rules.piece_plane_table(self.cfg), dtype=jnp.bfloat16
            )
            onehot = (
                queue[..., None]
                == jnp.arange(self.num_pieces, dtype=queue.dtype)
            ).astype(jnp.bfloat16)                      # (..., S, P)
            planes = jax.lax.dot_general(
                onehot, table,
                (((onehot.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.bfloat16,
            )                                           # (..., S, H*W)

        h, w = self.cfg.height, self.cfg.width
        if self.arch == "mlp":
            x = board.astype(jnp.bfloat16).reshape(*board.shape[:-2], -1)
            if self.queue_mode == "planes":
                flat_planes = planes.reshape(*planes.shape[:-2], -1)
                x = jnp.concatenate([x, flat_planes], axis=-1)
            x = jax.nn.relu(_dense_bf16(p["mlp_0"], x))
        else:
            # board (..., H, W) uint8 -> (..., H, W, 1) bf16
            x = board.astype(jnp.bfloat16)[..., None]
            if self.queue_mode == "planes":
                # (..., S, H*W) -> (..., H, W, S) input channels
                s = planes.shape[-2]
                chan = jnp.moveaxis(
                    planes.reshape(*planes.shape[:-2], s, h, w), -3, -1
                )
                x = jnp.concatenate([x, chan], axis=-1)
            for i in range(len(self.channels)):
                x = jax.nn.relu(_conv_bf16(p[f"Conv_{i}"], x))
            x = x.reshape(*x.shape[:-3], -1)

        if self.queue_mode == "embed":
            # queue (..., S) int32 -> (..., S * embed_dim)
            table = p["Embed_0"]["embedding"].astype(jnp.bfloat16)
            emb = jnp.take(table, queue, axis=0)
            emb = emb.reshape(*emb.shape[:-2], -1)
            x = jnp.concatenate([x, emb], axis=-1)
        return jax.nn.relu(_dense_bf16(p["hidden_proj"], x))


def _torso(net) -> Torso:
    return Torso(
        net.cfg, net.num_pieces, net.channels, net.hidden,
        arch=net.arch, mlp_width=net.mlp_width, queue_mode=net.queue_mode,
    )


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Masked-policy + value network (PPO / A2C / eval).

    Params: ``{"params": {"Torso_0": ..., "Head_0": policy, "Head_1":
    value}}``; ``apply`` takes the observation as (board, queue,
    action_mask).
    """

    cfg: EnvConfig
    num_pieces: int
    channels: Tuple[int, ...] = (32, 64)
    hidden: int = 256
    arch: str = "conv"
    mlp_width: int = 512
    queue_mode: str = "embed"

    def init(self, key: jax.Array) -> Params:
        k_torso, k_pi, k_v = jax.random.split(key, 3)
        return {"params": {
            "Torso_0": _torso(self).init(k_torso),
            "Head_0": _dense_params(
                k_pi, self.hidden, self.cfg.num_actions(), _lecun_normal
            ),
            "Head_1": _dense_params(k_v, self.hidden, 1, _lecun_normal),
        }}

    def apply(
        self, params: Params, board: jax.Array, queue: jax.Array,
        action_mask: jax.Array,
    ) -> Tuple[jax.Array, jax.Array]:
        """Returns (masked_logits (..., A) f32, value (...,) f32)."""
        p = params["params"]
        h = _torso(self)(p["Torso_0"], board, queue)
        logits = _dense_f32_out(p["Head_0"], h)
        logits = jnp.where(action_mask, logits, NEG_INF)
        value = _dense_f32_out(p["Head_1"], h)
        return logits, value[..., 0]


@dataclasses.dataclass(frozen=True)
class QNetwork:
    """Masked Q-network (DQN): illegal actions pinned to NEG_INF.

    ``dueling=True`` splits the head into state-value (``Head_0``) +
    advantage (``Head_1``) streams (Wang et al. 2016), with the advantage
    mean taken over LEGAL actions only — with masking, centering on illegal
    slots would let unused logits shift the legal Q-values.  Otherwise the
    single ``Head_0`` emits Q directly.
    """

    cfg: EnvConfig
    num_pieces: int
    channels: Tuple[int, ...] = (32, 64)
    hidden: int = 256
    arch: str = "conv"
    mlp_width: int = 512
    queue_mode: str = "embed"
    dueling: bool = False

    def init(self, key: jax.Array) -> Params:
        k_torso, k_0, k_1 = jax.random.split(key, 3)
        a = self.cfg.num_actions()
        p = {"Torso_0": _torso(self).init(k_torso)}
        if self.dueling:
            p["Head_0"] = _dense_params(k_0, self.hidden, 1, _lecun_normal)
            p["Head_1"] = _dense_params(k_1, self.hidden, a, _lecun_normal)
        else:
            p["Head_0"] = _dense_params(k_0, self.hidden, a, _lecun_normal)
        return {"params": p}

    def apply(
        self, params: Params, board: jax.Array, queue: jax.Array,
        action_mask: jax.Array,
    ) -> jax.Array:
        p = params["params"]
        h = _torso(self)(p["Torso_0"], board, queue)
        if self.dueling:
            v = _dense_f32_out(p["Head_0"], h)                   # (..., 1)
            adv = _dense_f32_out(p["Head_1"], h)
            legal = action_mask.astype(jnp.float32)
            n_legal = jnp.maximum(legal.sum(axis=-1, keepdims=True), 1.0)
            adv_mean = (adv * legal).sum(axis=-1, keepdims=True) / n_legal
            q = v + adv - adv_mean
        else:
            q = _dense_f32_out(p["Head_0"], h)
        return jnp.where(action_mask, q, NEG_INF)


def reroot_key(key: jax.Array, impl: str = "rbg") -> jax.Array:
    """Re-root a PRNG key under ``impl`` (shared by PPO/DQN init).

    ``rbg`` is the fast path for per-step sampling, but JAX documents its
    output as unstable across different shardings of the same computation;
    pass ``impl="threefry2x32"`` where sharded-vs-unsharded runs must agree
    bit-for-bit (e.g. the multi-device equivalence check).
    """
    return jax.jit(
        lambda k: jax.random.key(
            jax.random.bits(k, (), dtype=jnp.uint32), impl=impl
        )
    )(key)


def masked_categorical(key: jax.Array, logits: jax.Array) -> jax.Array:
    """Sample actions from masked logits."""
    return jax.random.categorical(key, logits, axis=-1)


def select_along_last(values: jax.Array, index: jax.Array) -> jax.Array:
    """``values[..., index]`` as a one-hot select instead of a gather.

    The hot-path rule (CLAUDE.md) keeps per-env lookups gather-free; the
    one-hot select fuses into the surrounding elementwise work.
    """
    iota = jax.lax.broadcasted_iota(
        index.dtype, values.shape, len(values.shape) - 1
    )
    return jnp.sum(
        jnp.where(iota == index[..., None], values, 0.0), axis=-1
    )


def log_prob(logits: jax.Array, action: jax.Array) -> jax.Array:
    logp = jax.nn.log_softmax(logits, axis=-1)
    return select_along_last(logp, action)


def masked_entropy(logits: jax.Array) -> jax.Array:
    """Entropy of the masked distribution; NEG_INF slots contribute 0."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    p = jnp.exp(logp)
    return -jnp.sum(jnp.where(p > 0, p * logp, 0.0), axis=-1)
