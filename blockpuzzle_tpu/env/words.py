"""Packed legal-words mask + rank-select uniform sampler (serving path).

A serving consumer that accepts the legal mask
as PACKED u32 row words — bit ``c`` of word ``s*H + r`` = action
``(s*H + r)*W + c`` is legal — can sample uniform-legal actions with one
(N,) uniform draw + popcount rank-select over S*H words, instead of the
(N, A) u32 draw + argmax over A = S*H*W bool lanes that the bool-mask
representation forces.  Everything here is lanes-over-N vector ops: no
gathers (CLAUDE.md hot-path rule), no transcendentals.

These are PURE functions over a packed-state engine (``make_env()``
default); they compose outside ``step`` so the engine's compiled
programs (and the learner's update HLO) are untouched.  Bit-parity with
the engine's bool mask and exact sampler uniformity are pinned in
``tests/test_bench_words.py``; ``BP_BENCH_SAMPLER=words python bench.py``
times it against the bool-mask sampler.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def rank_select_bit(word: jax.Array, j: jax.Array) -> jax.Array:
    """Bit index of the j-th (0-based) set bit of u32 ``word``.

    5-step binary search on prefix popcounts; callers guarantee
    ``j < popcount(word)``.  Pure vector ops, shapes broadcast."""
    pos = jnp.zeros_like(j)
    rem = j
    for width in (16, 8, 4, 2, 1):
        lowmask = jnp.uint32((1 << width) - 1) << pos.astype(jnp.uint32)
        c = jax.lax.population_count(word & lowmask).astype(jnp.int32)
        go_high = rem >= c
        rem = jnp.where(go_high, rem - c, rem)
        pos = pos + jnp.where(go_high, width, 0)
    return pos


def sample_uniform_legal(
    words: jax.Array, key: jax.Array, width: int
) -> jax.Array:
    """Uniform-legal flat action id from (N, S*H) u32 legal row words.

    ``a = word_index * W + bit`` — matches the engine's flat
    (slot, row, col) action layout.  One (N,) uniform draw; popcount
    cumsum over the tiny static S*H axis; one-hot select (no gather).
    Uniform up to the f32 draw's ~2^-24 quantization (relative bias
    ~total/2^24 — negligible but not exact; base bench sampler's argmax
    tie odds are the analogous ~2^-32).  Envs with an empty mask (cannot
    occur under fused auto-reset, whose post-reset mask is the
    empty-board mask; CAN occur on frozen ``auto_reset=False`` terminal
    states) return action 0."""
    n, sh = words.shape
    cnt = jax.lax.population_count(words).astype(jnp.int32)    # (N, SH)
    csum = jnp.cumsum(cnt, axis=1)                             # (N, SH)
    total = csum[:, -1]                                        # (N,)
    u = jax.random.uniform(key, (n,))
    r = jnp.minimum(
        (u * total.astype(jnp.float32)).astype(jnp.int32),
        jnp.maximum(total - 1, 0),
    )
    gt = csum > r[:, None]
    widx = jnp.sum(jnp.logical_not(gt).astype(jnp.int32), axis=1)
    onehot = widx[:, None] == jnp.arange(sh, dtype=jnp.int32)[None, :]
    word = jnp.sum(jnp.where(onehot, words, jnp.uint32(0)), axis=1)
    prev = jnp.sum(jnp.where(onehot, csum - cnt, 0), axis=1)
    bit = rank_select_bit(word, r - prev)
    # empty mask: widx lands one past the last word (gt all-False) and
    # the select yields word 0 / bit 31 -> an OUT-OF-RANGE id; pin the
    # documented action 0 instead
    return jnp.where(total > 0, widx * width + bit, 0)


def legal_words(env, board_words: jax.Array, queue: jax.Array) -> jax.Array:
    """(N, S*H) u32 packed legal mask from a packed-engine board.

    The engine's shared per-slot bitboard legality
    (core.VecBlockPuzzle._bitboard_legal_slots — the same traced ops as
    the bool mask path) with the bool expansion replaced by a pow2 pack
    over columns.  ``env`` must be a packed-state engine
    (``env.state_impl == "packed"``); ``board_words`` is its native
    (N, H) u32 board."""
    if env.state_impl != "packed":
        raise ValueError("legal_words needs a packed-state engine")
    # the engine's own column packing weights (core.py builds them with
    # its bitboard tables) — one definition of the packed-word layout
    pow2 = jnp.asarray(env._bb_pow2)
    outs = []
    for legal3, pid_ok in env._bitboard_legal_slots(board_words, queue):
        legal = legal3 & pid_ok[:, None, None]
        outs.append(
            jnp.sum(legal.astype(jnp.uint32) * pow2[None, None, :], axis=2)
        )
    return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]


def pack_bool_mask(
    mask: jax.Array, height: int, width: int, queue_size: int
) -> jax.Array:
    """(N, S*H*W) bool -> (N, S*H) u32 row words (pow2 weighted sum)."""
    n = mask.shape[0]
    pow2 = jnp.asarray(np.uint32(1) << np.arange(width, dtype=np.uint32))
    m3 = mask.reshape(n, queue_size * height, width)
    return jnp.sum(m3.astype(jnp.uint32) * pow2[None, None, :], axis=2)
