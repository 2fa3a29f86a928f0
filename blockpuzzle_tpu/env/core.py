"""Batched BlockPuzzle engine: pure jit/vmap-able init/reset/step.

This replaces the reference's per-step Python dispatch (SURVEY.md §3.2) with a
single XLA program stepping N envs in lockstep (§3.3):

  * The default state is PACKED: each board row is a u32 word, so the hand's
    legality mask for every anchor is a few AND/OR word taps per slot
    (``_bitboard_legal_slots``), placement is an OR of footprint words and
    the clear scan is word compares plus an AND-reduce.  The whole step is
    integer elementwise work that XLA fuses.
  * ``mask_impl="matmul"`` keeps the all-pieces formulation — one product
    ``board(N,HW) @ cover_T(HW, P*HW)`` whose outputs are occupied-cell
    counts under every candidate footprint (exact in bf16: counts ≤ 9) —
    and ``"shift"`` a per-slot cross-correlation; both on the u8 layout,
    both bit-equal to the bitboard mask (tested).
  * The chosen action's legality is NOT recomputed via the big matmul: its
    footprint (<=2 rectangles) is tested against the board directly.
  * Clear-scan, reward, dealing, auto-reset, and obs packing are fused
    elementwise ops in the same program; XLA fuses them into the step kernel.
  * Dealing uses counter-based RNG: ``fold_in(base_key, rng_counter)`` per
    env per step — checkpoint/resume and auto-reset stay bit-exact.
  * Parity mode injects the oracle's dealt-piece stream (``deal_override``)
    so trajectories match Python-MT19937 dealing bit-for-bit without
    reimplementing MT19937 on the device (SURVEY.md §7.1 PR2).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from blockpuzzle_tpu import rules
from blockpuzzle_tpu.config import EnvConfig
from blockpuzzle_tpu.env.state import EnvState, TimeStep


class VecBlockPuzzle:
    """Vectorized BlockPuzzle over a batched board tensor.

    The production default board layout is PACKED: (N, H) u32 row words
    (state_impl="packed").  state_impl="u8" keeps the (N, H*W) uint8 cell
    layout (older checkpoints, mask-impl comparisons).

    All methods are pure functions of their inputs; the instance only holds
    static configuration and constant tables (baked into jitted programs).
    Instances are hashable by identity, so bound methods can be jitted.
    """

    def __init__(
        self,
        cfg: EnvConfig,
        rng_impl: str = "rbg",
        mask_dtype: str = "bf16",
        mask_impl: Optional[str] = None,
        state_impl: Optional[str] = None,
    ) -> None:
        """Args:
          cfg: static game configuration.
          rng_impl: PRNG implementation for piece dealing on the fast path
            ("rbg", the default, or "threefry2x32"; parity mode injects the
            oracle's deals and never touches this).
          mask_dtype: operand dtype of the legality-counts matmul
            (mask_impl="matmul" only): "bf16" or "int8" (s8×s8→s32; exact,
            counts ≤ 9).  Both are bit-identical in outcome; selectable for
            benchmarking.
          mask_impl: how the per-hand action mask is computed.  Default
            (None) resolves to "bitboard" for boards whose rows fit a u32
            word (width <= 32, every shipped preset), else "shift".
            "shift": cross-correlate the board with the hand's
            ONE-HOT-SELECTED piece kernel — a static loop over the piece
            bbox taps (only offsets some piece occupies; 13 of 25 for
            classic19) of shifted multiply-adds on a ones-padded board
            (padding makes out-of-bounds anchors occupied ⇒ illegal
            automatically).  ~P× less compute and memory traffic than
            "matmul"; bit-equal (tested).
            "matmul": all-pieces counts matmul + one-hot selection — the
            (N, P·HW) intermediate costs ~2·P·HW bytes/env of memory
            traffic.  Kept selectable for benchmarking.
            "bitboard": board rows packed into u32 words with 32//W
            row-fields per word; legality is ceil(max_h/(32//W)) AND+OR
            word taps per anchor (2 for classic19 at W=10) instead of 13
            bf16 multiply-add taps.  Bit-equal (tested); width <= 32 only.
          state_impl: EnvState.board layout.  Default (None) resolves to
            "packed" ((N, H) u32 row words end-to-end) when rows fit a u32
            word and no non-bitboard mask_impl was requested; "u8"
            ((N, H*W) cells) otherwise and for explicit opt-out (e.g.
            resuming u8-layout checkpoints).
        """
        if mask_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown mask_dtype {mask_dtype!r}")
        if state_impl is None:
            # packed state is the production default wherever it applies:
            # rows fit a u32 word and no explicit request for a different
            # mask formulation (mask comparisons need the u8 layout).
            # u8-layout checkpoints: cli.train auto-matches on --resume via
            # run_meta, or pass state_impl="u8" explicitly.
            state_impl = (
                "packed"
                if (cfg.width <= 32 and mask_impl in (None, "bitboard"))
                else "u8"
            )
        if state_impl not in ("u8", "packed"):
            raise ValueError(f"unknown state_impl {state_impl!r}")
        if state_impl == "packed":
            # packed state keeps EnvState.board as (N, H) u32 row words
            # end-to-end: no per-step packing, word-level footprint /
            # collision / clear.  It subsumes the mask question (the mask
            # IS the bitboard formulation).
            if cfg.width > 32:
                raise ValueError("state_impl='packed' needs width <= 32")
            if mask_impl not in (None, "bitboard"):
                raise ValueError(
                    "state_impl='packed' implies mask_impl='bitboard'; got "
                    f"{mask_impl!r}"
                )
            mask_impl = "bitboard"
        if mask_impl is None:
            # u8 state: the bitboard mask does the least work per anchor
            mask_impl = "bitboard" if cfg.width <= 32 else "shift"
        if mask_impl not in ("matmul", "shift", "bitboard"):
            raise ValueError(f"unknown mask_impl {mask_impl!r}")
        if mask_impl == "bitboard" and cfg.width > 32:
            raise ValueError("mask_impl='bitboard' needs width <= 32")
        self.state_impl = state_impl
        self._packed = state_impl == "packed"
        self.cfg = cfg
        self.rng_impl = rng_impl
        self.mask_dtype = mask_dtype
        self.mask_impl = mask_impl
        t = rules.tables_for(cfg)
        self.tables = t
        self.num_pieces = t.num_pieces
        self.empty_id = t.num_pieces
        self.num_actions = cfg.num_actions()

        # Constant tables, kept as HOST numpy arrays (become jit-time
        # constants via closure).  Host-resident deliberately: jit lowering
        # embeds numpy constants into the program with zero device IO,
        # whereas device-resident (jnp) constants must be copied BACK to
        # host during lowering (_array_mlir_constant_handler).
        #
        # GATHER-FREE HOT PATH (CLAUDE.md invariant, chosen on the previous
        # accelerator, where row gathers dominated the profiled step; its
        # cost on the GPU is not measured yet): every per-env table lookup
        # is a one-hot matmul, a static slice loop, or arithmetic on
        # broadcasted indices:
        #   * piece attrs (h, w, cells, rect decomposition) <- one-hot @ attrs
        #   * footprint of the chosen action <- union of <=2 rectangles
        #     materialized from row/col index compares (rules.decompose_rects)
        #   * per-hand action mask <- static P-slice select over the counts
        #     matmul output (bf16 end to end, no f32 round trip)
        #   * empty-board mask (auto-reset) <- one-hot @ valid-anchor table
        self._cover_t_bf16 = np.asarray(t.cover.T, dtype=jnp.bfloat16)   # (HW, P*HW)
        self._cover_t_i8 = np.asarray(t.cover.T, dtype=np.int8)          # (HW, P*HW)
        self._valid = np.asarray(t.valid)                                # (P*HW,)
        # attrs rows: [h, w, cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]
        attrs = np.concatenate(
            [
                t.piece_h[:, None],
                t.piece_w[:, None],
                t.piece_cells[:, None],
                t.piece_rects,
            ],
            axis=1,
        ).astype(np.float32)
        self._attrs = np.asarray(attrs, dtype=jnp.bfloat16)              # (P, 11)
        # counts adjustment: +1024 on out-of-bounds anchors so the fused
        # "counts_adj == 0" test encodes legality AND validity (1024 and
        # all counts <= 9 are exact in bf16)
        self._counts_adj = np.asarray(
            np.where(t.valid, 0.0, 1024.0)[None, :], dtype=jnp.bfloat16
        )                                                                # (1, P*HW)
        self._counts_adj_i32 = np.asarray(
            np.where(t.valid, 0, 1024)[None, :], dtype=np.int32
        )
        # Legal anchors on an EMPTY board, per piece (bf16 for the one-hot
        # matmul selection used by auto-reset / init).
        self._empty_legal = np.asarray(
            t.valid.reshape(t.num_pieces, cfg.num_cells)
        )                                                                # (P, HW)
        self._empty_legal_bf16 = self._empty_legal.astype(jnp.bfloat16)
        # flat cell index -> (row, col), as (1, HW) constants
        cells = np.arange(cfg.num_cells, dtype=np.int32)
        self._row_idx = np.asarray((cells // cfg.width)[None, :])        # (1, HW)
        self._col_idx = np.asarray((cells % cfg.width)[None, :])         # (1, HW)
        self._piece_iota = np.arange(t.num_pieces, dtype=np.int32)       # (P,)
        # clear-scan line tables: rows + cols (+ regions) in ONE stack, so
        # full-line detection is two tiny matmuls on flat boards (no
        # (N, H, W) reshape relayouts in the hot loop)
        line_parts = [t.row_masks, t.col_masks]
        if cfg.region_clear:
            line_parts.append(t.region_masks)
        line_masks = np.concatenate(line_parts, axis=0)       # (L, HW)
        self._line_masks_bf16 = np.asarray(line_masks, dtype=jnp.bfloat16)
        self._line_masks_t_bf16 = np.asarray(
            line_masks.T, dtype=jnp.bfloat16
        )
        self._line_sizes = np.asarray(
            line_masks.sum(axis=1)[None, :], dtype=np.float32
        )                                                      # (1, L)
        # piece-plane obs mode (cfg.obs_planes): slot plane = one-hot @ table
        self._plane_table_bf16 = np.asarray(
            rules.piece_plane_table(cfg), dtype=jnp.bfloat16
        )                                                      # (P, HW)
        # shift mask impl: padded piece kernels (P, max_h*max_w) + the list
        # of taps some piece actually occupies (static; 13/25 for classic19)
        self._piece_kernel_bf16 = np.asarray(
            t.pieces.reshape(t.num_pieces, -1), dtype=jnp.bfloat16
        )
        self._kernel_taps = [
            (dr, dc)
            for dr in range(t.max_h)
            for dc in range(t.max_w)
            if t.pieces[:, dr, dc].any()
        ]
        # bitboard mask impl: board rows pack into u32 words, 32//W row-FIELDS per word, so the
        # whole piece footprint tests in ceil(max_h / fields) AND+OR taps
        # (2 for classic19 at W=10) instead of `len(kernel_taps)` (13)
        # bf16 multiply-add taps.  Tables are host numpy (jit constants).
        if cfg.width <= 32:
            w = cfg.width
            fpw = max(1, 32 // w)                 # row fields per u32 word
            nwords = -(-t.max_h // fpw)           # words per piece footprint
            self._bb_fpw, self._bb_nwords = fpw, nwords
            # per-piece packed footprint words: word k holds piece rows
            # k*fpw .. k*fpw+fpw-1, each as a W-bit field
            prow = (
                t.pieces.astype(np.uint64)
                * (1 << np.arange(t.max_w, dtype=np.uint64))
            ).sum(axis=2)                         # (P, max_h) row bitmasks
            packed = np.zeros((t.num_pieces, nwords), dtype=np.uint64)
            for i in range(t.max_h):
                packed[:, i // fpw] |= prow[:, i] << np.uint64((i % fpw) * w)
            self._bb_prow = packed.astype(np.uint32)          # (P, K)
            # per-anchor-column spill mask: a piece bit shifted past its
            # field's top lands in the LOW c bits of the next field (orig
            # bit b, shift c, b+c>W-1 -> position (j+1)W + (b+c-W), and
            # b+c-W <= c-1) — keeping only bits >= c of every field removes
            # exactly the spill and nothing legit
            field = np.uint64((1 << w) - 1)
            cmask = np.zeros(w, dtype=np.uint64)
            for c in range(w):
                keep = field & ~np.uint64((1 << c) - 1)
                for j in range(fpw):
                    cmask[c] |= keep << np.uint64(j * w)
            self._bb_cmask = cmask.astype(np.uint32)          # (W,)
            self._bb_pow2 = (1 << np.arange(w, dtype=np.uint32))  # (W,)
            self._bb_c_iota = np.arange(w, dtype=np.uint32)
            self._bb_piece_w = np.asarray(t.piece_w, dtype=np.int32)  # (P,)

    # ------------------------------------------------------------------
    # RNG: counter-based deals
    # ------------------------------------------------------------------

    def _deal_batch(self, base_key: jax.Array, counter: jax.Array, tag: int) -> jax.Array:
        """(N, S) uniform piece ids from per-env counter-folded keys.

        tag separates draw purposes (0 = refill, 1 = auto-reset redeal) so
        they never alias for the same counter value.
        """

        def one(key, ctr):
            k = jax.random.fold_in(jax.random.fold_in(key, ctr), tag)
            return jax.random.randint(
                k, (self.cfg.queue_size,), 0, self.num_pieces, dtype=jnp.int32
            )

        return jax.vmap(one)(base_key, counter)

    def _deal_batch2(
        self, base_key: jax.Array, counter: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """Refill + auto-reset deals from ONE draw per env per step
        ((N, 2S) randint instead of two tagged fold_in chains — halves the
        per-step PRNG work on the fast path)."""
        s = self.cfg.queue_size

        def one(key, ctr):
            k = jax.random.fold_in(key, ctr)
            return jax.random.randint(
                k, (2 * s,), 0, self.num_pieces, dtype=jnp.int32
            )

        v = jax.vmap(one)(base_key, counter)
        return v[:, :s], v[:, s:]

    # ------------------------------------------------------------------
    # Masking
    # ------------------------------------------------------------------

    def legal_all_pieces(self, board: jax.Array) -> jax.Array:
        """(N, P, HW) bool: legality of every piece at every anchor.

        One bf16 matmul: counts of occupied cells under each footprint.
        Accepts the engine's native board layout (packed engines unpack
        first — this is an inspection/test surface, not the hot path).
        """
        if self._packed:
            board = self._unpack_board(board).reshape(
                board.shape[0], self.cfg.num_cells
            )
        counts = jnp.dot(
            board.astype(jnp.bfloat16),
            self._cover_t_bf16,
            preferred_element_type=jnp.float32,
        )  # (N, P*HW)
        legal = jnp.logical_and(counts == 0, self._valid[None, :])
        n = board.shape[0]
        return legal.reshape(n, self.num_pieces, self.cfg.num_cells)

    def _piece_onehot(self, pid: jax.Array) -> jax.Array:
        """(N, P) bf16 one-hot of piece ids (all-zero for the empty sentinel)."""
        return (pid[:, None] == self._piece_iota[None, :]).astype(jnp.bfloat16)

    def action_mask(self, board: jax.Array, queue: jax.Array) -> jax.Array:
        """(N, S*HW) bool legal-action mask for the current hand.

        Dispatches on ``mask_impl`` (bitboard on packed state).  The
        "matmul" form is one bf16 matmul (counts of occupied cells under
        every footprint, out-of-bounds anchors pre-biased by +1024)
        followed by a gather-free static-slice one-hot selection of each
        hand slot's piece row.
        """
        if self._packed:
            # packed engine: ``board`` IS the (N, H) u32 word layout
            return self._bitboard_mask_from_words(board, queue)
        if self.mask_impl == "shift":
            return self._action_mask_shift(board, queue)
        if self.mask_impl == "bitboard":
            return self._action_mask_bitboard(board, queue)
        # compare BEFORE selection so the == 0 fuses into the matmul
        # epilogue and the all-pieces intermediate is bool (half the HBM
        # traffic of bf16 counts)
        if self.mask_dtype == "int8":
            legal_all = (
                jnp.dot(
                    board.astype(jnp.int8),
                    self._cover_t_i8,
                    preferred_element_type=jnp.int32,
                )
                + self._counts_adj_i32
            ) == 0
        else:
            legal_all = (
                jnp.dot(
                    board.astype(jnp.bfloat16),
                    self._cover_t_bf16,
                    preferred_element_type=jnp.bfloat16,
                )
                + self._counts_adj
            ) == 0  # (N, P*HW) bool; legal AND in bounds
        return self._mask_from_counts(legal_all, queue)

    def _action_mask_shift(
        self, board: jax.Array, queue: jax.Array
    ) -> jax.Array:
        """Gather-free hand mask WITHOUT the (N, P·HW) intermediate.

        Anchor (r, c) is legal for the slot's piece iff the piece's cells
        all land on empty in-bounds board cells — i.e. the cross-correlation
        of the board with the piece kernel is zero at (r, c).  The kernel is
        the ONE-HOT-SELECTED piece (tiny matmul, no gather); the board
        is padded with ONES on the bottom/right so any out-of-bounds cell
        reads as occupied (out-of-bounds anchors auto-fail, replacing the
        matmul path's +1024 bias).  Counts ≤ 9 + taps are bf16-exact, so the
        result is BIT-equal to the matmul path (tested).
        """
        cfg = self.cfg
        t = self.tables
        n = board.shape[0]
        b3 = board.reshape(n, cfg.height, cfg.width)
        padded = jnp.pad(
            b3,
            ((0, 0), (0, t.max_h - 1), (0, t.max_w - 1)),
            constant_values=1,
        ).astype(jnp.bfloat16)
        masks = []
        for s in range(cfg.queue_size):
            pid_s = queue[:, s]
            oh = self._piece_onehot(pid_s)                        # (N, P)
            kern = jnp.dot(
                oh, self._piece_kernel_bf16,
                preferred_element_type=jnp.bfloat16,
            )                                                     # (N, mh*mw)
            acc = jnp.zeros((n, cfg.height, cfg.width), jnp.bfloat16)
            for dr, dc in self._kernel_taps:
                acc = acc + (
                    kern[:, dr * t.max_w + dc, None, None]
                    * padded[:, dr : dr + cfg.height, dc : dc + cfg.width]
                )
            m = jnp.logical_and(
                (acc == 0).reshape(n, cfg.num_cells),
                (pid_s < self.num_pieces)[:, None],
            )
            masks.append(m)
        return jnp.concatenate(masks, axis=1) if len(masks) > 1 else masks[0]

    def _action_mask_bitboard(
        self, board: jax.Array, queue: jax.Array
    ) -> jax.Array:
        """Packed-u32 hand mask.

        Board rows pack into u32 words with ``fpw = 32 // W`` row-fields per
        word; the slot's piece packs the same way (host-constant table, one
        static P-way select — the 30-bit words exceed f32's 24-bit mantissa,
        so no one-hot matmul).  Anchor (r, c) is legal iff for every word k

            words_k(r)  &  ((prow_k << c) & cmask[c])  ==  0

        where words_k(r) ORs the board rows r+k·fpw.. as fields (rows past
        the bottom read as ALL-ONES fields, so row-overflow anchors fail
        automatically), and cmask[c] strips the cross-field spill of the
        left shift (see __init__).  Column overflow cannot be caught by the
        AND (its bits are exactly the stripped spill), so it is an explicit
        ``c + piece_w <= W`` test.  Bit-equal to the shift/matmul impls
        (tested); K = ceil(max_h/fpw) = 2 AND+OR taps for classic19 at
        W=10 vs the shift impl's 13 multiply-add taps.
        """
        return self._bitboard_mask_from_words(self._pack_board(board), queue)

    def _pack_board(self, board: jax.Array) -> jax.Array:
        """(N, HW) u8 -> (N, H) u32 row words (bit w of word r = cell (r,w))."""
        cfg = self.cfg
        n = board.shape[0]
        b3 = board.reshape(n, cfg.height, cfg.width)
        return jnp.sum(
            b3.astype(jnp.uint32) * self._bb_pow2[None, None, :], axis=2
        )

    def _unpack_board(self, words: jax.Array) -> jax.Array:
        """(N, H) u32 row words -> (N, H, W) u8 cells."""
        bits = (
            words[:, :, None] >> self._bb_c_iota[None, None, :]
        ) & jnp.uint32(1)
        return bits.astype(jnp.uint8)

    def _bitboard_legal_slots(self, words: jax.Array, queue: jax.Array):
        """Per-slot bitboard legality — the shared core of the bool mask
        and the packed legal-words producer (env/words.py): yields
        ``(legal3, pid_ok)`` per hand slot, where ``legal3`` is the
        (N, H, W) bool in-bounds/no-overlap test WITHOUT the hand-slot
        sentinel guard and ``pid_ok`` is that (N,) guard.  Consumers
        combine/reshape/pack as their output layout needs."""
        cfg = self.cfg
        t = self.tables
        n = words.shape[0]
        h, w = cfg.height, cfg.width
        fpw, nwords = self._bb_fpw, self._bb_nwords
        pad = jnp.full(
            (n, t.max_h - 1), np.uint32((1 << w) - 1), dtype=jnp.uint32
        )
        padded = jnp.concatenate([words, pad], axis=1)        # (N, H+max_h-1)
        # board words per anchor row, shared across hand slots
        wks = []
        for k in range(nwords):
            wk = jnp.zeros((n, h), jnp.uint32)
            for j in range(fpw):
                i = k * fpw + j
                if i >= t.max_h:
                    break
                wk = wk | (padded[:, i : i + h] << np.uint32(j * w))
            wks.append(wk)
        out = []
        for s in range(cfg.queue_size):
            pid_s = queue[:, s]
            onehot_b = pid_s[:, None] == self._piece_iota[None, :]  # (N, P)
            prow = jnp.sum(
                jnp.where(
                    onehot_b[:, :, None], self._bb_prow[None], jnp.uint32(0)
                ),
                axis=1,
            )                                                 # (N, K)
            pw = jnp.sum(
                jnp.where(onehot_b, self._bb_piece_w[None], 0), axis=1
            )                                                 # (N,)
            acc = jnp.zeros((n, h, w), jnp.uint32)
            for k in range(nwords):
                shifted = (
                    prow[:, k : k + 1] << self._bb_c_iota[None, :]
                ) & self._bb_cmask[None, :]                   # (N, W)
                acc = acc | (wks[k][:, :, None] & shifted[:, None, :])
            ok_col = (
                self._bb_c_iota.astype(jnp.int32)[None, :] + pw[:, None] <= w
            )                                                 # (N, W)
            legal3 = jnp.logical_and(acc == 0, ok_col[:, None, :])
            out.append((legal3, pid_s < self.num_pieces))
        return out

    def _bitboard_mask_from_words(
        self, words: jax.Array, queue: jax.Array
    ) -> jax.Array:
        """Hand mask from pre-packed (N, H) u32 row words (see
        _action_mask_bitboard for the algorithm)."""
        cfg = self.cfg
        n = words.shape[0]
        masks = []
        for legal3, pid_ok in self._bitboard_legal_slots(words, queue):
            m = legal3.reshape(n, cfg.num_cells)
            m = jnp.logical_and(m, pid_ok[:, None])
            masks.append(m)
        return jnp.concatenate(masks, axis=1) if len(masks) > 1 else masks[0]

    def _mask_from_counts(
        self, legal_all: jax.Array, queue: jax.Array
    ) -> jax.Array:
        hw = self.cfg.num_cells
        masks = []
        for s in range(self.cfg.queue_size):
            pid_s = queue[:, s]
            oh = self._piece_onehot(pid_s)                            # (N, P)
            acc = jnp.zeros((legal_all.shape[0], hw), jnp.bfloat16)
            for p in range(self.num_pieces):
                acc = acc + (
                    legal_all[:, p * hw : (p + 1) * hw].astype(jnp.bfloat16)
                    * oh[:, p : p + 1]
                )
            m = jnp.logical_and(acc > 0.5, (pid_s < self.num_pieces)[:, None])
            masks.append(m)
        return jnp.concatenate(masks, axis=1) if len(masks) > 1 else masks[0]

    def _empty_board_mask(self, queue: jax.Array) -> jax.Array:
        """Action mask for a fresh (empty) board: one-hot @ in-bounds table
        (a tiny matmul; no gather)."""
        masks = []
        for s in range(self.cfg.queue_size):
            pid_s = queue[:, s]
            oh = self._piece_onehot(pid_s)
            acc = jnp.dot(
                oh, self._empty_legal_bf16, preferred_element_type=jnp.bfloat16
            )  # (N, HW)
            masks.append(
                jnp.logical_and(acc > 0.5, (pid_s < self.num_pieces)[:, None])
            )
        return jnp.concatenate(masks, axis=1) if len(masks) > 1 else masks[0]

    def piece_planes(self, queue: jax.Array) -> jax.Array:
        """(N, S, H, W) uint8 spatial rendering of the hand (obs_planes mode).

        One tiny matmul per slot (one-hot @ plane table) — no gather;
        empty slots come out all-zero (one-hot of the sentinel is zeros).
        """
        cfg = self.cfg
        n = queue.shape[0]
        planes = []
        for s in range(cfg.queue_size):
            oh = self._piece_onehot(queue[:, s])                  # (N, P)
            p = jnp.dot(
                oh, self._plane_table_bf16,
                preferred_element_type=jnp.bfloat16,
            )                                                     # (N, HW)
            planes.append((p > 0.5).astype(jnp.uint8))
        stacked = jnp.stack(planes, axis=1)                       # (N, S, HW)
        return stacked.reshape(n, cfg.queue_size, cfg.height, cfg.width)

    def _maybe_planes(self, queue: jax.Array):
        return self.piece_planes(queue) if self.cfg.obs_planes else None

    # ------------------------------------------------------------------
    # Clear scan
    # ------------------------------------------------------------------

    def clear_scan(self, board: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Simultaneous full-line(+region) clear.

        Args:
          board: (N, HW) uint8 post-placement board.
        Returns:
          (cleared_board (N, HW) uint8, k (N,) int32 lines+regions cleared).
        The full set is computed before any clearing (reference simultaneity
        semantics, SURVEY.md §2.1 "Line/region clear").
        """
        # line l (row/col/region) is full iff its occupancy count equals its
        # size; membership of cleared cells comes back via the transposed
        # mask product — two tiny matmuls on the FLAT board (counts are
        # bf16-exact: <= max(H, W, region²) cells)
        occ = jnp.dot(
            board.astype(jnp.bfloat16),
            self._line_masks_t_bf16,
            preferred_element_type=jnp.float32,
        )                                                     # (N, L)
        full = occ == self._line_sizes
        clear_cells = jnp.dot(
            full.astype(jnp.bfloat16),
            self._line_masks_bf16,
            preferred_element_type=jnp.float32,
        )                                                     # (N, HW)
        cleared = jnp.where(clear_cells > 0, jnp.uint8(0), board)
        k = full.sum(axis=1).astype(jnp.int32)
        return cleared, k

    # ------------------------------------------------------------------
    # Packed-state (u32 row words) step pieces
    # ------------------------------------------------------------------

    def board_obs(self, board: jax.Array) -> jax.Array:
        """Engine-layout-agnostic (N, H, W) u8 board view (for policies)."""
        if self._packed:
            return self._unpack_board(board)
        n = board.shape[0]
        return board.reshape(n, self.cfg.height, self.cfg.width)

    def encode_board(self, cells) -> jax.Array:
        """(N, H*W) or (N, H, W) 0/1 cells -> the engine's NATIVE board
        layout (u8 flat cells, or packed u32 row words).  The inverse of
        ``board_obs`` up to shape; for crafting states (tests, scenario
        tooling, VectorEnv reset options).

        Cells are clamped to occupancy (nonzero -> 1) in BOTH layouts: the
        packed pow2 weighted sum would otherwise let a stray value of 2
        silently set the NEIGHBORING bit (advisor r4), and the u8 path
        must stay bit-equal to the packed one for any input."""
        cells = jnp.asarray(cells)
        cells = (cells != 0).astype(jnp.uint8).reshape(
            -1, self.cfg.num_cells
        )
        if self._packed:
            return self._pack_board(cells)
        return cells

    def _cover_words(
        self, attrs: jax.Array, r: jax.Array, c: jax.Array
    ) -> jax.Array:
        """(N, H) u32 footprint words of the chosen action — the packed
        analogue of the <=2-rectangle index-compare materialization: each
        rect is a shifted (2^rw - 1) row mask selected onto its row range.
        Sentinel/invalid pieces have all-zero attrs -> all-zero cover."""
        n = attrs.shape[0]
        row_iota = jnp.arange(self.cfg.height, dtype=jnp.int32)[None, :]
        cover = jnp.zeros((n, self.cfg.height), jnp.uint32)
        for j in range(2):
            dr, dc = attrs[:, 3 + 4 * j, None], attrs[:, 4 + 4 * j, None]
            rh, rw = attrs[:, 5 + 4 * j, None], attrs[:, 6 + 4 * j, None]
            r0 = r[:, None] + dr
            c0 = (c[:, None] + dc).astype(jnp.uint32)
            rowmask = (
                (jnp.uint32(1) << rw.astype(jnp.uint32)) - jnp.uint32(1)
            ) << c0                                            # (N, 1)
            inrows = (row_iota >= r0) & (row_iota < r0 + rh)   # (N, H)
            cover = cover | jnp.where(inrows, rowmask, jnp.uint32(0))
        return cover

    def _clear_scan_packed(
        self, words: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """Simultaneous full-line(+region) clear on (N, H) u32 row words.

        Rows: word == (2^W - 1).  Columns: AND-reduce of all row words —
        set bits are full columns (counted via popcount).  Regions
        (region_size rs): AND each rs-row band, then test each aligned
        rs-bit group.  All full sets come from the PRE-clear board
        (reference simultaneity semantics), then clear in one AND-NOT.
        """
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        full_word = np.uint32((1 << w) - 1)
        full_row = words == full_word                          # (N, H)
        colbits = words[:, 0]
        for r in range(1, h):
            colbits = colbits & words[:, r]                    # (N,)
        k = full_row.sum(axis=1).astype(jnp.int32)
        k = k + jax.lax.population_count(colbits).astype(jnp.int32)
        clearbits = jnp.where(full_row, full_word, jnp.uint32(0)) | (
            colbits[:, None]
        )
        if cfg.region_clear:
            rs = cfg.region_size
            tile0 = np.uint32((1 << rs) - 1)
            reg_rows = []
            for a in range(h // rs):
                band = words[:, a * rs]
                for i in range(1, rs):
                    band = band & words[:, a * rs + i]         # (N,)
                regrow = jnp.zeros_like(band)
                for b in range(w // rs):
                    tile = np.uint32(tile0 << (b * rs))
                    fullt = (band & tile) == tile              # (N,)
                    regrow = regrow | jnp.where(
                        fullt, tile, jnp.uint32(0)
                    )
                    k = k + fullt.astype(jnp.int32)
                reg_rows.append(regrow[:, None])
            # expand each band mask over its rs rows (tiny (N, H) concat)
            clearbits = clearbits | jnp.concatenate(
                [jnp.broadcast_to(rr, (words.shape[0], rs))
                 for rr in reg_rows],
                axis=1,
            )
        cleared = words & ~clearbits
        return cleared, k

    # ------------------------------------------------------------------
    # init / reset
    # ------------------------------------------------------------------

    def init(
        self,
        key: jax.Array,
        num_envs: int,
        deal_override: Optional[jax.Array] = None,
    ) -> Tuple[EnvState, TimeStep]:
        """Fresh batched state + initial timestep.

        Args:
          key: single PRNG key; split into per-env stream roots.
          num_envs: N.
          deal_override: optional (N, S) int32 initial hand (parity mode —
            the oracle's reset deals).
        """
        cfg = self.cfg
        # re-root the key under the configured PRNG impl (deterministic in
        # the caller's key; works under jit)
        seed = jax.random.bits(key, (), dtype=jnp.uint32)
        key = jax.random.key(seed, impl=self.rng_impl)
        base_key = jax.random.split(key, num_envs)
        counter = jnp.zeros(num_envs, dtype=jnp.int32)
        if deal_override is None:
            queue = self._deal_batch(base_key, counter, tag=1)
        else:
            queue = jnp.asarray(deal_override, dtype=jnp.int32)
        if self._packed:
            board0 = jnp.zeros((num_envs, cfg.height), dtype=jnp.uint32)
        else:
            board0 = jnp.zeros((num_envs, cfg.num_cells), dtype=jnp.uint8)
        state = EnvState(
            board=board0,
            queue=queue,
            base_key=base_key,
            rng_counter=jnp.ones(num_envs, dtype=jnp.int32),
            steps=jnp.zeros(num_envs, dtype=jnp.int32),
            score=jnp.zeros(num_envs, dtype=jnp.float32),
            streak=jnp.zeros(num_envs, dtype=jnp.int32),
        )
        zeros_f = jnp.zeros(num_envs, dtype=jnp.float32)
        zeros_b = jnp.zeros(num_envs, dtype=bool)
        ts = TimeStep(
            board=self.board_obs(state.board),
            queue=state.queue,
            action_mask=self._empty_board_mask(queue),
            reward=zeros_f,
            terminated=zeros_b,
            truncated=zeros_b,
            info={
                "lines_cleared": jnp.zeros(num_envs, dtype=jnp.int32),
                "legal": zeros_b,
                "episode_return": zeros_f,
                "episode_length": jnp.zeros(num_envs, dtype=jnp.int32),
            },
            piece_planes=self._maybe_planes(queue),
        )
        return state, ts

    def reset(self, state: EnvState) -> Tuple[EnvState, TimeStep]:
        """Manual full reset of every env (auto-reset usually suffices)."""
        n = state.num_envs
        queue = self._deal_batch(state.base_key, state.rng_counter, tag=1)
        new = state.replace(
            board=jnp.zeros_like(state.board),
            queue=queue,
            rng_counter=state.rng_counter + 1,
            steps=jnp.zeros_like(state.steps),
            score=jnp.zeros_like(state.score),
            streak=jnp.zeros_like(state.streak),
        )
        zeros_f = jnp.zeros(n, dtype=jnp.float32)
        zeros_b = jnp.zeros(n, dtype=bool)
        ts = TimeStep(
            board=self.board_obs(new.board),
            queue=new.queue,
            action_mask=self._empty_board_mask(queue),
            reward=zeros_f,
            terminated=zeros_b,
            truncated=zeros_b,
            info={
                "lines_cleared": jnp.zeros(n, dtype=jnp.int32),
                "legal": zeros_b,
                "episode_return": zeros_f,
                "episode_length": jnp.zeros(n, dtype=jnp.int32),
            },
            piece_planes=self._maybe_planes(queue),
        )
        return new, ts

    def partial_reset(
        self, state: EnvState, reset_mask: jax.Array
    ) -> Tuple[EnvState, TimeStep]:
        """Re-initialize ONLY the envs flagged in ``reset_mask`` ((N,) bool).

        The batched analogue of gymnasium's ``AutoresetMode.DISABLED``
        contract (``reset(options={"reset_mask": ...})``): masked envs get
        the same KIND of re-initialization as the fused in-step auto-reset
        — board cleared, a fresh deal from the env's own ``(base_key,
        rng_counter)`` stream, steps/score/streak zeroed — while unmasked
        envs pass through bit-untouched.  The dealt hands are NOT the same
        pieces the fused path would have dealt at the same counter: this
        path draws from the tag-1 substream (``fold_in(fold_in(key, c),
        1)``) while the fast step path draws both its step deal and its
        reset deal from one double-width untagged draw (``_deal_batch2``).
        Both are deterministic and alias-free; they are just distinct
        substreams.  ``rng_counter`` advances for ALL envs (the monotone
        counter scheme, env/state.py): unmasked envs skip a draw rather
        than ever replaying one.
        """
        n = state.num_envs
        m = reset_mask.astype(bool)
        mcol = m[:, None]
        fresh_queue = self._deal_batch(state.base_key, state.rng_counter, tag=1)
        queue = jnp.where(mcol, fresh_queue, state.queue)
        new = state.replace(
            board=jnp.where(mcol, jnp.zeros_like(state.board), state.board),
            queue=queue,
            rng_counter=state.rng_counter + 1,
            steps=jnp.where(m, 0, state.steps),
            score=jnp.where(m, 0.0, state.score),
            streak=jnp.where(m, 0, state.streak),
        )
        zeros_b = jnp.zeros(n, dtype=bool)
        ts = TimeStep(
            board=self.board_obs(new.board),
            queue=queue,
            # full mask (unmasked envs keep occupied boards), not the
            # empty-board shortcut init/reset use
            action_mask=self.action_mask(new.board, queue),
            reward=jnp.zeros(n, dtype=jnp.float32),
            terminated=zeros_b,
            truncated=zeros_b,
            info={
                "lines_cleared": jnp.zeros(n, dtype=jnp.int32),
                "legal": zeros_b,
                # unmasked envs are mid-episode: report their live stats
                "episode_return": new.score,
                "episode_length": new.steps,
            },
            piece_planes=self._maybe_planes(queue),
        )
        return new, ts

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def step(
        self,
        state: EnvState,
        action: jax.Array,
        deal_override: Optional[jax.Array] = None,
        auto_reset: bool = True,
    ) -> Tuple[EnvState, TimeStep]:
        """One lockstep transition for all N envs (SURVEY.md §3.3).

        Args:
          state: current EnvState.
          action: (N,) int32 flat actions (slot * H*W + row * W + col).
          deal_override: optional (N, S) int32 dealt-piece STREAM for this
            step in deal order (parity mode); sentinel ``num_pieces`` where
            the oracle dealt nothing.
          auto_reset: re-initialize finished envs in the same pass (batch
            semantics; disable for single-episode parity replay).
        """
        cfg = self.cfg
        n = state.num_envs
        hw = cfg.num_cells
        action = action.astype(jnp.int32)

        # -- decode + arithmetic footprint (gather-free) ------------------
        # Out-of-range actions are illegal no-ops (the single-env oracle
        # raises; a batched SPMD program cannot, so reject-in-graph).
        in_range = jnp.logical_and(action >= 0, action < self.num_actions)
        action_c = jnp.clip(action, 0, self.num_actions - 1)
        slot = action_c // hw                                         # (N,)
        cell = action_c % hw
        slot_onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (n, cfg.queue_size), 1)
            == slot[:, None]
        )
        if cfg.queue_size == 1:
            pid = state.queue[:, 0]
        else:
            pid = jnp.sum(
                jnp.where(slot_onehot, state.queue, 0), axis=1
            )
        slot_filled = pid < self.num_pieces
        r = cell // cfg.width
        c = cell % cfg.width
        # piece attributes via one-hot matmul: (N,P) @ (P,11)
        oh = self._piece_onehot(pid)
        attrs = jnp.dot(
            oh, self._attrs, preferred_element_type=jnp.float32
        ).astype(jnp.int32)                                           # (N, 11)
        ph, pw, cells_placed = attrs[:, 0], attrs[:, 1], attrs[:, 2]
        valid_a = jnp.logical_and(
            jnp.logical_and(in_range, slot_filled),
            jnp.logical_and(r + ph <= cfg.height, c + pw <= cfg.width),
        )
        # footprint = union of <=2 rectangles, from broadcast index compares
        def in_rect(j):
            dr, dc = attrs[:, 3 + 4 * j, None], attrs[:, 4 + 4 * j, None]
            rh, rw = attrs[:, 5 + 4 * j, None], attrs[:, 6 + 4 * j, None]
            r0 = r[:, None] + dr
            c0 = c[:, None] + dc
            return (
                (self._row_idx >= r0)
                & (self._row_idx < r0 + rh)
                & (self._col_idx >= c0)
                & (self._col_idx < c0 + rw)
            )

        # -- collision check + masked place + clear ----------------------
        if self._packed:
            cover = self._cover_words(attrs, r, c)             # (N, H) u32
            overlap = jnp.any((state.board & cover) != 0, axis=1)
            legal = jnp.logical_and(valid_a, jnp.logical_not(overlap))
            placed = jnp.where(
                legal[:, None], state.board | cover, state.board
            )
            cleared, k = self._clear_scan_packed(placed)
            k = jnp.where(legal, k, 0)
            board_next = jnp.where(legal[:, None], cleared, state.board)
        else:
            cover_row = jnp.logical_or(
                in_rect(0), in_rect(1)
            ).astype(jnp.uint8)
            overlap = jnp.sum(
                (state.board & cover_row).astype(jnp.int32), axis=1
            )
            legal = jnp.logical_and(valid_a, overlap == 0)
            placed = jnp.where(
                legal[:, None], state.board | cover_row, state.board
            )
            cleared, k = self.clear_scan(placed)
            k = jnp.where(legal, k, 0)
            board_next = jnp.where(legal[:, None], cleared, state.board)

        # -- reward -------------------------------------------------------
        kf = k.astype(jnp.float32)
        bonus = cfg.line_base * kf * (kf + 1.0) * 0.5
        reward = jnp.where(
            legal,
            cfg.cell_reward * cells_placed.astype(jnp.float32) + bonus,
            jnp.float32(cfg.illegal_penalty),
        )
        # Woodoku-style streak (cfg.streak_bonus, static knob: zero cost
        # when disabled): consecutive clearing placements pay
        # streak_bonus * (streak - 1); a legal non-clearing placement
        # resets the streak; illegal no-ops leave it unchanged
        if cfg.streak_bonus:
            cleared_now = jnp.logical_and(legal, k > 0)
            streak_next = jnp.where(
                cleared_now,
                state.streak + 1,
                jnp.where(legal, 0, state.streak),
            )
            reward = jnp.where(
                cleared_now,
                reward
                + jnp.float32(cfg.streak_bonus)
                * (streak_next - 1).astype(jnp.float32),
                reward,
            )
        else:
            streak_next = state.streak

        # -- queue consume + refill --------------------------------------
        consumed = jnp.logical_and(slot_onehot, legal[:, None])
        queue2 = jnp.where(consumed, self.empty_id, state.queue)

        empty = queue2 == self.empty_id                               # (N, S)
        if cfg.refill_batch:
            trigger = jnp.all(empty, axis=1)
            refill_slots = jnp.logical_and(empty, trigger[:, None])
        else:
            refill_slots = empty
        reset_deals = None
        if deal_override is None:
            deals, reset_deals = self._deal_batch2(
                state.base_key, state.rng_counter
            )
        else:
            deals = jnp.asarray(deal_override, dtype=jnp.int32)
        # Deal-stream position of each refilled slot (ascending slot order —
        # matches the oracle's draw order, the parity contract).  Selection
        # is a static S-loop (S <= 3), not a gather.
        if cfg.queue_size == 1:
            deal_vals = deals
        else:
            pos = jnp.cumsum(refill_slots.astype(jnp.int32), axis=1) - 1
            deal_vals = jnp.zeros_like(deals)
            for j in range(cfg.queue_size):
                deal_vals = deal_vals + jnp.where(
                    pos == j, deals[:, j : j + 1], 0
                )
        queue3 = jnp.where(refill_slots, deal_vals, queue2)

        # -- mask + termination ------------------------------------------
        mask = self.action_mask(board_next, queue3)
        terminated = jnp.logical_not(jnp.any(mask, axis=1))
        reward = jnp.where(
            terminated, reward + jnp.float32(cfg.terminal_penalty), reward
        )
        steps_next = state.steps + 1
        if cfg.max_steps > 0:
            # independent of `terminated` — the oracle sets both flags when
            # the game ends exactly at the horizon, and parity is bit-exact
            truncated = steps_next >= cfg.max_steps
        else:
            truncated = jnp.zeros(n, dtype=bool)
        done = jnp.logical_or(terminated, truncated)
        score_next = state.score + reward

        info = {
            "lines_cleared": k,
            "legal": legal,
            "episode_return": score_next,
            "episode_length": steps_next,
            "streak": streak_next,
        }

        # -- auto-reset (fused; SURVEY.md §3.3) --------------------------
        if auto_reset:
            if reset_deals is None:  # parity mode with auto-reset
                reset_deals = self._deal_batch(
                    state.base_key, state.rng_counter, tag=1
                )
            reset_queue = reset_deals
            board_out = jnp.where(
                done[:, None], jnp.zeros_like(board_next), board_next
            )
            queue_out = jnp.where(done[:, None], reset_queue, queue3)
            mask_out = jnp.where(
                done[:, None], self._empty_board_mask(reset_queue), mask
            )
            steps_out = jnp.where(done, 0, steps_next)
            score_out = jnp.where(done, 0.0, score_next)
            streak_out = jnp.where(done, 0, streak_next)
            # pre-reset ("final") observation for Gym-adapter and learner
            # consumers (truncation bootstrapping); identical to the live
            # obs for non-done envs
            info["final_board"] = self.board_obs(board_next)
            info["final_queue"] = queue3
            info["final_action_mask"] = mask
            if cfg.obs_planes:
                info["final_piece_planes"] = self.piece_planes(queue3)
        else:
            board_out, queue_out, mask_out = board_next, queue3, mask
            steps_out, score_out = steps_next, score_next
            streak_out = streak_next

        new_state = EnvState(
            board=board_out,
            queue=queue_out,
            base_key=state.base_key,
            rng_counter=state.rng_counter + 1,
            steps=steps_out,
            score=score_out,
            streak=streak_out,
        )
        ts = TimeStep(
            board=self.board_obs(board_out),
            queue=queue_out,
            action_mask=mask_out,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info=info,
            piece_planes=self._maybe_planes(queue_out),
        )
        return new_state, ts

    # ------------------------------------------------------------------
    # Convenience: jitted entry points
    # ------------------------------------------------------------------

    @functools.cached_property
    def step_jit(self):
        """Jitted fast-path step (auto-reset on, native RNG, donated state)."""
        return jax.jit(
            lambda state, action: self.step(state, action),
            donate_argnums=(0,),
        )

    @functools.cached_property
    def init_jit(self):
        return jax.jit(self.init, static_argnums=(1,))

    @functools.cached_property
    def reset_jit(self):
        return jax.jit(self.reset, donate_argnums=(0,))

    @functools.cached_property
    def partial_reset_jit(self):
        return jax.jit(self.partial_reset, donate_argnums=(0,))


def make_env(
    cfg: Optional[EnvConfig] = None,
    rng_impl: str = "rbg",
    mask_dtype: str = "bf16",
    mask_impl: Optional[str] = None,
    state_impl: Optional[str] = None,
) -> VecBlockPuzzle:
    """Factory mirroring the reference's env construction (SURVEY.md §3.1)."""
    if cfg is None:
        cfg = EnvConfig()
    # make first compiles a one-time cost for every engine consumer
    from blockpuzzle_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    return VecBlockPuzzle(
        cfg,
        rng_impl=rng_impl,
        mask_dtype=mask_dtype,
        mask_impl=mask_impl,
        state_impl=state_impl,
    )
