"""Checkpoint/resume as flattened-pytree ``.npz`` files (SURVEY.md §5
"Checkpoint / resume").

The reference is a stateless toy env with no checkpointing; the target saves
the FULL train state — params, optimizer state, env states, per-env RNG keys
and counters, step counters — so resume is bit-exact (counter-based RNG makes
this trivial: the piece stream depends only on saved keys + counters).

Layout: ``<dir>/<step>.npz`` holds one array per pytree leaf, keyed by the
leaf's ``jax.tree_util.keystr`` path, plus a ``__meta__`` JSON string with
each leaf's dtype and, for typed PRNG keys, the key impl (keys are stored as
their ``key_data``).  Each file is written to a temporary name and renamed,
so a reader never sees a half-written step.  Restored leaves are placed on
the template's shardings.  Single-process: every leaf must be addressable
from this process.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

RUN_META_FILE = "run_meta.json"
_META_KEY = "__meta__"
_STEP_FILE = re.compile(r"^(\d+)\.npz$")


def _is_key(x: Any) -> bool:
    return hasattr(x, "dtype") and jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key
    )


class CheckpointManager:
    """Numbered ``.npz`` steps in one directory, with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.npz")

    # -- save ------------------------------------------------------------

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as step ``step`` (replacing an existing file) and
        drop the oldest steps beyond ``max_to_keep``."""
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, dict] = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(state)
        for path, leaf in flat:
            name = jax.tree_util.keystr(path)
            info = {}
            if _is_key(leaf):
                info["key_impl"] = str(jax.random.key_impl(leaf))
                leaf = jax.random.key_data(leaf)
            arr = np.asarray(jax.device_get(leaf))
            info["dtype"] = str(arr.dtype)
            if arr.dtype.kind not in "biuf":  # e.g. bfloat16: store raw bits
                arr = arr.view(f"u{arr.dtype.itemsize}")
            arrays[name] = arr
            meta[name] = info
        arrays[_META_KEY] = np.asarray(json.dumps(meta))
        final = self._path(step)
        tmp = final + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        if self._max_to_keep:
            for old in self.all_steps()[: -self._max_to_keep]:
                os.remove(self._path(old))
        return True

    # -- restore ---------------------------------------------------------

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        with np.load(self._path(step), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(str(arrays.pop(_META_KEY)))
        return step, arrays, meta

    @staticmethod
    def _leaf(arr: np.ndarray, info: dict, tmpl: Any, name: str):
        """Saved array -> a leaf shaped, typed and placed like ``tmpl``."""
        if str(arr.dtype) != info["dtype"]:
            arr = arr.view(jnp.dtype(info["dtype"]))
        if "key_impl" in info:
            out = jax.random.wrap_key_data(
                jnp.asarray(arr), impl=info["key_impl"]
            )
        else:
            out = arr
        if tuple(out.shape) != tuple(tmpl.shape) or out.dtype != tmpl.dtype:
            raise ValueError(
                f"checkpoint leaf {name} is {out.dtype}{list(out.shape)}, "
                f"template expects {tmpl.dtype}{list(tmpl.shape)}"
            )
        sharding = getattr(tmpl, "sharding", None)
        if sharding is not None:
            return jax.device_put(out, sharding)
        return jnp.asarray(out)

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure/shardings of ``state_template``.

        Forward compatibility: when ``state_template`` has leaves the saved
        checkpoint lacks — a state field added AFTER the checkpoint was
        written (e.g. ``EnvState.streak``, added with the streak-bonus
        mechanic) — the saved leaves are restored and the new fields keep
        the template's (freshly initialized) values, with a note on stderr.
        Any other structure mismatch (removed/renamed/reshaped leaves)
        raises ValueError, because silently dropping saved state would
        corrupt the resume.
        """
        step, arrays, meta = self._load(step)
        flat, treedef = jax.tree_util.tree_flatten_with_path(state_template)
        names = [jax.tree_util.keystr(p) for p, _ in flat]
        missing = [n for n in names if n not in arrays]
        extra = sorted(set(arrays) - set(names))
        if extra or len(missing) == len(names):
            raise ValueError(
                f"checkpoint step {step} does not match the template: "
                f"saved-only leaves {extra[:5]}, template-only leaves "
                f"{missing[:5]}"
            )
        leaves = [
            tmpl if name in missing
            else self._leaf(arrays[name], meta[name], tmpl, name)
            for name, (_, tmpl) in zip(names, flat)
        ]
        if missing:
            print(
                f"[checkpoint] step {step} predates state field(s) "
                f"{', '.join(missing)}; restored the saved leaves and kept "
                f"the template's fresh values for the new field(s)",
                file=sys.stderr,
            )
        return treedef.unflatten(leaves)

    def restore_params(self, params_template: Any, step: Optional[int] = None) -> Any:
        """Restore only the ``params`` subtree of a saved TrainState.

        Lets evaluation restore weights from checkpoints whose optimizer
        state doesn't match the local template (e.g. trained with a LR
        schedule).  ``params_template`` may hold arrays or
        ``jax.eval_shape`` outputs.
        """
        step, arrays, meta = self._load(step)
        flat, treedef = jax.tree_util.tree_flatten_with_path(params_template)
        leaves = []
        for path, tmpl in flat:
            name = ".params" + jax.tree_util.keystr(path)
            if name not in arrays:
                raise ValueError(
                    f"checkpoint step {step} has no param leaf {name}"
                )
            leaves.append(self._leaf(arrays[name], meta[name], tmpl, name))
        return treedef.unflatten(leaves)

    # -- run metadata ----------------------------------------------------

    def save_run_meta(self, meta: dict) -> None:
        """Make the checkpoint dir self-describing (``run_meta.json``).

        Written once at train start with everything evaluation needs to
        rebuild the network (algo, preset, env overrides, torso shape) —
        ``cli.evaluate`` auto-fills its flags from it, so users don't have
        to re-type (and can't mis-type) the training configuration.
        Atomic write: evaluate never sees a half-written file.
        """
        path = os.path.join(self._dir, RUN_META_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def load_run_meta(self) -> Optional[dict]:
        """Read ``run_meta.json`` if present (None for older checkpoints)."""
        path = os.path.join(self._dir, RUN_META_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        """All retained checkpoint steps, ascending (peak-hunting evals)."""
        return sorted(
            int(m.group(1))
            for m in map(_STEP_FILE.match, os.listdir(self._dir))
            if m
        )

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
