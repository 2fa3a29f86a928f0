"""Aux subsystem tests: checkpoint/resume bit-exactness, metrics, profiling
(SURVEY.md §5: resume must be bit-exact — counter-based RNG makes the piece
stream a pure function of saved keys + counters)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blockpuzzle_tpu.config import default_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import PPO, PPOConfig
from blockpuzzle_tpu.utils import (
    CheckpointManager,
    MetricsLogger,
    ScopeTimer,
    Throughput,
)


def small_ppo():
    env = make_env(default_config())
    return PPO(env, PPOConfig(
        num_envs=8, rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=16, channels=(4,),
    ))


def test_checkpoint_roundtrip_env_state(tmp_path):
    env = make_env(default_config())
    state, ts = env.init(jax.random.key(0), 8)
    state, _ = env.step(state, jnp.zeros(8, jnp.int32))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(1, state)
    restored = mgr.restore(state)
    for name in ("board", "queue", "rng_counter", "steps", "score"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(restored, name)),
            name,
        )
    # typed PRNG keys survive the round trip
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(state.base_key)),
        np.asarray(jax.random.key_data(restored.base_key)),
    )
    mgr.close()


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Continue-from-checkpoint replays the exact same trajectory as an
    uninterrupted run (the SURVEY §5 fault-recovery contract)."""
    env = make_env(default_config())
    state, ts = env.init(jax.random.key(7), 16)
    actions = jnp.zeros(16, jnp.int32)
    for _ in range(3):
        state, ts = env.step(state, actions)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)

    # uninterrupted continuation
    cont_state, cont_ts = env.step(state, actions)
    # simulated crash + restore
    restored = mgr.restore(state)
    res_state, res_ts = env.step(restored, actions)
    np.testing.assert_array_equal(
        np.asarray(cont_state.board), np.asarray(res_state.board)
    )
    np.testing.assert_array_equal(
        np.asarray(cont_state.queue), np.asarray(res_state.queue)
    )
    np.testing.assert_array_equal(
        np.asarray(cont_ts.reward), np.asarray(res_ts.reward)
    )
    mgr.close()


def test_checkpoint_ppo_train_state(tmp_path):
    ppo = small_ppo()
    state = ppo.init(jax.random.key(0))
    state, _ = ppo.update_jit(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    restored = mgr.restore(state)
    leaves_a = jax.tree.leaves(
        jax.tree.map(
            lambda x: x
            if not jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
            else jax.random.key_data(x),
            (state.params, state.opt_state, state.update_count),
        )
    )
    leaves_b = jax.tree.leaves(
        jax.tree.map(
            lambda x: x
            if not jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
            else jax.random.key_data(x),
            (restored.params, restored.opt_state, restored.update_count),
        )
    )
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # restored state continues training
    state2, metrics = ppo.update_jit(restored)
    assert np.isfinite(float(metrics["loss"]))
    mgr.close()


def test_metrics_logger_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path), run_name="t")
    host = logger.log(1, {"loss": jnp.float32(1.5), "return": jnp.float32(3.0)})
    logger.log(2, {"loss": jnp.float32(1.0), "return": jnp.float32(4.0)})
    logger.close()
    assert host["loss"] == 1.5
    lines = open(tmp_path / "t.jsonl").read().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[1])
    assert rec["step"] == 2 and rec["loss"] == 1.0
    assert "wall_time" in rec


def test_throughput_meter_skips_compile_tick():
    m = Throughput()
    assert m.tick(1000) == 0.0  # first tick = compile, not counted
    import time

    time.sleep(0.01)
    v = m.tick(1000)
    assert v > 0


def test_scope_timer():
    t = ScopeTimer()
    with t.scope("a"):
        pass
    with t.scope("a"):
        pass
    with t.scope("b"):
        pass
    s = t.summary()
    assert set(s) == {"a", "b"}


def test_restore_params_across_optimizer_mismatch(tmp_path):
    """Eval-style params-only restore from a checkpoint whose optimizer
    state doesn't match the local template (LR-schedule mismatch)."""
    env = make_env(default_config())
    train_ppo = PPO(env, PPOConfig(
        num_envs=8, rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=16, channels=(4,),
    ))
    state = train_ppo.init(jax.random.key(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)

    eval_ppo = PPO(env, PPOConfig(
        num_envs=8, rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=16, channels=(4,),
    ))
    # different optimizer => different opt-state tree than the checkpoint
    import optax

    eval_ppo.tx = optax.sgd(1e-3)
    template = eval_ppo.init(jax.random.key(1))
    # fresh manager, as in a real eval process
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    params = mgr.restore_params(template.params)
    a = jax.tree.leaves(jax.tree.map(np.asarray, state.params))
    b = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mgr.close()


def test_restore_params_on_used_manager(tmp_path):
    """restore_params must work on a manager that already save()d."""
    ppo = small_ppo()
    state = ppo.init(jax.random.key(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    params = mgr.restore_params(state.params)  # same instance: must not raise
    a = jax.tree.leaves(jax.tree.map(np.asarray, state.params))
    b = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mgr.close()


def test_restore_params_from_eval_shape_template(tmp_path):
    """The abstract (jax.eval_shape) template path used by cli.evaluate."""
    ppo = small_ppo()
    state = ppo.init(jax.random.key(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    mgr.close()
    template = jax.eval_shape(ppo.net.init, jax.random.key(0))
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    params = mgr2.restore_params(template)
    a = jax.tree.leaves(jax.tree.map(np.asarray, state.params))
    b = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mgr2.close()


def test_restore_fills_fields_added_after_save(tmp_path):
    """Forward compat: a checkpoint saved BEFORE a state field existed
    (e.g. EnvState.streak, added with the streak-bonus mechanic) must
    still restore — saved leaves bit-exact, new fields kept from the
    template — instead of failing with a structure mismatch."""
    import chex

    @chex.dataclass
    class OldEnv:
        board: jax.Array
        score: jax.Array

    @chex.dataclass
    class NewEnv:
        board: jax.Array
        score: jax.Array
        streak: jax.Array  # the post-checkpoint addition

    old = {"env": OldEnv(board=jnp.arange(12.0).reshape(3, 4),
                         score=jnp.float32(5.0)),
           "step": jnp.int32(7)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(3, old)
    mgr.close()

    template = {"env": NewEnv(board=jnp.zeros((3, 4)),
                              score=jnp.float32(0.0),
                              streak=jnp.full((3,), -1, jnp.int32)),
                "step": jnp.int32(0)}
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    restored = mgr2.restore(template)
    mgr2.close()
    np.testing.assert_array_equal(np.asarray(restored["env"].board),
                                  np.asarray(old["env"].board))
    assert float(restored["env"].score) == 5.0
    assert int(restored["step"]) == 7
    # the new field keeps the template's (fresh-init) value
    np.testing.assert_array_equal(np.asarray(restored["env"].streak),
                                  np.full((3,), -1, np.int32))


def test_restore_still_raises_on_shape_mismatch(tmp_path):
    """Only new-field mismatches are auto-filled; a reshaped leaf (a REAL
    layout change) must still raise so a corrupt resume can't happen."""
    import pytest

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(1, {"a": jnp.zeros((4,)), "b": jnp.int32(0)})
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError):
        mgr2.restore({"a": jnp.zeros((8,)), "b": jnp.int32(0)})
    mgr2.close()


# -- npz checkpoint format ---------------------------------------------------


@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
def test_checkpoint_roundtrip_typed_keys_and_bf16(tmp_path, impl):
    """Typed PRNG keys come back with their impl; bf16 leaves bit-exact."""
    keys = jax.random.split(jax.random.key(3, impl=impl), 5)
    state = {"keys": keys, "w": jnp.arange(6, dtype=jnp.bfloat16) / 3,
             "n": jnp.int32(4)}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    template = {"keys": jax.random.split(jax.random.key(0, impl=impl), 5),
                "w": jnp.zeros(6, jnp.bfloat16), "n": jnp.int32(0)}
    out = CheckpointManager(str(tmp_path / "ck")).restore(template)
    assert str(jax.random.key_impl(out["keys"])) == impl
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(out["keys"])),
                                  np.asarray(jax.random.key_data(keys)))
    assert out["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["w"]), np.asarray(state["w"]))
    assert int(out["n"]) == 4


def test_checkpoint_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in range(1, 6):
        mgr.save(step, {"x": jnp.float32(step)})
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "4.npz", "5.npz"
    ]
    assert float(mgr.restore({"x": jnp.float32(0)}, step=4)["x"]) == 4.0


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the earlier steps intact, no
    partial step file and no temporary file behind."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"x": jnp.arange(4.0)})

    def dying_savez(f, **arrays):
        f.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, {"x": jnp.arange(4.0) + 1})
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["1.npz"]
    np.testing.assert_array_equal(
        np.asarray(mgr.restore({"x": jnp.zeros(4)})["x"]), np.arange(4.0)
    )


def test_checkpoint_restore_places_on_template_sharding(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blockpuzzle_tpu import dist

    mesh = dist.make_mesh()
    sharding = NamedSharding(mesh, P("dp"))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"b": jnp.arange(16, dtype=jnp.uint32)})
    template = {"b": jax.device_put(jnp.zeros(16, jnp.uint32), sharding)}
    out = mgr.restore(template)
    assert out["b"].sharding == sharding
    np.testing.assert_array_equal(np.asarray(out["b"]), np.arange(16))


def test_checkpoint_restore_rejects_removed_leaf(tmp_path):
    """A saved leaf the template no longer has is a layout change, not a
    new field: restoring would silently drop state, so it raises."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"a": jnp.zeros(2), "gone": jnp.ones(2)})
    with pytest.raises(ValueError, match="gone"):
        mgr.restore({"a": jnp.zeros(2)})


# -- compile cache ------------------------------------------------------------


@pytest.fixture
def cache_config():
    """Restore the cache settings enable_compilation_cache may change."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_off_on_cpu(monkeypatch, cache_config):
    from blockpuzzle_tpu.utils import compile_cache

    monkeypatch.delenv(compile_cache.CACHE_ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compilation_cache() == ""
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, cache_config):
    import pathlib

    from blockpuzzle_tpu.utils import compile_cache

    repo = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.delenv(compile_cache.CACHE_ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache.jax, "default_backend", lambda: "gpu")
    path = compile_cache.enable_compilation_cache()
    assert path == str(repo / ".jax_cache") == compile_cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


def test_compile_cache_env_var_honoured(monkeypatch, tmp_path, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the code sets no path of its own (JAX reads the variable itself)."""
    from blockpuzzle_tpu.utils import compile_cache

    target = str(tmp_path / "xla")
    monkeypatch.setenv(compile_cache.CACHE_ENV_VAR, target)
    monkeypatch.setattr(compile_cache.jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compilation_cache() == target
    assert compile_cache.cache_dir() == target
    assert jax.config.jax_compilation_cache_dir == before
    assert (tmp_path / "xla").is_dir()
