"""Sharding tests on the simulated 8-device CPU mesh (SURVEY.md §4.2).

Validates that the (dp, tp) mesh, the partition rules, and the full sharded
PPO update compile and execute with real multi-device shardings — the CI
stand-in for a multi-GPU host (BASELINE config 5).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blockpuzzle_tpu import dist
from blockpuzzle_tpu.config import default_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import PPO, PPOConfig
import pytest


def test_make_mesh_shapes():
    mesh = dist.make_mesh()
    assert mesh.devices.shape == (8, 1)
    assert mesh.axis_names == ("dp", "tp")
    mesh2 = dist.make_mesh(tp=2)
    assert mesh2.devices.shape == (4, 2)


def test_env_state_shards_on_dp():
    mesh = dist.make_mesh()
    env = make_env(default_config())
    state, ts = env.init(jax.random.key(0), 64)
    sharded = dist.shard_batch_axis(mesh, state)
    sh = sharded.board.sharding
    assert isinstance(sh, NamedSharding)
    assert sh.spec == P("dp")
    # stepping sharded state keeps the env axis sharded and stays correct
    step = jax.jit(lambda s, a: env.step(s, a))
    state2, ts2 = step(sharded, jnp.zeros(64, jnp.int32))
    assert np.asarray(ts2.reward).shape == (64,)


def test_sharded_env_step_matches_unsharded():
    mesh = dist.make_mesh()
    env = make_env(default_config())
    state, ts = env.init(jax.random.key(1), 32)
    actions = jnp.arange(32, dtype=jnp.int32) % env.num_actions
    ref_state, ref_ts = jax.jit(env.step)(state, actions)
    sharded = dist.shard_batch_axis(mesh, state)
    out_state, out_ts = jax.jit(env.step)(sharded, actions)
    np.testing.assert_array_equal(
        np.asarray(ref_state.board), np.asarray(out_state.board)
    )
    np.testing.assert_array_equal(
        np.asarray(ref_ts.reward), np.asarray(out_ts.reward)
    )


def test_param_rules_cover_actor_critic():
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, hidden=32,
                             channels=(8,), num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    leaves_state = jax.tree.leaves(state)
    leaves_spec = jax.tree.leaves(
        spec, is_leaf=lambda x: isinstance(x, P)
    )
    assert len(leaves_state) == len(leaves_spec)
    # env board sharded on dp
    assert spec.env_state.board == P("dp")
    assert spec.update_count == P()


def test_sharded_ppo_update_runs_on_mesh():
    """Full PPO update jitted with dp-sharded batch on the 8-device mesh."""
    mesh = dist.make_mesh()
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=16, rollout_len=4, hidden=32,
                             channels=(8,), num_epochs=1, num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    shardings = dist.to_named(mesh, spec)
    state = jax.device_put(state, shardings)
    update = jax.jit(ppo.update, donate_argnums=(0,))
    state2, metrics = update(state)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.update_count) == 1
    # params stayed replicated, env state stayed dp-sharded
    assert state2.env_state.board.sharding.spec == P("dp")


def test_tp2_mesh_shards_dense_kernel():
    mesh = dist.make_mesh(tp=2)
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, hidden=64,
                             channels=(8,), num_epochs=1, num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    shardings = dist.to_named(mesh, spec)
    state = jax.device_put(state, shardings)
    state2, metrics = jax.jit(ppo.update, donate_argnums=(0,))(state)
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.slow
def test_sharded_ppo_update_matches_unsharded():
    """The mesh-sharded update equals the single-device update to float
    tolerance (reduction reorder only) — the dryrun's equivalence check,
    mirrored in CI (VERDICT.md round 1, weak #5)."""
    mesh = dist.make_mesh()
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=16, rollout_len=4, hidden=32,
                             channels=(8,), num_epochs=1, num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    shardings = dist.to_named(mesh, dist.train_state_spec(state))
    update = jax.jit(ppo.update)
    sharded_out, m_sharded = update(jax.device_put(state, shardings))
    single_out, m_single = update(jax.device_put(state, jax.devices()[0]))
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(
            float(m_sharded[k]), float(m_single[k]), rtol=1e-3, atol=1e-5
        )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        ),
        sharded_out.params,
        single_out.params,
    )


def test_sharded_dqn_iteration_runs_on_mesh():
    from blockpuzzle_tpu.learn import DQN, DQNConfig

    mesh = dist.make_mesh()
    env = make_env(default_config())
    dqn = DQN(env, DQNConfig(num_envs=16, buffer_size=256, batch_size=8,
                             collect_steps=2, min_buffer=4, hidden=32,
                             channels=(8,)))
    state = dqn.init(jax.random.key(1))
    shardings = dist.to_named(mesh, dist.train_state_spec(state))
    state = jax.device_put(state, shardings)
    state2, metrics = jax.jit(dqn.iteration, donate_argnums=(0,))(state)
    assert int(metrics["buffer_filled"]) == 32  # 2 steps x 16 envs
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.iter_count) == 1


def test_param_spec_applies_rules_to_boxed_kernels():
    """param_spec applies the tp column rule to the torso's hidden kernel
    (the rules are the only record of the tensor-parallel layout)."""
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, hidden=64,
                             channels=(8,), num_epochs=1, num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    spec = dist.param_spec(state.params)
    flat = {
        "/".join(str(k.key) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, P)
        )[0]
    }
    torso = [k for k in flat if "Torso_0/hidden_proj/kernel" in k]
    assert torso and all(flat[k] == P(None, "tp") for k in torso), flat


def test_param_rules_shard_head_kernels():
    """The row-parallel head rule must actually match the param paths of
    the train state (params and the optimizer moments that mirror them)."""
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, hidden=64,
                             channels=(8,), num_epochs=1, num_minibatches=2))
    state = ppo.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    flat = {
        "/".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, P)
        )[0]
    }
    torso = [k for k in flat if "Torso_0/hidden_proj/kernel" in k]
    heads = [
        k for k in flat
        if "/Head_0/kernel" in k and "params/" in k
    ]
    assert torso and all(flat[k] == P(None, "tp") for k in torso), flat
    assert heads and all(flat[k] == P("tp", None) for k in heads), heads


def test_param_rules_shard_mlp_torso_kernel():
    """The mlp torso's dominant (cells, width) kernel must carry the tp
    column rule — it previously fell through to P() (replicated) while the
    docs claimed the rules were arch-independent."""
    env = make_env(default_config())
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, hidden=64,
                             channels=(8,), num_epochs=1, num_minibatches=2,
                             torso="mlp"))
    state = ppo.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    flat = {
        "/".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, P)
        )[0]
    }
    mlp = [k for k in flat if "Torso_0/mlp_0/kernel" in k and "params/" in k]
    assert mlp and all(flat[k] == P(None, "tp") for k in mlp), flat
    # and the sharded update actually executes on a tp=2 mesh
    mesh = dist.make_mesh(tp=2)
    shardings = dist.to_named(mesh, spec)
    state = jax.device_put(state, shardings)
    state2, metrics = jax.jit(ppo.update, donate_argnums=(0,))(state)
    assert np.isfinite(float(metrics["loss"]))


def test_param_rules_shard_dueling_heads():
    """The dueling QNetwork's two head kernels are Head_0 (value) AND
    Head_1 (advantage); a rule anchored on _0 would silently replicate the
    advantage kernel at tp>1.  Both must carry the row-parallel tp rule,
    and the dueling iteration must execute sharded on a tp=2 mesh."""
    from blockpuzzle_tpu.learn import DQN, DQNConfig

    env = make_env(default_config())
    dqn = DQN(env, DQNConfig(num_envs=16, buffer_size=256, batch_size=8,
                             collect_steps=2, min_buffer=8, hidden=32,
                             channels=(8,), dueling=True))
    state = dqn.init(jax.random.key(0))
    spec = dist.train_state_spec(state)
    flat = {
        "/".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, P)
        )[0]
    }
    for name in ("Head_0", "Head_1"):
        ks = [k for k in flat if f"/{name}/kernel" in k and "params/" in k]
        assert ks and all(flat[k] == P("tp", None) for k in ks), (name, flat)
    mesh = dist.make_mesh(tp=2)
    shardings = dist.to_named(mesh, spec)
    state = jax.device_put(state, shardings)
    state2, metrics = jax.jit(dqn.iteration, donate_argnums=(0,))(state)
    assert int(metrics["buffer_filled"]) == 32
    assert np.isfinite(float(metrics["loss"]))


def test_sharded_nstep_dqn_iteration_runs_on_mesh():
    """n-step pending window shards on its ENV axis (axis 1), not axis 0."""
    from blockpuzzle_tpu.learn import DQN, DQNConfig

    mesh = dist.make_mesh()
    env = make_env(default_config())
    dqn = DQN(env, DQNConfig(num_envs=16, buffer_size=256, batch_size=8,
                             collect_steps=2, min_buffer=8, hidden=32,
                             channels=(8,), n_step=3, dueling=True, per=True))
    state = dqn.init(jax.random.key(1))
    specs = dist.train_state_spec(state)
    from jax.sharding import PartitionSpec as P
    assert specs.pending["valid"] == P()
    assert specs.pending["board"] == P(None, "dp")
    shardings = dist.to_named(mesh, specs)
    state = jax.device_put(state, shardings)
    it = jax.jit(dqn.iteration, donate_argnums=(0,))
    state, metrics = it(state)
    # first iteration: both emissions rooted at invalid startup slots
    assert int(metrics["buffer_filled"]) == 0
    state, metrics = it(state)
    assert int(metrics["buffer_filled"]) == 32  # 2 valid emissions x 16
    assert np.isfinite(float(metrics["loss"]))
    assert int(state.iter_count) == 2


def test_sharded_words_sampler_matches_unsharded():
    """Round-5 serving path: the packed-words uniform-legal sampler
    (env/words.py) is sharding-stable — dp-sharding the words batch
    changes nothing bit-wise (threefry keys are position-, not
    shard-indexed), so a sharded serving fleet samples exactly the
    actions a single chip would."""
    from blockpuzzle_tpu.env.words import legal_words, sample_uniform_legal

    mesh = dist.make_mesh()
    cfg = default_config()
    env = make_env(cfg)
    state, ts = env.init(jax.random.key(3), 32)
    words = legal_words(env, state.board, state.queue)
    key = jax.random.key(7)
    fn = jax.jit(sample_uniform_legal, static_argnums=2)
    ref = fn(words, key, cfg.width)
    sharded_words = jax.device_put(
        words, NamedSharding(mesh, P("dp", None))
    )
    out = fn(sharded_words, key, cfg.width)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))
    # every sampled action is legal on the bool mask
    mask = np.asarray(ts.action_mask)
    assert mask[np.arange(32), np.asarray(out)].all()


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_equivalence_on_four_devices(tp):
    """The check chip_smoke.py --four-gpus runs on real cards, rehearsed on
    four virtual CPU devices at dp=4,tp=1 and dp=2,tp=2: sharded PPO update
    == unsharded, DQN iterations fill the replay, every array on the mesh."""
    from blockpuzzle_tpu.dist.equivalence import check_sharded_equivalence

    r = check_sharded_equivalence(jax.devices()[:4], tp=tp)
    assert (r["dp"], r["tp"]) == (4 // tp, tp)
    assert r["param_outlier_frac"] == 0.0
    assert r["dqn_buffer_filled"] == 3 * 4 * (4 // tp)
