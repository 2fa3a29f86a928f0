"""Learner tests: PPO and DQN update programs at tiny shapes (SURVEY §4.2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blockpuzzle_tpu.config import default_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn import DQN, DQNConfig, PPO, PPOConfig


@pytest.fixture(scope="module")
def env():
    return make_env(default_config())


def small_ppo(env, **kw):
    cfg = PPOConfig(
        num_envs=16,
        rollout_len=8,
        num_epochs=1,
        num_minibatches=2,
        hidden=32,
        channels=(8,),
        **kw,
    )
    return PPO(env, cfg)


def test_ppo_init_and_update_shapes(env):
    ppo = small_ppo(env)
    state = ppo.init(jax.random.key(0))
    p0 = jax.tree.map(np.array, state.params)  # host copy: state is donated
    state2, metrics = ppo.update_jit(state)
    assert int(state2.update_count) == 1
    for k in ("loss", "policy_loss", "value_loss", "entropy", "approx_kl",
              "episode_return", "reward_per_step"):
        assert np.isfinite(float(metrics[k])), k
    # params actually changed
    diff = jax.tree.map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), p0, state2.params
    )
    assert max(jax.tree.leaves(diff)) > 0


def test_ppo_multiple_updates_stable(env):
    ppo = small_ppo(env)
    state = ppo.init(jax.random.key(1))
    for _ in range(3):
        state, metrics = ppo.update_jit(state)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["entropy"]) >= 0


def test_ppo_policy_only_picks_legal_actions(env):
    """Masked logits make illegal actions unsampleable."""
    from blockpuzzle_tpu.learn import networks

    ppo = small_ppo(env)
    state = ppo.init(jax.random.key(2))
    board, queue, action_mask = ppo.observe(state.env_state)
    logits, value = ppo.net.apply(state.params, board, queue, action_mask)
    assert logits.shape == (16, env.num_actions)
    assert value.shape == (16,)
    samples = networks.masked_categorical(jax.random.key(3), logits)
    mask = np.asarray(action_mask)
    for i, a in enumerate(np.asarray(samples)):
        assert mask[i, a], f"sampled illegal action {a} for env {i}"


def test_gae_simple_case(env):
    """GAE on a hand-built 2-step batch matches the closed form."""
    from blockpuzzle_tpu.learn.ppo import Batch

    ppo = small_ppo(env)
    gamma, lam = ppo.cfg.gamma, ppo.cfg.gae_lambda
    T, N = 3, 2
    z = jnp.zeros((T, N))
    batch = Batch(
        board=z, queue=z, action_mask=z, action=z, log_prob=z,
        value=jnp.array([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]),
        reward=jnp.array([[1.0, 1.0], [1.0, 1.0], [1.0, 1.0]]),
        done=jnp.array([[False, False], [False, True], [False, False]]),
        terminated=jnp.array([[False, False], [False, True], [False, False]]),
        final_value=z,
    )
    last_value = jnp.array([5.0, 5.0])
    adv, ret = ppo._gae(batch, last_value)
    # env 1, t=1 terminated: delta = r - v = 1 - 2 = -1, no bootstrap
    d2 = 1.0 + gamma * 5.0 - 3.0
    d1_env1 = 1.0 - 2.0
    assert float(adv[1, 1]) == pytest.approx(d1_env1 + gamma * lam * 0.0)
    assert float(adv[2, 0]) == pytest.approx(d2)
    np.testing.assert_allclose(
        np.asarray(ret), np.asarray(adv + batch.value), rtol=1e-6
    )


@pytest.mark.slow
def test_ppo_runtime_hypers_match_static(env):
    """update(state, default_hypers) matches update(state) to float
    tolerance — the sweep path (runtime scalars) has the same semantics as
    the baked-constant path.  Not bit-exact: the static program constant-
    folds e.g. gamma*gae_lambda at f64 before the single f32 round, the
    runtime program rounds each factor to f32 first."""
    from blockpuzzle_tpu.learn import default_hypers

    ppo = small_ppo(env)
    state_a = ppo.init(jax.random.key(7))
    state_b = ppo.init(jax.random.key(7))
    out_a, m_a = jax.jit(ppo.update)(state_a)
    out_b, m_b = jax.jit(ppo.update)(state_b, default_hypers(ppo.cfg))
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        ),
        out_a.params,
        out_b.params,
    )
    np.testing.assert_allclose(
        float(m_a["loss"]), float(m_b["loss"]), rtol=1e-4
    )


def test_ppo_runtime_lr_is_live(env):
    """Changing the runtime lr changes the step (no silent constant-folding);
    lr=0 freezes the params exactly."""
    ppo = small_ppo(env)
    state = ppo.init(jax.random.key(8))
    p0 = jax.tree.map(np.array, state.params)
    from blockpuzzle_tpu.learn import default_hypers

    hy = dict(default_hypers(ppo.cfg), lr=0.0)
    out, _ = jax.jit(ppo.update)(state, hy)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        p0,
        out.params,
    )


def test_ppo_anneal_updates_decays_lr(env):
    """cfg.anneal_updates>0 (hypers=None path) shrinks the step over time
    and reaches lr=0 at the horizon."""
    ppo = small_ppo(env, anneal_updates=2)
    state = ppo.init(jax.random.key(9))
    state = state.replace(update_count=jnp.asarray(2, jnp.int32))
    p0 = jax.tree.map(np.array, state.params)
    out, _ = jax.jit(ppo.update)(state)  # frac = 1 - 2/2 = 0 -> frozen
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        p0,
        out.params,
    )


@pytest.mark.slow
def test_ppo_multi_update_matches_sequential(env):
    """K scanned updates (one dispatch) match K sequential updates."""
    from blockpuzzle_tpu.learn import default_hypers

    ppo = small_ppo(env)
    hy = default_hypers(ppo.cfg)
    state_a = ppo.init(jax.random.key(11))
    state_b = ppo.init(jax.random.key(11))
    for _ in range(3):
        state_a, m_a = ppo.update_jit(state_a, hy)
    stack = {k: jnp.full((3,), v, jnp.float32) for k, v in hy.items()}
    state_b, m_b = ppo.multi_update_jit(state_b, stack)
    assert m_b["loss"].shape == (3,)
    assert int(state_b.update_count) == 3
    np.testing.assert_allclose(
        float(m_a["loss"]), float(m_b["loss"][-1]), rtol=1e-4
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        ),
        state_a.params,
        state_b.params,
    )


def test_ppo_mlp_torso_trains(env):
    """The pure-matmul torso variant runs and learns param updates."""
    ppo = small_ppo(env, torso="mlp")
    state = ppo.init(jax.random.key(12))
    p0 = jax.tree.map(np.array, state.params)
    assert "mlp_0" in state.params["params"]["Torso_0"]
    assert "Conv_0" not in state.params["params"]["Torso_0"]
    state, metrics = ppo.update_jit(state)
    assert np.isfinite(float(metrics["loss"]))
    diff = jax.tree.map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), p0, state.params
    )
    assert max(jax.tree.leaves(diff)) > 0


def test_ppo_mlp_width_is_plumbed(env):
    """PPOConfig.mlp_width sizes the torso matmul (ROADMAP width sweep)."""
    ppo = small_ppo(env, torso="mlp", mlp_width=96)
    state = ppo.init(jax.random.key(14))
    kernel = state.params["params"]["Torso_0"]["mlp_0"]["kernel"]
    assert kernel.shape[-1] == 96
    state, metrics = ppo.update_jit(state)
    assert np.isfinite(float(metrics["loss"]))


def test_dqn_mlp_width_is_plumbed(env):
    cfg = DQNConfig(
        num_envs=8, buffer_size=128, batch_size=8, collect_steps=2,
        min_buffer=4, hidden=16, channels=(4,), torso="mlp", mlp_width=48,
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(15))
    kernel = state.params["params"]["Torso_0"]["mlp_0"]["kernel"]
    assert kernel.shape[-1] == 48
    state, m = dqn.iteration_jit(state)
    assert int(m["buffer_filled"]) == 16


def test_dqn_mlp_torso_iteration(env):
    cfg = DQNConfig(
        num_envs=8, buffer_size=128, batch_size=8, collect_steps=2,
        min_buffer=4, hidden=16, channels=(4,), torso="mlp",
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(13))
    state, m = dqn.iteration_jit(state)
    assert int(m["buffer_filled"]) == 16


def test_dqn_iteration(env):
    cfg = DQNConfig(
        num_envs=16,
        buffer_size=512,
        batch_size=32,
        collect_steps=2,
        grad_steps=1,
        min_buffer=64,
        hidden=32,
        channels=(8,),
        eps_decay_iters=10,
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(0))
    # first iterations fill the buffer without gradient steps
    state, m = dqn.iteration_jit(state)
    assert int(m["buffer_filled"]) == 32
    assert float(m["loss"]) == 0.0  # buffer below min at update decision
    p0 = jax.tree.map(np.array, state.params)  # host copy: state is donated
    for _ in range(3):
        state, m = dqn.iteration_jit(state)
    assert int(m["buffer_filled"]) > 32
    assert float(m["loss"]) > 0.0
    diff = jax.tree.map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), p0, state.params
    )
    assert max(jax.tree.leaves(diff)) > 0
    assert float(m["epsilon"]) < 1.0


def test_dqn_replay_wraps(env):
    cfg = DQNConfig(
        num_envs=8, buffer_size=16, batch_size=8, collect_steps=3,
        grad_steps=0, min_buffer=8, hidden=16, channels=(4,),
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(1))
    state, m = dqn.iteration_jit(state)  # writes 24 > 16: wraps
    assert int(state.replay.filled) == 16
    assert int(state.replay.cursor) == 8


def test_ppo_update_on_tenten_preset():
    """Multi-slot queue config exercises the S>1 learner/mask paths."""
    from blockpuzzle_tpu.config import tenten_config

    env3 = make_env(tenten_config())
    ppo = PPO(env3, PPOConfig(
        num_envs=8, rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=16, channels=(4,),
    ))
    state = ppo.init(jax.random.key(0))
    state, metrics = ppo.update_jit(state)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["illegal_action_rate"]) == 0.0  # masked policy


@pytest.mark.slow
def test_dqn_runtime_hypers_match_static(env):
    """iteration(state, default_dqn_hypers(cfg, it)) == iteration(state)
    bit-for-bit (mirrors the PPO runtime-hypers equivalence test)."""
    from blockpuzzle_tpu.learn import default_dqn_hypers

    cfg = DQNConfig(
        num_envs=8, buffer_size=64, batch_size=8, collect_steps=2,
        min_buffer=4, hidden=16, channels=(4,),
    )
    dqn = DQN(env, cfg)
    s_static = dqn.init(jax.random.key(3))
    s_hyper = dqn.init(jax.random.key(3))
    it_static = jax.jit(dqn.iteration)
    it_hyper = jax.jit(lambda s, h: dqn.iteration(s, h))
    for it in range(3):
        s_static, m_static = it_static(s_static)
        s_hyper, m_hyper = it_hyper(s_hyper, default_dqn_hypers(cfg, it))
        for k in ("loss", "q_mean", "epsilon"):
            assert float(m_static[k]) == float(m_hyper[k]), (k, it)
    for a, b in zip(
        jax.tree.leaves(s_static.params), jax.tree.leaves(s_hyper.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dqn_runtime_lr_is_live(env):
    """lr=0 through hypers must freeze params (proves lr is runtime)."""
    from blockpuzzle_tpu.learn import default_dqn_hypers

    cfg = DQNConfig(
        num_envs=8, buffer_size=64, batch_size=8, collect_steps=2,
        min_buffer=4, hidden=16, channels=(4,),
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(4))
    # warm the buffer first so the grad path actually runs
    state, _ = jax.jit(dqn.iteration)(state)
    p0 = jax.tree.map(np.array, state.params)
    h = dict(default_dqn_hypers(cfg, 1), lr=0.0)
    state, metrics = jax.jit(lambda s, hh: dqn.iteration(s, hh))(state, h)
    assert int(metrics["buffer_filled"]) > 0
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dqn_hypers_zero_decay_is_constant_eps_end():
    """eps_decay_iters=0 means no decay (was ZeroDivisionError)."""
    from blockpuzzle_tpu.learn import default_dqn_hypers

    cfg = DQNConfig(eps_decay_iters=0, eps_start=1.0, eps_end=0.07)
    for it in (0, 1, 100):
        assert default_dqn_hypers(cfg, it)["eps"] == pytest.approx(0.07)


def test_dqn_explore_only_picks_legal_actions(env):
    """The bits-argmax uniform-legal explorer (eps=1) must never emit an
    illegal action, including on all-zero random draws (the `| 1` tie
    guard)."""
    import jax
    import numpy as np

    from blockpuzzle_tpu.learn import DQN, DQNConfig

    dqn = DQN(env, DQNConfig(num_envs=32, buffer_size=128, batch_size=8,
                             collect_steps=1, min_buffer=8, hidden=32,
                             channels=(8,)))
    state = dqn.init(jax.random.key(3))
    board, queue, mask = dqn.observe(state.env_state)
    for i in range(4):
        a = dqn._act(state.params, board, queue, mask,
                     jax.random.key(100 + i), eps=1.0)
        picked = np.asarray(mask)[np.arange(mask.shape[0]), np.asarray(a)]
        assert picked.all()


def test_nstep_aggregate_synthetic(env):
    """_nstep_aggregate: hand-computed window math incl. done truncation."""
    cfg = DQNConfig(num_envs=2, collect_steps=2, n_step=3,
                    hidden=16, channels=(4,))
    dqn = DQN(env, cfg)
    hw, s, a = 100, 1, 100
    tprime, n = 4, 2
    rng = np.random.default_rng(0)
    comb = {
        "board": jnp.asarray(rng.integers(0, 2, (tprime, n, hw)), jnp.uint8),
        "queue": jnp.asarray(rng.integers(0, 19, (tprime, n, s)), jnp.int32),
        "action_mask": jnp.asarray(rng.integers(0, 2, (tprime, n, a)), bool),
        "action": jnp.asarray(rng.integers(0, a, (tprime, n)), jnp.int32),
        "reward": jnp.asarray(
            [[1.0, 10.0], [2.0, 20.0], [3.0, 30.0], [4.0, 40.0]]
        ),
        "next_board": jnp.asarray(
            rng.integers(0, 2, (tprime, n, hw)), jnp.uint8
        ),
        "next_queue": jnp.asarray(
            rng.integers(0, 19, (tprime, n, s)), jnp.int32
        ),
        "next_mask": jnp.asarray(rng.integers(0, 2, (tprime, n, a)), bool),
        "terminated": jnp.asarray(
            [[False, False], [True, False], [False, False], [False, True]]
        ),
        "done": jnp.asarray(
            [[False, False], [True, False], [False, False], [False, True]]
        ),
    }
    agg = jax.jit(dqn._nstep_aggregate, static_argnums=())(comb, 0.5)
    # env0 t=0: r0 + 0.5*r1, stops at done row 1 -> m=2, next from row 1
    # env1 t=0: 10 + 0.5*20 + 0.25*30 = 27.5, m=3, next from row 2
    np.testing.assert_allclose(
        np.asarray(agg["reward"][0]), [1 + 0.5 * 2, 27.5])
    np.testing.assert_array_equal(np.asarray(agg["m"][0]), [2, 3])
    np.testing.assert_array_equal(
        np.asarray(agg["next_board"][0, 0]), np.asarray(comb["next_board"][1, 0]))
    np.testing.assert_array_equal(
        np.asarray(agg["next_board"][0, 1]), np.asarray(comb["next_board"][2, 1]))
    assert bool(agg["terminated"][0, 0]) is True
    assert bool(agg["terminated"][0, 1]) is False
    # env0 t=1: window starts at row 1 which is done -> m=1, R=r1
    # env1 t=1: 20 + 0.5*30 + 0.25*40 = 45, m=3, terminated at row 3
    np.testing.assert_allclose(np.asarray(agg["reward"][1]), [2.0, 45.0])
    np.testing.assert_array_equal(np.asarray(agg["m"][1]), [1, 3])
    assert bool(agg["terminated"][1, 0]) is True
    assert bool(agg["terminated"][1, 1]) is True
    np.testing.assert_array_equal(
        np.asarray(agg["next_board"][1, 1]), np.asarray(comb["next_board"][3, 1]))
    # source-side fields pass through from the window root
    np.testing.assert_array_equal(
        np.asarray(agg["board"]), np.asarray(comb["board"][:2]))
    np.testing.assert_array_equal(
        np.asarray(agg["action"]), np.asarray(comb["action"][:2]))


@pytest.mark.slow
def test_dqn_nstep_buffer_matches_1step_aggregation(env):
    """End-to-end: the n=3 replay IS the n-step aggregate of the n=1 replay.

    Same seed, min_buffer high enough that params never update -> both
    learners produce identical action/transition streams; the n=3 buffer
    rows must then equal the window math recomputed from the n=1 rows
    (incl. the startup drop of the first n-1 emissions and gamma^m
    bootstrap metadata).
    """
    n_envs, k_steps, n_step, iters = 8, 3, 3, 30
    kw = dict(
        num_envs=n_envs, buffer_size=1024, batch_size=8,
        collect_steps=k_steps, grad_steps=1, min_buffer=10**6,
        hidden=16, channels=(4,),
    )
    dqn_a = DQN(env, DQNConfig(**kw))                      # 1-step
    dqn_b = DQN(env, DQNConfig(n_step=n_step, **kw))       # n-step
    sa = dqn_a.init(jax.random.key(7))
    sb = dqn_b.init(jax.random.key(7))
    for _ in range(iters):
        sa, _ = dqn_a.iteration_jit(sa)
        sb, _ = dqn_b.iteration_jit(sb)
    t_total = iters * k_steps
    w = n_step - 1
    assert int(sa.replay.filled) == t_total * n_envs
    assert int(sb.replay.filled) == (t_total - w) * n_envs

    a = dqn_a._unpack(
        sa.replay.bytes_buf[: t_total * n_envs],
        sa.replay.float_buf[: t_total * n_envs],
    )
    a = {kk: np.asarray(v).reshape((t_total, n_envs) + v.shape[1:])
         for kk, v in a.items()}
    b = dqn_b._unpack(
        sb.replay.bytes_buf[: (t_total - w) * n_envs],
        sb.replay.float_buf[: (t_total - w) * n_envs],
    )
    b = {kk: np.asarray(v).reshape((t_total - w, n_envs) + v.shape[1:])
         for kk, v in b.items()}
    # default config has max_steps=0 -> done == terminated
    gamma = dqn_a.cfg.gamma
    done = a["terminated"]
    assert done.any(), "test needs at least one episode end in the window"
    for g in range(t_total - w):
        alive = np.ones(n_envs, bool)
        r_exp = np.zeros(n_envs, np.float64)
        m_exp = np.zeros(n_envs, np.int64)
        for i in range(n_step):
            r_exp += alive * (gamma ** i) * a["reward"][g + i]
            m_exp += alive
            alive &= ~done[g + i]
        f = g + m_exp - 1
        np.testing.assert_allclose(b["reward"][g], r_exp, rtol=1e-6)
        np.testing.assert_array_equal(b["m"][g], m_exp)
        np.testing.assert_array_equal(b["board"][g], a["board"][g])
        np.testing.assert_array_equal(b["action"][g], a["action"][g])
        np.testing.assert_array_equal(b["action_mask"][g], a["action_mask"][g])
        for e in range(n_envs):
            np.testing.assert_array_equal(
                b["next_board"][g, e], a["next_board"][f[e], e])
            np.testing.assert_array_equal(
                b["next_queue"][g, e], a["next_queue"][f[e], e])
            np.testing.assert_array_equal(
                b["next_mask"][g, e], a["next_mask"][f[e], e])
            assert b["terminated"][g, e] == a["terminated"][f[e], e]


def test_dqn_nstep_trains(env):
    """n_step=3 learner runs gradient steps and moves params (smoke)."""
    cfg = DQNConfig(
        num_envs=16, buffer_size=512, batch_size=32, collect_steps=2,
        grad_steps=1, min_buffer=64, hidden=32, channels=(8,),
        eps_decay_iters=10, n_step=3,
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(0))
    state, m = dqn.iteration_jit(state)
    # first iteration: 2 collect steps, n-1=2 startup emissions dropped
    assert int(m["buffer_filled"]) == 0
    p0 = jax.tree.map(np.array, state.params)
    for _ in range(4):
        state, m = dqn.iteration_jit(state)
    assert int(m["buffer_filled"]) > 64
    assert float(m["loss"]) > 0.0
    diff = jax.tree.map(
        lambda x, y: float(np.abs(x - np.asarray(y)).max()), p0, state.params
    )
    assert max(jax.tree.leaves(diff)) > 0


def test_dqn_dueling_trains(env):
    """Dueling head: distinct param tree, legal-only Q, params move."""
    cfg = DQNConfig(
        num_envs=16, buffer_size=512, batch_size=32, collect_steps=2,
        grad_steps=1, min_buffer=64, hidden=32, channels=(8,),
        eps_decay_iters=10, dueling=True, n_step=2,
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(0))
    # two head matmuls instead of one: value (.., 1) + advantage (.., A)
    head_outs = sorted(
        p["kernel"].shape[-1]
        for name, p in state.params["params"].items()
        if name.startswith("Head_")
    )
    assert head_outs == [1, env.cfg.num_actions()]
    # illegal actions stay pinned regardless of the dueling combine
    _, ts = env.init(jax.random.key(1), 4)
    q = dqn.net.apply(state.params, ts.board, ts.queue, ts.action_mask)
    q = np.asarray(q)
    mask = np.asarray(ts.action_mask)
    assert (q[~mask] < -1e8).all()
    assert (q[mask] > -1e8).all()
    p0 = jax.tree.map(np.array, state.params)
    for _ in range(4):
        state, m = dqn.iteration_jit(state)
    assert float(m["loss"]) > 0.0
    diff = jax.tree.map(
        lambda x, y: float(np.abs(x - np.asarray(y)).max()), p0, state.params
    )
    assert max(jax.tree.leaves(diff)) > 0


def test_per_sample_respects_priorities_and_filled(env):
    """Gumbel-top-k PER draw (per_replacement=False): unfilled rows never
    sampled, a dominant priority is always in the batch, uniform priorities
    at beta=1 give unit importance weights."""
    from blockpuzzle_tpu.learn.dqn import Replay

    cfg = DQNConfig(
        num_envs=8, buffer_size=256, batch_size=16, min_buffer=16,
        hidden=16, channels=(4,), per=True, per_replacement=False,
    )
    dqn = DQN(env, cfg)
    prio = np.full(256, 1e-4, np.float32)
    prio[7] = 1e6  # dominates everything
    replay = Replay(
        bytes_buf=jnp.zeros((256, 8), jnp.uint8),
        float_buf=jnp.zeros((256, 2), jnp.float32),
        cursor=jnp.zeros((), jnp.int32),
        filled=jnp.asarray(64, jnp.int32),  # only the first 64 rows real
        prio=jnp.asarray(prio),
        max_prio=jnp.asarray(1e6, jnp.float32),
    )
    sample = jax.jit(dqn._per_sample)
    for seed in range(5):
        idx, w = sample(replay, jax.random.key(seed), 0.4)
        idx = np.asarray(idx)
        assert (idx < 64).all(), "sampled an unfilled slot"
        assert 7 in idx, "dominant-priority row missing from the batch"
        assert len(set(idx.tolist())) == 16, "sampling is without replacement"
        w = np.asarray(w)
        assert w.max() == 1.0 and (w > 0).all()
    # uniform priorities, beta=1: every weight is exactly the batch max
    replay_u = replay.replace(prio=jnp.full((256,), 0.5, jnp.float32))
    _, w = sample(replay_u, jax.random.key(0), 1.0)
    np.testing.assert_allclose(np.asarray(w), 1.0, rtol=1e-6)


def test_per_sample_with_replacement_exact(env):
    """Default PER sampler (with replacement, VERDICT r3 weak #3): unfilled
    rows are never drawn, duplicates occur (proving replacement), empirical
    group frequencies match the exact p_i, and the IS weights equal Schaul's
    (1/(N p_i))^beta max-normalized — exact because each draw really is an
    independent categorical with probability p_i."""
    from blockpuzzle_tpu.learn.dqn import Replay

    beta = 0.7
    cfg = DQNConfig(
        num_envs=8, buffer_size=256, batch_size=128, min_buffer=128,
        hidden=16, channels=(4,), per=True, per_alpha=1.0, per_eps=0.0,
    )
    dqn = DQN(env, cfg)
    prio = np.zeros(256, np.float32)
    prio[:64] = 3.0          # high-priority group
    prio[64:192] = 1.0       # low-priority group; rows 192+ unfilled
    replay = Replay(
        bytes_buf=jnp.zeros((256, 8), jnp.uint8),
        float_buf=jnp.zeros((256, 2), jnp.float32),
        cursor=jnp.zeros((), jnp.int32),
        filled=jnp.asarray(192, jnp.int32),
        prio=jnp.asarray(prio),
        max_prio=jnp.asarray(3.0, jnp.float32),
    )
    sample = jax.jit(dqn._per_sample)
    total = 64 * 3.0 + 128 * 1.0
    n_hi = dup = 0
    for seed in range(20):
        idx, w = sample(replay, jax.random.key(seed), beta)
        idx, w = np.asarray(idx), np.asarray(w)
        assert (idx < 192).all(), "sampled an unfilled slot"
        dup += 128 - len(set(idx.tolist()))
        n_hi += int((idx < 64).sum())
        # exact IS weights: p depends only on the group; max-normalize
        p = np.where(idx < 64, 3.0 / total, 1.0 / total)
        w_exp = (1.0 / (192.0 * p)) ** beta
        np.testing.assert_allclose(w, w_exp / w_exp.max(), rtol=1e-5)
    assert dup > 0, "no duplicates in 2560 draws — not with-replacement"
    emp = n_hi / (20 * 128)
    assert abs(emp - 192.0 / total) < 0.05, emp  # expect 0.6 +- noise
    # uniform priorities at beta=1: every weight exactly 1
    replay_u = replay.replace(prio=jnp.full((256,), 0.5, jnp.float32))
    _, w = sample(replay_u, jax.random.key(0), 1.0)
    np.testing.assert_allclose(np.asarray(w), 1.0, rtol=1e-6)


def test_dqn_per_trains_and_updates_priorities(env):
    cfg = DQNConfig(
        num_envs=16, buffer_size=512, batch_size=32, collect_steps=2,
        grad_steps=2, min_buffer=32, hidden=32, channels=(8,),
        eps_decay_iters=10, per=True,
    )
    dqn = DQN(env, cfg)
    state = dqn.init(jax.random.key(0))
    state, m = dqn.iteration_jit(state)  # fills 32 = min_buffer
    p0 = jax.tree.map(np.array, state.params)
    for _ in range(3):
        state, m = dqn.iteration_jit(state)
    assert float(m["loss"]) > 0.0
    prio = np.asarray(state.replay.prio)
    filled = int(state.replay.filled)
    # sampled rows got |td|+eps priorities: no longer all at max_prio
    assert len(np.unique(prio[:filled])) > 1
    assert (prio[filled:] == 0).all()
    assert float(state.replay.max_prio) >= 1.0
    diff = jax.tree.map(
        lambda x, y: float(np.abs(x - np.asarray(y)).max()), p0, state.params
    )
    assert max(jax.tree.leaves(diff)) > 0


def test_dqn_per_rejects_small_min_buffer(env):
    with pytest.raises(ValueError):
        DQN(env, DQNConfig(per=True, batch_size=64, min_buffer=32))
