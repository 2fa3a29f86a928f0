"""The plain-JAX policy/value networks: param paths the tensor-parallel
rules match, exact masking, shapes and dtypes, and init determinism."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from blockpuzzle_tpu import dist
from blockpuzzle_tpu.config import default_config
from blockpuzzle_tpu.env import make_env
from blockpuzzle_tpu.learn.networks import NEG_INF, ActorCritic, QNetwork

CFG = default_config()
ENV = make_env(CFG)


def _obs(n=8, lead=()):
    state, ts = ENV.init(jax.random.key(0), n)
    state, ts = ENV.step(state, jnp.argmax(ts.action_mask, axis=-1))
    board, queue, mask = ts.board, ts.queue, ts.action_mask
    if lead:
        tile = lambda x: jnp.broadcast_to(x, lead + x.shape)
        board, queue, mask = tile(board), tile(queue), tile(mask)
    return board, queue, mask


def _flat_specs(params):
    return {
        "/".join(str(k.key) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            dist.param_spec(params), is_leaf=lambda x: isinstance(x, P)
        )[0]
    }


@pytest.mark.parametrize("net", [
    ActorCritic(CFG, ENV.num_pieces),
    ActorCritic(CFG, ENV.num_pieces, arch="mlp"),
    QNetwork(CFG, ENV.num_pieces, dueling=True),
], ids=["ac-conv", "ac-mlp", "q-dueling"])
def test_param_rules_match_every_dense_kernel(net):
    """PARAM_RULES is the only record of the tp layout: every dense kernel
    gets its column/row split, everything else replicates."""
    specs = _flat_specs(net.init(jax.random.key(0)))
    want = {
        "params/Torso_0/hidden_proj/kernel": P(None, "tp"),
        "params/Head_0/kernel": P("tp", None),
        "params/Head_1/kernel": P("tp", None),
    }
    if net.arch == "mlp":
        want["params/Torso_0/mlp_0/kernel"] = P(None, "tp")
    for path, spec in specs.items():
        assert spec == want.get(path, P()), path
    assert set(want) <= set(specs)


@pytest.mark.parametrize("net", [
    ActorCritic(CFG, ENV.num_pieces),
    QNetwork(CFG, ENV.num_pieces),
    QNetwork(CFG, ENV.num_pieces, arch="mlp", dueling=True),
], ids=["ac", "q", "q-dueling"])
def test_illegal_actions_are_exactly_neg_inf(net):
    board, queue, mask = _obs()
    out = net.apply(net.init(jax.random.key(1)), board, queue, mask)
    logits = np.asarray(out[0] if isinstance(out, tuple) else out)
    mask = np.asarray(mask)
    assert (logits[~mask] == np.float32(NEG_INF)).all()
    assert (logits[mask] > NEG_INF / 2).all()


@pytest.mark.parametrize("arch", ["conv", "mlp"])
@pytest.mark.parametrize("queue_mode", ["embed", "planes"])
def test_forward_shapes_and_dtypes(arch, queue_mode):
    """(B, A) f32 logits and (B,) f32 values, also under extra leading
    batch dims (time-major rollout batches)."""
    net = ActorCritic(CFG, ENV.num_pieces, arch=arch, queue_mode=queue_mode,
                      channels=(4, 8), hidden=32, mlp_width=64)
    params = net.init(jax.random.key(2))
    for lead in ((), (3,)):
        logits, value = net.apply(params, *_obs(8, lead))
        assert logits.shape == lead + (8, CFG.num_actions())
        assert value.shape == lead + (8,)
        assert logits.dtype == value.dtype == jnp.float32


def test_unknown_arch_and_queue_mode_rejected():
    with pytest.raises(ValueError, match="arch"):
        ActorCritic(CFG, ENV.num_pieces, arch="transformer").init(
            jax.random.key(0))
    with pytest.raises(ValueError, match="queue_mode"):
        QNetwork(CFG, ENV.num_pieces, queue_mode="bag").init(
            jax.random.key(0))


def test_init_is_a_function_of_the_key():
    net = ActorCritic(CFG, ENV.num_pieces, channels=(4,), hidden=16)
    a, b = net.init(jax.random.key(5)), net.init(jax.random.key(5))
    c = net.init(jax.random.key(6))
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    assert all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(c)))
