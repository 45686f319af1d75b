"""The policy factories of ``models/policies.py`` in the port against the JAX
package, on the CPU: each factory's parameter count exactly (the layouts
leaf for leaf), and its forward on the JAX ``init``'s flat vectors, two
steps for the recurrent ones (the second from the first's state), within
``rtol=1e-5, atol=1e-6`` (float32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import evotorch_tpu.models as JM
import evotorch_tpu_torch.models as PM
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy
from evotorch_tpu_torch.neuroevolution.net.layers import map_state

OBS, ACT, POP = 11, 3, 4

FACTORIES = {
    "LinearPolicy": dict(),
    "MLPPolicy": dict(hidden=(16, 8)),
    "RNNPolicy": dict(hidden_size=6),
    "LSTMPolicy": dict(hidden_size=5),
    "structured_control_policy": dict(num_layers=2, hidden_size=7),
    "locomotor_policy": dict(num_sinusoids=4),
}
#: the parameter counts worked out by hand, each factory at (11, 3)
COUNTS = {
    "LinearPolicy": 3 * 12,
    "MLPPolicy": 16 * 12 + 8 * 17 + 3 * 9,
    "RNNPolicy": 6 * (11 + 6 + 2) + 3 * 7,
    "LSTMPolicy": 4 * 5 * (11 + 5 + 2) + 3 * 6,
    "structured_control_policy": 3 * 12 + 7 * 12 + 7 * 8 + 3 * 8,
    "locomotor_policy": 4 + 3 * 12 + 4 * 3 * 12,
}


def _close(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_matches_jax(name):
    jax_module = getattr(JM, name)(OBS, ACT, **FACTORIES[name])
    module = getattr(PM, name)(OBS, ACT, **FACTORIES[name])
    flats = np.stack([np.asarray(ravel_pytree(jax_module.init(jax.random.key(i)))[0]) for i in range(POP)]).astype(np.float32)
    shapes = [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(jax_module.init(jax.random.key(0)))]
    policy = FlatParamsPolicy(module)
    assert policy.parameter_count == flats.shape[1] == COUNTS[name]
    assert [shape for _, shape, _ in policy.layout] == shapes
    jax_policy = JaxFlatParamsPolicy(jax_module)
    rng = np.random.default_rng(0)
    state, jstate = None, None
    for _ in range(2 if module.is_stateful else 1):
        x = rng.normal(size=(POP, OBS)).astype(np.float32)
        y, state = policy(torch.from_numpy(flats), torch.from_numpy(x), state)
        if jstate is None:
            jy, jstate = jax.vmap(lambda p, o: jax_policy(p, o))(jnp.asarray(flats), jnp.asarray(x))
        else:
            jy, jstate = jax.vmap(jax_policy)(jnp.asarray(flats), jnp.asarray(x), jstate)
        assert y.shape == (POP, ACT)
        _close(y, jy)
    if module.is_stateful:
        jax_leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jstate)]
        ours = []
        map_state(lambda t: ours.append(t.numpy()), state)
        assert len(ours) == len(jax_leaves)
        for a, b in zip(ours, jax_leaves):
            _close(a, b)


def test_mlp_policy_activations():
    module = PM.MLPPolicy(OBS, ACT, hidden=(8,), activation=torch.relu, final_activation=torch.tanh)
    jax_module = JM.MLPPolicy(OBS, ACT, hidden=(8,), activation=jax.nn.relu, final_activation=jnp.tanh)
    flats = np.asarray(ravel_pytree(jax_module.init(jax.random.key(3)))[0], dtype=np.float32)[None].repeat(2, 0)
    x = np.random.default_rng(1).normal(size=(2, OBS)).astype(np.float32)
    y, _ = FlatParamsPolicy(module)(torch.from_numpy(flats), torch.from_numpy(x))
    jy, _ = jax.vmap(lambda p, o: JaxFlatParamsPolicy(jax_module)(p, o))(jnp.asarray(flats), jnp.asarray(x))
    _close(y, jy)
    assert float(y.abs().max()) <= 1.0


def test_the_gymne_benchmark_policy_has_5123_parameters():
    """``bench_common.py``'s real-MuJoCo configuration: the 64-64 tanh MLP
    on Hopper's 11 observations and 3 actions."""
    assert FlatParamsPolicy(PM.MLPPolicy(11, 3)).parameter_count == 5_123
