"""Parity of the port's population policy forward (``FlatParamsPolicy`` over
``tanh_mlp``) with the JAX package at the flagship width (109 -> 64 -> 64 ->
17, L = 12,305), on the CPU, plus the flat-layout check of ``interop``.

Tolerance: ``atol=2e-5`` on outputs of magnitude ~10. The products sum 109
and 64 float32 terms in a different order in the two packages (a few ulps
of the partial sums, ~1e-6 relative), and tanh passes the differences on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import tanh_mlp as jax_tanh_mlp
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp

OBS, ACT, HIDDEN = 109, 17, [64, 64]


def _policies():
    return JaxFlatParamsPolicy(jax_tanh_mlp(OBS, ACT, HIDDEN)), FlatParamsPolicy(tanh_mlp(OBS, ACT, HIDDEN))


def _jax_leaf_shapes(jax_policy, flat):
    return [leaf.shape for leaf in jax.tree_util.tree_leaves(jax_policy.unravel(jnp.asarray(flat)))]


def test_flagship_parameter_count_and_layout():
    jax_policy, policy = _policies()
    assert policy.parameter_count == jax_policy.parameter_count == 12305
    flat = np.arange(policy.parameter_count, dtype=np.float32)
    shapes = _jax_leaf_shapes(jax_policy, flat)
    assert [shape for _, shape, _ in policy.layout] == [tuple(s) for s in shapes]
    # every leaf view reads the same numbers as the JAX unravel
    views = policy.unravel(torch.from_numpy(flat)[None])
    for view, leaf in zip(views, jax.tree_util.tree_leaves(jax_policy.unravel(jnp.asarray(flat)))):
        np.testing.assert_array_equal(view[0].numpy(), np.asarray(leaf))


def test_population_forward_matches_jax():
    jax_policy, policy = _policies()
    rng = np.random.default_rng(0)
    popsize = 16
    params = (0.3 * rng.normal(size=(popsize, policy.parameter_count))).astype(np.float32)
    obs = rng.normal(size=(popsize, OBS)).astype(np.float32)
    expected = np.asarray(jax.vmap(lambda p, o: jax_policy(p, o)[0])(jnp.asarray(params), jnp.asarray(obs)))
    leaf_shapes = _jax_leaf_shapes(jax_policy, params[0])
    got, state = policy(interop.policy_params_from_numpy(policy, params, leaf_shapes, device="cpu"), torch.from_numpy(obs))
    assert state is None
    assert got.shape == (popsize, ACT)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(interop.policy_params_to_numpy(policy, torch.from_numpy(params)), params)


def test_linear_without_bias_matches_jax():
    from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
    from evotorch_tpu.neuroevolution.net import Tanh as JaxTanh
    from evotorch_tpu_torch.neuroevolution.net import Linear, Tanh

    jax_policy = JaxFlatParamsPolicy(JaxLinear(5, 3, bias=False) >> JaxTanh())
    policy = FlatParamsPolicy(Linear(5, 3, bias=False) >> Tanh())
    rng = np.random.default_rng(1)
    params = rng.normal(size=(4, 15)).astype(np.float32)
    obs = rng.normal(size=(4, 5)).astype(np.float32)
    expected = np.asarray(jax.vmap(lambda p, o: jax_policy(p, o)[0])(jnp.asarray(params), jnp.asarray(obs)))
    got = policy(torch.from_numpy(params), torch.from_numpy(obs))[0].numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-6)


def test_layout_mismatch_is_refused():
    jax_policy, policy = _policies()
    flat = np.zeros(policy.parameter_count, dtype=np.float32)
    shapes = _jax_leaf_shapes(jax_policy, flat)
    with pytest.raises(ValueError):
        interop.policy_params_from_numpy(policy, flat, shapes[::-1], device="cpu")
    with pytest.raises(ValueError):
        interop.policy_params_from_numpy(policy, flat[:-1], shapes, device="cpu")
