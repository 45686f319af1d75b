"""The port's batching engine and batched functional searches against the
JAX package's on the CPU: ``expects_ndim`` / ``rowwise`` / ``vectorized``,
``make_functional_sampler``, ``make_functional_grad_estimator`` (batched
parameters, and bound to a ``function=``), batched CEM, SNES and XNES, and
``make_search_span``.

The JAX package gives each lane of a batch its own key (``split(key,
lanes)``); the port draws one ``(*batch, ...)`` tensor. The tests replay
the JAX lanes' noise into the port through the private draw step
``distributions._draw_sampler_noise``.

Tolerances: ``expects_ndim`` results exactly (the same elementwise
operations); populations to ``rtol=1e-6, atol=1e-6`` (XLA contracts ``mu +
sigma * eps`` into an FMA); gradients and CEM/SNES states to ``rtol=1e-5,
atol=1e-6``, and ``atol=1e-5`` for the gradients of ``"raw"`` weights (the
fitnesses themselves, ~20 here: the sums cancel to ~0.1, so their float32
round-off in another summation order is ~1e-5 absolute); XNES states (``matrix_exp`` against ``expm``) to ``rtol=1e-4,
atol=1e-5``; a span against a hand-written loop of the port's own calls:
bit for bit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evotorch_tpu.algorithms.functional as JF
import evotorch_tpu.decorators as jax_decorators
import evotorch_tpu.distributions as jax_distributions
import evotorch_tpu_torch.algorithms.functional as PF
from evotorch_tpu_torch import decorators, distributions, vectorized
from evotorch_tpu_torch.core import Problem

POP_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
B, P, L = 3, 10, 5


def _np(x):
    return x.detach().cpu().numpy()


def _lane_noise(key, batch, rows, length):
    """The JAX functional sampler's noise: one key per lane."""
    keys = jax.random.split(key, int(np.prod(batch)))
    eps = np.stack([np.asarray(jax.random.normal(k, (rows, length))) for k in keys])
    return torch.from_numpy(eps.reshape(tuple(batch) + (rows, length)))


def _ndim_fn(xp):
    def f(x, y, scale, shift=0.0):
        return xp.sum(x * y, axis=-1) * scale + shift, x * y

    return f


CALLS = {
    "batched_x": lambda a: ((a(np.ones((3, 4), np.float32) * np.arange(4, dtype=np.float32)), a(np.float32(2.0)), 3.0), {}),
    "broadcast": lambda a: ((a(np.random.default_rng(0).normal(size=(3, 1, 4)).astype(np.float32)), a(np.arange(2, dtype=np.float32)), 0.5), {}),
    "kwargs_bind": lambda a: ((a(np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)),), dict(y=a(np.float32(3.0)), scale=2.0, shift=1.0)),
    "python_scalar": lambda a: ((a(np.random.default_rng(2).normal(size=(2, 4)).astype(np.float32)), 1.5, 2.0), {}),
    "no_batch": lambda a: ((a(np.arange(4, dtype=np.float32)), a(np.float32(2.0)), 1.0), {}),
}  # fmt: skip


@pytest.mark.parametrize("case", list(CALLS))
def test_expects_ndim_equals_jax(case):
    ours_fn = decorators.expects_ndim(1, 0, None)(_ndim_fn(torch))
    theirs_fn = jax_decorators.expects_ndim(1, 0, None)(_ndim_fn(jnp))
    args, kwargs = CALLS[case](torch.as_tensor)
    jargs, jkwargs = CALLS[case](jnp.asarray)
    ours, theirs = ours_fn(*args, **kwargs), theirs_fn(*jargs, **jkwargs)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_expects_ndim_scalars_follow_the_float_dtype_and_refuse_too_few_dims():
    f = decorators.expects_ndim(1, 0)(lambda x, s: x * s)
    out = f(torch.ones(2, 3, dtype=torch.float64), 0.1)
    assert out.dtype == torch.float64 and out.shape == (2, 3)
    assert float(out[0, 0]) == 0.1
    with pytest.raises(ValueError, match="fewer than"):
        f(torch.tensor(1.0), 2.0)
    g = decorators.expects_ndim(1, 1, allow_smaller_ndim=True)(lambda x, y: x + y)
    assert g(torch.ones(2, 3), torch.tensor(1.0)).shape == (2, 3)


def test_rowwise_and_vectorized_mark_fitness_functions():
    @decorators.rowwise
    def norm(x):
        return torch.sqrt(torch.sum(x**2))

    assert norm.__evotorch_vectorized__ and norm.__evotorch_rowwise__
    torch.testing.assert_close(norm(torch.ones(4, 9)), torch.full((4,), 3.0))

    @vectorized
    def sphere(x):
        return torch.sum(x**2, dim=-1)

    problem = Problem("min", sphere, solution_length=3, initial_bounds=(-1, 1), device="cpu")
    assert problem._vectorized
    for name in ("on_cuda", "on_aux_device"):
        fn = getattr(decorators, name)(lambda x: x)
        assert hasattr(fn, "__evotorch_on_device__")


DISTS = {
    "separable": ("SeparableGaussian", lambda mu: {"mu": mu, "sigma": torch.full_like(mu, 0.7)}),
    "symmetric": ("SymmetricSeparableGaussian", lambda mu: {"mu": mu, "sigma": torch.full_like(mu, 0.7)}),
    "exp_separable": ("ExpSeparableGaussian", lambda mu: {"mu": mu, "sigma": torch.full_like(mu, 0.7)}),
    "exp_full": (
        "ExpGaussian",
        lambda mu: {"mu": mu, "sigma": torch.eye(L) * 0.7 + 0.05, "sigma_inv": torch.linalg.inv(torch.eye(L) * 0.7 + 0.05)},
    ),
}


@pytest.mark.parametrize("batch", [(), (B,), (2, 2)])
@pytest.mark.parametrize("dist", list(DISTS))
def test_functional_sampler_and_grad_estimator_equal_jax(dist, batch, monkeypatch):
    name, make = DISTS[dist]
    ours_cls, theirs_cls = getattr(distributions, name), getattr(jax_distributions, name)
    mu = torch.from_numpy(np.random.default_rng(3).normal(size=batch + (L,)).astype(np.float32))
    params = make(mu)
    jparams = {k: jnp.asarray(_np(v)) for k, v in params.items()}
    key = jax.random.key(5)
    theirs = jax_distributions.make_functional_sampler(theirs_cls)(key, P, jparams)
    rows = P // 2 if ours_cls.SAMPLES_MUST_BE_EVEN else P
    eps = _lane_noise(key, batch, rows, L) if batch else torch.from_numpy(np.array(jax.random.normal(key, (rows, L))))
    monkeypatch.setattr(distributions, "_draw_sampler_noise", lambda *a: eps)
    ours = distributions.make_functional_sampler(ours_cls)(torch.Generator(), P, params)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **POP_TOL)

    fitnesses = np.sum(np.asarray(theirs) ** 2, axis=-1).astype(np.float32)
    for method in ("raw", "centered", "nes"):
        kw = dict(objective_sense="min", ranking_method=method)
        g_ours = distributions.make_functional_grad_estimator(ours_cls, **kw)(ours, torch.from_numpy(fitnesses), params)
        g_theirs = jax_distributions.make_functional_grad_estimator(theirs_cls, **kw)(theirs, fitnesses, jparams)
        assert set(g_ours) == set(g_theirs)
        for k in g_ours:
            tol = dict(TOL, atol=1e-5) if method == "raw" else TOL
            np.testing.assert_allclose(_np(g_ours[k]), np.asarray(g_theirs[k]), err_msg=f"{method} {k}", **tol)

    # bound to a fitness function: samples, evaluates, estimates
    kw = dict(objective_sense="max", ranking_method="centered", return_samples=True, return_fitnesses=True)
    bound_ours = distributions.make_functional_grad_estimator(ours_cls, function=lambda x: -torch.sum(x**2, dim=-1), **kw)
    bound_theirs = jax_distributions.make_functional_grad_estimator(theirs_cls, function=lambda x: -jnp.sum(x**2, axis=-1), **kw)
    (g_ours, s_ours, f_ours), (g_theirs, s_theirs, f_theirs) = (
        bound_ours(torch.Generator(), P, params), bound_theirs(key, P, jparams)
    )
    np.testing.assert_allclose(_np(s_ours), np.asarray(s_theirs), **POP_TOL)
    np.testing.assert_allclose(_np(f_ours), np.asarray(f_theirs), **TOL)
    for k in g_ours:
        np.testing.assert_allclose(_np(g_ours[k]), np.asarray(g_theirs[k]), err_msg=k, **TOL)


def _fitness(x):
    return (np.sum(np.asarray(x, np.float64) ** 2, axis=-1)).astype(np.float32)


BATCHED = {
    "cem": (JF.cem, JF.cem_ask, JF.cem_tell, PF.cem, PF.cem_ask, PF.cem_tell, dict(parenthood_ratio=0.5, stdev_init=2.0, stdev_max_change=0.2), ("center", "stdev"), TOL),
    "snes": (JF.snes, JF.snes_ask, JF.snes_tell, PF.snes, PF.snes_ask, PF.snes_tell, dict(radius_init=np.array([1.0, 2.0, 3.0], np.float32)), ("center", "stdev"), TOL),
    "xnes": (JF.xnes, JF.xnes_ask, JF.xnes_tell, PF.xnes, PF.xnes_ask, PF.xnes_tell, dict(stdev_init=np.array([0.5, 1.0, 1.5], np.float32)), ("center", "A", "A_inv"), LOOSE),
}  # fmt: skip


@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_searches_equal_jax(name, monkeypatch):
    """Three lanes, each its own search (the stdev or radius per lane), three
    generations with the JAX lanes' noise."""
    jinit, jask, jtell, pinit, pask, ptell, kw, fields, tol = BATCHED[name]
    centers = np.random.default_rng(6).normal(size=(B, L)).astype(np.float32) * 3
    jstate = jinit(center_init=centers, objective_sense="min", **kw)
    pstate = pinit(center_init=torch.from_numpy(centers), objective_sense="min", **kw)
    for gen in range(3):
        key = jax.random.key(20 + gen)
        jx = jask(key, jstate, popsize=P)
        eps = _lane_noise(key, (B,), P, L)
        monkeypatch.setattr(distributions, "_draw_sampler_noise", lambda *a: eps)
        px = pask(torch.Generator(), pstate, popsize=P)
        np.testing.assert_allclose(_np(px), np.asarray(jx), **POP_TOL)
        f = _fitness(jx)
        jstate, pstate = jtell(jstate, jx, f), ptell(pstate, px, torch.from_numpy(f))
        for field in fields:
            np.testing.assert_allclose(_np(getattr(pstate, field)), np.asarray(getattr(jstate, field)), err_msg=field, **tol)


def test_search_span_equals_a_loop_and_jax(monkeypatch):
    """``examples/functional_batched_search.py`` at a small size: a span of
    CEM searches equals the same calls in a loop bit for bit, and the JAX
    span with the noise of its keys."""
    gens = 4
    centers = np.random.default_rng(7).normal(size=(B, L)).astype(np.float32) * 3
    kw = dict(parenthood_ratio=0.5, objective_sense="min", stdev_init=2.0, stdev_max_change=0.2)

    def sphere(x):
        return torch.sum(x**2, dim=-1)

    def metrics(pop, fit):
        return {"best": torch.amin(fit, dim=-1), "mean": torch.mean(fit, dim=-1)}

    span = PF.make_search_span(sphere, ask=partial(PF.cem_ask, popsize=P), tell=PF.cem_tell, metrics=metrics)
    state, ys = span(PF.cem(center_init=torch.from_numpy(centers), **kw), [torch.Generator().manual_seed(1)] * gens)
    loop_state, g = PF.cem(center_init=torch.from_numpy(centers), **kw), torch.Generator().manual_seed(1)
    best = []
    for _ in range(gens):
        pop = PF.cem_ask(g, loop_state, popsize=P)
        fit = sphere(pop)
        loop_state = PF.cem_tell(loop_state, pop, fit)
        best.append(torch.amin(fit, dim=-1))
    assert torch.equal(state.center, loop_state.center) and torch.equal(state.stdev, loop_state.stdev)
    assert torch.equal(ys["best"], torch.stack(best)) and ys["mean"].shape == (gens, B)

    keys = jax.random.split(jax.random.key(1), gens)
    jspan = JF.make_search_span(
        lambda x: jnp.sum(x**2, axis=-1), ask=partial(JF.cem_ask, popsize=P), tell=JF.cem_tell,
        metrics=lambda pop, fit: jnp.min(fit, axis=-1),
    )  # fmt: skip
    jstate, jys = jspan(JF.cem(center_init=centers, **kw), keys)
    draws = iter([_lane_noise(k, (B,), P, L) for k in keys])
    monkeypatch.setattr(distributions, "_draw_sampler_noise", lambda *a: next(draws))
    span = PF.make_search_span(
        sphere, ask=partial(PF.cem_ask, popsize=P), tell=PF.cem_tell, metrics=lambda pop, fit: torch.amin(fit, dim=-1)
    )
    state, ys = span(PF.cem(center_init=torch.from_numpy(centers), **kw), [torch.Generator()] * gens)
    np.testing.assert_allclose(_np(ys), np.asarray(jys), **TOL)
    np.testing.assert_allclose(_np(state.center), np.asarray(jstate.center), **TOL)
    np.testing.assert_allclose(_np(state.stdev), np.asarray(jstate.stdev), **TOL)
