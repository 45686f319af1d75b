"""The port's functional SNES, XNES, CEM and CMA-ES (full and separable)
against the JAX package's on the CPU: three generations each, the JAX
ask's own noise injected into the port's (through the private draw step
``distributions._draw_sampler_noise`` or ``funccmaes._draw_local_coordinates``),
the fitnesses computed on the host with numpy from the JAX population, so
both tells rank the same bits. The states cross between the packages with
``interop``'s ``*_state_from_numpy``.

Tolerances: populations to ``rtol=1e-6, atol=1e-6`` (XLA contracts ``mu
+ sigma * eps`` into an FMA); SNES and CEM states to ``rtol=1e-5,
atol=1e-6``; XNES (``matrix_exp`` against ``jax.scipy.linalg.expm``) and
full CMA-ES (a Cholesky factor every ``decompose_C_freq`` generations) to
``rtol=1e-4, atol=1e-5``. Configuration (popsize, mu, decomposition
frequency, flags): exact; the float32 constants (weights, learning rates)
to ``rtol=1e-6, atol=1e-7`` (``torch.log`` and XLA's ``log`` differ by an
ulp).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import evotorch_tpu.algorithms.functional as JF
import evotorch_tpu_torch.algorithms.functional as PF
from evotorch_tpu_torch import distributions, interop
from evotorch_tpu_torch.algorithms.functional import funccmaes

L, P = 6, 12
POP_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


def _fitness(x):
    x = np.asarray(x, dtype=np.float64)
    return (np.sum(x**2, axis=-1) + np.sum(np.cos(3 * x), axis=-1)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_state_numpy(state) -> dict:
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v) for f in dataclasses.fields(state) for v in [getattr(state, f.name)]}


def _assert_state_close(ours, theirs, fields, tol):
    for name in fields:
        np.testing.assert_allclose(_np(getattr(ours, name)), np.asarray(getattr(theirs, name)), err_msg=name, **tol)


SEARCHERS = {
    "snes": (JF.snes, JF.snes_ask, JF.snes_tell, PF.snes, PF.snes_ask, PF.snes_tell, dict(stdev_init=0.5), ("center", "stdev"), TOL),
    "snes_centered": (
        JF.snes, JF.snes_ask, JF.snes_tell, PF.snes, PF.snes_ask, PF.snes_tell,
        dict(radius_init=2.0, ranking_method="centered"), ("center", "stdev"), TOL,
    ),
    "cem": (
        JF.cem, JF.cem_ask, JF.cem_tell, PF.cem, PF.cem_ask, PF.cem_tell,
        dict(stdev_init=0.5, parenthood_ratio=0.5, stdev_max_change=0.2), ("center", "stdev"), TOL,
    ),
    "xnes": (JF.xnes, JF.xnes_ask, JF.xnes_tell, PF.xnes, PF.xnes_ask, PF.xnes_tell, dict(stdev_init=0.5), ("center", "A", "A_inv"), LOOSE),
}  # fmt: skip


@pytest.mark.parametrize("sense", ["min", "max"])
@pytest.mark.parametrize("name", list(SEARCHERS))
def test_three_generations_with_jax_noise(name, sense, monkeypatch):
    jinit, jask, jtell, pinit, pask, ptell, kw, fields, tol = SEARCHERS[name]
    center = np.random.default_rng(0).normal(size=L).astype(np.float32)
    jstate = jinit(center_init=center, objective_sense=sense, **kw)
    pstate = pinit(center_init=torch.from_numpy(center), objective_sense=sense, **kw)
    _assert_state_close(pstate, jstate, fields, TOL)
    for gen in range(3):
        key = jax.random.key(gen)
        jx = jask(key, jstate, popsize=P)
        eps = torch.from_numpy(np.array(jax.random.normal(key, (P, L))))
        monkeypatch.setattr(distributions, "_draw_sampler_noise", lambda *a: eps)
        px = pask(torch.Generator(), pstate, popsize=P)
        np.testing.assert_allclose(_np(px), np.asarray(jx), **POP_TOL)
        f = _fitness(jx)
        jstate = jtell(jstate, jx, f)
        pstate = ptell(pstate, px, torch.from_numpy(f))
        _assert_state_close(pstate, jstate, fields, tol)


CMAES_CONFIGS = {
    "full": dict(stdev_init=0.5),
    "separable": dict(stdev_init=0.5, separable=True),
    "full_passive_csa_squared": dict(stdev_init=0.5, active=False, csa_squared=True, popsize=10),
    "full_bounded_stdev": dict(stdev_init=0.5, stdev_min=0.3, stdev_max=0.6),
    "full_limited_decomposition": dict(stdev_init=0.5, c_1_ratio=0.05, c_mu_ratio=0.05),
}
CMAES_FIELDS = ("m", "sigma", "C", "A", "p_sigma", "p_c")


@pytest.mark.parametrize("sense", ["min", "max"])
@pytest.mark.parametrize("config", list(CMAES_CONFIGS))
def test_cmaes_generations_with_jax_noise(config, sense, monkeypatch):
    kw = CMAES_CONFIGS[config]
    d = 8
    center = np.random.default_rng(1).normal(size=d).astype(np.float32)
    jstate = JF.cmaes(center_init=center, objective_sense=sense, **kw)
    pstate = PF.cmaes(center_init=torch.from_numpy(center), objective_sense=sense, **kw)
    for name in ("popsize", "mu", "decompose_C_freq", "separable", "active", "csa_squared", "maximize"):
        assert getattr(pstate, name) == getattr(jstate, name), name
    for name in ("weights", "mu_eff", "c_sigma", "damp_sigma", "c_c", "c_1", "c_mu", "unbiased_expectation"):
        np.testing.assert_allclose(_np(getattr(pstate, name)), np.asarray(getattr(jstate, name)), rtol=1e-6, atol=1e-7, err_msg=name)
    generations = 3 if pstate.decompose_C_freq == 1 else pstate.decompose_C_freq + 1
    for gen in range(generations):
        key = jax.random.key(10 + gen)
        jstate, jx = JF.cmaes_ask(key, jstate)
        zs = torch.from_numpy(np.array(jax.random.normal(key, (jstate.popsize, d))))
        monkeypatch.setattr(funccmaes, "_draw_local_coordinates", lambda *a: zs)
        pstate, px = PF.cmaes_ask(torch.Generator(), pstate)
        np.testing.assert_allclose(_np(px), np.asarray(jx), **POP_TOL)
        f = _fitness(jx)
        A_before = pstate.A.clone()
        jstate = JF.cmaes_tell(jstate, jx, f)
        pstate = PF.cmaes_tell(pstate, px, torch.from_numpy(f))
        assert pstate.iteration == int(jstate.iteration) == gen + 1
        _assert_state_close(pstate, jstate, CMAES_FIELDS, LOOSE if not kw.get("separable") else TOL)
        refreshed = pstate.iteration % pstate.decompose_C_freq == 0
        assert torch.equal(pstate.A, A_before) != refreshed or torch.equal(pstate.C, torch.eye(d))


@pytest.mark.parametrize("d", [2, 10, 50, 200, 1000])
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("limit", [True, False])
def test_cmaes_decomposition_frequency_rule(d, separable, limit):
    """``decompose_C_freq = max(1, floor(1 / (10 d (c_1 + c_mu))))`` with
    the limit on, 1 with it off: equal to the JAX package's."""
    kw = dict(stdev_init=1.0, objective_sense="min", separable=separable, limit_C_decomposition=limit)
    theirs = JF.cmaes(center_init=np.zeros(d, np.float32), **kw).decompose_C_freq
    ours = PF.cmaes(center_init=torch.zeros(d), **kw).decompose_C_freq
    assert ours == theirs
    if not limit:
        assert ours == 1


@pytest.mark.parametrize("name", ["snes", "xnes", "cem", "cmaes", "ga", "mapelites"])
def test_states_cross_from_jax_through_numpy(name):
    """A JAX state, flattened to numpy, becomes the port's state and back."""
    center = np.linspace(-1, 1, L).astype(np.float32)
    if name == "snes":
        jstate = JF.snes(center_init=center, objective_sense="min", stdev_init=0.3)
    elif name == "xnes":
        jstate = JF.xnes(center_init=center, objective_sense="max", stdev_init=0.3)
    elif name == "cem":
        jstate = JF.cem(center_init=center, objective_sense="min", stdev_init=0.3, parenthood_ratio=0.25)
    elif name == "cmaes":
        jstate = JF.cmaes(center_init=center, objective_sense="min", stdev_init=0.3)
        jstate, x = JF.cmaes_ask(jax.random.key(0), jstate)
        jstate = JF.cmaes_tell(jstate, x, _fitness(x))
    elif name == "ga":
        values = np.random.default_rng(2).normal(size=(8, L)).astype(np.float32)
        jstate = JF.ga(values_init=values, evals_init=np.stack([_fitness(values), -_fitness(values)], 1), objective_sense=["min", "max"])
    else:
        values = np.random.default_rng(3).normal(size=(8, L)).astype(np.float32)
        evals = np.concatenate([_fitness(values)[:, None], values[:, :2]], axis=1)
        grid = np.asarray([[[-np.inf, 0.0], [-np.inf, np.inf]], [[0.0, np.inf], [-np.inf, np.inf]]], np.float32)
        jstate = JF.mapelites(values_init=values, evals_init=evals, feature_grid=grid, objective_sense="min")
    arrays = _jax_state_numpy(jstate)
    port = getattr(interop, f"{name}_state_from_numpy")(arrays, device="cpu")
    back = getattr(interop, f"{name}_state_to_numpy")(port)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        else:
            assert back[k] == (tuple(v) if isinstance(v, list) else v), k


@pytest.mark.parametrize("length", [1, 2, 3, 7, 10, 100, 12_305, 98_321])
def test_snes_default_popsize(length):
    """``funcsnes.default_popsize``, ``4 + floor(3 log n)``, equal to the
    JAX package's at each length."""
    from evotorch_tpu.algorithms.functional import funcsnes as jax_funcsnes
    from evotorch_tpu_torch.algorithms.functional import funcsnes

    assert funcsnes.default_popsize(length) == jax_funcsnes.default_popsize(length)
