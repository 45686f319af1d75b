"""The port's variation operators (``operators/functional.py``) against the
JAX package's on the CPU, with the JAX package's own draws given to the
port's deterministic cores. The draws are replayed here from the JAX key
the way each JAX operator splits and consumes it.

Tolerances:
- Selections (tournament winners, cut points, permutations, take_best):
  exact.
- SBX, the Gaussian and polynomial mutations: ``rtol=1e-6, atol=1e-6``
  (``pow`` and contracted multiply-adds round differently by an ulp or
  two; ``atol`` covers children near 0 after cancellation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.operators import functional as JF
from evotorch_tpu_torch.operators import functional as F

N, L = 24, 7
TOL = dict(rtol=1e-6, atol=1e-6)


def _values(seed, shape=(N, L)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _evals(seed, n=N, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 4, size=n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy()


def _tournament_draws(key, half, size, n):
    k1, k2 = jax.random.split(key)
    return (
        _t(jax.random.randint(k1, (half, size), 0, n)).long(),
        _t(jax.random.randint(k2, (half, size), 0, n - 1)).long(),
    )


@pytest.mark.parametrize("sense", ["min", "max"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("size", [2, 4])
def test_tournament_core_selects_as_jax(sense, ties, size):
    values, evals = _values(0), _evals(1, ties=ties)
    key = jax.random.key(3)
    theirs = JF.tournament(
        key, values, evals, num_tournaments=16, tournament_size=size, objective_sense=sense, return_indices=True
    )
    utilities = F.utility(_t(evals), objective_sense=sense)
    np.testing.assert_array_equal(_np(utilities), np.asarray(JF.utility(evals, objective_sense=sense)))
    ours = F._tournament_core(utilities, *_tournament_draws(key, 8, size, N))
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))


def test_tournament_result_forms(monkeypatch):
    """Values, evals and the split forms pick the rows of the indices."""
    values, evals = _values(0), _evals(1)
    key = jax.random.key(5)
    draws = _tournament_draws(key, 4, 3, N)
    monkeypatch.setattr(F, "_draw_tournament", lambda *a: draws)
    kw = dict(num_tournaments=8, tournament_size=3, objective_sense="max")
    g = torch.Generator()
    ours = F.tournament(g, _t(values), _t(evals), with_evals=True, split_results=True, **kw)
    theirs = JF.tournament(key, values, evals, with_evals=True, split_results=True, **kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    picked, picked_evals = F.tournament(g, _t(values), _t(evals), with_evals=True, **kw)
    np.testing.assert_array_equal(_np(picked), np.asarray(JF.tournament(key, values, evals, **kw)))
    np.testing.assert_array_equal(_np(picked_evals), np.asarray(JF.tournament(key, values, evals, with_evals=True, **kw)[1]))


def test_tournament_routes_through_the_centered_rank(monkeypatch):
    """A single-objective tournament ranks its candidates with the
    centered-rank entry point, the one that launches the kernel on the
    card."""
    from evotorch_tpu_torch.ops import ranking
    from evotorch_tpu_torch.tools import ranking as tools_ranking

    calls = []
    real = ranking.centered_rank

    def spy(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(tools_ranking, "centered_rank", spy)
    F.tournament(torch.Generator(), _t(_values(0)), _t(_evals(1)), num_tournaments=8, tournament_size=2, objective_sense="min")
    assert calls == [(N,)]


@pytest.mark.parametrize("num_points", [1, 2, 3])
def test_kpoint_crossover_core_equals_jax(num_points):
    parents = _values(2)
    key = jax.random.key(7)
    theirs = JF.multi_point_cross_over(key, parents, num_points=num_points)
    _, sub = jax.random.split(key)
    cuts = _t(jax.random.randint(sub, (N // 2, num_points), 1, L)).long()
    ours = F._kpoint_crossover_core(_t(parents[: N // 2]), _t(parents[N // 2 :]), cuts)
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))


def test_sbx_core_equals_jax():
    parents = _values(3)
    key = jax.random.key(11)
    theirs = JF.simulated_binary_cross_over(key, parents, eta=8.0)
    _, sub = jax.random.split(key)
    u = _t(jax.random.uniform(sub, (N // 2, L), dtype=jnp.float32))
    ours = F._sbx_core(_t(parents[: N // 2]), _t(parents[N // 2 :]), torch.tensor(8.0), u)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)


def test_sbx_with_tournament_equals_jax(monkeypatch):
    """SBX whose parents come by tournament: the tournament's draws, then
    the crossover's, each from its own split of the key."""
    parents, evals = _values(4), _evals(5)
    key = jax.random.key(13)
    theirs = JF.simulated_binary_cross_over(
        key, parents, evals, eta=4.0, tournament_size=3, num_children=10, objective_sense="min"
    )
    key1, sub = jax.random.split(key)
    _, sub2 = jax.random.split(key1)
    monkeypatch.setattr(F, "_draw_tournament", lambda *a: _tournament_draws(sub, 5, 3, N))
    monkeypatch.setattr(F, "_draw_uniform", lambda *a: _t(jax.random.uniform(sub2, (5, L), dtype=jnp.float32)))
    ours = F.simulated_binary_cross_over(
        torch.Generator(), _t(parents), _t(evals), eta=4.0, tournament_size=3, num_children=10, objective_sense="min"
    )
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("probability", [None, 0.3])
def test_gaussian_mutation_core_equals_jax(probability):
    values = _values(6)
    key = jax.random.key(17)
    theirs = JF.gaussian_mutation(key, values, stdev=0.3, mutation_probability=probability)
    if probability is None:
        z, gate = jax.random.normal(key, values.shape, dtype=jnp.float32), None
    else:
        k1, k2 = jax.random.split(key)
        z = jax.random.normal(k1, values.shape, dtype=jnp.float32)
        gate = _t(jax.random.uniform(k2, values.shape)) < probability
    ours = F._gaussian_mutation_core(_t(values), torch.tensor(0.3), _t(z), gate)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("probability", [None, 0.5])
def test_polynomial_mutation_core_equals_jax(probability):
    values = np.clip(_values(7), -1.9, 1.9)
    lb, ub = np.full(L, -2.0, np.float32), np.full(L, 2.0, np.float32)
    key = jax.random.key(19)
    theirs = JF.polynomial_mutation(key, values, lb=lb, ub=ub, eta=15.0, mutation_probability=probability)
    if probability is None:
        u, gate = jax.random.uniform(key, values.shape, dtype=jnp.float32), None
    else:
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, values.shape, dtype=jnp.float32)
        gate = _t(jax.random.uniform(k2, values.shape)) < probability
    ours = F._polynomial_mutation_core(_t(values), _t(lb), _t(ub), torch.tensor(15.0), _t(u), gate)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("sense", ["min", "max"])
def test_cosyne_permutations_equal_jax(sense):
    values, evals = _values(8), _evals(9)
    key = jax.random.key(23)
    full = JF.cosyne_permutation(key, values, permute_all=True)
    ours = F._cosyne_full_permutation_core(_t(values), _t(jax.random.uniform(key, (N, L))))
    np.testing.assert_array_equal(_np(ours), np.asarray(full))
    partial = JF.cosyne_permutation(key, values, evals, permute_all=False, objective_sense=sense)
    k1, k2 = jax.random.split(key)
    ours = F._cosyne_partial_permutation_core(
        _t(values), _t(evals), sense, _t(jax.random.uniform(k1, (N, L))), _t(jax.random.uniform(k2, (N, L)))
    )
    np.testing.assert_array_equal(_np(ours), np.asarray(partial))
    # a full permutation keeps each column's values
    np.testing.assert_array_equal(np.sort(np.asarray(full), axis=0), np.sort(values, axis=0))


@pytest.mark.parametrize("sense", ["min", "max"])
@pytest.mark.parametrize("n", [None, 1, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_take_best_and_combine_equal_jax(sense, n, ties):
    values, evals = _values(10), _evals(11, ties=ties)
    merged = F.combine((_t(values[:10]), _t(evals[:10])), (_t(values[10:]), _t(evals[10:])), objective_sense=sense)
    theirs = JF.combine((values[:10], evals[:10]), (values[10:], evals[10:]), objective_sense=sense)
    for a, b in zip(merged, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    ours = F.take_best(*merged, n, objective_sense=sense)
    theirs = JF.take_best(*theirs, n, objective_sense=sense)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_batched_operators_draw_per_lane():
    """Extra leading dimensions are lanes with independent draws: each lane
    equals the unbatched core on its slice of the draws."""
    values = _t(_values(12, (3, N, L)))
    g = torch.Generator().manual_seed(0)
    out = F.gaussian_mutation(g, values, stdev=torch.tensor([0.1, 0.2, 0.3]))
    assert out.shape == values.shape
    noise = (out - values) / torch.tensor([0.1, 0.2, 0.3])[:, None, None]
    assert not torch.allclose(noise[0], noise[1])
    children = F.simulated_binary_cross_over(g, values, eta=torch.tensor([2.0, 8.0, 20.0]))
    assert children.shape == values.shape
    winners = F.tournament(
        g, values, _t(_evals(13, n=3 * N).reshape(3, N)), num_tournaments=6, tournament_size=2,
        objective_sense="max", return_indices=True,
    )  # fmt: skip
    assert winners.shape == (3, 6) and int(winners.max()) < N
