"""The port's ``PyCMAES`` (``evotorch_tpu_torch/algorithms/cmaes.py``) run
through a fake ``cma`` module, against the JAX package's adapter on the
same inputs: the counterpart of ``tests/test_adapters.py``'s
``test_pycmaes_wrapper_ask_tell``.

Neither machine has ``cma``, and it cannot be installed, so both adapters
run over the same double of ``cma.CMAEvolutionStrategy`` (a copy of
``tests/test_adapters.py``'s ``_FakeCMAES``, not an import of it: a plain
mean and stdev random search from a seeded numpy generator). Both adapters
get the same asked solutions; the fitnesses each tells the double are
held to ``rtol=1e-6`` (a float32 sum of 5 squares, reduced by XLA and by
torch in their own orders), their signs exactly (``"max"`` is flipped,
since ``cma`` minimizes), and the double's means, which follow the ranks
of those fitnesses, to ``rtol=1e-6``.
"""

import sys
import types

import numpy as np
import pytest
import torch

GENERATIONS = 20


class _FakeCMAES:
    """Mimics cma.CMAEvolutionStrategy's ask/tell/popsize surface with a
    plain (mu, sigma) random search; records what each tell received."""

    def __init__(self, x0, sigma0, opts):
        self._mu = np.asarray(x0, dtype=np.float64)
        self._sigma = float(sigma0)
        self.popsize = int(opts.get("popsize", 8))
        self._rng = np.random.default_rng(0)
        self._told = 0
        self.told = []  # (solutions, fitnesses) of each tell
        self.means = []

    def ask(self):
        return [self._mu + self._sigma * self._rng.standard_normal(self._mu.shape) for _ in range(self.popsize)]

    def tell(self, solutions, fitnesses):
        self.told.append((np.asarray(solutions), np.asarray(fitnesses, dtype=np.float64)))
        order = np.argsort(fitnesses)  # cma minimizes
        elite = np.asarray(solutions)[order[: max(1, self.popsize // 4)]]
        self._mu = elite.mean(axis=0)
        self._sigma *= 0.95
        self._told += 1
        self.means.append(self._mu.copy())


@pytest.fixture
def fake_cma(monkeypatch):
    module = types.ModuleType("cma")
    module.CMAEvolutionStrategy = _FakeCMAES
    monkeypatch.setitem(sys.modules, "cma", module)
    return module


def _port_run(sense):
    from evotorch_tpu_torch import Problem, vectorized
    from evotorch_tpu_torch.algorithms import PyCMAES

    sign = -1.0 if sense == "max" else 1.0

    @vectorized
    def sphere(xs):
        return sign * torch.sum(xs**2, dim=-1)

    problem = Problem(sense, sphere, solution_length=5, initial_bounds=(-1, 1), device="cpu")
    searcher = PyCMAES(problem, stdev_init=0.5, popsize=8, center_init=torch.full((5,), 2.0))
    searcher.run(GENERATIONS)
    return searcher


def _jax_run(sense):
    import jax.numpy as jnp

    from evotorch_tpu import Problem, vectorized
    from evotorch_tpu.algorithms import PyCMAES

    sign = -1.0 if sense == "max" else 1.0

    @vectorized
    def sphere(xs):
        return sign * jnp.sum(xs**2, axis=-1)

    problem = Problem(sense, sphere, solution_length=5, initial_bounds=(-1, 1))
    searcher = PyCMAES(problem, stdev_init=0.5, popsize=8, center_init=jnp.full((5,), 2.0))
    searcher.run(GENERATIONS)
    return searcher


@pytest.mark.parametrize("sense", ["max", "min"])
def test_pycmaes_through_the_fake_cma_matches_the_jax_adapter(fake_cma, sense):
    """Both adapters ask the same solutions and tell the same fitnesses,
    negated for ``"max"`` (a maximized ``-|x|^2`` is told as ``+|x|^2``),
    so the double walks the same means; the port's population and best
    solution come from its own evaluations, on the CPU as asked."""
    ours, theirs = _port_run(sense), _jax_run(sense)
    assert len(ours._es.told) == len(theirs._es.told) == GENERATIONS
    for (xa, fa), (xb, fb) in zip(ours._es.told, theirs._es.told):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_allclose(fa, fb, rtol=1e-6)
        # what cma minimizes is |x|^2 in both senses
        np.testing.assert_allclose(fa, (xa.astype(np.float32) ** 2).sum(axis=1), rtol=1e-6)
    np.testing.assert_allclose(np.stack(ours._es.means), np.stack(theirs._es.means), rtol=1e-6)
    assert len(ours.population) == 8 and ours.population.values.device == torch.device("cpu")
    best = ours.status["pop_best"].values.numpy()
    assert float(np.sum(best**2)) < float(np.sum(np.full(5, 2.0) ** 2))
    np.testing.assert_allclose(best, np.asarray(theirs.status["pop_best"].values), rtol=1e-6)
