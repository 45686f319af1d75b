"""The port's population-based searchers (``GeneticAlgorithm`` elitist,
non-elitist and multi-objective, ``SteadyStateGA``, ``Cosyne``,
``MAPElites``) and restarts (``Restart``, ``IPOP``) against the JAX
package's on the CPU, a few generations each.

The JAX run goes first, with its operators' cores wrapped so that every
draw they make is replayed from its key (in the order the JAX package
splits and consumes it) onto a tape; the port's run then takes its draws
from that tape through the private draw steps of ``operators/functional.py``
(and ``funccmaes._draw_local_coordinates``), each checked for kind and
shape. The port starts from the JAX initial population, and fitnesses are
computed on the host with numpy, so both select on the same bits.

Tolerances: the populations' values and evals after each generation to
``rtol=1e-5, atol=1e-6`` (SBX and mutation children differ from XLA's by
an ulp or two); MAP-Elites' ``filled`` mask and the restart counts exactly.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evotorch_tpu.algorithms.cmaes as jax_cmaes_module
import evotorch_tpu.operators.functional as JF
from evotorch_tpu.algorithms import CMAES as JaxCMAES
from evotorch_tpu.algorithms import IPOP as JaxIPOP
from evotorch_tpu.algorithms import Cosyne as JaxCosyne
from evotorch_tpu.algorithms import GeneticAlgorithm as JaxGA
from evotorch_tpu.algorithms import MAPElites as JaxMAPElites
from evotorch_tpu.algorithms import Restart as JaxRestart
from evotorch_tpu.algorithms import SteadyStateGA as JaxSteadyStateGA
from evotorch_tpu.core import Problem as JaxProblem
from evotorch_tpu.operators import real as jax_real
from evotorch_tpu_torch.algorithms import CMAES, IPOP, Cosyne, GeneticAlgorithm, MAPElites, Restart, SteadyStateGA
from evotorch_tpu_torch.algorithms.functional import funccmaes
from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.operators import functional as F
from evotorch_tpu_torch.operators import real

L = 6
TOL = dict(rtol=1e-5, atol=1e-6)


def _fitness(x):
    x = np.asarray(x, dtype=np.float64)
    return (np.sum(x**2, axis=-1) + np.sum(np.cos(3 * x), axis=-1)).astype(np.float32)


def _kursawe(x):
    x = np.asarray(x, dtype=np.float64)
    f1 = np.sum(-10 * np.exp(-0.2 * np.sqrt(x[:, :-1] ** 2 + x[:, 1:] ** 2)), axis=-1)
    f2 = np.sum(np.abs(x) ** 0.8 + 5 * np.sin(x**3), axis=-1)
    return np.stack([f1, f2], axis=1).astype(np.float32)


def _with_features(x):
    x = np.asarray(x, dtype=np.float32)
    return np.concatenate([_fitness(x)[:, None], x[:, :2]], axis=1)


def _problems(sense, fn, **kw):
    kw = dict(solution_length=L, initial_bounds=(-2.0, 2.0), vectorized=True, **kw)
    jax_problem = JaxProblem(sense, lambda x: jnp.asarray(fn(np.asarray(x))), seed=0, **kw)
    port_problem = Problem(sense, lambda x: torch.from_numpy(fn(x.numpy())), device="cpu", **kw)
    return jax_problem, port_problem


def _t(x):
    return torch.from_numpy(np.array(x))


class Tape:
    """The JAX run's draws, in order, for the port's run to take."""

    def __init__(self):
        self.draws = collections.deque()

    def put(self, kind, *arrays):
        self.draws.append((kind, tuple(_t(a) for a in arrays)))

    def take(self, kind, shape=None):
        got, arrays = self.draws.popleft()
        assert got == kind, (got, kind)
        if shape is not None:
            assert tuple(arrays[0].shape) == tuple(shape), (kind, arrays[0].shape, shape)
        return arrays


@pytest.fixture
def tape(monkeypatch):
    """Record the JAX operators' draws; replay them into the port's."""
    tape = Tape()
    split = jax.random.split

    tournament = JF._tournament_indices

    def tournament_wrapped(utilities, num_tournaments, size, key):
        k1, k2 = split(key)
        n, half = utilities.shape[0], num_tournaments // 2
        tape.put("tournament", jax.random.randint(k1, (half, size), 0, n), jax.random.randint(k2, (half, size), 0, n - 1))
        return tournament.__wrapped__(utilities, num_tournaments, size, key)

    patched = lambda *a, **k: tournament(*a, **k)  # noqa: E731
    patched.__wrapped__ = tournament_wrapped
    monkeypatch.setattr(JF, "_tournament_indices", patched)

    def recording(name, record):
        original = getattr(JF, name)

        def wrapper(*args):
            record(*args)
            return original(*args)

        monkeypatch.setattr(JF, name, wrapper)

    recording("_sbx_core", lambda p1, p2, eta, key: tape.put("uniform", jax.random.uniform(key, p1.shape, dtype=p1.dtype)))
    recording(
        "_kpoint_crossover_core",
        lambda p1, p2, k, key: tape.put("cuts", jax.random.randint(key, (p1.shape[0], min(k, p1.shape[1] - 1)), 1, p1.shape[1])),
    )
    recording("_gaussian_mutation_core", lambda v, s, key: tape.put("normal", jax.random.normal(key, v.shape, dtype=v.dtype)))

    def gated(v, s, p, key):
        k1, k2 = split(key)
        tape.put("normal", jax.random.normal(k1, v.shape, dtype=v.dtype))
        tape.put("uniform", jax.random.uniform(k2, v.shape))

    recording("_gaussian_mutation_core_gated", gated)
    recording("_polynomial_mutation_core", lambda v, lb, ub, eta, key: tape.put("uniform", jax.random.uniform(key, v.shape, dtype=v.dtype)))

    def polynomial_gated(v, lb, ub, eta, p, key):
        k1, k2 = split(key)
        tape.put("uniform", jax.random.uniform(k1, v.shape, dtype=v.dtype))
        tape.put("uniform", jax.random.uniform(k2, v.shape))

    recording("_polynomial_mutation_core_gated", polynomial_gated)
    # (the partial permutation calls the full one inside its own trace:
    # those draws are recorded by the partial's wrapper)
    recording(
        "_cosyne_full_permutation",
        lambda v, key: None if isinstance(v, jax.core.Tracer) else tape.put("uniform", jax.random.uniform(key, v.shape)),
    )

    def partial(v, e, sense, key):
        k1, k2 = split(key)
        tape.put("uniform", jax.random.uniform(k1, v.shape))
        tape.put("uniform", jax.random.uniform(k2, v.shape))

    recording("_cosyne_partial_permutation", partial)

    ask = jax_cmaes_module.cmaes_ask

    def cmaes_ask(key, state):
        tape.put("normal", jax.random.normal(key, (state.popsize, state.m.shape[0]), dtype=state.m.dtype))
        return ask(key, state)

    monkeypatch.setattr(jax_cmaes_module, "cmaes_ask", cmaes_ask)

    monkeypatch.setattr(F, "_draw_tournament", lambda g, batch, half, size, n, device: tape.take("tournament", (half, size)))
    monkeypatch.setattr(F, "_draw_cut_points", lambda g, batch, half, k, length, device: tape.take("cuts", (half, k))[0])
    monkeypatch.setattr(F, "_draw_uniform", lambda g, shape, dtype, device: tape.take("uniform", shape)[0])
    monkeypatch.setattr(F, "_draw_normal", lambda g, shape, dtype, device: tape.take("normal", shape)[0])
    monkeypatch.setattr(
        funccmaes, "_draw_local_coordinates", lambda g, state: tape.take("normal", (state.popsize, state.m.shape[0]))[0]
    )
    return tape


def _same_start(port_searcher, jax_searcher, port_problem):
    port_searcher._population = SolutionBatch(port_problem, values=_t(jax_searcher.population.values))


def _run_both(jax_searcher, port_searcher, tape, generations=3, check_evals=True):
    """The JAX searcher's step, then the port's from its draws; the
    populations agree after each."""
    for _ in range(generations):
        jax_searcher.step()
        port_searcher.step()
        assert not tape.draws, f"{len(tape.draws)} draws left"
        np.testing.assert_allclose(port_searcher.population.values.numpy(), np.asarray(jax_searcher.population.values), **TOL)
        if check_evals:
            np.testing.assert_allclose(port_searcher.population.evals.numpy(), np.asarray(jax_searcher.population.evals), **TOL)


def _sbx_mutation(module, problem):
    return [
        module.SimulatedBinaryCrossOver(problem, tournament_size=4, eta=8.0),
        module.GaussianMutation(problem, stdev=0.03),
    ]


@pytest.mark.parametrize("sense", ["min", "max"])
def test_elitist_ga_equals_jax(tape, sense):
    jp, pp = _problems(sense, _fitness)
    js = JaxGA(jp, operators=_sbx_mutation(jax_real, jp), popsize=16)
    ps = GeneticAlgorithm(pp, operators=_sbx_mutation(real, pp), popsize=16)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape)
    assert ps.status["best_eval"] == pytest.approx(float(js.status["best_eval"]), rel=1e-6)


@pytest.mark.parametrize(
    "num_children,re_evaluate", [(8, True), (16, False), (24, True)], ids=["fewer_children", "as_many_no_reeval", "more_children"]
)
def test_non_elitist_ga_equals_jax(tape, num_children, re_evaluate):
    jp, pp = _problems("min", _fitness)

    def operators(module, problem):
        return [
            module.OnePointCrossOver(problem, tournament_size=3, num_children=num_children),
            module.GaussianMutation(problem, stdev=0.1, mutation_probability=0.5),
        ]

    kw = dict(popsize=16, elitist=False, re_evaluate=re_evaluate)
    js = JaxGA(jp, operators=operators(jax_real, jp), **kw)
    ps = GeneticAlgorithm(pp, operators=operators(real, pp), **kw)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape)


def test_multi_objective_ga_equals_jax(tape):
    """NSGA-II selection on Kursawe: Pareto fronts and crowding in the
    tournaments and in ``take_best``."""
    jp, pp = _problems(["min", "min"], _kursawe)
    js = JaxGA(jp, operators=_sbx_mutation(jax_real, jp), popsize=16)
    ps = GeneticAlgorithm(pp, operators=_sbx_mutation(real, pp), popsize=16)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape)
    fronts, theirs = ps.population.arg_pareto_sort(), js.population.arg_pareto_sort()
    assert [f.tolist() for f in fronts] == [np.asarray(f).tolist() for f in theirs]


def test_steady_state_ga_equals_jax(tape):
    """Operators added with ``use``: a two-point crossover and a gated
    polynomial mutation on a bounded problem."""
    jp, pp = _problems("max", _fitness, bounds=(-2.0, 2.0))
    js, ps = JaxSteadyStateGA(jp, popsize=12), SteadyStateGA(pp, popsize=12)
    for searcher, module, problem in ((js, jax_real, jp), (ps, real, pp)):
        searcher.use(module.TwoPointCrossOver(problem, tournament_size=2))
        searcher.use(module.PolynomialMutation(problem, eta=10.0, mutation_probability=0.3))
    _same_start(ps, js, pp)
    _run_both(js, ps, tape)


@pytest.mark.parametrize(
    "kw",
    [dict(permute_all=False), dict(permute_all=True, num_elites=2), dict(eta=5.0, elitism_ratio=0.25, mutation_probability=0.5)],
    ids=["rank_biased", "permute_all_elites", "sbx_elitism_ratio"],
)
def test_cosyne_equals_jax(tape, kw):
    jp, pp = _problems("min", _fitness)
    common = dict(popsize=16, tournament_size=3, mutation_stdev=0.05, **kw)
    js, ps = JaxCosyne(jp, **common), Cosyne(pp, **common)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape)


def test_cosyne_and_ga_rank_through_the_centered_rank(tape, monkeypatch):
    """GA's tournament ranks the population with the centered-rank entry
    point (the one that launches the kernel on the card); CoSyNE ranks its
    parents (a quarter) in the tournament and the population in the
    permutation's linear rank."""
    from evotorch_tpu_torch.ops import ranking
    from evotorch_tpu_torch.tools import ranking as tools_ranking

    shapes = []
    real_rank = ranking.centered_rank
    monkeypatch.setattr(tools_ranking, "centered_rank", lambda x, **kw: shapes.append(tuple(x.shape)) or real_rank(x, **kw))
    jp, pp = _problems("min", _fitness)
    js = JaxGA(jp, operators=_sbx_mutation(jax_real, jp), popsize=16)
    ps = GeneticAlgorithm(pp, operators=_sbx_mutation(real, pp), popsize=16)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape, generations=1)
    assert shapes == [(16,)]
    shapes.clear()
    js = JaxCosyne(jp, popsize=16, tournament_size=3, mutation_stdev=0.05)
    ps = Cosyne(pp, popsize=16, tournament_size=3, mutation_stdev=0.05)
    _same_start(ps, js, pp)
    _run_both(js, ps, tape, generations=1)
    assert shapes == [(4,), (16,)]


def test_mapelites_equals_jax(tape):
    jp, pp = _problems("min", _with_features, eval_data_length=2)
    # overlapping edges at the grid lines; the outer cells reach infinity
    jgrid = JaxMAPElites.make_feature_grid([-1.0, -1.0], [1.0, 1.0], num_bins=[4, 3])
    pgrid = MAPElites.make_feature_grid([-1.0, -1.0], [1.0, 1.0], num_bins=[4, 3], device="cpu")
    np.testing.assert_array_equal(pgrid.numpy(), np.asarray(jgrid))
    js = JaxMAPElites(jp, operators=[jax_real.GaussianMutation(jp, stdev=0.5)], feature_grid=jgrid)
    ps = MAPElites(pp, operators=[real.GaussianMutation(pp, stdev=0.5)], feature_grid=pgrid)
    _same_start(ps, js, pp)
    for _ in range(3):
        js.step()
        ps.step()
        np.testing.assert_array_equal(ps.filled.numpy(), np.asarray(js.filled))
        filled = ps.filled.numpy()
        np.testing.assert_allclose(ps.population.values.numpy()[filled], np.asarray(js.population.values)[filled], **TOL)
        np.testing.assert_allclose(ps.population.evals.numpy()[filled], np.asarray(js.population.evals)[filled], **TOL)


def test_mapelites_cell_blocks_agree(monkeypatch):
    """The per-cell selection built a few cells at a time equals the one
    built all at once."""
    from evotorch_tpu_torch.algorithms import mapelites

    rng = np.random.default_rng(4)
    values = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    evals = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    grid = MAPElites.make_feature_grid([-1.0, -1.0], [1.0, 1.0], num_bins=5, device="cpu")
    whole = mapelites._best_solutions_for_all_cells("max", values, evals, grid)
    monkeypatch.setattr(mapelites, "_MASK_ELEMENTS", 50 * 3)
    blocks = mapelites._best_solutions_for_all_cells("max", values, evals, grid)
    for a, b in zip(whole, blocks):
        assert torch.equal(a, b)


def test_restart_and_ipop_equal_jax(tape):
    """``Restart`` over a GA never restarts (a GA does not terminate);
    ``IPOP`` over CMA-ES with a spread floor no population reaches restarts
    every generation, doubling the popsize."""
    jp, pp = _problems("min", _fitness)
    js = JaxRestart(jp, JaxGA, {"operators": _sbx_mutation(jax_real, jp), "popsize": 8})
    ps = Restart(pp, GeneticAlgorithm, {"operators": _sbx_mutation(real, pp), "popsize": 8})
    ps.search_algorithm._population = SolutionBatch(pp, values=_t(js.search_algorithm.population.values))
    for _ in range(2):
        js.step()
        ps.step()
        np.testing.assert_allclose(
            ps.search_algorithm.population.values.numpy(), np.asarray(js.search_algorithm.population.values), **TOL
        )
    assert ps.num_restarts == js.num_restarts == 1

    center = np.linspace(-1, 1, L).astype(np.float32)
    kw = dict(min_fitness_stdev=1e9, popsize_multiplier=2)
    ji = JaxIPOP(jp, JaxCMAES, {"stdev_init": 0.5, "popsize": 6, "center_init": center}, **kw)
    pi = IPOP(pp, CMAES, {"stdev_init": 0.5, "popsize": 6, "center_init": torch.from_numpy(center)}, **kw)
    for _ in range(3):
        ji.step()
        pi.step()
        assert not tape.draws
        assert pi.num_restarts == ji.num_restarts
        assert len(pi.search_algorithm.population) == len(ji.search_algorithm.population)
    assert pi.num_restarts == 4 and len(pi.search_algorithm.population) == 48
