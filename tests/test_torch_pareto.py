"""The port's Pareto utilities (``operators/functional.py``) and the Pareto
half of ``SolutionBatch`` against the JAX package's on the CPU, on the same
numpy evals, ties and duplicates included.

Tolerances: domination, ranks, front groupings and sort orders exactly;
crowding distances and Pareto utilities exactly too (the same float32
operations in the same order; ``+inf`` at each front's boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.core import Problem as JaxProblem
from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu.operators import functional as JF
from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.operators import functional as F


def _np(x):
    return x.detach().cpu().numpy()


def _evals(seed, n, k=2, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 5, size=(n, k)).astype(np.float32)
    return rng.normal(size=(n, k)).astype(np.float32)


CASES = {
    "random_min_min": (_evals(0, 40), ["min", "min"]),
    "random_min_max": (_evals(1, 40), ["min", "max"]),
    "ties_max_max": (_evals(2, 40, ties=True), ["max", "max"]),
    "three_objectives_ties": (_evals(3, 50, k=3, ties=True), ["min", "max", "min"]),
    "duplicates": (np.repeat(_evals(4, 10), 3, axis=0), ["min", "min"]),
    "one_front": (np.stack([np.arange(12.0), -np.arange(12.0)], 1).astype(np.float32), ["min", "min"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_domination_and_ranks_equal_jax(case):
    evals, sense = CASES[case]
    t = torch.from_numpy(evals)
    np.testing.assert_array_equal(
        _np(F.domination_matrix(t, objective_sense=sense)), np.asarray(JF.domination_matrix(evals, objective_sense=sense))
    )
    np.testing.assert_array_equal(
        _np(F.domination_counts(t, objective_sense=sense)), np.asarray(JF.domination_counts(evals, objective_sense=sense))
    )
    ranks = F.pareto_ranks(t, objective_sense=sense)
    assert ranks.dtype == torch.int32
    np.testing.assert_array_equal(_np(ranks), np.asarray(JF.pareto_ranks(evals, objective_sense=sense)))
    np.testing.assert_array_equal(
        _np(F.dominates(t[:-1], t[1:], objective_sense=sense)),
        np.asarray(JF.dominates(evals[:-1], evals[1:], objective_sense=sense)),
    )


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("crowdsort", [True, False])
def test_crowding_and_utility_equal_jax(case, crowdsort):
    evals, sense = CASES[case]
    t = torch.from_numpy(evals)
    np.testing.assert_array_equal(
        _np(F.crowding_distances(t, objective_sense=sense)), np.asarray(JF.crowding_distances(evals, objective_sense=sense))
    )
    np.testing.assert_array_equal(
        _np(F.pareto_utility(t, objective_sense=sense, crowdsort=crowdsort)),
        np.asarray(JF.pareto_utility(evals, objective_sense=sense, crowdsort=crowdsort)),
    )
    values = np.arange(evals.shape[0] * 3, dtype=np.float32).reshape(-1, 3)
    ours = F.take_best(torch.from_numpy(values), t, 7, objective_sense=sense, crowdsort=crowdsort)
    theirs = JF.take_best(values, evals, 7, objective_sense=sense, crowdsort=crowdsort)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_batched_pareto_ranks_take_lanes_one_by_one():
    evals = np.stack([CASES["random_min_min"][0], CASES["ties_max_max"][0]])
    ranks = F.pareto_ranks(torch.from_numpy(evals), objective_sense=["min", "max"])
    np.testing.assert_array_equal(_np(ranks), np.asarray(JF.pareto_ranks(evals, objective_sense=["min", "max"])))


def _kursawe_np(x):
    x = np.asarray(x, dtype=np.float64)
    f1 = np.sum(-10 * np.exp(-0.2 * np.sqrt(x[:, :-1] ** 2 + x[:, 1:] ** 2)), axis=-1)
    f2 = np.sum(np.abs(x) ** 0.8 + 5 * np.sin(x**3), axis=-1)
    return np.stack([f1, f2], axis=1).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_solution_batch_pareto_methods_equal_jax(ties):
    """``argsort``/``take_best`` with no ``obj_index`` sort by Pareto
    utility; ``compute_pareto_ranks`` and ``arg_pareto_sort`` group by
    front; fitnesses come from numpy, so both batches hold the same bits."""
    n = 48
    values = np.random.default_rng(5).uniform(-5, 5, size=(n, 3)).astype(np.float32)
    if ties:
        values[n // 2 :] = values[: n // 2]  # every solution twice
    kw = dict(solution_length=3, initial_bounds=(-5.0, 5.0), vectorized=True)
    jp = JaxProblem(["min", "min"], lambda x: jnp.asarray(_kursawe_np(x)), **kw)
    pp = Problem(["min", "min"], lambda x: torch.from_numpy(_kursawe_np(x.numpy())), device="cpu", **kw)
    jb, pb = JaxSolutionBatch(jp, n, values=values), SolutionBatch(pp, n, values=torch.from_numpy(values))
    jp.evaluate(jb)
    pp.evaluate(pb)
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
    np.testing.assert_array_equal(_np(pb.argsort()), np.asarray(jb.argsort()))
    np.testing.assert_array_equal(_np(pb.compute_pareto_ranks()), np.asarray(jb.compute_pareto_ranks()))
    ours, theirs = pb.arg_pareto_sort(), jb.arg_pareto_sort()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(pb.take_best(10).values), np.asarray(jb.take_best(10).values))
    np.testing.assert_array_equal(_np(pb.take_best(10, obj_index=1).evals), np.asarray(jb.take_best(10, obj_index=1).evals))
