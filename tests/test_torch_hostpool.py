"""The port's host worker pool (``parallel/hostpool.py``): ``num_actors``
with a per-solution Python objective evaluates in worker processes, with
the results equal to serial evaluation, the main/worker sync protocol
merged back, sub-batches, a worker's death survived, a failing objective
reported, and a problem that cannot be pickled evaluated serially with a
logged warning (the JAX package's behaviour, ``tests/test_hostpool.py``).

The objectives are module-level functions (a spawned worker unpickles
them by name). Every pool is shut down at the end of its test.
"""

import logging
import os
import signal

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.parallel import HostEvaluatorPool


def per_solution_sphere(row):
    return float(torch.sum(row**2))


def always_broken(row):
    raise RuntimeError("this objective always fails")


class CountingProblem(Problem):
    """Counts its evaluated solutions through the sync protocol: each
    worker reports how many it evaluated, the main process adds them up."""

    def __init__(self, **kwargs):
        super().__init__("min", per_solution_sphere, solution_length=4, initial_bounds=(-1, 1), device="cpu", **kwargs)
        self.evaluated_here = 0
        self.merged = 0
        self.sent = None

    def _make_sync_data_for_actors(self):
        return {"generation": 7}

    def _use_sync_data_from_main(self, data):
        self.sent = data["generation"]

    def _evaluate_batch(self, batch):
        super()._evaluate_batch(batch)
        self.evaluated_here += len(batch)

    def _make_sync_data_for_main(self):
        out = {"evaluated": self.evaluated_here, "sent": self.sent}
        self.evaluated_here = 0
        return out

    def _use_sync_data_from_actors(self, data_list):
        assert all(d["sent"] == 7 for d in data_list)
        self.merged += sum(d["evaluated"] for d in data_list)


def _serial(values):
    return torch.sum(values**2, dim=-1)


def test_num_actors_evaluates_in_worker_processes():
    problem = CountingProblem(num_actors=2, seed=1)
    try:
        batch = problem.generate_batch(6)
        problem.evaluate(batch)
        np.testing.assert_allclose(batch.evals[:, 0].numpy(), _serial(batch.values).numpy(), rtol=1e-6)
        pool = problem._host_pool
        assert pool is not None and pool.num_workers == 2 and pool.is_alive()
        assert len(set(pool.worker_pids)) == 2 and os.getpid() not in pool.worker_pids
        assert problem.merged == 6 and "best_eval" in problem.status
        again = problem.generate_batch(5)
        problem.evaluate(again)
        assert problem._host_pool is pool and problem.merged == 11
        np.testing.assert_allclose(again.evals[:, 0].numpy(), _serial(again.values).numpy(), rtol=1e-6)
    finally:
        problem.kill_actors()
    assert problem._host_pool is None


def test_pool_pieces_and_a_worker_death():
    """``HostEvaluatorPool`` itself: pieces come back in their order, equal
    to serial evaluation; a worker killed before a round is replaced by a
    clone with the same seed and its piece handed out again."""
    problem = Problem("min", per_solution_sphere, solution_length=3, initial_bounds=(-1, 1), device="cpu")
    pool = HostEvaluatorPool(problem, 2, seeds=[5, 6])
    try:
        pieces = [torch.randn(n, 3, generator=torch.Generator().manual_seed(n)) for n in (3, 1, 4, 2)]
        evals, sync = pool.evaluate_pieces(pieces, None)
        for piece, got in zip(pieces, evals):
            np.testing.assert_allclose(got[:, 0], _serial(piece).numpy(), rtol=1e-6)
        assert sync == [{}] * 4
        victim = pool.worker_pids[0]
        os.kill(victim, signal.SIGKILL)
        evals, _ = pool.evaluate_pieces(pieces, None)
        for piece, got in zip(pieces, evals):
            np.testing.assert_allclose(got[:, 0], _serial(piece).numpy(), rtol=1e-6)
        assert victim not in pool.worker_pids and pool.is_alive()
    finally:
        pool.shutdown()
    assert not pool.is_alive()


def test_subbatches_and_a_failing_objective():
    """``subbatch_size`` sets the pieces the pool hands out; an objective
    that raises fails the evaluation with the worker's traceback and shuts
    the pool down."""
    problem = CountingProblem(num_actors=2, subbatch_size=2, seed=2)
    try:
        batch = problem.generate_batch(5)
        problem.evaluate(batch)
        np.testing.assert_allclose(batch.evals[:, 0].numpy(), _serial(batch.values).numpy(), rtol=1e-6)
        assert problem.merged == 5
    finally:
        problem.kill_actors()
    broken = Problem("min", always_broken, solution_length=3, initial_bounds=(-1, 1), device="cpu", num_actors=2)
    with pytest.raises(RuntimeError, match="always fails"):
        broken.evaluate(broken.generate_batch(4))
    assert broken._host_pool is None


def test_unpicklable_problem_evaluates_serially(caplog):
    problem = Problem("min", lambda row: float(torch.sum(row**2)), solution_length=3, initial_bounds=(-1, 1), device="cpu", num_actors=2)
    batch = problem.generate_batch(4)
    with caplog.at_level(logging.WARNING, logger="evotorch_tpu_torch"):
        problem.evaluate(batch)
    assert problem._host_pool is None
    assert any("could not be pickled" in r.message for r in caplog.records)
    np.testing.assert_allclose(batch.evals[:, 0].numpy(), _serial(batch.values).numpy(), rtol=1e-6)


def test_subbatches_without_a_pool():
    """``num_subbatches`` alone evaluates in pieces in this process."""
    problem = Problem("min", per_solution_sphere, solution_length=3, initial_bounds=(-1, 1), device="cpu", num_subbatches=3)
    batch = SolutionBatch(problem, values=torch.randn(7, 3, generator=torch.Generator().manual_seed(3)))
    problem.evaluate(batch)
    np.testing.assert_allclose(batch.evals[:, 0].numpy(), _serial(batch.values).numpy(), rtol=1e-6)


class _MainFlag:
    """A per-solution objective that reports where it ran: 1 in the main
    program, 0 in a pool worker (``Problem.is_main``)."""

    def _evaluate(self, solution):
        solution.set_evals(float(self.is_main))


class PortMainFlagProblem(_MainFlag, Problem):
    def __init__(self, **kwargs):
        super().__init__("max", solution_length=3, initial_bounds=(-1, 1), device="cpu", **kwargs)


def __getattr__(name):
    # the JAX package's twin, made on first use so that a port worker (which
    # imports this module to unpickle its problem) never imports JAX; pickle
    # finds it by name in the JAX pool's workers the same way
    if name != "JaxMainFlagProblem":
        raise AttributeError(name)
    from evotorch_tpu.core import Problem as JaxProblem

    class JaxMainFlagProblem(_MainFlag, JaxProblem):
        def __init__(self, **kwargs):
            super().__init__("max", solution_length=3, initial_bounds=(-1, 1), **kwargs)

    JaxMainFlagProblem.__module__ = __name__
    JaxMainFlagProblem.__qualname__ = name
    globals()[name] = JaxMainFlagProblem
    return JaxMainFlagProblem


@pytest.mark.parametrize("num_actors", [None, 2])
def test_is_main_in_workers_matches_jax(num_actors):
    """``is_main`` is False in every pool worker and True in the main
    process, as in the JAX package's pool."""
    results = []
    for cls in (PortMainFlagProblem, __getattr__("JaxMainFlagProblem")):
        problem = cls(num_actors=num_actors, seed=3)
        try:
            batch = problem.generate_batch(6)
            problem.evaluate(batch)
            results.append(np.asarray(batch.evals).reshape(-1))
        finally:
            problem.kill_actors()
        assert problem.is_main
    expected = np.full(6, 1.0 if num_actors is None else 0.0)
    np.testing.assert_array_equal(results[0], expected)
    np.testing.assert_array_equal(results[1], expected)


class PortSequenceProblem(Problem):
    """An object-typed problem (variable-length sequences) whose fitness
    is their sum."""

    def __init__(self, **kwargs):
        super().__init__("max", dtype=object, device="cpu", **kwargs)

    def _fill(self, n, generator):
        from evotorch_tpu_torch.tools import ObjectArray

        return ObjectArray.from_values([list(range(i % 5 + 1)) for i in range(n)])

    def _evaluate(self, solution):
        solution.set_evals(float(sum(solution.values)))


def test_object_typed_problem_in_worker_processes():
    """The pool hands an object problem's pieces to its workers as
    ``ObjectArray``s, as the JAX package's pool does."""
    problem = PortSequenceProblem(num_actors=2)
    try:
        batch = problem.generate_batch(7)
        problem.evaluate(batch)
        assert problem._host_pool is not None and problem._host_pool.num_workers == 2
        np.testing.assert_array_equal(batch.evals[:, 0].numpy(), [float(sum(range(i % 5 + 1))) for i in range(7)])
    finally:
        problem.kill_actors()
