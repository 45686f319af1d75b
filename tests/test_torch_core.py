"""The port's core runtime (``Problem``, ``SolutionBatch``, ``Solution``,
``ProblemBoundEvaluator``) against the JAX package's on the CPU.

Both packages get the same numpy population, and their fitness functions
compute on the host in float64 from it (then float32), so the evaluations
are the same bits and the tests hold the machinery, not the arithmetic:
evals, ``argsort``, ``argbest``, the best/worst status, slicing with
scatter-back, ``take`` and ``cat`` must equal the JAX values exactly
(NaN where JAX has NaN).
"""

import math
import pickle

import numpy as np
import pytest
import torch

from evotorch_tpu.core import Problem as JaxProblem
from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu_torch.core import Problem, ProblemBoundEvaluator, SolutionBatch

L, N = 6, 24


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sphere(x: np.ndarray) -> np.ndarray:
    return np.sum(x.astype(np.float64) ** 2, axis=-1)


def _rastrigin(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return 10.0 * x.shape[-1] + np.sum(x**2 - 10.0 * np.cos(2 * math.pi * x), axis=-1)


def _fitness(name: str, eval_data: bool, nan_rows: bool):
    """A host-side fitness on an ``(N, L)`` array: float32 scores, NaN on
    the rows whose first value is above 0.6 when ``nan_rows``, and two eval
    data columns (the mean and the max of the row) when ``eval_data``."""

    def f(x: np.ndarray) -> np.ndarray:
        scores = {"sphere": _sphere, "rastrigin": _rastrigin}[name](x)
        if nan_rows:
            scores = np.where(x[:, 0] > 0.6, np.nan, scores)
        if eval_data:
            return np.stack([scores, x.mean(axis=-1), x.max(axis=-1)], axis=1).astype(np.float32)
        return scores.astype(np.float32)

    return f


def _problems(sense, name="sphere", eval_data=False, nan_rows=False):
    f = _fitness(name, eval_data, nan_rows)
    kw = dict(solution_length=L, initial_bounds=(-1.0, 1.0), eval_data_length=2 if eval_data else 0, vectorized=True)
    jax_problem = JaxProblem(sense, lambda x: f(np.asarray(x)), **kw)
    port_problem = Problem(sense, lambda x: torch.from_numpy(f(x.numpy())), device="cpu", **kw)
    return jax_problem, port_problem


def _population(seed, n=N):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, L)).astype(np.float32)


CASES = [
    (sense, name, eval_data, nan_rows)
    for sense in ("min", "max")
    for name in ("sphere", "rastrigin")
    for eval_data in (False, True)
    for nan_rows in (False, True)
]


@pytest.mark.parametrize("sense,name,eval_data,nan_rows", CASES)
def test_evaluate_argsort_argbest_and_best_worst_equal_jax(sense, name, eval_data, nan_rows):
    """Two evaluations (so the best/worst merge runs); tolerance: exact."""
    jax_problem, port_problem = _problems(sense, name, eval_data, nan_rows)
    for seed in (0, 1):
        values = _population(seed)
        jb = JaxSolutionBatch(jax_problem, N, values=values)
        pb = SolutionBatch(port_problem, N, values=torch.from_numpy(values))
        jax_problem.evaluate(jb)
        port_problem.evaluate(pb)
        np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
        np.testing.assert_array_equal(_np(pb.argsort()), np.asarray(jb.argsort()))
        assert int(pb.argbest()) == int(jb.argbest())
        assert int(pb.argworst()) == int(jb.argworst())
        assert pb.is_evaluated == jb.is_evaluated
        np.testing.assert_array_equal(_np(pb.evdata), np.asarray(jb.evdata))
    for key in ("best_eval", "worst_eval"):
        assert port_problem.status[key] == jax_problem.status[key]
    for key in ("best", "worst"):
        np.testing.assert_array_equal(_np(port_problem.status[key].values), np.asarray(jax_problem.status[key].values))
        np.testing.assert_array_equal(_np(port_problem.status[key].evals), np.asarray(jax_problem.status[key].evals))


def test_all_nan_batch_leaves_best_not_ready():
    """No valid evaluation yet: the best/worst keys are absent, as in JAX."""
    jax_problem, port_problem = _problems("min", nan_rows=True)
    values = np.full((4, L), 0.9, dtype=np.float32)  # every row NaN
    jax_problem.evaluate(JaxSolutionBatch(jax_problem, 4, values=values))
    port_problem.evaluate(SolutionBatch(port_problem, 4, values=torch.from_numpy(values)))
    for problem in (jax_problem, port_problem):
        assert "best_eval" not in dict(problem.status.items())
        with pytest.raises(KeyError):
            problem.status["best"]


@pytest.mark.parametrize("eval_data", [False, True])
def test_slicing_take_and_cat_equal_jax(eval_data):
    """Slices and ``take`` pieces share scatter-back with their parent;
    ``cat`` concatenates. Tolerance: exact."""
    jax_problem, port_problem = _problems("max", "rastrigin", eval_data)
    values = _population(2)
    jb = JaxSolutionBatch(jax_problem, N, values=values)
    pb = SolutionBatch(port_problem, N, values=torch.from_numpy(values))
    # evaluate two pieces; the results land in the parent
    for lo, hi in ((0, 10), (10, N)):
        jax_problem.evaluate(jb[lo:hi])
        port_problem.evaluate(pb[lo:hi])
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
    idx = np.array([5, 1, 17, 3])
    jt, pt = jb.take(idx), pb.take(idx)
    np.testing.assert_array_equal(_np(pt.values), np.asarray(jt.values))
    np.testing.assert_array_equal(_np(pt.evals), np.asarray(jt.evals))
    # a write into a piece scatters into the parent
    jt.forget_evals()
    pt.forget_evals()
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
    assert np.isnan(_np(pb.evals)[idx]).all()
    # best n, split pieces, cat
    jax_problem.evaluate(jb)
    port_problem.evaluate(pb)
    np.testing.assert_array_equal(_np(pb.take_best(5).values), np.asarray(jb.take_best(5).values))
    pieces = pb.split(3)
    assert [pieces.indices_of(i) for i in range(3)] == [jb.split(3).indices_of(i) for i in range(3)]
    jc = JaxSolutionBatch.cat([jb[:7], jb[7:]])
    pc = SolutionBatch.cat([pb[:7], pb[7:]])
    np.testing.assert_array_equal(_np(pc.values), np.asarray(jc.values))
    np.testing.assert_array_equal(_np(pc.evals), np.asarray(jc.evals))
    np.testing.assert_array_equal(_np(pb.concat(pb[:3]).evals), np.asarray(jb.concat(jb[:3]).evals))
    # a Solution's values, evals, and set_values invalidating its evals
    ps, js = pb[4], jb[4]
    np.testing.assert_array_equal(_np(ps.values), np.asarray(js.values))
    np.testing.assert_array_equal(_np(ps.evals), np.asarray(js.evals))
    ps.set_values(torch.zeros(L))
    js.set_values(np.zeros(L, dtype=np.float32))
    np.testing.assert_array_equal(_np(pb.values), np.asarray(jb.values))
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))


def test_multi_objective_evals_and_sorting():
    """Two objectives (min, max): evals, per-objective argsort and the
    per-objective best status equal JAX exactly; so does sorting with no
    ``obj_index``, by Pareto utility (fronts, then crowding)."""

    def f(x):
        return np.stack([_sphere(x), _rastrigin(x)], axis=1).astype(np.float32)

    kw = dict(solution_length=L, initial_bounds=(-1.0, 1.0), vectorized=True)
    jax_problem = JaxProblem(["min", "max"], lambda x: f(np.asarray(x)), **kw)
    port_problem = Problem(["min", "max"], lambda x: torch.from_numpy(f(x.numpy())), device="cpu", **kw)
    values = _population(3)
    jb = JaxSolutionBatch(jax_problem, N, values=values)
    pb = SolutionBatch(port_problem, N, values=torch.from_numpy(values))
    jax_problem.evaluate(jb)
    port_problem.evaluate(pb)
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
    for i in (0, 1):
        np.testing.assert_array_equal(_np(pb.argsort(obj_index=i)), np.asarray(jb.argsort(obj_index=i)))
        np.testing.assert_array_equal(
            _np(port_problem.status[f"obj{i}_best"].values), np.asarray(jax_problem.status[f"obj{i}_best"].values)
        )
    np.testing.assert_array_equal(_np(pb.argsort()), np.asarray(jb.argsort()))
    with pytest.raises(ValueError):
        port_problem.normalize_obj_index(None)
    assert port_problem.normalize_obj_index(-1) == jax_problem.normalize_obj_index(-1) == 1


def test_per_solution_objective_and_callable_evaluator():
    """A non-vectorized objective runs row by row; the callable evaluator
    flattens leading batch dims. Tolerance: exact."""

    def f(x):
        return float(np.sum(np.asarray(x, dtype=np.float64) ** 2))

    kw = dict(solution_length=L, initial_bounds=(-1.0, 1.0))
    jax_problem = JaxProblem("min", lambda x: f(np.asarray(x)), **kw)
    port_problem = Problem("min", lambda x: f(x.numpy()), device="cpu", **kw)
    values = _population(4, n=6)
    jb = JaxSolutionBatch(jax_problem, 6, values=values)
    pb = SolutionBatch(port_problem, 6, values=torch.from_numpy(values))
    jax_problem.evaluate(jb)
    port_problem.evaluate(pb)
    np.testing.assert_array_equal(_np(pb.evals), np.asarray(jb.evals))
    stacked = values.reshape(2, 3, L)
    np.testing.assert_array_equal(
        _np(ProblemBoundEvaluator(port_problem)(torch.from_numpy(stacked))),
        np.asarray(jax_problem.make_callable_evaluator()(stacked)),
    )


def test_problem_basics_devices_and_unported_options(monkeypatch):
    """Senses, bounds, generation within the initial bounds, the hooks, the
    generator's pickling, and the options that are not ported yet."""
    problem = Problem("max", solution_length=L, initial_bounds=(-2.0, 2.0), device="cpu", seed=3)
    assert problem.senses == ["max"] and problem.objective_sense == "max" and problem.generator.device.type == "cpu"
    values = problem.generate_values(50)
    assert values.shape == (50, L) and bool((values >= -2).all()) and bool((values <= 2).all())
    batch = problem.generate_batch(8, center=torch.zeros(L), stdev=1.0, symmetric=True)
    assert torch.equal(batch.values[0::2], -batch.values[1::2])
    with pytest.raises(ValueError):
        Problem("max", solution_length=2, bounds=([1.0, 1.0], [0.0, 0.0]), device="cpu")
    with pytest.raises(ValueError, match="unbounded"):
        Problem("max", solution_length=2, bounds=(-1.0, 1.0), device="cpu").ensure_unbounded()
    # the fan-out options are ported (multi-GPU; tests/test_torch_distributed_oo.py
    # and tests/test_torch_hostpool.py run them): taken, checked as in the JAX package
    for option in (dict(num_actors=2), dict(num_subbatches=2), dict(subbatch_size=4), dict(num_gpus_per_actor=1)):
        Problem("max", solution_length=2, device="cpu", **option)
    with pytest.raises(ValueError, match="at most one"):
        Problem("max", solution_length=2, device="cpu", num_subbatches=2, subbatch_size=4)
    # dtype=object is ported (tests/test_torch_objectarray.py): an object
    # problem takes no solution_length, as in the JAX package
    with pytest.raises(ValueError, match="solution_length must be None"):
        Problem("max", solution_length=2, dtype=object, device="cpu")
    assert Problem("max", dtype=object, device="cpu").solution_length is None
    with pytest.raises(ValueError, match="vectorized"):
        problem.use_sharded_evaluation()
    # the generator survives pickling with its state
    expected = torch.rand(3, generator=pickle.loads(pickle.dumps(problem)).generator)
    assert torch.equal(torch.rand(3, generator=problem.generator), expected)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Problem("max", solution_length=2)


def test_hooks_accumulate_into_the_status():
    _, problem = _problems("min")
    seen = []
    problem.before_eval_hook.append(lambda batch: seen.append(len(batch)))
    problem.after_eval_hook.append(lambda batch: {"evaluated": len(batch)})
    problem.evaluate(SolutionBatch(problem, 5, values=torch.from_numpy(_population(5, n=5))))
    assert seen == [5] and problem.status["evaluated"] == 5
