"""Object-typed problems in the port against the JAX package, on the CPU:
``ObjectArray``, the immutable containers, ``ReadOnlyTensor``,
``Problem(dtype=object)`` with its ``SolutionBatch`` and ``Solution``
semantics, the object paths of ``operators.functional``, ``CutAndSplice``
and the GA over sequences (``examples/object_dtype_ga.py``), and the small
tools of the same slice (``tools.misc`` helpers, ``tools.constraints``,
``testing``, ``make_*_shaped_like``).

Everything deterministic is held exactly (element for element, the evals
bit for bit): the containers, slicing, views, cat, take, cloning and
pickling, ``combine`` and ``take_best`` given the same evals. The random
paths draw from a ``torch.Generator`` where the JAX package seeds numpy
from its key, so they are held by their invariants: a tournament's
winners beat the other candidates, every child of ``CutAndSplice`` is a
prefix of one parent joined to a suffix of the other (so the lengths sum
to the parents'), and the GA's best fitness never falls under elitism.
Constraint penalties: ``rtol=1e-6`` (float32 on both sides).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import evotorch_tpu.core as J
import evotorch_tpu.operators.functional as JF
import evotorch_tpu.tools as JT
import evotorch_tpu_torch.core as P
import evotorch_tpu_torch.operators.functional as PF
import evotorch_tpu_torch.tools as PT
from evotorch_tpu_torch.operators import sequence as port_sequence

TARGET = 42


def _lists(arr):
    """An ObjectArray's elements as plain nested Python lists."""
    return [list(v) if hasattr(v, "__iter__") and not isinstance(v, str) else v for v in arr]


# ------------------------------------------------------ containers


def _sequences(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in rng.integers(0, 10, size=int(rng.integers(1, 8)))] for _ in range(n)]


def test_object_array_semantics_match_jax():
    seqs = _sequences()
    ours, theirs = PT.ObjectArray.from_values(seqs), JT.ObjectArray.from_values(seqs)
    assert len(ours) == len(theirs) and ours.shape == theirs.shape and ours.ndim == 1 and ours.numel() == 6
    assert _lists(ours) == _lists(theirs)
    assert type(ours[0]).__name__ == type(theirs[0]).__name__ == "ImmutableList"
    # a slice is a view sharing storage; fancy indexing copies
    for arr in (ours, theirs):
        view = arr[1:4]
        assert view.storage_ptr() == arr.storage_ptr()
        view[0] = [7, 7]
        assert list(arr[1]) == [7, 7]
        picked = arr[[5, 0]]
        picked[0] = [1]
        assert list(arr[5]) != [1]
        read_only = arr.get_read_only_view()
        assert read_only.is_read_only and not arr.is_read_only
        with pytest.raises(ValueError, match="read-only"):
            read_only[0] = 3
        clone = read_only.clone()
        assert not clone.is_read_only and type(clone[0]) is list
        assert copy.deepcopy(read_only).is_read_only
        assert arr[np.array([True, False, True, False, False, False])].numel() == 2
    assert _lists(ours) == _lists(theirs)
    assert _lists(ours.repeat(2)) == _lists(theirs.repeat(2))
    assert _lists(ours[torch.tensor([2, 3])]) == _lists(theirs[[2, 3]])
    assert ours.device == torch.device("cpu")
    # equality tolerates array- and tensor-valued elements
    mixed = [np.arange(3), torch.arange(3), "x", {"a": 1}, 2.5]
    o, t = PT.ObjectArray.from_values(mixed), JT.ObjectArray.from_values([np.arange(3), np.arange(3), "x", {"a": 1}, 2.5])
    assert list(o == [np.arange(3), np.arange(3), "x", {"a": 1}, 2.5]) == list(t == [np.arange(3), np.arange(3), "x", {"a": 1}, 2.5])
    assert list(o == [0, 1]) == list(t == [0, 1]) == [False] * 5
    assert isinstance(o[1], PT.ReadOnlyTensor)


@pytest.mark.parametrize(
    "value",
    [[1, [2, 3]], (4, 5), {"a": [1, 2], "b": 3}, {1, 2}, np.arange(4.0), np.array([[1, 2]], dtype=object), 3, "s", None],
    ids=["list", "tuple", "dict", "set", "ndarray", "object_ndarray", "int", "str", "none"],
)
def test_immutable_round_trip_matches_jax(value):
    ours, theirs = PT.as_immutable(value), JT.as_immutable(value)
    assert type(ours).__name__ == type(theirs).__name__
    assert PT.is_immutable(ours) == JT.is_immutable(theirs)
    back_ours, back_theirs = PT.mutable_copy(ours), JT.mutable_copy(theirs)
    assert type(back_ours) is type(back_theirs)
    if isinstance(back_ours, np.ndarray):
        np.testing.assert_array_equal(back_ours, back_theirs)
        assert back_ours.flags.writeable
    else:
        assert back_ours == back_theirs
    with pytest.raises(TypeError):
        PT.as_immutable(object())


def test_read_only_tensor():
    base = torch.arange(4.0)
    frozen = PT.as_immutable(base)  # a copy
    assert isinstance(frozen, PT.ReadOnlyTensor) and PT.is_immutable(frozen)
    base[0] = 9.0
    assert float(frozen[0]) == 0.0
    for write in (lambda t: t.add_(1), lambda t: t.__setitem__(0, 1.0), lambda t: t[1:].mul_(2), lambda t: torch.add(t, 1, out=t)):
        with pytest.raises(TypeError, match="ReadOnlyTensor"):
            write(frozen)
    assert isinstance(frozen[1:], PT.ReadOnlyTensor)  # a view stays read-only
    for fresh in (frozen + 1, frozen.clone(), PT.mutable_copy(frozen)):
        assert type(fresh) is torch.Tensor
    assert not frozen.numpy().flags.writeable
    view = PT.as_read_only_tensor(base)
    assert view.data_ptr() == base.data_ptr() and PT.readonlytensor.is_read_only(view)
    np.testing.assert_array_equal(PT.read_only_tensor([1.0, 2.0]).numpy(), np.asarray(JT.read_only_tensor([1.0, 2.0])))
    assert PT.read_only_tensor([1.0, 2.0]).dtype == torch.float32
    arr = np.arange(3)
    ours, theirs = PT.as_read_only_tensor(arr), JT.as_read_only_tensor(arr)
    assert not ours.flags.writeable and not theirs.flags.writeable
    assert isinstance(pickle.loads(pickle.dumps(frozen)), PT.ReadOnlyTensor)

    class Frozen(PT.ReadOnlyClonable):
        def __init__(self):
            self.data = [1, 2]

        def _get_mutable_clone(self, *, memo):
            return list(self.data)

    assert Frozen().clone() == [1, 2] and isinstance(Frozen().clone(preserve_read_only=True), Frozen)


# ------------------------------------------------------ problems


def _fill(problem, n):
    # the same sequences in both packages: from the problem's numpy stream
    arr = problem.ObjectArray(n)
    for i in range(n):
        length = int(problem._rng.integers(1, 8))
        arr[i] = [int(v) for v in problem._rng.integers(0, 10, size=length)]
    return arr


def _fitness(solution):
    seq = list(solution.values)
    solution.set_evals(float(-abs(sum(seq) - TARGET) - 0.1 * len(seq)))


class PortSequenceProblem(P.Problem):
    ObjectArray = PT.ObjectArray

    def __init__(self, **kwargs):
        super().__init__("max", dtype=object, seed=0, device="cpu", **kwargs)
        self._rng = np.random.default_rng(0)

    def _fill(self, n, generator):
        return _fill(self, n)

    def _evaluate(self, solution):
        _fitness(solution)


class JaxSequenceProblem(J.Problem):
    ObjectArray = JT.ObjectArray

    def __init__(self, **kwargs):
        super().__init__("max", dtype=object, seed=0, **kwargs)
        self._rng = np.random.default_rng(0)

    def _fill(self, n, key):
        return _fill(self, n)

    def _evaluate(self, solution):
        _fitness(solution)


def _same_batch(ours, theirs):
    assert len(ours) == len(theirs)
    assert _lists(ours.values) == _lists(theirs.values)
    np.testing.assert_array_equal(ours.evals.numpy(), np.asarray(theirs.evals))


def test_object_problem_validation_matches_jax():
    for cls in (P.Problem, J.Problem):
        kw = {"device": "cpu"} if cls is P.Problem else {}
        with pytest.raises(ValueError, match="solution_length must be None"):
            cls("max", dtype=object, solution_length=3, **kw)
        with pytest.raises(ValueError, match="bounds are not supported"):
            cls("max", dtype=object, initial_bounds=(-1, 1), **kw)
        with pytest.raises(ValueError, match="eval_dtype cannot be object"):
            cls("max", solution_length=2, eval_dtype=object, **kw)
        plain = cls("max", dtype=object, **kw)
        assert plain.solution_length is None
        with pytest.raises(NotImplementedError, match="override _fill"):
            plain.generate_batch(3)
        with pytest.raises(ValueError, match="non-object"):
            plain.ensure_numeric()


def test_object_batch_semantics_match_jax():
    ours_p, theirs_p = PortSequenceProblem(), JaxSequenceProblem()
    ours, theirs = ours_p.generate_batch(8), theirs_p.generate_batch(8)
    _same_batch(ours, theirs)
    assert ours.values.is_read_only and ours.device == torch.device("cpu")
    for p, b in ((ours_p, ours), (theirs_p, theirs)):
        p.evaluate(b)
    _same_batch(ours, theirs)
    assert isinstance(ours.evals, torch.Tensor) and ours.evals.device == ours_p.device
    assert list(ours_p.status["best"].values) == list(theirs_p.status["best"].values)
    assert ours_p.status["best_eval"] == theirs_p.status["best_eval"]
    assert ours_p.status["worst_eval"] == theirs_p.status["worst_eval"]

    for b in (ours, theirs):
        # a slice view writes through; a fancy-indexed piece scatters back
        b[2:5][1].set_values([1, 2, 3])
        b.take([6, 0])[0].set_values([4])
        b.access_values(keep_evals=True)[7] = [5, 5]
    _same_batch(ours, theirs)
    _same_batch(P.SolutionBatch.cat([ours[:3], ours.take([7, 1])]), J.SolutionBatch.cat([theirs[:3], theirs.take([7, 1])]))
    _same_batch(ours.take_best(3), theirs.take_best(3))
    _same_batch(ours.clone(), theirs.clone())
    _same_batch(pickle.loads(pickle.dumps(ours)), pickle.loads(pickle.dumps(theirs)))
    _same_batch(ours[1].clone().to_batch(), theirs[1].clone().to_batch())
    empty = P.SolutionBatch(ours_p, 3, empty=True)
    assert _lists(empty.values) == _lists(J.SolutionBatch(theirs_p, 3, empty=True).values) == [None] * 3
    ours.set_values(_sequences(8, seed=1))
    theirs.set_values(_sequences(8, seed=1))
    _same_batch(ours, theirs)
    assert not ours.is_evaluated
    assert PT.ObjectArray in type(ours_p.make_tensor([[1], [2, 3]], dtype=object)).__mro__
    assert ours_p.make_tensor([[1]], dtype=object, read_only=True).is_read_only


# ------------------------------------------------------ operators


def _population(n=10, seed=3):
    seqs = _sequences(n, seed)
    evals = np.random.default_rng(seed).permutation(n).astype(np.float32) - 4.5  # distinct
    return seqs, evals


@pytest.mark.parametrize("pairs", [False, True])
def test_combine_matches_jax(pairs):
    seqs, evals = _population()
    a, b = seqs[:4], seqs[4:]
    if pairs:
        ours = PF.combine((PT.ObjectArray.from_values(a), torch.from_numpy(evals[:4])), (PT.ObjectArray.from_values(b), torch.from_numpy(evals[4:])))
        theirs = JF.combine((JT.ObjectArray.from_values(a), evals[:4]), (JT.ObjectArray.from_values(b), evals[4:]))
        assert _lists(ours[0]) == _lists(theirs[0])
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    else:
        ours = PF.combine(PT.ObjectArray.from_values(a), PT.ObjectArray.from_values(b))
        assert _lists(ours) == _lists(JF.combine(JT.ObjectArray.from_values(a), JT.ObjectArray.from_values(b)))


@pytest.mark.parametrize("n", [None, 1, 4])
@pytest.mark.parametrize("sense", ["max", "min", ["max", "min"]])
def test_take_best_matches_jax(n, sense):
    seqs, evals = _population()
    if not isinstance(sense, str):
        if n is None:
            return
        evals = np.stack([evals, np.random.default_rng(4).permutation(10).astype(np.float32)], axis=-1)
    ours = PF.take_best(PT.ObjectArray.from_values(seqs), torch.from_numpy(evals), n, objective_sense=sense)
    theirs = JF.take_best(JT.ObjectArray.from_values(seqs), evals, n, objective_sense=sense)
    if n is None:
        assert list(ours[0]) == list(theirs[0])
    else:
        assert _lists(ours[0]) == _lists(theirs[0])
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


@pytest.mark.parametrize("sense", ["max", "min"])
def test_tournament_on_objects_keeps_its_invariants(sense):
    seqs, evals = _population()
    solutions = PT.ObjectArray.from_values(seqs)
    g = torch.Generator().manual_seed(0)
    picked = PF.tournament(g, solutions, torch.from_numpy(evals), num_tournaments=8, tournament_size=3, objective_sense=sense)
    # the same draws on a tensor population pick the same rows
    g = torch.Generator().manual_seed(0)
    idx = PF.tournament(g, solutions, torch.from_numpy(evals), num_tournaments=8, tournament_size=3, objective_sense=sense, return_indices=True)
    assert _lists(picked) == [seqs[i] for i in idx.tolist()]
    g = torch.Generator().manual_seed(0)
    result = PF.tournament(g, solutions, torch.from_numpy(evals), num_tournaments=8, tournament_size=3, objective_sense=sense, with_evals=True, split_results=True)
    assert _lists(result.parent1_values) + _lists(result.parent2_values) == _lists(picked)
    np.testing.assert_array_equal(torch.cat([result.parent1_evals, result.parent2_evals]).numpy(), evals[idx.numpy()])
    # each pair's two parents are distinct solutions
    assert all(a != b for a, b in zip(idx[:4].tolist(), idx[4:].tolist()))
    # winners beat their candidates: with tournament_size = popsize the
    # first set's winners are all the best solution
    g = torch.Generator().manual_seed(1)
    idx = PF.tournament(g, solutions, torch.from_numpy(evals), num_tournaments=4, tournament_size=200, objective_sense=sense, return_indices=True)
    best = int(np.argmax(evals) if sense == "max" else np.argmin(evals))
    assert idx[:2].tolist() == [best, best]


def test_cut_and_splice_children_are_spliced_from_their_parents():
    problem = PortSequenceProblem()
    batch = problem.generate_batch(12)
    problem.evaluate(batch)
    operator = port_sequence.CutAndSplice(problem, tournament_size=2)
    parents1, parents2 = operator._do_tournament(batch)
    children = operator._do_cross_over(parents1, parents2)
    n = len(parents1)
    assert len(children) == 2 * n and not children.is_evaluated
    for i in range(n):
        a, b = list(parents1[i]), list(parents2[i])
        c1, c2 = list(children.values[i]), list(children.values[n + i])
        assert len(c1) + len(c2) == len(a) + len(b)
        assert any(c1 == a[:i1] + b[len(b) - (len(c1) - i1) :] and c2 == b[: len(b) - (len(c1) - i1)] + a[i1:]
                   for i1 in range(len(a) + 1) if 0 <= len(c1) - i1 <= len(b))  # fmt: skip
    # the deterministic core against a hand-made splice
    core = port_sequence._cut_and_splice_core([[1, 2, 3]], [[7, 8]], [1], [2])
    assert _lists(core) == [[1], [7, 8, 2, 3]]
    cuts = port_sequence._draw_splice_cuts(torch.Generator().manual_seed(0), [0, 5, 2], [3, 0, 9])
    assert all(0 <= c <= m for c, m in zip(cuts[0] + cuts[1], [0, 5, 2, 3, 0, 9]))


def test_object_ga_keeps_its_best_under_elitism():
    """The port's counterpart of ``examples/object_dtype_ga.py``."""
    from evotorch_tpu_torch.algorithms import GeneticAlgorithm

    problem = PortSequenceProblem()
    ga = GeneticAlgorithm(problem, operators=[port_sequence.CutAndSplice(problem, tournament_size=3)], popsize=16)
    best = []
    for _ in range(6):
        ga.step()
        best.append(float(ga.status["pop_best_eval"]))
        assert isinstance(ga.population.values, PT.ObjectArray) and len(ga.population) == 16
        assert ga.population.evals.device == problem.device
    assert all(b2 >= b1 for b1, b2 in zip(best, best[1:]))
    assert float(ga.status["best_eval"]) == max(best)


# ------------------------------------------------------ small tools


def test_misc_helpers_match_jax():
    from evotorch_tpu.tools import misc as jm
    from evotorch_tpu_torch.tools import misc as pm

    for dtype in ("float32", "float64", "int32", "int64", "bool", "uint8", object):
        for name in ("is_dtype_object", "is_dtype_bool", "is_dtype_integer", "is_dtype_float", "is_dtype_real"):
            assert getattr(pm, name)(dtype) == getattr(jm, name)(dtype), (name, dtype)
        assert pm.to_numpy_dtype(dtype) == jm.to_numpy_dtype(dtype)
    for w, k in ((10, 3), (7, 7), (3, 5), (0, 2)):
        assert pm.split_workload(w, k) == jm.split_workload(w, k)
    x = np.array([-2.0, 0.5, 3.0], dtype=np.float32)
    np.testing.assert_array_equal(pm.clip_tensor(torch.from_numpy(x), -1.0, 1.0).numpy(), np.asarray(jm.clip_tensor(x, -1.0, 1.0)))
    container = {"a": np.ones(2, np.float32), "b": [torch.zeros(3), 5]}
    cast = pm.cast_arrays_in_container(container, dtype="float64")
    assert cast["a"].dtype == cast["b"][0].dtype == torch.float64 and cast["b"][1] == 5
    assert pm.dtype_of_container(cast) == torch.float64 and pm.dtype_of_container({"x": 1}) is None
    with pytest.raises(ValueError, match="multiple dtypes"):
        pm.dtype_of_container([torch.zeros(1), torch.zeros(1, dtype=torch.int64)])
    err = pm.ErroneousResult.call(lambda: 1 / 0)
    assert not err and isinstance(err.error, ZeroDivisionError) and pm.ErroneousResult.call(lambda: 3) == 3
    assert pm.pass_through(4) == jm.pass_through(4)
    assert pm.message_from(object(), "hi") == jm.message_from(object(), "hi")
    pm.expect_none("f", a=None)
    with pytest.raises(ValueError, match="unexpected argument b"):
        pm.expect_none("f", a=None, b=1)
    assert pm.set_default_logger_config("WARNING").name == "evotorch_tpu_torch"
    assert _lists(pm.ensure_tensor_length_and_dtype("ab", 3, object, device="cpu")) == _lists(jm.ensure_array_length_and_dtype("ab", 3, object))
    problem = P.Problem("min", solution_length=3, initial_bounds=(-1, 1), device="cpu")
    for t in (torch.zeros(2, 5), torch.zeros((), dtype=torch.float64)):
        u = problem.make_uniform_shaped_like(t, lb=-1, ub=1)
        g = problem.make_gaussian_shaped_like(t, center=2.0, stdev=0.1)
        assert u.shape == g.shape == t.shape and u.dtype == g.dtype == t.dtype
        assert bool(((u >= -1) & (u <= 1)).all())


@pytest.mark.parametrize("comparison", ["<=", ">=", "=="])
def test_constraints_match_jax(comparison):
    from evotorch_tpu.tools import constraints as jc
    from evotorch_tpu_torch.tools import constraints as pc

    lhs = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    rhs = np.float32(0.2)
    tol = dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(pc.violation(torch.from_numpy(lhs), comparison, rhs).numpy(), np.asarray(jc.violation(lhs, comparison, rhs)), **tol)
    for sign in ("-", "+"):
        ours = pc.penalty(torch.from_numpy(lhs), comparison, rhs, penalty_sign=sign, linear=2.0, step=0.5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jc.penalty(lhs, comparison, rhs, penalty_sign=sign, linear=2.0, step=0.5)), **tol)
    if comparison != "==":
        ours = pc.log_barrier(torch.from_numpy(lhs), comparison, rhs, sharpness=2.0).numpy()
        np.testing.assert_allclose(ours, np.asarray(jc.log_barrier(lhs, comparison, rhs, sharpness=2.0)), **tol)
    else:
        with pytest.raises(ValueError):
            pc.log_barrier(lhs, comparison, rhs)
    with pytest.raises(ValueError):
        pc.violation(lhs, "<", rhs)


def test_testing_assertions_match_jax():
    import evotorch_tpu.testing as jt
    import evotorch_tpu_torch.testing as pt

    x = torch.tensor([1.0, 2.0, 3.0])
    pt.assert_allclose(x, np.array([1.0, 2.0, 3.0 + 1e-7]), rtol=1e-6)
    pt.assert_almost_between(x, 1.0, 3.0)
    pt.assert_dtype_matches(x, "float")
    pt.assert_dtype_matches(x, torch.float32)
    pt.assert_shape_matches(torch.zeros(2, 3), (2, "*"))
    pt.assert_eachclose(torch.full((4,), 0.5), 0.5, atol=1e-7)
    for failing in (
        lambda m: m.assert_allclose(np.ones(2), np.zeros(2), atol=0.1),
        lambda m: m.assert_almost_between(np.array([0.0, 5.0]), 1.0, 3.0),
        lambda m: m.assert_dtype_matches(np.ones(2, np.int32), "float"),
        lambda m: m.assert_shape_matches(np.zeros((2, 3)), (3, 2)),
        lambda m: m.assert_eachclose(np.arange(3), 1, atol=0.5),
    ):
        with pytest.raises(pt.TestingError):
            failing(pt)
        with pytest.raises(jt.TestingError):
            failing(jt)
    with pytest.raises(ValueError):
        pt.assert_allclose(x, x)
    batch = P.SolutionBatch(P.Problem("min", solution_length=2, initial_bounds=(0, 1), device="cpu"), 3)
    pt.assert_almost_between(batch, 0.0, 1.0)
