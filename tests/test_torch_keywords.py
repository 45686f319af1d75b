"""Keywords the JAX package accepts, held against it on the CPU: the port
takes each one with the same meaning (documented there as an effective
no-op, or, where torch can honour it, doing what its name says) instead of
refusing it with a ``TypeError``. Results are compared exactly, or at
``rtol=1e-6`` where the two packages compute in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _runningnorm():
    from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm as JaxRunningNorm
    from evotorch_tpu_torch.neuroevolution.net import RunningNorm

    x = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    ours = RunningNorm(3, device="cpu", min_variance=1e-6)
    theirs = JaxRunningNorm(3, min_variance=1e-6)
    ours.update(torch.from_numpy(x))
    theirs.update(x)
    return ours.normalize(torch.from_numpy(x)).numpy(), np.asarray(theirs.normalize(x))


def _ascent(name, cloned_result):
    import evotorch_tpu.optimizers as jax_optimizers

    import evotorch_tpu_torch.optimizers as optimizers

    kwargs = {"ClipUp": dict(stepsize=0.1), "Adam": dict(stepsize=0.1), "SGD": dict(stepsize=0.1, momentum=0.9)}[name]
    ours = getattr(optimizers, name)(solution_length=4, device="cpu", **kwargs)
    theirs = getattr(jax_optimizers, name)(solution_length=4, **kwargs)
    grads = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    steps = []
    for g in grads:
        step = ours.ascent(torch.from_numpy(g), cloned_result=cloned_result)
        own = getattr(ours, "_velocity", None)
        if cloned_result and own is not None:
            assert step is not own and step.data_ptr() != own.data_ptr()
        steps.append((step.clone(), np.asarray(theirs.ascent(jnp.asarray(g), cloned_result=cloned_result))))
    return np.stack([a.numpy() for a, _ in steps]), np.stack([b for _, b in steps])


def _solution_batch():
    from evotorch_tpu.core import Problem as JaxProblem
    from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
    from evotorch_tpu_torch.core import Problem, SolutionBatch

    values = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    problem = Problem("min", solution_length=3, initial_bounds=(-1, 1), device="cpu")
    jax_problem = JaxProblem("min", solution_length=3, initial_bounds=(-1, 1))
    ours = SolutionBatch(problem, device="cpu", values=torch.from_numpy(values))
    theirs = JaxSolutionBatch(jax_problem, device="cpu", values=jnp.asarray(values))
    assert SolutionBatch(problem, 2, device=torch.device("cpu")).values.shape == (2, 3)
    with pytest.raises(ValueError, match="problem's device"):
        SolutionBatch(problem, 2, device="cuda")
    with pytest.raises(ValueError, match="problem's device"):
        SolutionBatch(slice_of=(ours, slice(0, 2)), device="meta")
    return ours.values.numpy(), np.asarray(theirs.values)


def _make_tensor():
    from evotorch_tpu.core import Problem as JaxProblem
    from evotorch_tpu_torch.core import Problem

    data = [[1.5, -2.0], [0.25, 3.0]]
    ours = Problem("min", solution_length=2, initial_bounds=(-1, 1), device="cpu").make_tensor(data, read_only=True)
    theirs = JaxProblem("min", solution_length=2, initial_bounds=(-1, 1)).make_tensor(data, read_only=True)
    assert ours.dtype == torch.float32
    return ours.numpy(), np.asarray(theirs)


def _modify_tensor():
    from evotorch_tpu.tools.misc import modify_tensor as jax_modify_tensor
    from evotorch_tpu_torch.tools.misc import modify_tensor

    original = np.array([1.0, -2.0, 0.5, 4.0], dtype=np.float32)
    target = np.array([1.5, -1.0, 0.4, 9.0], dtype=np.float32)
    kw = dict(lb=-1.5, ub=4.5, max_change=0.2)
    mine = torch.from_numpy(original.copy())
    returned = modify_tensor(mine, torch.from_numpy(target), **kw, in_place=True)
    assert returned is mine  # the result is written into the original
    fresh = modify_tensor(torch.from_numpy(original), torch.from_numpy(target), **kw, in_place=False)
    assert torch.equal(fresh, mine)
    return mine.numpy(), np.asarray(jax_modify_tensor(original, target, **kw, in_place=True))


CASES = {
    "RunningNorm(min_variance=)": _runningnorm,
    "ClipUp.ascent(cloned_result=True)": lambda: _ascent("ClipUp", True),
    "ClipUp.ascent(cloned_result=False)": lambda: _ascent("ClipUp", False),
    "Adam.ascent(cloned_result=True)": lambda: _ascent("Adam", True),
    "SGD.ascent(cloned_result=True)": lambda: _ascent("SGD", True),
    "SGD.ascent(cloned_result=False)": lambda: _ascent("SGD", False),
    "SolutionBatch(device=)": _solution_batch,
    "make_tensor(read_only=)": _make_tensor,
    "modify_tensor(in_place=)": _modify_tensor,
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_reference_keyword_is_accepted_with_its_meaning(case):
    ours, theirs = CASES[case]()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_grad_estimator_keywords_name_their_roadmap_item():
    """``return_samples``/``return_fitnesses`` apply only to an estimator
    bound to a ``function`` in the JAX package too: unbound, they change
    nothing; bound, the samples and fitnesses follow the gradients. Batched
    parameters (item A.8, ported) give each lane its own gradients.
    Tolerance: exact for the bound form; ``rtol=1e-6`` for a lane of the
    batch, whose products run as one batched matmul (another summation
    order)."""
    from evotorch_tpu_torch.distributions import SeparableGaussian, make_functional_grad_estimator

    estimator = make_functional_grad_estimator(
        SeparableGaussian, objective_sense="max", return_samples=True, return_fitnesses=True
    )
    params = {"mu": torch.zeros(3), "sigma": torch.ones(3)}
    samples = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    grads = estimator(samples, torch.arange(6.0), params)
    assert set(grads) == {"mu", "sigma"}
    bound = make_functional_grad_estimator(
        SeparableGaussian, function=lambda x: x.sum(-1), objective_sense="max", return_samples=True, return_fitnesses=True
    )
    got, drawn, fitnesses = bound(torch.Generator().manual_seed(0), 6, params)
    assert drawn.shape == (6, 3)
    torch.testing.assert_close(fitnesses, drawn.sum(-1), rtol=0, atol=0)
    for k, v in estimator(drawn, fitnesses, params).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    batched = estimator(samples[None], torch.arange(6.0)[None], {"mu": torch.zeros(1, 3), "sigma": torch.ones(1, 3)})
    for k, v in grads.items():
        torch.testing.assert_close(batched[k][0], v, rtol=1e-6, atol=1e-7)
