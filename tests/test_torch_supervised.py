"""``SupervisedNE`` of the port against the JAX package's on the CPU.

The minibatches the JAX problem draws are recorded and injected into the
port's problem by monkeypatching its ``_sample_minibatch`` (the two draw
from different generators), so both evaluate the same networks on the same
rows. The losses are means over a minibatch taken in another order, so
they agree to float32 rounding: ``rtol=1e-5, atol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu.neuroevolution import SupervisedNE as JaxSupervisedNE
from evotorch_tpu.neuroevolution.supervisedne import cross_entropy_loss as jax_cross_entropy_loss
from evotorch_tpu_torch.algorithms import SNES
from evotorch_tpu_torch.core import SolutionBatch
from evotorch_tpu_torch.neuroevolution import SupervisedNE, cross_entropy_loss, mse_loss

MLP = "Linear(5, 8) >> Tanh() >> Linear(8, 8) >> Tanh() >> Linear(8, {out})"
LINEAR = "Linear(5, {out})"

CASES = {
    "linear-mse": (LINEAR, "mse"),
    "mlp-mse": (MLP, "mse"),
    "linear-cross_entropy_labels": (LINEAR, "labels"),
    "mlp-cross_entropy_labels": (MLP, "labels"),
    "linear-cross_entropy_one_hot": (LINEAR, "one_hot"),
    "mlp-cross_entropy_one_hot": (MLP, "one_hot"),
}


def _dataset(kind, rng, n=200):
    X = rng.normal(size=(n, 5)).astype(np.float32)
    if kind == "mse":
        return X, (X @ rng.normal(size=(5, 2))).astype(np.float32), 2
    labels = rng.integers(0, 3, size=n)
    if kind == "labels":
        return X, labels.astype(np.int64), 3
    return X, np.eye(3, dtype=np.float32)[labels], 3


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_supervised_losses_match_jax_with_injected_minibatches(case, monkeypatch):
    net, kind = CASES[case]
    rng = np.random.default_rng(len(case))
    X, y, out = _dataset(kind, rng)
    network = net.format(out=out)
    kw = dict(minibatch_size=16, num_minibatches=3, seed=0)
    jax_loss = None if kind == "mse" else jax_cross_entropy_loss
    loss = None if kind == "mse" else cross_entropy_loss
    jax_problem = JaxSupervisedNE((X, y), network, jax_loss, **kw)
    problem = SupervisedNE((X, y), network, loss, device="cpu", **kw)
    assert problem.solution_length == jax_problem.solution_length and problem.minibatch_size == 16

    drawn = []
    jax_draw = jax_problem._sample_minibatch

    def record(key):
        xb, yb = jax_draw(key)
        drawn.append((np.array(xb), np.array(yb)))
        return xb, yb

    monkeypatch.setattr(jax_problem, "_sample_minibatch", record)
    values = (0.5 * rng.normal(size=(12, problem.solution_length))).astype(np.float32)
    jax_batch = JaxSolutionBatch(jax_problem, values=jnp.asarray(values))
    jax_problem.evaluate(jax_batch)
    assert len(drawn) == 3

    replay = list(drawn)
    monkeypatch.setattr(problem, "_sample_minibatch", lambda generator: tuple(torch.from_numpy(a) for a in replay.pop(0)))
    batch = SolutionBatch(problem, values=torch.from_numpy(values))
    problem.evaluate(batch)
    assert not replay
    assert batch.evals.shape == (12, 1)
    np.testing.assert_allclose(batch.evals.numpy(), np.asarray(jax_batch.evals), rtol=1e-5, atol=1e-6)


def test_minibatches_come_from_the_problem_generator():
    """The indices are drawn from the problem's ``torch.Generator``: the
    global RNG is untouched, a reseeded problem draws the same rows, and
    every network of one evaluation sees the same minibatches (the losses
    of two equal networks are equal)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 3)).astype(np.float32)
    y = rng.normal(size=(100, 1)).astype(np.float32)
    problem = SupervisedNE((X, y), "Linear(3, 1)", minibatch_size=8, num_minibatches=2, seed=4, device="cpu")
    assert problem._inputs.device == problem.device and problem._inputs.dtype == torch.float32
    values = torch.randn(6, problem.solution_length, generator=torch.Generator().manual_seed(1))
    values[3] = values[0]
    torch.manual_seed(0)
    global_state = torch.random.get_rng_state()
    first = SolutionBatch(problem, values=values.clone())
    problem.evaluate(first)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert first.evals[0, 0] == first.evals[3, 0]
    problem.manual_seed(4)
    again = SolutionBatch(problem, values=values.clone())
    problem.evaluate(again)
    assert torch.equal(first.evals, again.evals)
    xb, yb = problem._sample_minibatch(torch.Generator().manual_seed(2))
    assert xb.shape == (8, 3) and yb.shape == (8, 1)


def test_loss_functions_match_jax():
    from evotorch_tpu.neuroevolution.supervisedne import mse_loss as jax_mse_loss

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=7)
    one_hot = np.eye(4, dtype=np.float32)[labels]
    target = rng.normal(size=(7, 4)).astype(np.float32)
    pairs = [
        (mse_loss(torch.from_numpy(logits), torch.from_numpy(target)), jax_mse_loss(logits, target)),
        (cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)), jax_cross_entropy_loss(logits, labels)),
        (cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(one_hot)), jax_cross_entropy_loss(logits, one_hot)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_supervised_ne_learns_linear_map():
    """The port of the JAX package's ``test_supervised_ne_learns_linear_map``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 3)).astype(np.float32)
    w_true = np.array([[1.0], [-2.0], [0.5]], dtype=np.float32)
    y = X @ w_true

    problem = SupervisedNE((X, y), "Linear(3, 1)", minibatch_size=64, seed=1, common_minibatch=False, device="cpu")
    searcher = SNES(problem, stdev_init=0.3, popsize=30)
    searcher.run(40)
    assert searcher.status["best_eval"] < 0.5

    # evals are losses on a shared minibatch
    batch = problem.generate_batch(4)
    problem.evaluate(batch)
    assert batch.evals.shape == (4, 1)


def test_supervised_ne_rejects_other_datasets():
    with pytest.raises(TypeError, match="pair"):
        SupervisedNE([np.zeros((4, 2))], "Linear(2, 1)", device="cpu")
    with pytest.raises(ValueError, match="leading length"):
        SupervisedNE((np.zeros((4, 2)), np.zeros((3, 1))), "Linear(2, 1)", device="cpu")
