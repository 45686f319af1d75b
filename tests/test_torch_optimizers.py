"""``TorchOptimizer`` (``evotorch_tpu_torch/optimizers.py``), the port's
counterpart of the JAX package's ``OptaxOptimizer``, against it on the CPU.

Five ``ascent`` calls of seeded float32 gradients of length 33 through each
pair: ``optax.sgd(lr)`` and ``torch.optim.SGD(lr)``; with ``momentum=0.9``,
plain and Nesterov; ``optax.adam(lr, b1, b2, eps)`` and ``torch.optim.Adam(lr,
betas, eps)``. The steps agree to ``rtol=1e-5, atol=2e-6``: the torch
optimizer keeps a center and returns its change, which rounds once more
than optax's update (the largest difference on these inputs is 8.2e-8, for
Adam; 7.5e-8 for Nesterov SGD). Three PGPE generations with ``TorchOptimizer(Adam)``
against the JAX ``PGPE`` with ``OptaxOptimizer(optax.adam)``, the JAX
draws injected: the centers at ``rtol=1e-5, atol=1e-5``.
"""

import numpy as np
import optax
import pytest
import torch

from evotorch_tpu.algorithms import PGPE as JaxPGPE
from evotorch_tpu.optimizers import OptaxOptimizer
from evotorch_tpu_torch.algorithms import PGPE
from evotorch_tpu_torch.optimizers import SGD, Adam, TorchOptimizer
from test_torch_searchers import L, N, _inject_eps, _jax_next_eps, _problems

LENGTH = 33
STEPS = 5
TOL = dict(rtol=1e-5, atol=2e-6)
PGPE_TOL = dict(rtol=1e-5, atol=1e-5)

PAIRS = {
    "sgd": (lambda: optax.sgd(0.1), torch.optim.SGD, dict(lr=0.1)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9), torch.optim.SGD, dict(lr=0.1, momentum=0.9)),
    "sgd_nesterov": (
        lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
        torch.optim.SGD,
        dict(lr=0.1, momentum=0.9, nesterov=True),
    ),
    "adam": (
        lambda: optax.adam(0.1, b1=0.8, b2=0.99, eps=1e-6),
        torch.optim.Adam,
        dict(lr=0.1, betas=(0.8, 0.99), eps=1e-6),
    ),
}


def _gradients(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=LENGTH).astype(np.float32) for _ in range(STEPS)]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_ascent_equals_optax(name):
    make_tx, cls, config = PAIRS[name]
    theirs = OptaxOptimizer(make_tx(), solution_length=LENGTH, dtype="float32")
    ours = TorchOptimizer(cls, solution_length=LENGTH, dtype="float32", device="cpu", **config)
    for grad in _gradients():
        step = ours.ascent(torch.from_numpy(grad))
        assert step.dtype == torch.float32 and step.shape == (LENGTH,)
        np.testing.assert_allclose(step.numpy(), np.asarray(theirs.ascent(grad)), **TOL)
    assert isinstance(ours.contained_optimizer, cls)


def test_sgd_adapter_steps_half_the_gradient():
    """The port's twin of ``tests/test_func_optim.py::test_optax_adapter``."""
    opt = TorchOptimizer(torch.optim.SGD, solution_length=2, dtype="float32", device="cpu", lr=0.5)
    step = opt.ascent(torch.tensor([1.0, -1.0]))
    assert np.allclose(step.numpy(), [0.5, -0.5])


def test_a_factory_and_the_ports_own_optimizers():
    """``optimizer`` may be any callable of a parameter list; a plain list
    gradient is coerced; ``TorchOptimizer(SGD)`` and ``(Adam)`` step as the
    port's own ``SGD`` and ``Adam`` do."""
    grads = _gradients(1)
    factory = lambda params: torch.optim.SGD(params, lr=0.05, momentum=0.9)  # noqa: E731
    ours = TorchOptimizer(factory, solution_length=LENGTH, device="cpu")
    own = SGD(solution_length=LENGTH, device="cpu", stepsize=0.05, momentum=0.9)
    for grad in grads:
        np.testing.assert_allclose(ours.ascent(list(map(float, grad))).numpy(), own.ascent(torch.from_numpy(grad)).numpy(), **TOL)
    ours = TorchOptimizer(torch.optim.Adam, solution_length=LENGTH, device="cpu", lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    own = Adam(solution_length=LENGTH, device="cpu", stepsize=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8)
    for grad in grads:
        np.testing.assert_allclose(ours.ascent(torch.from_numpy(grad)).numpy(), own.ascent(torch.from_numpy(grad)).numpy(), **TOL)
    with pytest.raises(ValueError):
        ours.ascent(torch.zeros(LENGTH + 1))


def test_three_pgpe_generations_with_adam_equal_jax(monkeypatch):
    """PGPE with ``TorchOptimizer(torch.optim.Adam)`` against the JAX
    ``PGPE`` with ``OptaxOptimizer(optax.adam)`` over three ``run``
    generations, the JAX sampler's draws injected: the centers after each."""
    center = np.random.default_rng(9).normal(size=L).astype(np.float32)
    jax_problem, port_problem = _problems()
    kw = dict(popsize=N, center_learning_rate=0.2, stdev_learning_rate=0.1, stdev_init=0.4, center_init=center)
    jax_searcher = JaxPGPE(jax_problem, optimizer=OptaxOptimizer(optax.adam(0.2), solution_length=L), **kw)
    port_searcher = PGPE(
        port_problem, optimizer=TorchOptimizer(torch.optim.Adam, solution_length=L, device="cpu", lr=0.2), **kw
    )
    assert isinstance(port_searcher.optimizer, TorchOptimizer)
    queue = []
    _inject_eps(monkeypatch, queue)
    for _ in range(3):
        queue.append(_jax_next_eps(jax_problem, N))
        jax_searcher.run(1)
        port_searcher.run(1)
        assert not queue
        np.testing.assert_allclose(
            port_searcher.status["center"].numpy(), np.asarray(jax_searcher.status["center"]), **PGPE_TOL
        )
    assert not np.allclose(np.asarray(jax_searcher.status["center"]), center)


def test_torch_optimizer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchOptimizer(torch.optim.Adam, solution_length=3, lr=0.1)
    opt = TorchOptimizer(torch.optim.Adam, solution_length=3, device="cpu", lr=0.1)
    assert opt.contained_optimizer.param_groups[0]["params"][0].device == torch.device("cpu")
