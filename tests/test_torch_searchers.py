"""The port's searchers (PGPE, SNES, CEM, XNES over ``SearchAlgorithm``),
optimizers and distributions against the JAX package's on the CPU.

Tolerances:
- One tell step from the same population and fitnesses (two in a row, so
  the optimizers' state carries over): ``mu`` and ``sigma`` (and XNES's
  ``A_inv``) to ``rtol=1e-5, atol=1e-6``, float32 round-off of sums taken
  in another order (and, for XNES, of another matrix exponential).
- Three ``run`` generations of PGPE on a vectorized sphere, the JAX draws
  injected through ``eps=``: the centers to ``rtol=1e-5, atol=1e-6`` at
  each step (XLA contracts ``mu + sigma * eps`` into an FMA on the CPU, so
  the populations agree to FMA rounding).
- Pickling a searcher: the next step equals the original's exactly.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.algorithms import CEM as JaxCEM
from evotorch_tpu.algorithms import PGPE as JaxPGPE
from evotorch_tpu.algorithms import SNES as JaxSNES
from evotorch_tpu.algorithms import XNES as JaxXNES
from evotorch_tpu.core import Problem as JaxProblem
from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.algorithms import CEM, PGPE, SNES, XNES
from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.distributions import (
    ExpGaussian,
    ExpSeparableGaussian,
    SeparableGaussian,
    SymmetricSeparableGaussian,
)
from evotorch_tpu_torch.optimizers import SGD, Adam, ClipUp, get_optimizer_class
from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch

L, N = 8, 16
TOL = dict(rtol=1e-5, atol=1e-6)


def _sphere_np(x):
    return np.sum(np.asarray(x, dtype=np.float64) ** 2, axis=-1).astype(np.float32)


def torch_sphere(x):
    return torch.sum(x**2, dim=-1)


def _problems(sense="min"):
    kw = dict(solution_length=L, initial_bounds=(-1.0, 1.0), vectorized=True)
    jax_problem = JaxProblem(sense, lambda x: jnp.asarray(_sphere_np(x)), **kw)
    port_problem = Problem(sense, torch_sphere, device="cpu", **kw)
    return jax_problem, port_problem


CONFIGS = [
    ("pgpe_clipup", JaxPGPE, PGPE, dict(popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_min=0.05, stdev_max=0.6)),
    ("pgpe_adam_nonsym", JaxPGPE, PGPE, dict(popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, optimizer="adam", symmetric=False)),
    (
        "pgpe_sgd_momentum",
        JaxPGPE,
        PGPE,
        dict(popsize=N, center_learning_rate=0.05, stdev_learning_rate=0.1, optimizer="sgd", optimizer_config={"momentum": 0.9}, ranking_method="normalized"),
    ),
    ("snes", JaxSNES, SNES, dict(popsize=N)),
    ("snes_adam_clamped", JaxSNES, SNES, dict(popsize=N, optimizer="adam", optimizer_config={"beta1": 0.8}, stdev_max_change=0.1, stdev_min=0.1)),
    ("cem", JaxCEM, CEM, dict(popsize=N, parenthood_ratio=0.5, stdev_max_change=0.3)),
    ("xnes", JaxXNES, XNES, dict(popsize=N)),
]


def _assert_distributions_close(port, jax_dist):
    for key in ("mu", "sigma", "sigma_inv"):
        if key in jax_dist.parameters:
            np.testing.assert_allclose(port.parameters[key].numpy(), np.asarray(jax_dist.parameters[key]), **TOL)


@pytest.mark.parametrize("name,jax_cls,port_cls,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_tell_steps_equal_jax(name, jax_cls, port_cls, kw):
    """Two tells in a row from injected populations and fitnesses."""
    rng = np.random.default_rng(7)
    center = rng.normal(size=L).astype(np.float32)
    jax_problem, port_problem = _problems("min" if name != "cem" else "max")
    jax_searcher = jax_cls(jax_problem, center_init=center, stdev_init=0.3, **kw)
    port_searcher = port_cls(port_problem, center_init=center, stdev_init=0.3, **kw)
    _assert_distributions_close(port_searcher.distribution, jax_searcher.distribution)
    for _ in range(2):
        mu = np.asarray(jax_searcher.distribution.parameters["mu"])
        eps = rng.normal(size=(N // 2, L)).astype(np.float32)
        values = np.stack([mu + 0.3 * eps, mu - 0.3 * eps], axis=1).reshape(N, L).astype(np.float32)
        fitnesses = rng.normal(size=(N, 1)).astype(np.float32)
        jax_searcher._population = JaxSolutionBatch(jax_problem, N, values=values, evals=fitnesses)
        port_searcher._population = SolutionBatch(
            port_problem, N, values=torch.from_numpy(values), evals=torch.from_numpy(fitnesses)
        )
        jax_searcher._first_iter = port_searcher._first_iter = False
        jax_searcher.step()
        port_searcher.step()
        _assert_distributions_close(port_searcher.distribution, jax_searcher.distribution)
        for key in ("center_update_norm", "stdev_norm"):
            np.testing.assert_allclose(port_searcher.status[key], jax_searcher.status[key], rtol=1e-5, atol=1e-6)
    velocity = getattr(jax_searcher.optimizer, "_velocity", None)
    if velocity is not None:
        np.testing.assert_allclose(port_searcher.optimizer._velocity.numpy(), np.asarray(velocity), **TOL)


def _jax_next_eps(jax_problem, popsize):
    """The standard normals the JAX symmetric sampler draws next: its key is
    the problem's next ``split`` (the sphere's evaluation takes no key)."""
    _, key = jax.random.split(jax_problem._rng_key)
    return np.asarray(jax.random.normal(key, (popsize // 2, L), dtype=jnp.float32))


def _inject_eps(monkeypatch, queue):
    original = SymmetricSeparableGaussian.sample

    def sample(self, num_solutions, *, generator=None, eps=None):
        return original(self, num_solutions, eps=torch.from_numpy(queue.pop(0).copy()))

    monkeypatch.setattr(SymmetricSeparableGaussian, "sample", sample)


def test_three_pgpe_generations_equal_jax(monkeypatch):
    """PGPE (ClipUp, centered ranking) on a vectorized sphere over three
    ``run`` generations: the first samples and evaluates, the next two tell
    and resample; centers and status after each step."""
    center = np.random.default_rng(8).normal(size=L).astype(np.float32)
    jax_problem, port_problem = _problems()
    kw = dict(popsize=N, center_learning_rate=0.2, stdev_learning_rate=0.1, stdev_init=0.4, center_init=center)
    jax_searcher = JaxPGPE(jax_problem, **kw)
    port_searcher = PGPE(port_problem, **kw)
    queue = []
    _inject_eps(monkeypatch, queue)
    for _ in range(3):
        queue.append(_jax_next_eps(jax_problem, N))
        jax_searcher.run(1)
        port_searcher.run(1)
        assert not queue
        np.testing.assert_allclose(port_searcher.status["center"].numpy(), np.asarray(jax_searcher.status["center"]), **TOL)
        np.testing.assert_allclose(port_searcher.population.evals.numpy(), np.asarray(jax_searcher.population.evals), rtol=1e-5)
        for key in ("mean_eval", "median_eval", "pop_best_eval", "best_eval", "stdev_norm"):
            np.testing.assert_allclose(port_searcher.status[key], jax_searcher.status[key], rtol=1e-5)
    assert port_searcher.status["iter"] == jax_searcher.status["iter"] == 3


def test_pickled_searcher_resumes_with_the_same_step():
    """A pickled searcher carries its distribution, optimizer state,
    population and the problem's generator state: its next step equals the
    original's bit for bit."""
    _, problem = _problems()
    searcher = PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3)
    searcher.run(2)
    clone = pickle.loads(pickle.dumps(searcher))
    searcher.step()
    clone.step()
    assert torch.equal(clone.status["center"], searcher.status["center"])
    assert torch.equal(clone.population.values, searcher.population.values)
    assert torch.equal(clone.optimizer._velocity, searcher.optimizer._velocity)


def test_optimizers_equal_jax_adapters():
    """The stateful optimizers against the JAX adapters over three ascent
    steps; ``get_optimizer_class`` with a config; the ClipUp parameter
    group."""
    from evotorch_tpu import optimizers as jax_optimizers

    rng = np.random.default_rng(9)
    grads = [rng.normal(size=L).astype(np.float32) for _ in range(3)]
    pairs = [
        (jax_optimizers.ClipUp(solution_length=L, stepsize=0.1), ClipUp(solution_length=L, stepsize=0.1, device="cpu")),
        (jax_optimizers.Adam(solution_length=L, stepsize=0.05), Adam(solution_length=L, stepsize=0.05, device="cpu")),
        (
            jax_optimizers.SGD(solution_length=L, stepsize=0.05, momentum=0.5),
            SGD(solution_length=L, stepsize=0.05, momentum=0.5, device="cpu"),
        ),
    ]
    for jax_opt, port_opt in pairs:
        for g in grads:
            np.testing.assert_allclose(port_opt.ascent(torch.from_numpy(g)).numpy(), np.asarray(jax_opt.ascent(g)), **TOL)
    clipup = get_optimizer_class("clipup", {"max_speed": 0.3})(solution_length=L, stepsize=0.1, device="cpu")
    assert isinstance(clipup, ClipUp) and clipup.param_groups[0]["max_speed"] == 0.3
    clipup.param_groups[0]["lr"] = 0.2
    assert clipup._stepsize == 0.2
    with pytest.raises(ValueError):
        clipup.param_groups[0]["momentum"] = 1.5
    with pytest.raises(ValueError):
        get_optimizer_class("lbfgs")


def test_distributions_sample_and_kl():
    """Sampling with injected noise equals the JAX formulas; the symmetric
    sampler's antithetic layout; the KL divergence; ExpGaussian's
    coordinates."""
    from evotorch_tpu import distributions as jax_distributions

    rng = np.random.default_rng(10)
    mu, sigma = rng.normal(size=L).astype(np.float32), (0.1 + rng.random(L)).astype(np.float32)
    params = {"mu": torch.from_numpy(mu), "sigma": torch.from_numpy(sigma)}
    eps = rng.normal(size=(6, L)).astype(np.float32)
    np.testing.assert_allclose(
        SeparableGaussian(params).sample(6, eps=torch.from_numpy(eps)).numpy(), mu + sigma * eps, rtol=1e-6
    )
    sym = SymmetricSeparableGaussian(params).sample(6, eps=torch.from_numpy(eps[:3]))
    torch.testing.assert_close(sym[0::2] + sym[1::2], 2 * params["mu"].expand(3, L), rtol=1e-6, atol=1e-6)
    drawn = SymmetricSeparableGaussian(params, seed=1).sample(4)
    assert drawn.shape == (4, L) and bool(torch.isfinite(drawn).all())
    other = {"mu": torch.from_numpy(mu + 0.5), "sigma": torch.from_numpy(sigma * 1.5)}
    jax_kl = jax_distributions.SeparableGaussian({"mu": mu, "sigma": sigma}).relative_entropy(
        jax_distributions.SeparableGaussian({"mu": mu + 0.5, "sigma": sigma * 1.5})
    )
    assert SeparableGaussian(params).relative_entropy(SeparableGaussian(other)) == pytest.approx(jax_kl, rel=1e-5)
    xnes = ExpGaussian(params)
    z = torch.from_numpy(eps)
    torch.testing.assert_close(xnes.to_local_coordinates(xnes.to_global_coordinates(z)), z, rtol=1e-4, atol=1e-5)
    assert torch.equal(xnes.sample(6, eps=z), xnes.to_global_coordinates(z))
    assert ExpSeparableGaussian(params).modified_copy(sigma=params["sigma"] * 2).generator is not None
    with pytest.raises(ValueError, match="unrecognized"):
        SeparableGaussian({**params, "bogus": 1})


def test_status_keys_hooks_and_unported_options(tmp_path):
    _, problem = _problems()
    searcher = PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3)
    ends = []
    searcher.end_of_run_hook.append(lambda status: ends.append(status["iter"]))
    searcher.after_step_hook.append(lambda: {"extra": 1})
    searcher.run(2, profile_dir=str(tmp_path / "trace"))
    status = dict(searcher.status.items())
    for key in ("iter", "step_seconds", "center", "stdev", "mean_eval", "pop_best", "best", "best_eval", "extra"):
        assert key in status, key
    assert isinstance(searcher.status["mean_eval"], float) and ends == [2]
    assert (tmp_path / "trace" / "trace.json").exists()
    # distributed=True is ported (multi-GPU): one rank, no process group, the
    # problem samples, evaluates and estimates (tests/test_torch_distributed_oo.py
    # runs it over ranks)
    distributed = PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, distributed=True)
    distributed.run(2)
    assert math.isfinite(distributed.status["mean_eval"])
    # factored populations are ported: lowrank_rank samples one (held against
    # the JAX package in tests/test_torch_lowrank.py); a rank below 1 is refused
    factored = PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, lowrank_rank=4)
    factored.step()
    assert isinstance(factored.population.values, LowRankParamsBatch)
    assert factored.population.values.coeffs.shape == (N, 4)
    with pytest.raises(ValueError, match="lowrank_rank"):
        PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, lowrank_rank=0)
    with pytest.raises(ValueError, match="even"):
        PGPE(problem, popsize=5, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3)
    with pytest.raises(ValueError):
        PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1)


def test_adaptive_popsize_reads_the_interaction_counter():
    """With ``num_interactions`` the searcher samples rounds of ``popsize``
    until the problem reports more interactions than that."""
    _, problem = _problems()
    count = {"n": 0}

    def report(batch):
        count["n"] += 10 * len(batch)
        return {"total_interaction_count": count["n"]}

    problem.after_eval_hook.append(report)
    searcher = PGPE(
        problem, popsize=4, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, num_interactions=100
    )
    searcher.step()
    assert searcher.status["popsize"] == 12  # 3 rounds: 40, 80, 120 > 100


def _jax_searcher_arrays(searcher) -> dict:
    """A JAX OO searcher's state flattened into the interop dict."""
    out = {f"distribution.{k}": np.asarray(v) for k, v in searcher.distribution.parameters.items() if not isinstance(v, str)}
    fields = {"ClipUp": ("velocity",), "SGD": ("velocity",), "Adam": ("m", "v", "t")}
    for name in fields[type(searcher.optimizer).__name__]:
        out[f"optimizer.{name}"] = np.asarray(getattr(searcher.optimizer, f"_{name}"))
    return out


def test_interop_carries_a_jax_searcher_state():
    """A JAX OO searcher's distribution and optimizer state carried across as
    numpy arrays: the port then takes the same next tell."""
    rng = np.random.default_rng(11)
    center = rng.normal(size=L).astype(np.float32)
    for optimizer in ("clipup", "adam", "sgd"):
        jax_problem, port_problem = _problems()
        kw = dict(popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, optimizer=optimizer)
        jax_searcher = JaxPGPE(jax_problem, center_init=center, **kw)
        jax_searcher.run(2)
        port_searcher = PGPE(port_problem, center_init=np.zeros(L, dtype=np.float32), **kw)
        interop.load_searcher_state(port_searcher, _jax_searcher_arrays(jax_searcher))
        _assert_distributions_close(port_searcher.distribution, jax_searcher.distribution)
        values = np.array(jax_searcher.population.values)
        evals = np.array(jax_searcher.population.evals)
        port_searcher._population = SolutionBatch(port_problem, N, values=torch.from_numpy(values), evals=torch.from_numpy(evals))
        port_searcher._first_iter = False
        jax_searcher.step()
        port_searcher.step()
        _assert_distributions_close(port_searcher.distribution, jax_searcher.distribution)
        back = interop.searcher_state_to_numpy(port_searcher)
        np.testing.assert_allclose(back["distribution.mu"], np.asarray(jax_searcher.distribution.parameters["mu"]), **TOL)


def test_distribution_without_tensors_defaults_to_the_card(monkeypatch):
    """A distribution whose parameters are not tensors, given no device,
    runs on the card like every entry point: without one it raises, naming
    ``device="cpu"``; it used to land on the CPU silently. Tensors keep
    their own device, and ``device="cpu"`` is honoured."""
    params = {"mu": np.zeros(3, dtype=np.float32), "sigma": np.ones(3, dtype=np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SeparableGaussian, SymmetricSeparableGaussian, ExpGaussian):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls(params)
        assert cls(params, device="cpu").device == torch.device("cpu")
        assert cls({k: torch.from_numpy(v) for k, v in params.items()}).device == torch.device("cpu")
