"""The port's low-rank populations against the JAX package's, on the CPU:
``tools/lowrank.py``, ``net/lowrank.py``'s low-rank forward, the factored
sampler and gradients of ``SymmetricSeparableGaussian``, the functional
``pgpe_ask_lowrank``/``pgpe_tell_lowrank``, factored batches in the rollout
engine, ``SolutionBatch``, ``PGPE(lowrank_rank=)`` and ``VecNE``.

Inputs are made from a seed with numpy and carried to both packages; where
the port draws (the basis and the coefficients), the test patches its
private draw steps with the JAX sampler's own draws, replayed from its key
(``split(key)``: part 0 the basis, part 1 the coefficients).

Tolerances:
- Forwards (port against its own dense forward and against JAX's low-rank
  forward): ``rtol=1e-5, atol=1e-6`` (float32 products of at most 17
  terms and one per-lane sum of ``k`` terms, in another order).
- Recurrent forwards over 4 steps: the same, the state carried.
- Samplers given JAX's draws: the coefficients exact; the basis to
  ``rtol=1e-6`` (an ulp or two: XLA fuses the normal draw with its scaling
  by ``sigma / sqrt(k)`` and contracts it, as ``ROADMAP.md``'s reference
  caveats note for the dense sampler).
- ``pgpe_tell_lowrank`` against JAX's: ``rtol=1e-5, atol=1e-6``; against
  the port's dense ``pgpe_tell`` of the materialized population: ``rtol=
  1e-4, atol=1e-6`` (the factored gradient sums over the basis's rank, the
  dense one over the population: float32 round-off of different sums,
  scaled by ClipUp's normalization; the JAX package's own test holds the
  same pair to the same tolerance).
- Rollouts, low-rank against dense: CartPole scores ``atol=1e-4`` (they
  are episode lengths), steps exact.
- ``basis_capture`` against JAX's: ``rtol=1e-4`` (a ``k x k`` solve with a
  1e-12 ridge, then a square root).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
from evotorch_tpu.algorithms.functional import pgpe_ask_lowrank as jax_pgpe_ask_lowrank
from evotorch_tpu.algorithms.functional import pgpe_tell_lowrank as jax_pgpe_tell_lowrank
from evotorch_tpu.distributions import SymmetricSeparableGaussian as JaxSymmetricSeparableGaussian
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import layers as jax_layers
from evotorch_tpu.neuroevolution.net.lowrank import lowrank_forward as jax_lowrank_forward
from evotorch_tpu.tools.lowrank import LowRankParamsBatch as JaxLowRankParamsBatch
from evotorch_tpu.tools.lowrank import basis_capture as jax_basis_capture
from evotorch_tpu_torch import distributions, interop
from evotorch_tpu_torch.algorithms import PGPE, SNES
from evotorch_tpu_torch.algorithms.gaussian import GaussianSearchAlgorithm
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask_lowrank, pgpe_tell, pgpe_tell_lowrank
from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.decorators import vectorized
from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian
from evotorch_tpu_torch.envs import CartPole, make_env
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import (
    LSTM,
    RNN,
    FlatParamsPolicy,
    Linear,
    Tanh,
    lowrank_forward,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    stats_init,
)
from evotorch_tpu_torch.neuroevolution.net.layers import Module, state_leaves
from evotorch_tpu_torch.neuroevolution.net.lowrank import lowrank_supported, prepare_lowrank
from evotorch_tpu_torch.parallel import make_generation_step
from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch, basis_capture, dense_values, is_factored

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TELL_TOL = dict(rtol=1e-5, atol=1e-6)
DENSE_TELL_TOL = dict(rtol=1e-4, atol=1e-6)

# (port network, JAX network, input width)
NETS = {
    "mlp": (lambda: Linear(9, 16) >> Tanh() >> Linear(16, 4) >> Tanh(), lambda: jax_layers.Linear(9, 16) >> jax_layers.Tanh() >> jax_layers.Linear(16, 4) >> jax_layers.Tanh(), 9),
    "rnn": (lambda: RNN(5, 7) >> Tanh() >> Linear(7, 3), lambda: jax_layers.RNN(5, 7) >> jax_layers.Tanh() >> jax_layers.Linear(7, 3), 5),
    "lstm": (lambda: LSTM(5, 7) >> Linear(7, 3), lambda: jax_layers.LSTM(5, 7) >> jax_layers.Linear(7, 3), 5),
    "mixed": (
        lambda: Linear(5, 6) >> Tanh() >> LSTM(6, 8) >> Linear(8, 3),
        lambda: jax_layers.Linear(5, 6) >> jax_layers.Tanh() >> jax_layers.LSTM(6, 8) >> jax_layers.Linear(8, 3),
        5,
    ),
}


def _random_arrays(L, n, k, seed):
    rng = np.random.default_rng(seed)
    return {
        "center": (rng.normal(size=L) * 0.3).astype(np.float32),
        "basis": (rng.normal(size=(L, k)) * 0.1).astype(np.float32),
        "coeffs": rng.normal(size=(n, k)).astype(np.float32),
    }


def _both(arrays):
    port = interop.lowrank_batch_from_numpy(arrays, device="cpu")
    theirs = JaxLowRankParamsBatch(*(jnp.asarray(arrays[k]) for k in ("center", "basis", "coeffs")))
    return port, theirs


class _Unstructured(Module):
    """A module whose parameter enters per feature, not through a product:
    it has no structured factored path."""

    def param_shapes(self):
        return [("scale", (3,))]

    def apply(self, params, x, state=None):
        return x * params[0], state


def _cartpole_policy(hidden=16):
    env = CartPole(continuous_actions=True, device="cpu")
    return env, FlatParamsPolicy(Linear(env.observation_size, hidden) >> Tanh() >> Linear(hidden, env.action_size))


def test_supported_detection():
    assert lowrank_supported(NETS["mlp"][0]())
    assert lowrank_supported(LSTM(4, 8) >> Linear(8, 2))
    assert lowrank_supported(RNN(4, 8) >> Linear(8, 2))
    assert not lowrank_supported(Linear(4, 3) >> _Unstructured())


def test_unsupported_module_falls_back_with_warning():
    policy = FlatParamsPolicy(Linear(3, 3) >> _Unstructured())
    params, _ = _both(_random_arrays(policy.parameter_count, 4, 2, seed=10))
    obs = torch.from_numpy(np.random.default_rng(12).normal(size=(4, 3)).astype(np.float32))
    with pytest.warns(UserWarning, match="materializ"):
        out, _ = lowrank_forward(policy, params, None, obs, None)
    dense, _ = policy(params.materialize(), obs)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(Linear(4, 3) >> _Unstructured() >> Linear(3, 1))
    params, _ = _both(_random_arrays(policy.parameter_count, 4, 2, seed=11))
    with pytest.warns(UserWarning, match="materializ"):
        result = run_vectorized_rollout(env, policy, params, torch.Generator().manual_seed(0), None, episode_length=10)
    assert bool(torch.isfinite(result.scores).all())


@pytest.mark.parametrize("name", list(NETS))
def test_structured_forward_matches_dense_and_jax(name):
    make_port, make_jax, in_dim = NETS[name]
    policy, jax_policy = FlatParamsPolicy(make_port()), JaxFlatParamsPolicy(make_jax())
    assert policy.parameter_count == jax_policy.parameter_count
    params, jax_params = _both(_random_arrays(policy.parameter_count, 6, 4, seed=4))
    prepared = prepare_lowrank(policy, params)
    rng = np.random.default_rng(5)
    states = dense_states = jax_states = None
    for _ in range(4):
        obs = rng.normal(size=(6, in_dim)).astype(np.float32)
        out, states = lowrank_forward(policy, params, prepared, torch.from_numpy(obs), states)
        dense, dense_states = policy(params.materialize(), torch.from_numpy(obs), dense_states)
        jax_out, jax_states = jax_lowrank_forward(jax_policy, jax_params, None, jnp.asarray(obs), jax_states)
        np.testing.assert_allclose(out.numpy(), dense.numpy(), **FWD_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **FWD_TOL)
        ours, theirs = state_leaves(states), jax.tree_util.tree_leaves(jax_states)
        assert len(ours) == len(theirs) == len(state_leaves(dense_states))
        for a, b, c in zip(ours, state_leaves(dense_states), theirs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **FWD_TOL)


def test_batch_algebra_and_interop():
    arrays = _random_arrays(30, 8, 3, seed=1)
    params, jax_params = _both(arrays)
    assert is_factored(params) and params.popsize == 8 and params.rank == 3
    np.testing.assert_allclose(params.materialize().numpy(), np.asarray(jax_params.materialize()), rtol=1e-6, atol=1e-7)
    sub = params.take(torch.tensor([1, 3, 5]))
    assert sub.center is params.center and sub.basis is params.basis and sub.coeffs.shape == (3, 3)
    torch.testing.assert_close(sub.materialize(), params.materialize()[[1, 3, 5]])
    back = interop.lowrank_batch_to_numpy(params)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    assert dense_values(params).shape == (8, 30) and dense_values(params.center) is params.center


def _jax_lowrank_draws(key, L, n, k):
    """The JAX sampler's draws: ``split(key)``, the basis from part 0 and the
    coefficients from part 1."""
    key_basis, key_coeffs = jax.random.split(key)
    return (
        torch.from_numpy(np.array(jax.random.normal(key_basis, (L, k), jnp.float32))),
        torch.from_numpy(np.array(jax.random.normal(key_coeffs, (n // 2, k), jnp.float32))),
    )


def _inject(monkeypatch, basis=None, coeffs=None):
    if basis is not None:
        monkeypatch.setattr(distributions, "_draw_lowrank_basis", lambda g, shape, dtype: basis)
    if coeffs is not None:
        monkeypatch.setattr(distributions, "_draw_lowrank_coeffs", lambda g, shape, dtype: coeffs)


def test_pgpe_ask_and_tell_lowrank_match_jax_and_dense(monkeypatch):
    L, n, k = 40, 24, 6
    rng = np.random.default_rng(11)
    kw = dict(center_learning_rate=0.3, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.7)
    center = rng.normal(size=L).astype(np.float32)
    jax_state = jax_pgpe(center_init=jnp.asarray(center), optimizer="clipup", optimizer_config={"max_speed": 0.3}, **kw)
    state = pgpe(center_init=torch.from_numpy(center), optimizer="clipup", optimizer_config={"max_speed": 0.3}, **kw)
    for generation in range(3):  # later generations carry a ClipUp velocity
        key = jax.random.key(generation)
        jax_params = jax_pgpe_ask_lowrank(key, jax_state, popsize=n, rank=k)
        _inject(monkeypatch, *_jax_lowrank_draws(key, L, n, k))
        params = pgpe_ask_lowrank(torch.Generator(), state, popsize=n, rank=k)
        assert isinstance(params, LowRankParamsBatch) and params.coeffs.shape == (n, k)
        torch.testing.assert_close(params.coeffs[0::2], -params.coeffs[1::2], rtol=0, atol=0)
        np.testing.assert_array_equal(params.coeffs.numpy(), np.asarray(jax_params.coeffs))
        # the center and stdev are the tells' (exact before the first)
        center_tol = dict(rtol=0, atol=0) if generation == 0 else TELL_TOL
        np.testing.assert_allclose(params.center.numpy(), np.asarray(jax_params.center), **center_tol)
        np.testing.assert_allclose(params.basis.numpy(), np.asarray(jax_params.basis), rtol=1e-6 if generation == 0 else 1e-5)
        evals = rng.normal(size=n).astype(np.float32)
        dense_state = pgpe_tell(state, params.materialize(), torch.from_numpy(evals))
        state = pgpe_tell_lowrank(state, params, torch.from_numpy(evals))
        jax_state = jax_pgpe_tell_lowrank(jax_state, jax_params, jnp.asarray(evals))
        np.testing.assert_allclose(state.stdev.numpy(), np.asarray(jax_state.stdev), **TELL_TOL)
        np.testing.assert_allclose(state.stdev.numpy(), dense_state.stdev.numpy(), **DENSE_TELL_TOL)
        for field in ("center", "velocity"):
            ours = getattr(state.optimizer_state, field).numpy()
            np.testing.assert_allclose(ours, np.asarray(getattr(jax_state.optimizer_state, field)), **TELL_TOL)
            np.testing.assert_allclose(ours, getattr(dense_state.optimizer_state, field).numpy(), **DENSE_TELL_TOL)


def test_sampler_basis_reuse_and_rank_check(monkeypatch):
    L, n, k = 20, 8, 3
    mu, sigma = np.zeros(L, np.float32), np.full(L, 0.5, np.float32)
    key = jax.random.key(7)
    jax_dist = JaxSymmetricSeparableGaussian({"mu": jnp.asarray(mu), "sigma": jnp.asarray(sigma)})
    theirs = jax_dist.sample_lowrank(n, k, key=key)
    dist = SymmetricSeparableGaussian({"mu": torch.from_numpy(mu), "sigma": torch.from_numpy(sigma)}, device="cpu")
    _inject(monkeypatch, *_jax_lowrank_draws(key, L, n, k))
    ours = dist.sample_lowrank(n, k)
    np.testing.assert_allclose(ours.basis.numpy(), np.asarray(theirs.basis), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ours.coeffs.numpy(), np.asarray(theirs.coeffs))
    assert ours.center is dist.mu
    monkeypatch.undo()
    again = dist.sample_lowrank(6, k, basis=ours.basis)
    assert again.basis is ours.basis and again.coeffs.shape == (6, k)
    with pytest.raises(ValueError, match="rank"):
        dist.sample_lowrank(6, k + 1, basis=ours.basis)
    with pytest.raises(ValueError, match="even"):
        dist.sample_lowrank(5, k)


def test_oo_gradients_match_dense_and_jax():
    L, n, k = 20, 12, 5
    params_np = {
        "mu": np.zeros(L, np.float32),
        "sigma": np.full(L, 0.6, np.float32),
        "divide_mu_grad_by": "num_directions",
        "divide_sigma_grad_by": "num_directions",
    }
    jax_dist = JaxSymmetricSeparableGaussian({k_: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k_, v in params_np.items()})
    jax_params = jax_dist.sample_lowrank(n, k, key=jax.random.key(7))
    params = interop.lowrank_batch_from_numpy({f: np.asarray(getattr(jax_params, f)) for f in ("center", "basis", "coeffs")}, device="cpu")
    dist = SymmetricSeparableGaussian({k_: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k_, v in params_np.items()}, device="cpu")
    fitnesses = np.random.default_rng(8).normal(size=n).astype(np.float32)
    kw = dict(objective_sense="max", ranking_method="centered")
    g_lr = dist.compute_gradients(params, torch.from_numpy(fitnesses), **kw)
    g_dense = dist.compute_gradients(params.materialize(), torch.from_numpy(fitnesses), **kw)
    g_jax = jax_dist.compute_gradients(jax_params, jnp.asarray(fitnesses), **kw)
    for name in ("mu", "sigma"):
        np.testing.assert_allclose(g_lr[name].numpy(), g_dense[name].numpy(), **DENSE_TELL_TOL)
        np.testing.assert_allclose(g_lr[name].numpy(), np.asarray(g_jax[name]), **TELL_TOL)


def test_basis_capture_matches_jax():
    rng = np.random.default_rng(0)
    L, k = 2000, 16
    basis = rng.normal(size=(L, k)).astype(np.float32)
    v = rng.normal(size=L).astype(np.float32)
    cap = basis_capture(torch.from_numpy(basis), torch.from_numpy(v))
    np.testing.assert_allclose(float(cap), float(jax_basis_capture(jnp.asarray(basis), jnp.asarray(v))), rtol=1e-4)
    expected = (k / L) ** 0.5
    assert 0.2 * expected < float(cap) < 5 * expected
    in_span = torch.from_numpy(basis) @ torch.from_numpy(rng.normal(size=k).astype(np.float32))
    assert float(basis_capture(torch.from_numpy(basis), in_span)) > 0.999
    assert float(basis_capture(torch.from_numpy(basis), torch.zeros(L))) == 1.0


@vectorized
def _sphere(xs):
    return torch.sum(xs**2, dim=-1)


def _sphere_problem(length=30):
    return Problem("min", _sphere, solution_length=length, initial_bounds=(2.5, 3.5), device="cpu")


def test_exhaustion_warning_fires_once():
    # rank 4 against L = 2,000: a random basis captures ~sqrt(4/2000) = 4.5%
    # of the accumulated direction, under the 10% threshold every generation
    searcher = PGPE(
        _sphere_problem(2_000), popsize=16, center_learning_rate=0.05, stdev_learning_rate=0.1, stdev_init=0.1,
        lowrank_rank=4,
    )  # fmt: skip
    assert searcher.status["basis_capture"] is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(7):
            searcher.step()
    capture = searcher.status["basis_capture"]
    assert capture is not None and capture < 0.1
    exhaustion = [w for w in caught if "subspace exhaustion" in str(w.message)]
    assert len(exhaustion) == 1 and "rank-4" in str(exhaustion[0].message)


def test_oo_pgpe_lowrank_improves_sphere():
    searcher = PGPE(
        _sphere_problem(), popsize=64, center_learning_rate=0.5, stdev_learning_rate=0.1, stdev_init=0.5,
        optimizer="adam", lowrank_rank=8,
    )  # fmt: skip
    searcher.run(40)
    assert float(searcher.status["mean_eval"]) < 30.0  # from ~9 * 30
    assert float(searcher.status["best_eval"]) < 30.0
    assert searcher.status["best"].values.shape == (30,)


def test_oo_population_is_factored_and_refuses_writes():
    searcher = PGPE(_sphere_problem(), popsize=16, center_learning_rate=0.3, stdev_learning_rate=0.1, stdev_init=0.5, lowrank_rank=4)
    searcher.step()
    pop = searcher.population
    values = pop.values
    assert isinstance(values, LowRankParamsBatch) and values.coeffs.shape == (16, 4) and len(pop) == 16
    sub = pop[2:6]
    assert isinstance(sub.values, LowRankParamsBatch)
    torch.testing.assert_close(sub.values.coeffs, values.coeffs[2:6], rtol=0, atol=0)
    taken = pop.take([7, 1])
    torch.testing.assert_close(taken.values.coeffs, values.coeffs[[7, 1]], rtol=0, atol=0)
    torch.testing.assert_close(pop[3].values, values.materialize()[3], rtol=1e-6, atol=1e-6)
    # the best row is densified from its coefficient row
    best = int(torch.argmin(pop.evals[:, 0]))
    assert float(searcher.status["pop_best_eval"]) == float(pop.evals[best, 0])
    torch.testing.assert_close(searcher.status["pop_best"].values, values.materialize()[best], rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="factored"):
        pop[0].set_values(torch.zeros(30))
    with pytest.raises(NotImplementedError, match="slice"):
        sub.set_values(sub.values)
    with pytest.raises(TypeError, match="factored"):
        pop.set_values(values.materialize())
    pop.set_values(values._replace(coeffs=values.coeffs.flip(0)))
    assert not pop.is_evaluated
    clone = pop.clone()
    assert isinstance(clone.values, LowRankParamsBatch) and clone.values.coeffs is not pop.values.coeffs


def test_oo_pgpe_lowrank_validation():
    problem = _sphere_problem()
    with pytest.raises(ValueError, match="symmetric"):
        PGPE(problem, popsize=16, center_learning_rate=0.3, stdev_learning_rate=0.1, stdev_init=0.5, symmetric=False, lowrank_rank=4)
    with pytest.raises(ValueError, match=">= 1"):
        PGPE(problem, popsize=16, center_learning_rate=0.3, stdev_learning_rate=0.1, stdev_init=0.5, lowrank_rank=0)
    # the shared engine's check, for a distribution without a factored sampler
    with pytest.raises(ValueError, match="factored sampler"):
        GaussianSearchAlgorithm.__init__(
            SNES.__new__(SNES), problem, popsize=16, center_learning_rate=1.0, stdev_learning_rate=0.1, stdev_init=0.5,
            lowrank_rank=4,
        )  # fmt: skip


def test_factored_cat_shared_basis():
    problem = _sphere_problem()
    dist = SymmetricSeparableGaussian({"mu": torch.zeros(30), "sigma": torch.full((30,), 0.5)}, device="cpu")
    first = dist.sample_lowrank(8, 3)
    second = dist.sample_lowrank(6, 3, basis=first.basis)
    merged = SolutionBatch.cat([SolutionBatch(problem, values=first), SolutionBatch(problem, values=second)])
    assert isinstance(merged.values, LowRankParamsBatch) and merged.values.coeffs.shape == (14, 3)
    torch.testing.assert_close(merged.values.materialize(), torch.cat([first.materialize(), second.materialize()]))


def test_factored_cat_refusals():
    problem = _sphere_problem()
    dist = SymmetricSeparableGaussian({"mu": torch.zeros(30), "sigma": torch.full((30,), 0.5)}, device="cpu")
    a, b = dist.sample_lowrank(8, 3), dist.sample_lowrank(8, 3)  # two bases
    with pytest.raises(ValueError, match="materialize"):
        SolutionBatch.cat([SolutionBatch(problem, values=a), SolutionBatch(problem, values=b)])
    # equal values in another tensor are refused too: the check is an `is`
    copy = a._replace(basis=a.basis.clone())
    with pytest.raises(ValueError, match="share one generation's"):
        SolutionBatch.cat([SolutionBatch(problem, values=a), SolutionBatch(problem, values=copy)])
    with pytest.raises(TypeError, match="factored"):
        SolutionBatch.cat([SolutionBatch(problem, values=a), SolutionBatch(problem, values=a.materialize())])


def test_plain_fitness_gets_the_dense_population():
    seen = []

    @vectorized
    def fitness(xs):
        seen.append(xs)
        return torch.sum(xs, dim=-1)

    problem = Problem("max", fitness, solution_length=10, initial_bounds=(-1, 1), device="cpu")
    params = interop.lowrank_batch_from_numpy(_random_arrays(10, 4, 2, seed=3), device="cpu")
    batch = SolutionBatch(problem, values=params)
    problem.evaluate(batch)
    assert isinstance(seen[0], torch.Tensor) and seen[0].shape == (4, 10)
    torch.testing.assert_close(batch.evals[:, 0], params.materialize().sum(-1))


@pytest.mark.parametrize("mode", ["budget", "episodes", "episodes_refill", "episodes_compact"])
def test_rollout_lowrank_matches_dense(mode):
    env, policy = _cartpole_policy()
    params, _ = _both(_random_arrays(policy.parameter_count, 16, 6, seed=6))
    kw = dict(num_episodes=2, episode_length=60, observation_normalization=True)
    if mode == "episodes_compact":
        run = lambda p: run_vectorized_rollout_compacting(  # noqa: E731
            env, policy, p, torch.Generator().manual_seed(9), stats_init(4, device="cpu"), chunk_size=10,
            allowed_widths=(4, 8), **kw,
        )  # fmt: skip
    else:
        extra = dict(refill_width=4) if mode == "episodes_refill" else {}
        run = lambda p: run_vectorized_rollout(  # noqa: E731
            env, policy, p, torch.Generator().manual_seed(9), stats_init(4, device="cpu"), eval_mode=mode, **kw, **extra
        )
    factored, dense = run(params), run(params.materialize())
    np.testing.assert_allclose(factored.scores.numpy(), dense.scores.numpy(), atol=1e-4)
    assert factored.total_steps == dense.total_steps
    torch.testing.assert_close(factored.telemetry, dense.telemetry, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["episodes", "episodes_refill"])
def test_recurrent_rollout_lowrank_matches_dense(mode):
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(LSTM(env.observation_size, 8) >> Linear(8, env.action_size))
    params, _ = _both(_random_arrays(policy.parameter_count, 8, 3, seed=13))
    extra = dict(refill_width=4) if mode == "episodes_refill" else {}
    results = [
        run_vectorized_rollout(env, policy, p, torch.Generator().manual_seed(4), None, eval_mode=mode, episode_length=40, **extra)
        for p in (params, params.materialize())
    ]
    np.testing.assert_allclose(results[0].scores.numpy(), results[1].scores.numpy(), atol=1e-4)
    assert results[0].total_steps == results[1].total_steps


def test_rollout_lowrank_budget_bf16():
    env = make_env("hopper", device="cpu")
    policy = FlatParamsPolicy(Linear(env.observation_size, 8) >> Tanh() >> Linear(8, env.action_size))
    params, _ = _both(_random_arrays(policy.parameter_count, 8, 4, seed=7))
    result = run_vectorized_rollout(
        env, policy, params, torch.Generator().manual_seed(1), None, episode_length=30, eval_mode="budget",
        compute_dtype=torch.bfloat16,
    )  # fmt: skip
    assert result.total_steps == 8 * 30 and result.scores.dtype == torch.float32
    assert bool(torch.isfinite(result.scores).all())
    assert params.coeffs.dtype == torch.float32  # the caller's batch is not cast


def test_generation_step_lowrank():
    env, policy = _cartpole_policy()
    state = pgpe(center_init=torch.zeros(policy.parameter_count), center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1)
    asked = []

    def ask(generator, s):
        asked.append(pgpe_ask_lowrank(generator, s, popsize=16, rank=4))
        return asked[-1]

    generation = make_generation_step(
        env, policy, ask=ask, tell=pgpe_tell_lowrank, popsize=16, device="cpu", eval_mode="budget", episode_length=20
    )
    new_state, scores, _, total_steps, telemetry = generation(state, torch.Generator().manual_seed(0), stats_init(4, device="cpu"))
    assert total_steps == 16 * 20 and telemetry.shape == (1, 20)
    expected = pgpe_tell_lowrank(state, asked[0], scores)
    torch.testing.assert_close(new_state.optimizer_state.center, expected.optimizer_state.center, rtol=0, atol=0)


@pytest.mark.parametrize("max_num_envs", [None, 6])
def test_vecne_pgpe_lowrank_never_densifies(monkeypatch, max_num_envs):
    def refuse(self):
        raise AssertionError("the dense population was materialized")

    monkeypatch.setattr(LowRankParamsBatch, "materialize", refuse)
    problem = VecNE(
        "cartpole", "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)", env_config={"continuous_actions": True},
        episode_length=24, observation_normalization=True, max_num_envs=max_num_envs, device="cpu",
    )  # fmt: skip
    searcher = PGPE(problem, popsize=12, center_learning_rate=0.2, stdev_learning_rate=0.1, stdev_init=0.1, lowrank_rank=4)
    searcher.run(2)
    assert isinstance(searcher.population.values, LowRankParamsBatch)
    assert np.isfinite(float(searcher.status["mean_eval"]))


def test_vecne_lowrank_adaptive_popsize():
    # num_interactions grows the population over rounds that share the
    # generation's basis, so they concatenate
    problem = VecNE(
        "cartpole", "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)", env_config={"continuous_actions": True},
        episode_length=8, observation_normalization=True, device="cpu",
    )  # fmt: skip
    searcher = PGPE(
        problem, popsize=8, center_learning_rate=0.2, stdev_learning_rate=0.1, stdev_init=0.1, lowrank_rank=4,
        num_interactions=8 * 8 * 3, popsize_max=64,
    )  # fmt: skip
    searcher.run(3)
    pop = searcher.population
    assert isinstance(pop.values, LowRankParamsBatch)
    assert 8 < len(pop) <= 64 and pop.values.coeffs.shape[0] == len(pop) == searcher.status["popsize"]
    assert np.isfinite(float(searcher.status["mean_eval"]))
