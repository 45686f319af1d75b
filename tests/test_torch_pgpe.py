"""Parity of the port's PGPE tell and of the whole flagship generation
(``make_generation_step``: ask -> budget rollout -> tell) with the JAX
package, on the CPU.

Tolerances:
- ``pgpe_tell`` (same population and scores): the gradient is a weighted
  sum over the population, taken in another order by each package, and
  ClipUp normalizes it, so center, velocity and stdev agree to float32
  round-off: ``rtol=1e-5, atol=1e-7``.
- The whole generation at popsize 8 over a 10-step Humanoid budget: the
  population is injected from JAX's own noise and the resets are
  noise-free. At the flagship's scale (stdev 0.1 around a random center)
  the closed loop is chaotic: one step's round-off grows until the two
  packages' trajectories part within the 10 steps. So the test evolves a
  gentler population (center and stdev 0.01), where one step's round-off
  (~1e-5 in observations of magnitude ~10) stays that size. Scores (returns ~50)
  then agree to ``atol=1e-4``; ``total_steps`` exactly; the observation
  statistics (sums over 88 observations) to ``rtol=1e-4``; the next state
  to ``rtol=1e-4, atol=1e-6``. The scores' ranks must be equal; the test
  checks that their gaps are wider than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
from evotorch_tpu.algorithms.functional import pgpe_ask as jax_pgpe_ask
from evotorch_tpu.algorithms.functional import pgpe_tell as jax_pgpe_tell
from evotorch_tpu.envs import Humanoid as JaxHumanoid
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import tanh_mlp as jax_tanh_mlp
from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm
from evotorch_tpu.parallel import make_generation_step as jax_make_generation_step
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.algorithms.functional import get_functional_optimizer, pgpe, pgpe_ask, pgpe_health, pgpe_tell
from evotorch_tpu_torch.envs import Humanoid
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
from evotorch_tpu_torch.parallel import make_generation_step

PGPE_KW = dict(center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1)


def _jax_state_to_numpy(state) -> dict:
    opt = state.optimizer_state
    out = {k: np.asarray(getattr(opt, k)) for k in ("center", "velocity", "center_learning_rate", "momentum", "max_speed")}
    for k in ("stdev", "stdev_learning_rate", "stdev_min", "stdev_max", "stdev_max_change"):
        out[k] = np.asarray(getattr(state, k))
    for k in ("optimizer", "ranking_method", "maximize", "symmetric"):
        out[k] = getattr(state, k)
    return out


def _assert_states_close(port_state, jax_state, *, rtol, atol):
    ours = interop.pgpe_state_to_numpy(port_state)
    theirs = _jax_state_to_numpy(jax_state)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(ours[k], v, rtol=rtol, atol=atol, err_msg=k)
        else:
            assert ours[k] == v, k


def test_state_round_trips_through_interop():
    center = np.linspace(-1, 1, 7, dtype=np.float32)
    jax_state = jax_pgpe(center_init=jnp.asarray(center), **PGPE_KW)
    port_state = interop.pgpe_state_from_numpy(_jax_state_to_numpy(jax_state), device="cpu")
    _assert_states_close(port_state, jax_state, rtol=0, atol=0)
    fresh = pgpe(center_init=torch.from_numpy(center), **PGPE_KW)
    _assert_states_close(fresh, jax_state, rtol=0, atol=0)


@pytest.mark.parametrize("objective_sense", ["max", "min"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_pgpe_tell_matches_jax(objective_sense, symmetric):
    L, popsize = 500, 20
    rng = np.random.default_rng(4)
    kw = dict(PGPE_KW, objective_sense=objective_sense, symmetric=symmetric)
    jax_state = jax_pgpe(center_init=jnp.asarray(rng.normal(size=L).astype(np.float32)), **kw)
    port_state = interop.pgpe_state_from_numpy(_jax_state_to_numpy(jax_state), device="cpu")
    for generation in range(3):  # later generations carry a ClipUp velocity
        values = np.array(jax_pgpe_ask(jax.random.key(generation), jax_state, popsize=popsize))
        scores = rng.normal(size=popsize).astype(np.float32)
        jax_state = jax_pgpe_tell(jax_state, jnp.asarray(values), jnp.asarray(scores))
        port_state = pgpe_tell(port_state, torch.from_numpy(values), torch.from_numpy(scores))
        _assert_states_close(port_state, jax_state, rtol=1e-5, atol=1e-7)
    health = pgpe_health(port_state)
    assert set(health) == {"stdev_norm", "velocity_norm"}


def test_unported_optimizers_raise_clearly():
    """Every optimizer name of the JAX registry resolves (Adam and SGD are
    ported too); an unknown name or specification raises."""
    for name in ("adam", "clipup", "sgd", "sga", "momentum"):
        assert all(callable(f) for f in get_functional_optimizer(name))
    with pytest.raises(ValueError):
        get_functional_optimizer("nonsense")
    with pytest.raises(TypeError):
        get_functional_optimizer(3)


def _jax_generation(popsize, episode_length, obs_norm):
    env = JaxHumanoid(reset_noise_scale=0.0)
    policy = JaxFlatParamsPolicy(jax_tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    generation = jax_make_generation_step(
        env,
        policy,
        ask=lambda k, s: jax_pgpe_ask(k, s, popsize=popsize),
        tell=jax_pgpe_tell,
        popsize=popsize,
        mesh=Mesh(np.asarray(jax.devices()[:1]), ("pop",)),
        num_episodes=1,
        episode_length=episode_length,
        eval_mode="budget",
        observation_normalization=obs_norm,
        telemetry=False,
    )
    return env, policy, generation


@pytest.mark.parametrize("obs_norm", [False, True])
def test_flagship_generation_matches_jax(obs_norm):
    popsize, episode_length = 8, 10
    jax_env, jax_policy, jax_generation = _jax_generation(popsize, episode_length, obs_norm)
    L = jax_policy.parameter_count
    rng = np.random.default_rng(5)
    center = (0.01 * rng.normal(size=L)).astype(np.float32)
    jax_state = jax_pgpe(center_init=jnp.asarray(center), **dict(PGPE_KW, stdev_init=0.01))
    jax_stats = RunningNorm(jax_env.observation_size).stats
    if obs_norm:  # start from non-trivial statistics
        jax_stats = type(jax_stats)(
            count=jnp.float32(50.0),
            sum=jnp.asarray(rng.normal(size=109).astype(np.float32)),
            sum_of_squares=jnp.asarray(50.0 + rng.uniform(size=109).astype(np.float32)),
        )
    port_state = interop.pgpe_state_from_numpy(_jax_state_to_numpy(jax_state), device="cpu")
    port_stats = interop.stats_from_numpy(
        {name: np.asarray(getattr(jax_stats, name)) for name in ("count", "sum", "sum_of_squares")}, device="cpu"
    )

    key = jax.random.key(11)
    k_ask, _ = jax.random.split(key)  # what the JAX generation hands its ask
    eps = torch.from_numpy(np.array(jax.random.normal(k_ask, (popsize // 2, L), dtype=jnp.float32)))
    jax_state, jax_scores, jax_stats_out, jax_steps, _ = jax_generation(jax_state, key, jax_stats)

    env = Humanoid(reset_noise_scale=0.0, device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    generation = make_generation_step(
        env,
        policy,
        ask=lambda g, s: pgpe_ask(g, s, popsize=popsize, eps=eps),
        tell=pgpe_tell,
        popsize=popsize,
        device="cpu",
        num_episodes=1,
        episode_length=episode_length,
        eval_mode="budget",
        observation_normalization=obs_norm,
    )
    port_state, scores, stats_out, steps, telemetry = generation(port_state, torch.Generator().manual_seed(0), port_stats)
    assert telemetry.shape == (1, 20) and telemetry.dtype == torch.int32

    jax_scores = np.asarray(jax_scores)
    assert np.all(np.isfinite(scores.numpy()))
    np.testing.assert_allclose(scores.numpy(), jax_scores, rtol=0, atol=1e-4)
    assert np.min(np.diff(np.sort(jax_scores))) > 1e-3  # ranks cannot flip within atol
    np.testing.assert_array_equal(np.argsort(scores.numpy()), np.argsort(jax_scores))
    assert steps == int(jax_steps) == popsize * episode_length
    for name, value in interop.stats_to_numpy(stats_out).items():
        np.testing.assert_allclose(value, np.asarray(getattr(jax_stats_out, name)), rtol=1e-4, atol=1e-3, err_msg=name)
    _assert_states_close(port_state, jax_state, rtol=1e-4, atol=1e-6)
