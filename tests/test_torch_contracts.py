"""The port's evaluation contracts (``episodes``, ``episodes_refill``,
``episodes_compact``, and ``budget``'s telemetry) against the JAX package,
and against each other, on the CPU.

The JAX engine seeds item ``e * N + s`` (episode ``e`` of solution ``s``)
from ``split(fold_in(key, e * N + s))[1]``; the tests derive each item's raw
reset draws from that chain, as ``vecrl.py`` and ``envs/*.py`` do, and
inject them into the port as ``reset_noise=``. At one episode per solution
the JAX ``episodes`` lanes are seeded the same way; at two the JAX
``episodes`` engine draws its resets from per-lane chains, so the port is
held against the JAX ``episodes_refill``, whose item seeding the port's
every contract shares.

Tolerances:
- Counters (``total_steps``, ``total_episodes``) and the telemetry's
  counter and histogram columns: exact. CartPole's returns are whole
  numbers, so its health block (float sums of them) is exact too.
- Scores: ``atol=1e-4`` with equal ranks. CartPole: the dynamics agree to
  FMA rounding (XLA contracts ``a * b + c`` on the CPU) and an episode
  ends where a threshold is crossed, so the scores (episode lengths) come
  out equal. Humanoid: the gentle population of ``tests/test_torch_pgpe.py``
  (center and stdev 0.01) over 2 episodes of 15 steps, each ended by
  truncation; the health block's float sums to ``rtol=1e-5``.
- Within the port (observation normalization off): every contract and
  width equal ``episodes`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from evotorch_tpu.envs import CartPole as JaxCartPole
from evotorch_tpu.envs import Humanoid as JaxHumanoid
from evotorch_tpu.envs import Pendulum as JaxPendulum
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
from evotorch_tpu.neuroevolution.net import Tanh as JaxTanh
from evotorch_tpu.neuroevolution.net import run_vectorized_rollout as jax_rollout
from evotorch_tpu.neuroevolution.net import tanh_mlp as jax_tanh_mlp
from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm
from evotorch_tpu.neuroevolution.net.vecrl import run_vectorized_rollout_compacting as jax_compacting
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_ask_trunk_delta, pgpe_tell
from evotorch_tpu_torch.envs import CartPole, Humanoid, Pendulum
from evotorch_tpu_torch.neuroevolution.net import (
    CollectedStats,
    FlatParamsPolicy,
    Linear,
    Tanh,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    stats_init,
    tanh_mlp,
)
from evotorch_tpu_torch.observability import GroupTelemetry
from evotorch_tpu_torch.parallel import make_generation_step
from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch

CARTPOLE_N, CARTPOLE_STEPS = 37, 120
HUMANOID_N, HUMANOID_STEPS = 16, 15


# ---------------------------------------------------------------- helpers


def _item_reset_keys(key, num_items):
    """The reset key of each item ``j``, as the JAX refill engine (and, for
    ``j < N``, its episodes engine) derives it."""
    return jax.vmap(lambda j: jax.random.split(jax.random.fold_in(key, j), 2)[1])(jnp.arange(num_items, dtype=jnp.int32))


def _cartpole_rows(key, num_items):
    """CartPole.reset: ``_, sub = split(key); uniform(sub, (4,))``."""
    subs = jax.vmap(lambda k: jax.random.split(k)[1])(_item_reset_keys(key, num_items))
    return np.array(jax.vmap(lambda s: jax.random.uniform(s, (4,)))(subs))


def _pendulum_rows(key, num_items):
    """Pendulum.reset: two successive splits, one uniform each."""

    def draws(k):
        k, sub1 = jax.random.split(k)
        _, sub2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(sub1, ()), jax.random.uniform(sub2, ())])

    return np.array(jax.vmap(draws)(_item_reset_keys(key, num_items)))


def _humanoid_rows(key, num_items, nb):
    """Humanoid.batch_reset: ``split(key, 3)``; normals ``(nb, 3)`` from
    parts 1 (velocities) and 2 (angular velocities)."""

    def draws(k):
        parts = jax.random.split(k, 3)
        return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

    return np.array(jax.vmap(draws)(_item_reset_keys(key, num_items)))


def _cartpole(n=CARTPOLE_N, seed=0):
    jax_env = JaxCartPole(continuous_actions=True)
    jax_policy = JaxFlatParamsPolicy(JaxLinear(4, 1) >> JaxTanh())
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(Linear(4, 1) >> Tanh())
    params = np.random.default_rng(seed).normal(size=(n, policy.parameter_count)).astype(np.float32)
    return jax_env, jax_policy, env, policy, params


def _humanoid(n=HUMANOID_N, seed=5):
    jax_env = JaxHumanoid()
    jax_policy = JaxFlatParamsPolicy(jax_tanh_mlp(109, 17, [64, 64]))
    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(109, 17, [64, 64]))
    rng = np.random.default_rng(seed)
    center = 0.01 * rng.normal(size=policy.parameter_count)
    params = (center + 0.01 * rng.normal(size=(n, policy.parameter_count))).astype(np.float32)
    return jax_env, jax_policy, env, policy, params


def _jax_run(jax_env, jax_policy, params, key, **kw):
    stats = RunningNorm(jax_env.observation_size).stats
    return jax_rollout(jax_env, jax_policy, jnp.asarray(params), key, stats, **kw)


def _port_run(env, policy, params, rows, **kw):
    stats = stats_init(env.observation_size, device="cpu")
    return run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), stats, reset_noise=torch.from_numpy(rows), **kw)


def _assert_scores_close(ours, theirs):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rankdata(ours), rankdata(theirs))


def _assert_wire(ours, theirs, *, exact_health: bool):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape == (1, 20) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours[:, :15], theirs[:, :15])
    if exact_health:
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(
            GroupTelemetry.from_array(ours).health, GroupTelemetry.from_array(theirs).health, rtol=1e-5
        )


# ------------------------------------------------------ against the JAX package


def test_cartpole_episodes_matches_jax_one_episode():
    jax_env, jax_policy, env, policy, params = _cartpole()
    key = jax.random.key(7)
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw)
    ours = _port_run(env, policy, params, _cartpole_rows(key, CARTPOLE_N), **kw)
    _assert_scores_close(ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps) and int(ours.total_episodes) == int(theirs.total_episodes)
    _assert_wire(ours.telemetry, theirs.telemetry, exact_health=True)


@pytest.mark.parametrize("num_episodes", [1, 2])
@pytest.mark.parametrize("width", [5, 16])
def test_cartpole_refill_matches_jax(num_episodes, width):
    jax_env, jax_policy, env, policy, params = _cartpole()
    key = jax.random.key(8)
    kw = dict(num_episodes=num_episodes, episode_length=CARTPOLE_STEPS)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes_refill", refill_width=width, **kw)
    rows = _cartpole_rows(key, CARTPOLE_N * num_episodes)
    ours = _port_run(env, policy, params, rows, eval_mode="episodes_refill", refill_width=width, **kw)
    _assert_scores_close(ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps)
    assert int(ours.total_episodes) == int(theirs.total_episodes) == CARTPOLE_N * num_episodes
    _assert_wire(ours.telemetry, theirs.telemetry, exact_health=True)
    # the port's plain episodes contract runs the same items
    plain = _port_run(env, policy, params, rows, **kw)
    _assert_scores_close(plain.scores, theirs.scores)
    assert plain.total_steps == int(theirs.total_steps)


def test_cartpole_compacting_matches_jax_one_episode():
    jax_env, jax_policy, env, policy, params = _cartpole()
    key = jax.random.key(9)
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS, chunk_size=10, allowed_widths=(4, 8, 16))
    theirs = jax_compacting(
        jax_env, jax_policy, jnp.asarray(params), key, RunningNorm(4).stats, **kw
    )
    ours = run_vectorized_rollout_compacting(
        env, policy, torch.from_numpy(params), torch.Generator(), None,
        reset_noise=torch.from_numpy(_cartpole_rows(key, CARTPOLE_N)), **kw,
    )  # fmt: skip
    _assert_scores_close(ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps)
    # capacity: width summed over the steps that did work, through every
    # compaction, as the JAX runner counts it
    _assert_wire(ours.telemetry, theirs.telemetry, exact_health=True)


@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill"])
def test_humanoid_two_episodes_match_jax_refill(eval_mode):
    jax_env, jax_policy, env, policy, params = _humanoid()
    key = jax.random.key(12)
    kw = dict(num_episodes=2, episode_length=HUMANOID_STEPS)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes_refill", refill_width=5, **kw)
    rows = _humanoid_rows(key, 2 * HUMANOID_N, env.sys.num_bodies)
    extra = dict(refill_width=5) if eval_mode == "episodes_refill" else {}
    ours = _port_run(env, policy, params, rows, eval_mode=eval_mode, **kw, **extra)
    _assert_scores_close(ours.scores, theirs.scores)
    assert np.min(np.diff(np.sort(np.asarray(theirs.scores)))) > 1e-3  # ranks cannot flip within atol
    # every episode runs to truncation
    assert ours.total_steps == int(theirs.total_steps) == 2 * HUMANOID_N * HUMANOID_STEPS
    assert int(ours.total_episodes) == int(theirs.total_episodes) == 2 * HUMANOID_N
    if eval_mode == "episodes_refill":
        _assert_wire(ours.telemetry, theirs.telemetry, exact_health=False)


def test_humanoid_episodes_matches_jax_one_episode():
    jax_env, jax_policy, env, policy, params = _humanoid()
    key = jax.random.key(13)
    kw = dict(num_episodes=1, episode_length=HUMANOID_STEPS)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw)
    ours = _port_run(env, policy, params, _humanoid_rows(key, HUMANOID_N, env.sys.num_bodies), **kw)
    _assert_scores_close(ours.scores, theirs.scores)
    _assert_wire(ours.telemetry, theirs.telemetry, exact_health=False)


def test_reward_adjustments_match_jax():
    jax_env, jax_policy, env, policy, params = _cartpole(n=12, seed=3)
    key = jax.random.key(14)
    for extra in (dict(decrease_rewards_by=0.25), dict(alive_bonus_schedule=(5, 0.5)), dict(alive_bonus_schedule=(3, 20, 2.0))):
        kw = dict(num_episodes=1, episode_length=60, **extra)
        theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw)
        ours = _port_run(env, policy, params, _cartpole_rows(key, 12), **kw)
        np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=1e-6, atol=1e-4, err_msg=str(extra))
        assert ours.total_steps == int(theirs.total_steps)


def test_masked_statistics_under_observation_normalization_match_jax():
    """The statistics count only the observations of lanes still running:
    ``count`` = N reset observations + every active lane's next observation."""
    jax_env, jax_policy, env, policy, params = _cartpole(n=16, seed=4)
    key = jax.random.key(15)
    kw = dict(num_episodes=1, episode_length=40, observation_normalization=True)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw)
    ours = _port_run(env, policy, params, _cartpole_rows(key, 16), **kw)
    _assert_scores_close(ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps)
    assert float(ours.stats.count) == float(theirs.stats.count)
    assert float(ours.stats.count) < 16 + 16 * 40  # some lanes stopped early
    for name in ("sum", "sum_of_squares"):
        np.testing.assert_allclose(
            getattr(ours.stats, name).numpy(), np.asarray(getattr(theirs.stats, name)), rtol=1e-4, atol=1e-4
        )


def test_compaction_statistics_match_episodes_under_observation_normalization():
    """Compaction masks the statistics over the same lanes at every width:
    the count is exact, the sums agree up to summation order."""
    _, _, env, policy, params = _cartpole(n=32, seed=8)
    rows = env.reset_noise(32, torch.Generator().manual_seed(9)).numpy()
    kw = dict(num_episodes=1, episode_length=60, observation_normalization=True)
    plain = _port_run(env, policy, params, rows, **kw)
    compact = run_vectorized_rollout_compacting(
        env, policy, torch.from_numpy(params), torch.Generator(), stats_init(4, device="cpu"),
        reset_noise=torch.from_numpy(rows), allowed_widths=(8, 16), chunk_size=5, **kw,
    )  # fmt: skip
    # N reset observations, then every lane's next observation but the one after its last step
    assert float(compact.stats.count) == float(plain.stats.count) == plain.total_steps
    for name in ("sum", "sum_of_squares"):
        np.testing.assert_allclose(getattr(compact.stats, name).numpy(), getattr(plain.stats, name).numpy(), rtol=1e-5)
    np.testing.assert_allclose(compact.scores.numpy(), plain.scores.numpy(), rtol=0, atol=1e-4)


def test_budget_telemetry_matches_jax():
    """Pendulum episodes end only by time, so the budget's counters are
    fixed whatever the resets: the whole counter block equals the JAX
    package's (the resets, and so the scores, come from different
    generators)."""
    jax_env, env = JaxPendulum(), Pendulum(device="cpu")
    jax_policy, policy = JaxFlatParamsPolicy(JaxLinear(3, 1)), FlatParamsPolicy(Linear(3, 1))
    params = np.random.default_rng(6).normal(size=(9, 4)).astype(np.float32)
    kw = dict(num_episodes=2, episode_length=25, eval_mode="budget")
    theirs = _jax_run(jax_env, jax_policy, params, jax.random.key(1), **kw)
    ours = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(0), None, **kw)
    assert ours.total_steps == int(theirs.total_steps) == 9 * 50
    np.testing.assert_array_equal(ours.telemetry.numpy()[:, :15], np.asarray(theirs.telemetry)[:, :15])


def _pendulum_with_nan_solutions(nan_rows):
    env, policy = Pendulum(device="cpu"), FlatParamsPolicy(Linear(3, 1))
    params = np.random.default_rng(7).normal(size=(10, 4)).astype(np.float32)
    params[nan_rows, 0] = np.nan  # a NaN bias: NaN torques, NaN rewards
    return env, policy, params


@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill", "budget", "episodes_compact"])
def test_nonfinite_quarantine(eval_mode):
    nan_rows = [2, 7]
    env, policy, params = _pendulum_with_nan_solutions(nan_rows)
    rows = torch.from_numpy(_pendulum_rows(jax.random.key(3), 10))

    def run(**kw):
        if eval_mode == "episodes_compact":
            return run_vectorized_rollout_compacting(
                env, policy, torch.from_numpy(params), torch.Generator(), None, episode_length=30,
                allowed_widths=(4, 8), chunk_size=5, reset_noise=rows, **kw,
            )  # fmt: skip
        extra = {} if eval_mode == "budget" else dict(reset_noise=rows)
        if eval_mode == "episodes_refill":
            extra["refill_width"] = 4
        return run_vectorized_rollout(
            env, policy, torch.from_numpy(params), torch.Generator().manual_seed(0), None,
            episode_length=30, eval_mode=eval_mode, **extra, **kw,
        )  # fmt: skip

    raw = run().scores
    assert torch.isnan(raw[nan_rows]).all()
    finite = np.setdiff1d(np.arange(10), nan_rows)
    quarantined = run(nonfinite_quarantine=True)
    assert torch.isfinite(quarantined.scores).all()
    assert torch.equal(quarantined.scores[finite], raw[finite])
    assert torch.all(quarantined.scores[nan_rows] == raw[finite].min())
    assert GroupTelemetry.from_array(quarantined.telemetry).total().nonfinite == 2
    penalized = run(nonfinite_quarantine=True, nonfinite_penalty=-1e4)
    assert torch.all(penalized.scores[nan_rows] == -1e4)
    assert GroupTelemetry.from_array(run().telemetry).total().nonfinite == 0


def test_quarantine_matches_jax():
    jax_env = JaxPendulum()
    jax_policy = JaxFlatParamsPolicy(JaxLinear(3, 1))
    env, policy, params = _pendulum_with_nan_solutions([1, 4])
    key = jax.random.key(4)
    for kw in (dict(nonfinite_quarantine=True), dict(nonfinite_quarantine=True, nonfinite_penalty=-7.5)):
        kw = dict(kw, num_episodes=1, episode_length=20)
        theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw)
        ours = _port_run(env, policy, params, _pendulum_rows(key, 10), **kw)
        np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(ours.telemetry.numpy()[:, :15], np.asarray(theirs.telemetry)[:, :15])


# ------------------------------------------------------------ within the port


def _all_contracts(env, policy, params, rows, **kw):
    out = {"episodes": _port_run(env, policy, params, rows, **kw)}
    for width in (5, 16):
        out[f"refill{width}"] = _port_run(env, policy, params, rows, eval_mode="episodes_refill", refill_width=width, **kw)
    loop_stats = {}
    out["compact"] = run_vectorized_rollout_compacting(
        env, policy, torch.from_numpy(params), torch.Generator(), None, reset_noise=torch.from_numpy(rows),
        allowed_widths=(4, 8, 16), chunk_size=10, loop_stats=loop_stats, **kw,
    )  # fmt: skip
    return out, loop_stats


@pytest.mark.parametrize("num_episodes", [1, 2])
def test_contracts_equal_bit_for_bit_cartpole(num_episodes):
    _, _, env, policy, params = _cartpole()
    rows = env.reset_noise(CARTPOLE_N * num_episodes, torch.Generator().manual_seed(num_episodes)).numpy()
    out, loop_stats = _all_contracts(env, policy, params, rows, num_episodes=num_episodes, episode_length=CARTPOLE_STEPS)
    assert min(loop_stats["widths"]) == 4  # the compaction did narrow
    ref = out["episodes"]
    for name, result in out.items():
        assert torch.equal(result.scores, ref.scores), name
        assert result.total_steps == ref.total_steps, name
        assert int(result.total_episodes) == CARTPOLE_N * num_episodes, name
        tele = GroupTelemetry.from_array(result.telemetry).total()
        assert tele.env_steps == result.total_steps and tele.episodes == CARTPOLE_N * num_episodes, name
    for width in (5, 16):
        tele = GroupTelemetry.from_array(out[f"refill{width}"].telemetry).total()
        assert tele.lane_width == width and tele.refill_events == CARTPOLE_N * num_episodes - width


@pytest.mark.parametrize("num_episodes", [1, 2])
def test_contracts_equal_bit_for_bit_humanoid(num_episodes):
    _, _, env, policy, params = _humanoid()
    params = 30 * params  # wide enough that lanes fall at different steps
    rows = env.reset_noise(HUMANOID_N * num_episodes, torch.Generator().manual_seed(3)).numpy()
    out, _ = _all_contracts(env, policy, params, rows, num_episodes=num_episodes, episode_length=40)
    ref = out["episodes"]
    assert ref.total_steps < HUMANOID_N * num_episodes * 40  # some episodes ended early
    for name, result in out.items():
        assert torch.equal(result.scores, ref.scores), name
        assert result.total_steps == ref.total_steps, name


def test_default_contract_is_episodes_and_draws_from_the_generator():
    _, _, env, policy, params = _cartpole(n=8)
    a = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(2), None, episode_length=50)
    b = run_vectorized_rollout(
        env, policy, torch.from_numpy(params), torch.Generator(), None, episode_length=50,
        reset_noise=env.reset_noise(8, torch.Generator().manual_seed(2)),
    )  # fmt: skip
    assert torch.equal(a.scores, b.scores)
    assert GroupTelemetry.from_array(a.telemetry).total().lane_width == 8


def test_refill_period_waits_and_histogram():
    _, _, env, policy, params = _cartpole()
    rows = env.reset_noise(CARTPOLE_N, torch.Generator().manual_seed(5)).numpy()
    kw = dict(episode_length=CARTPOLE_STEPS, eval_mode="episodes_refill", refill_width=8)
    plain = _port_run(env, policy, params, rows, **kw)
    waited = _port_run(env, policy, params, rows, refill_period=4, **kw)
    assert torch.equal(plain.scores, waited.scores)
    tele = GroupTelemetry.from_array(waited.telemetry)
    assert tele.total().queue_wait > 0 and tele.total().refill_events == CARTPOLE_N - 8
    assert int(tele.hist.sum()) == CARTPOLE_N - 8 and int(tele.hist[0, 0]) < CARTPOLE_N - 8


def test_refill_period_matches_jax():
    jax_env, jax_policy, env, policy, params = _cartpole()
    key = jax.random.key(16)
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS, eval_mode="episodes_refill", refill_width=8, refill_period=3)
    theirs = _jax_run(jax_env, jax_policy, params, key, **kw)
    ours = _port_run(env, policy, params, _cartpole_rows(key, CARTPOLE_N), **kw)
    _assert_scores_close(ours.scores, theirs.scores)
    _assert_wire(ours.telemetry, theirs.telemetry, exact_health=True)


@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill", "budget"])
def test_generation_step_returns_telemetry(eval_mode):
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(Linear(4, 1) >> Tanh())
    state = pgpe(
        center_init=torch.zeros(policy.parameter_count), center_learning_rate=0.1, stdev_learning_rate=0.1,
        objective_sense="max", stdev_init=0.5,
    )  # fmt: skip
    popsize = 20
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize), tell=pgpe_tell, popsize=popsize,
        device="cpu", eval_mode=eval_mode, episode_length=50,
    )  # fmt: skip
    new_state, scores, stats, total_steps, telemetry = generation(state, torch.Generator().manual_seed(0), None)
    assert scores.shape == (popsize,) and telemetry.shape == (1, 20) and telemetry.dtype == torch.int32
    decoded = GroupTelemetry.from_array(telemetry)
    assert decoded.total().env_steps == total_steps and decoded.total().episodes >= popsize
    health = decoded.score_stats()
    assert health["count"] == popsize
    assert health["min"] == float(scores.min()) and health["max"] == float(scores.max())
    assert not torch.equal(new_state.optimizer_state.center, state.optimizer_state.center)
    with pytest.raises(ValueError, match="episodes_compact"):
        make_generation_step(
            env, policy, ask=None, tell=None, popsize=popsize, device="cpu", eval_mode="episodes_compact"
        )  # fmt: skip
    off = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize), tell=pgpe_tell, popsize=popsize,
        device="cpu", eval_mode=eval_mode, episode_length=10, telemetry=False,
    )(state, torch.Generator().manual_seed(0), None)  # fmt: skip
    assert off[-1].shape == (0,)


UNPORTED = [
    ("groups", torch.zeros(4, dtype=torch.int32)),
    ("num_groups", 2),
    ("solution_keys", torch.zeros(4)),
    ("lane_ids", torch.arange(4)),
    ("num_valid", 3),
    ("seed_stride", 8),
    ("stats_sync_axis", "pop"),
    ("nonfinite_sync_axis", "pop"),
    ("action_noise_stdev", 0.1),
    ("compute_dtype", torch.bfloat16),
    ("trunk_block", 2),
]


@pytest.mark.parametrize("name,value", UNPORTED, ids=[n for n, _ in UNPORTED])
def test_unported_options_raise_naming_the_roadmap(name, value):
    _, _, env, policy, params = _cartpole(n=4)
    if name in ("compute_dtype", "action_noise_stdev"):
        # ported since: both entry points take them and score finitely
        # (tests/test_torch_vecne.py and tests/test_torch_action_noise.py
        # hold them against the JAX engine)
        for run in (run_vectorized_rollout, run_vectorized_rollout_compacting):
            result = run(env, policy, torch.from_numpy(params), torch.Generator(), None, **{name: value})
            assert result.scores.dtype == torch.float32 and bool(torch.isfinite(result.scores).all())
        return
    if name == "trunk_block":
        # ported since: run_vectorized_rollout takes it for every population
        # (a no-op for a dense one) and scores finitely; the compacting entry
        # does not take it, as in the JAX engine (tests/test_torch_trunk_delta.py
        # holds the blocked forward against the unblocked one)
        trunk = pgpe_ask_trunk_delta(
            torch.Generator().manual_seed(0),
            pgpe(center_init=torch.zeros(policy.parameter_count), center_learning_rate=0.1, stdev_learning_rate=0.1,
                 objective_sense="max", stdev_init=0.3),
            popsize=4, rank=2, policy=policy,
        )  # fmt: skip
        for population in (torch.from_numpy(params), trunk):
            result = run_vectorized_rollout(env, policy, population, torch.Generator(), None, **{name: value})
            assert result.scores.dtype == torch.float32 and bool(torch.isfinite(result.scores).all())
        with pytest.raises(TypeError, match="trunk_block"):
            run_vectorized_rollout_compacting(env, policy, trunk, torch.Generator(), None, **{name: value})
        return
    if name in ("lane_ids", "num_valid", "seed_stride", "stats_sync_axis", "nonfinite_sync_axis"):
        # ported since (multi-GPU): both entry points take them; a sync axis
        # is a mesh, whose collectives are the identity at world size 1
        # (tests/test_torch_parallel.py holds the sharded forms against one rank)
        from evotorch_tpu_torch.parallel import default_mesh

        option = {name: default_mesh() if name.endswith("_axis") else value}
        for run in (run_vectorized_rollout, run_vectorized_rollout_compacting):
            result = run(env, policy, torch.from_numpy(params), torch.Generator(), None, **option)
            assert result.scores.dtype == torch.float32 and bool(torch.isfinite(result.scores).all())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, **{name: value})
    if name in ("groups", "num_groups", "action_noise_stdev", "compute_dtype"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run_vectorized_rollout_compacting(env, policy, torch.from_numpy(params), torch.Generator(), None, **{name: value})


def test_unported_forms_and_modes_raise():
    _, _, env, policy, params = _cartpole(n=4)
    # factored populations are ported: a low-rank batch runs (and scores as
    # its materialized population does, tests/test_torch_lowrank.py); a
    # population that is neither a tensor nor a factored batch is refused
    rng = np.random.default_rng(1)
    lowrank = LowRankParamsBatch(
        torch.from_numpy(params[0]),
        torch.from_numpy(rng.normal(size=(policy.parameter_count, 2)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)),
    )
    result = run_vectorized_rollout(env, policy, lowrank, torch.Generator(), None, episode_length=20)
    assert result.scores.shape == (4,) and bool(torch.isfinite(result.scores).all())
    with pytest.raises(TypeError, match="factored batch"):
        run_vectorized_rollout(env, policy, object(), torch.Generator(), None)
    stacked = CollectedStats(torch.zeros(2), torch.zeros(2, 4), torch.zeros(2, 4))
    with pytest.raises(NotImplementedError, match="A.12"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), stacked)
    with pytest.raises(ValueError, match="eval_mode"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, eval_mode="episodes_compact")
    with pytest.raises(TypeError):
        run_vectorized_rollout_compacting(env, policy, torch.from_numpy(params), torch.Generator(), None, prewarm=True)
    with pytest.raises(ValueError, match="reset_noise"):
        run_vectorized_rollout(
            env, policy, torch.from_numpy(params), torch.Generator(), None, eval_mode="budget",
            reset_noise=torch.zeros(4, 4),
        )  # fmt: skip
    with pytest.raises(ValueError, match="rows"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, reset_noise=torch.zeros(3, 4))
