"""The host backends' pieces in the port against the JAX package, on the
CPU: ``RunningStat``, the host shims of ``net/rl.py``, ``SyncVectorEnv``,
and both host rollout engines (``run_host_vectorized_rollout`` and
``run_host_pipelined_rollout``) against the JAX engines, from the same
flat parameters (one numpy population given to both) and the same env
seeds.

Held exactly: ``RunningStat`` (the same float64 numpy arithmetic), the
shims, every vector-env step, and on the programmable-length env (the
first action of an episode sets its length; reward 1 a step) the engines'
scores, interactions, episodes, per-item step counts, lane episodes and
block iterations, stateless and with ``LSTMPolicy``, with reward shaping
and action noise from one numpy generator. On CartPole-v1 through
gymnasium the discrete argmax of the policy decides every step, so the
same counts are held exactly there too, with observation normalization
(the statistics' sums bit for bit). The policy outputs themselves agree
to float32 rounding only; an argmax or a rounding of ``10 * a0`` would
have to sit within an ulp of a tie to part the two packages, which these
seeds do not. Pipelined against sync is held bit for bit in the port.
"""

import numpy as np
import pytest
import torch

import evotorch_tpu.models as JM
import evotorch_tpu.neuroevolution.net.hostvecenv as JH
import evotorch_tpu.neuroevolution.net.rl as JRL
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net.runningnorm import RunningStat as JaxRunningStat
import evotorch_tpu_torch.models as PM
import evotorch_tpu_torch.neuroevolution.net.hostvecenv as PH
import evotorch_tpu_torch.neuroevolution.net.rl as PRL
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, RunningNorm, RunningStat

gym = pytest.importorskip("gymnasium")


class ProgrammableLengthEnv:
    """obs = [1.0]; the first action of an episode sets its length,
    ``clip(round(10 * a0), 1, 60)``; reward 1 a step."""

    class _Box:
        low = np.asarray([-10.0])
        high = np.asarray([10.0])
        shape = (1,)

    observation_space = _Box()
    action_space = _Box()

    def __init__(self):
        self._t = 0
        self._length = 1

    def reset(self, seed=None):
        self._t = 0
        self._length = 1
        return np.asarray([1.0], dtype=np.float32), {}

    def step(self, action):
        if self._t == 0:
            self._length = int(np.clip(round(10.0 * float(np.asarray(action).reshape(-1)[0])), 1, 60))
        self._t += 1
        return np.asarray([1.0], dtype=np.float32), 1.0, self._t >= self._length, False, {}

    def close(self):
        pass


def _population(n_params, popsize, seed, scale):
    return (np.random.default_rng(seed).normal(size=(popsize, n_params)) * scale).astype(np.float32)


def _policies(name, obs, act, **kw):
    return FlatParamsPolicy(getattr(PM, name)(obs, act, **kw)), JaxFlatParamsPolicy(getattr(JM, name)(obs, act, **kw))


def _cartpole(module, n, seed=100):
    vec = module.SyncVectorEnv(lambda: gym.make("CartPole-v1"), n)
    vec.seed(range(seed, seed + n))
    return vec


def _same_result(a, b, keys=("scores", "interactions", "episodes")):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------- RunningStat


def test_running_stat_matches_jax():
    rng = np.random.default_rng(0)
    ours, theirs = RunningStat(), JaxRunningStat()
    np.testing.assert_array_equal(ours.normalize(np.ones(3)), theirs.normalize(np.ones(3)))
    batches = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)] + [rng.normal(size=3)]
    for x in batches:
        ours.update(x)
        theirs.update(x)
    assert ours.count == theirs.count == 21
    for attr in ("sum", "sum_of_squares", "mean", "stdev"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(theirs, attr), err_msg=attr)
    y = rng.normal(size=(2, 3))
    np.testing.assert_array_equal(ours.normalize(y), theirs.normalize(y))
    # merging, and the delta since a baseline (the host pool's sync)
    base_o, base_t = RunningStat(), JaxRunningStat()
    base_o.update(ours)
    base_t.update(theirs)
    extra = rng.normal(size=(4, 3))
    ours.update(extra)
    theirs.update(extra)
    d_o, d_t = ours.to_delta(base_o), theirs.to_delta(base_t)
    assert d_o.count == d_t.count == 4
    np.testing.assert_array_equal(d_o.sum, d_t.sum)
    np.testing.assert_array_equal(d_o.sum_of_squares, d_t.sum_of_squares)
    # across through interop
    carried = interop.running_stat_from_numpy({"count": theirs.count, "sum": theirs.sum, "sum_of_squares": theirs.sum_of_squares})
    np.testing.assert_array_equal(carried.stdev, theirs.stdev)
    assert interop.running_stat_to_numpy(carried)["count"] == theirs.count


# ------------------------------------------------------------- rl.py shims


@pytest.mark.parametrize("schedule", [None, (3, 0.5), (2, 6, 1.5)])
def test_alive_bonus_for_step_host_matches_jax(schedule):
    for t in range(10):
        assert PRL.alive_bonus_for_step_host(t, schedule) == JRL.alive_bonus_for_step_host(t, schedule)
        if schedule is not None:
            got = PRL.alive_bonus_for_step(torch.tensor([t]), schedule)
            assert float(got[0]) == pytest.approx(PRL.alive_bonus_for_step_host(t, schedule), abs=1e-6)


def test_reset_and_step_shims_match_jax():
    envs = [gym.make("CartPole-v1") for _ in range(2)]
    envs[0].reset(seed=3)
    envs[1].reset(seed=3)
    o0, o1 = PRL.reset_env(envs[0]), JRL.reset_env(envs[1])
    assert o0.shape == o1.shape == (4,)
    envs[0].reset(seed=5)
    envs[1].reset(seed=5)
    for action in (0, 1, 1, 0, 1):
        a = PRL.take_step_in_env(envs[0], action)
        b = JRL.take_step_in_env(envs[1], action)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def test_wrapper_modules_match_jax():
    import jax
    import jax.numpy as jnp

    from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
    from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm as JaxRunningNorm
    from evotorch_tpu_torch.neuroevolution.net import Linear

    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    norm, jnorm = RunningNorm(3, device="cpu"), JaxRunningNorm(3)
    norm.update(torch.from_numpy(x))
    jnorm.update(jnp.asarray(x))
    params = rng.normal(size=8).astype(np.float32)
    module = PRL.ActClipWrapperModule(PRL.ObsNormWrapperModule(Linear(3, 2), norm), -0.5, 0.5)
    jmodule = JRL.ActClipWrapperModule(JRL.ObsNormWrapperModule(JaxLinear(3, 2), jnorm), -0.5, 0.5)
    y, _ = FlatParamsPolicy(module)(torch.from_numpy(params[None].repeat(6, 0)), torch.from_numpy(x))
    jy, _ = jax.vmap(lambda o: JaxFlatParamsPolicy(jmodule)(jnp.asarray(params), o))(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert float(y.abs().max()) <= 0.5


# --------------------------------------------------------------- SyncVectorEnv


def test_sync_vector_env_matches_jax():
    ours, theirs = _cartpole(PH, 4), _cartpole(JH, 4)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    assert ours.num_envs == 4 and ours.is_discrete == theirs.is_discrete
    rng = np.random.default_rng(2)
    for _ in range(40):
        actions = rng.integers(0, 2, size=4)
        active = rng.random(4) < 0.8
        a, b = ours.step(actions, active=active), theirs.step(actions, active=active)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ours.close()
    theirs.close()
    with pytest.raises(ValueError):
        PH.SyncVectorEnv(ProgrammableLengthEnv)


# ------------------------------------------------------------------- engines


SHAPING = dict(decrease_rewards_by=0.25, alive_bonus_schedule=(2, 6, 0.5))


@pytest.mark.parametrize("network", ["LinearPolicy", "LSTMPolicy"])
def test_vectorized_engine_matches_jax_on_programmable_lengths(network):
    policy, jpolicy = _policies(network, 1, 1, **({"hidden_size": 3} if network == "LSTMPolicy" else {}))
    params = _population(policy.parameter_count, 6, seed=3, scale=1.5)
    kw = dict(num_episodes=2, episode_length=25, action_noise_stdev=0.05, **SHAPING)
    ours = PH.run_host_vectorized_rollout(
        PH.SyncVectorEnv(ProgrammableLengthEnv, 8), policy, torch.from_numpy(params), rng=np.random.default_rng(4), device="cpu", **kw
    )
    theirs = JH.run_host_vectorized_rollout(
        JH.SyncVectorEnv(ProgrammableLengthEnv, 8), jpolicy, params, rng=np.random.default_rng(4), **kw
    )
    _same_result(ours, theirs)
    assert ours["episodes"] == 12


@pytest.mark.parametrize("network", ["LinearPolicy", "LSTMPolicy"])
@pytest.mark.parametrize("mode", ["pipelined", "sync"])
def test_pipelined_engine_matches_jax_on_programmable_lengths(network, mode):
    policy, jpolicy = _policies(network, 1, 1, **({"hidden_size": 3} if network == "LSTMPolicy" else {}))
    params = _population(policy.parameter_count, 9, seed=5, scale=1.5)
    kw = dict(num_episodes=2, episode_length=30, num_blocks=2, mode=mode, action_noise_stdev=0.05, **SHAPING)
    stats, jstats = RunningStat(), JaxRunningStat()
    ours = PH.run_host_pipelined_rollout(
        PH.SyncVectorEnv(ProgrammableLengthEnv, 4), policy, torch.from_numpy(params), obs_stats=stats,
        rng=np.random.default_rng(6), device="cpu", **kw,
    )  # fmt: skip
    theirs = JH.run_host_pipelined_rollout(
        JH.SyncVectorEnv(ProgrammableLengthEnv, 4), jpolicy, params, obs_stats=jstats, rng=np.random.default_rng(6), **kw
    )
    _same_result(ours, theirs, ("scores", "interactions", "episodes", "episode_steps", "lane_episodes", "block_iters", "occupancy"))
    assert ours["tuned_config_source"] == theirs["tuned_config_source"] == "override"
    assert stats.count == jstats.count
    # lanes were refilled: 18 items over 4 lanes
    assert ours["episodes"] == 18 and ours["lane_episodes"].sum() == 18


def test_engines_match_jax_on_cartpole_with_normalization():
    policy, jpolicy = _policies("LinearPolicy", 4, 2)
    params = _population(policy.parameter_count, 6, seed=7, scale=0.5)
    for mode in ("pipelined", "chunked"):
        stats, jstats = RunningStat(), JaxRunningStat()
        if mode == "chunked":
            ours = PH.run_host_vectorized_rollout(_cartpole(PH, 6), policy, torch.from_numpy(params), obs_stats=stats, episode_length=60, device="cpu")
            theirs = JH.run_host_vectorized_rollout(_cartpole(JH, 6), jpolicy, params, obs_stats=jstats, episode_length=60)
        else:
            kw = dict(num_episodes=2, episode_length=60, num_blocks=2)
            ours = PH.run_host_pipelined_rollout(_cartpole(PH, 4), policy, torch.from_numpy(params), obs_stats=stats, device="cpu", **kw)
            theirs = JH.run_host_pipelined_rollout(_cartpole(JH, 4), jpolicy, params, obs_stats=jstats, **kw)
            _same_result(ours, theirs, ("episode_steps", "lane_episodes", "block_iters"))
        _same_result(ours, theirs)
        assert stats.count == jstats.count > 0
        np.testing.assert_array_equal(stats.sum, jstats.sum)
        np.testing.assert_array_equal(stats.sum_of_squares, jstats.sum_of_squares)


@pytest.mark.parametrize("network", ["LinearPolicy", "LSTMPolicy"])
def test_pipelined_equals_sync_bit_for_bit(network):
    policy, _ = _policies(network, 4, 2, **({"hidden_size": 4} if network == "LSTMPolicy" else {}))
    params = torch.from_numpy(_population(policy.parameter_count, 7, seed=8, scale=0.5))
    out = {}
    for mode in ("pipelined", "sync"):
        stats = RunningStat()
        result = PH.run_host_pipelined_rollout(
            _cartpole(PH, 4), policy, params, num_episodes=2, episode_length=40, obs_stats=stats, num_blocks=2,
            mode=mode, device="cpu",
        )  # fmt: skip
        out[mode] = result, stats
    (a, sa), (b, sb) = out["pipelined"], out["sync"]
    for k in ("scores", "episode_steps", "lane_episodes", "block_iters", "interactions", "episodes", "occupancy"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    np.testing.assert_array_equal(sa.sum, sb.sum)
    np.testing.assert_array_equal(sa.sum_of_squares, sb.sum_of_squares)


def test_engine_tuned_cache_and_failures(tmp_path, monkeypatch):
    from evotorch_tpu_torch.observability import timings

    policy, _ = _policies("LinearPolicy", 1, 1)
    params = torch.from_numpy(_population(policy.parameter_count, 3, seed=9, scale=1.0))
    # the machine-scoped cache entry decides the block split when none is given
    cache = tmp_path / "tuned.json"
    monkeypatch.setenv("EVOTORCH_TUNED_CACHE", str(cache))
    timings.save_tuned_entry(
        timings.TunedEntry(group="host_pipeline", shape={}, machine=timings.machine_fingerprint("cpu"), config={"num_blocks": 1}),
        path=cache,
    )
    timings.load_tuned_cache(force=True)
    result = PH.run_host_pipelined_rollout(PH.SyncVectorEnv(ProgrammableLengthEnv, 3), policy, params, device="cpu")
    assert result["tuned_config_source"] == "cache" and len(result["block_iters"]) == 1
    result = PH.run_host_pipelined_rollout(PH.SyncVectorEnv(ProgrammableLengthEnv, 3), policy, params, device="cpu", use_tuned_cache=False)
    assert result["tuned_config_source"] == "fallback"
    with pytest.raises(ValueError):
        PH.run_host_pipelined_rollout(PH.SyncVectorEnv(ProgrammableLengthEnv, 3), policy, params, device="cpu", mode="fast")

    class Broken(ProgrammableLengthEnv):
        def step(self, action):
            raise RuntimeError("physics failed")

    with pytest.raises(RuntimeError, match="physics failed"):
        PH.run_host_pipelined_rollout(PH.SyncVectorEnv(Broken, 3), policy, params, device="cpu", num_blocks=2)


def test_engines_default_to_the_card(monkeypatch):
    policy, _ = _policies("LinearPolicy", 1, 1)
    params = torch.zeros(2, policy.parameter_count)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (PH.run_host_vectorized_rollout, PH.run_host_pipelined_rollout):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run(PH.SyncVectorEnv(ProgrammableLengthEnv, 2), policy, params)
