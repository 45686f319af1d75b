"""``GymNE`` in the port against the JAX package, on the CPU: the serial path
(``num_envs=None``), the ``chunked`` path and the ``pipelined`` and
``sync`` paths, each evaluating one numpy population in both packages;
the interaction and episode counters and the control-step counter; ``tuned_config_source`` (override,
cache, fallback); ``save_solution`` from the JAX package read by the port,
with the same ``to_policy``; the four host-pool sync hooks; a callable env
without gymnasium; and the card as the default device.

The evals, the counters and the observation statistics are held exactly
(episode lengths are set by the policies' first actions or argmaxes,
which these seeds keep clear of ties; the rewards are whole numbers); the
``to_policy`` forwards to ``rtol=1e-5, atol=1e-6`` (float32 products).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu.neuroevolution import GymNE as JaxGymNE
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.core import SolutionBatch
from evotorch_tpu_torch.neuroevolution import GymNE
from evotorch_tpu_torch.neuroevolution.net import RunningStat

from test_torch_hostenv import ProgrammableLengthEnv

gym = pytest.importorskip("gymnasium")

NET = "Linear(obs_length, act_length)"


def _values(length, n, seed, scale):
    return (np.random.default_rng(seed).normal(size=(n, length)) * scale).astype(np.float32)


def _evaluate(problem, jax_problem, values):
    batch = SolutionBatch(problem, len(values), values=torch.from_numpy(values))
    problem.evaluate(batch)
    jbatch = JaxSolutionBatch(jax_problem, len(values), values=jnp.asarray(values))
    jax_problem.evaluate(jbatch)
    return batch.evals[:, 0].numpy(), np.asarray(jbatch.evals[:, 0])


def _assert_counters(problem, jax_problem):
    for key in ("total_interaction_count", "total_episode_count"):
        assert int(problem.status[key]) == int(jax_problem.status[key]), key


def _assert_stats(problem, jax_problem):
    ours, theirs = problem.get_observation_stats(), jax_problem.get_observation_stats()
    assert ours.count == theirs.count
    if ours.count:
        np.testing.assert_array_equal(ours.sum, theirs.sum)
        np.testing.assert_array_equal(ours.sum_of_squares, theirs.sum_of_squares)


def test_serial_path_matches_jax():
    kw = dict(num_episodes=2, episode_length=30, decrease_rewards_by=0.5, alive_bonus_schedule=(3, 0.25))
    problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", **kw)
    jax_problem = JaxGymNE(ProgrammableLengthEnv, NET, **kw)
    values = _values(problem.solution_length, 5, seed=0, scale=1.5)
    for _ in range(2):
        ours, theirs = _evaluate(problem, jax_problem, values)
        np.testing.assert_array_equal(ours, theirs)
        _assert_counters(problem, jax_problem)
    assert problem.run_solution(torch.from_numpy(values[0])) == jax_problem.run_solution(jnp.asarray(values[0]))


@pytest.mark.parametrize("host_pipeline", ["chunked", "pipelined", "sync"])
def test_vectorized_paths_match_jax_on_cartpole(host_pipeline):
    kw = dict(
        num_envs=4, host_pipeline=host_pipeline, host_pipeline_blocks=2, observation_normalization=True,
        num_episodes=2, episode_length=50,
    )  # fmt: skip
    problem = GymNE("CartPole-v1", NET, device="cpu", **kw)
    jax_problem = JaxGymNE("CartPole-v1", NET, **kw)
    for p in (problem, jax_problem):
        p._make_vector_env().seed(range(200, 204))
    values = _values(problem.solution_length, 7, seed=1, scale=0.5)
    for _ in range(2):
        ours, theirs = _evaluate(problem, jax_problem, values)
        np.testing.assert_array_equal(ours, theirs)
        _assert_counters(problem, jax_problem)
        _assert_stats(problem, jax_problem)
    assert problem.status["tuned_config_source"] == "override"


def test_pipelined_and_sync_agree_and_match_chunked_at_one_chunk():
    out = {}
    for hp in ("pipelined", "sync", "chunked"):
        problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", num_envs=6, host_pipeline=hp, host_pipeline_blocks=2)
        values = _values(problem.solution_length, 6, seed=2, scale=1.5)
        batch = SolutionBatch(problem, 6, values=torch.from_numpy(values))
        problem.evaluate(batch)
        out[hp] = batch.evals[:, 0].numpy(), int(problem.status["total_interaction_count"])
        assert batch.evals.device == problem.device
    assert np.array_equal(out["pipelined"][0], out["sync"][0]) and out["pipelined"][1] == out["sync"][1]
    # one chunk, one episode a solution: every lane's episode is the same
    np.testing.assert_array_equal(out["pipelined"][0], out["chunked"][0])


@pytest.mark.parametrize("host_pipeline", ["chunked", "pipelined", "sync"])
def test_control_step_counter_counts_the_policy_forwards(host_pipeline):
    """``total_control_step_count`` grows by the batched policy forwards the
    vectorized engines run (counted here by wrapping the policy); serially
    it is one forward an env step. The host-pool hooks carry it as a delta."""

    class Counted:
        def __init__(self, policy):
            self.policy, self.calls = policy, 0

        def __getattr__(self, name):
            return getattr(self.policy, name)

        def __call__(self, *args, **kwargs):
            self.calls += 1
            return self.policy(*args, **kwargs)

    problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", num_envs=4, host_pipeline=host_pipeline, host_pipeline_blocks=2)
    problem._policy = counted = Counted(problem._policy)
    values = _values(problem.solution_length, 7, seed=2, scale=1.5)
    problem.evaluate(SolutionBatch(problem, 7, values=torch.from_numpy(values)))
    assert counted.calls > 0 and int(problem.status["total_control_step_count"]) == counted.calls
    assert problem._make_sync_data_for_main()["control_steps"] == counted.calls
    assert problem._control_step_count == 0
    serial = GymNE(ProgrammableLengthEnv, NET, device="cpu")
    serial.evaluate(SolutionBatch(serial, 3, values=torch.from_numpy(values[:3])))
    assert int(serial.status["total_control_step_count"]) == int(serial.status["total_interaction_count"]) > 0


def test_tuned_config_source(tmp_path, monkeypatch):
    from evotorch_tpu_torch.observability import timings

    cache = tmp_path / "tuned.json"
    monkeypatch.setenv("EVOTORCH_TUNED_CACHE", str(cache))
    monkeypatch.delenv("EVOTORCH_MJ_NTHREAD", raising=False)
    values = _values(2, 3, seed=3, scale=1.0)

    def source(**kw):
        problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", num_envs=3, **kw)
        problem.evaluate(SolutionBatch(problem, 3, values=torch.from_numpy(values)))
        return problem.status["tuned_config_source"], problem._resolve_host_tuning()

    assert source() == ("fallback", {})
    assert source(host_pipeline_blocks=1) == ("override", {"num_blocks": 1})
    monkeypatch.setenv("EVOTORCH_MJ_NTHREAD", "2")
    assert source() == ("override", {"mj_nthread": 2})
    monkeypatch.delenv("EVOTORCH_MJ_NTHREAD")
    # an entry the JAX package measured never matches the port's machine
    jax_machine = {"backend": "cpu", "core_count": timings.machine_fingerprint("cpu")["core_count"], "device_kind": "cpu"}
    timings.save_tuned_entry(timings.TunedEntry("host_pipeline", {}, jax_machine, {"num_blocks": 1}), path=cache)
    assert source() == ("fallback", {})
    timings.save_tuned_entry(timings.TunedEntry("host_pipeline", {}, timings.machine_fingerprint("cpu"), {"num_blocks": 1}), path=cache)
    assert source() == ("cache", {"num_blocks": 1})


def test_jax_save_solution_loads_in_the_port(tmp_path):
    jax_problem = JaxGymNE("Pendulum-v1", NET, observation_normalization=True, episode_length=20)
    values = _values(jax_problem.solution_length, 3, seed=4, scale=0.3)
    jax_problem.evaluate(JaxSolutionBatch(jax_problem, 3, values=jnp.asarray(values)))
    fname = tmp_path / "best.pkl"
    jax_problem.save_solution(jnp.asarray(values[1]), str(fname))
    with open(fname, "rb") as f:
        payload = pickle.load(f)
    for v in payload.values():  # numpy and Python values only: loads without JAX
        assert v is None or isinstance(v, (np.ndarray, int, float, str)), type(v)
    problem = GymNE("Pendulum-v1", NET, device="cpu", observation_normalization=True, episode_length=20)
    stats = jax_problem.get_observation_stats()
    problem.set_observation_stats(
        interop.running_stat_from_numpy({"count": stats.count, "sum": stats.sum, "sum_of_squares": stats.sum_of_squares})
    )
    policy = problem.to_policy(torch.from_numpy(payload["values"]))
    jax_policy = jax_problem.to_policy(jnp.asarray(payload["values"]))
    obs = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    y, _ = policy.apply([], torch.from_numpy(obs))
    jparams = jax_policy.init(jax.random.key(0))  # the weights are frozen: any key
    jy = jax.vmap(lambda o: jax_policy.apply(jparams, o)[0])(jnp.asarray(obs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert float(y.abs().max()) <= 2.0  # the action clip
    # and the port writes the same payload back
    problem.save_solution(torch.from_numpy(payload["values"]), str(tmp_path / "again.pkl"))
    with open(tmp_path / "again.pkl", "rb") as f:
        again = pickle.load(f)
    assert again.keys() == payload.keys()
    np.testing.assert_array_equal(again["values"], payload["values"])
    np.testing.assert_array_equal(again["obs_mean"], payload["obs_mean"])
    assert again["obs_count"] == payload["obs_count"] and again["network_spec"] == payload["network_spec"]


def test_host_pool_sync_hooks_match_jax():
    """One round of the main/worker protocol, run in process: the worker
    adopts the main's statistics, evaluates, reports its counts and the
    statistics' delta; the main merges. Held against the JAX problem's
    hooks driven the same way."""
    kw = dict(observation_normalization=True, episode_length=20, num_envs=3, host_pipeline="sync")
    results = []
    for make, batch_cls, conv in (
        (lambda: GymNE("CartPole-v1", NET, device="cpu", **kw), SolutionBatch, torch.from_numpy),
        (lambda: JaxGymNE("CartPole-v1", NET, **kw), JaxSolutionBatch, jnp.asarray),
    ):
        main, worker = make(), make()
        for p in (main, worker):
            p._make_vector_env().seed(range(300, 303))
        values = _values(main.solution_length, 3, seed=6, scale=0.5)
        main.evaluate(batch_cls(main, 3, values=conv(values)))
        worker._use_sync_data_from_main(main._make_sync_data_for_actors())
        worker.evaluate(batch_cls(worker, 3, values=conv(values[::-1].copy())))
        back = worker._make_sync_data_for_main()
        assert worker._interaction_count == 0 and worker._episode_count == 0  # a delta a round
        main._use_sync_data_from_actors([back])
        stats = main.get_observation_stats()
        results.append((main._interaction_count, main._episode_count, stats.count, stats.sum, stats.sum_of_squares, back["interactions"]))
    ours, theirs = results
    assert ours[:3] == theirs[:3] and ours[5] == theirs[5]
    np.testing.assert_array_equal(ours[3], theirs[3])
    np.testing.assert_array_equal(ours[4], theirs[4])
    assert GymNE("CartPole-v1", NET, device="cpu")._make_sync_data_for_actors() is None


def test_a_callable_env_runs_without_gymnasium(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    monkeypatch.setitem(sys.modules, "evotorch_tpu_torch.envs.mujoco.mjvecenv", None)
    for num_envs in (None, 3):
        problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", num_envs=num_envs)
        problem.evaluate(SolutionBatch(problem, 3, values=torch.from_numpy(_values(2, 3, seed=7, scale=1.0))))
        assert int(problem.status["total_episode_count"]) == 3
    assert type(problem._vec_env).__name__ == "SyncVectorEnv"
    with pytest.raises(ImportError):
        GymNE("CartPole-v1", NET, device="cpu")


def test_gymne_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GymNE(ProgrammableLengthEnv, NET)


def test_observation_stats_accessors():
    problem = GymNE(ProgrammableLengthEnv, NET, device="cpu", observation_normalization=True)
    stats = RunningStat()
    stats.update(np.ones((3, 1)))
    problem.set_observation_stats(stats)
    assert problem.get_observation_stats() is stats and problem.observation_normalization
