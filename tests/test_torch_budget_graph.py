"""The budget contract's bookkeeping replayed from a CUDA graph
(``neuroevolution/net/vecrl.py``: ``_ReplayedBookkeeping``).

On the card (``cuda`` marker; each test decides inside it and skips without
a card): a graphed budget round against the eager step driven by hand, bit
for bit, over three rounds at one width: the tallies, the statistics, the
whole final carry, the generator's state after each round and the next ask
drawn from it; one capture for the three; and every observation and
statistics handed to ``_act_and_step`` its own storage, still holding its
step's values at the round's end. Then each rigid-body locomotion env
through ``run_vectorized_rollout`` against the same rollout with the graph
kept out. Run them on a machine with the card:
``python3 -m pytest --noconftest -m cuda tests/test_torch_budget_graph.py``.

On the CPU: no contract captures or replays, budget counts its steps as
eager, and the benchmark's ``graphed_step_share`` reads those counters.
This file imports no JAX.
"""

from __future__ import annotations

import pytest
import torch

import evotorch_tpu_torch.observability as observability
from evotorch_tpu_torch.envs import make_env
from evotorch_tpu_torch.models.policies import LSTMPolicy
from evotorch_tpu_torch.neuroevolution.net import vecrl
from evotorch_tpu_torch.neuroevolution.net.functional import FlatParamsPolicy
from evotorch_tpu_torch.neuroevolution.net.layers import Linear
from evotorch_tpu_torch.neuroevolution.net.runningnorm import stats_init
from evotorch_tpu_torch.observability import CounterRegistry
from evotorch_tpu_torch.ops import sampling

CAPTURES, REPLAYED, EAGER = "rollout.graph.captures", "rollout.graph.replayed_steps", "rollout.graph.eager_steps"
LANES = 2_048
#: two episodes of this length a round: lanes restart mid-round
EPISODE_LENGTH = 50
ROUNDS = 3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def registry(monkeypatch):
    """A fresh counter registry, where the engine counts and where the
    benchmark reads."""
    reg = CounterRegistry()
    monkeypatch.setattr(vecrl, "counters", reg)
    monkeypatch.setattr(observability, "counters", reg)
    return reg


def _assert_same(a, b):
    la, lb = vecrl._leaves(a), vecrl._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _policy(kind: str, env) -> FlatParamsPolicy:
    if kind == "linear":
        return FlatParamsPolicy(Linear(env.observation_size, env.action_size))
    return FlatParamsPolicy(LSTMPolicy(env.observation_size, env.action_size))


def _population(policy, n, device):
    g = torch.Generator(device=device).manual_seed(11)
    return 0.1 * torch.randn((n, policy.parameter_count), generator=g, device=device)


def _rounds_by_hand(env, policy, params, *, graphed: bool, device):
    """``ROUNDS`` budget rounds of ``_make_budget_step`` driven by hand, the
    statistics carried from round to round: each round's final carry and
    the generator's state after it, the ask drawn after the last round, and
    every ``(obs, stats)`` handed to ``_act_and_step`` with a copy of each
    taken when it was handed."""
    generator = torch.Generator(device=device).manual_seed(2**40 + 7)
    options = vecrl._make_options(True, None, 5.0, None, None)
    stats = stats_init(env.observation_size, device=device)
    handed = []
    original = vecrl._act_and_step

    def tapped(env_, forward, params_, obs, stats_, *args, **kwargs):
        handed[-1].append((obs, obs.clone(), stats_, vecrl._tree_map(torch.clone, stats_)))
        return original(env_, forward, params_, obs, stats_, *args, **kwargs)

    carries, states = [], []
    vecrl._act_and_step = tapped
    try:
        for _ in range(ROUNDS):
            handed.append([])
            carry = vecrl._budget_init(env, policy, params, generator, stats, options)
            step = vecrl._make_budget_step(
                env, policy, params, generator, max_t=EPISODE_LENGTH, options=options, graphed=graphed
            )
            for _ in range(2 * EPISODE_LENGTH):
                carry = step(carry)
            stats = carry.stats
            carries.append(vecrl._tree_map(torch.clone, carry))
            states.append(generator.get_state())
    finally:
        vecrl._act_and_step = original
    mu = torch.zeros(policy.parameter_count, device=device)
    ask = sampling.sample_symmetric_gaussian(mu, torch.ones_like(mu), 64, generator=generator)
    return carries, states, ask, handed


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "lstm"])
def test_graphed_rounds_equal_eager_rounds(device, registry, kind):
    env = make_env("humanoid", device=device)
    policy = _policy(kind, env)
    params = _population(policy, LANES, device)
    graphed = _rounds_by_hand(env, policy, params, graphed=True, device=device)
    assert registry.get(CAPTURES) == 1
    assert registry.get(EAGER) == vecrl._GRAPH_WARMUP_STEPS
    assert registry.get(REPLAYED) == ROUNDS * 2 * EPISODE_LENGTH - vecrl._GRAPH_WARMUP_STEPS
    eager = _rounds_by_hand(env, policy, params, graphed=False, device=device)
    assert registry.get(CAPTURES) == 1
    carries, states, ask, handed = graphed
    for ours, theirs in zip(carries, eager[0]):
        assert int(ours.episodes_done.sum()) > LANES  # lanes restarted within the round
        _assert_same(ours, theirs)
    for ours, theirs in zip(states, eager[1]):
        assert torch.equal(ours, theirs)
    assert torch.equal(ask, eager[2])
    torch.cuda.synchronize(device)
    for steps in handed:
        assert len({obs.data_ptr() for obs, *_ in steps}) == len(steps)
        assert len({stats.sum.data_ptr() for _, _, stats, _ in steps}) == len(steps)
        for obs, obs_then, stats, stats_then in steps:
            assert torch.equal(obs, obs_then)
            _assert_same(stats, stats_then)


#: every rigid-body locomotion env, one with action noise drawn eagerly
#: before each replay, and the LSTM in bfloat16
ROLLOUTS = [
    ("humanoid", "linear", {}),
    ("ant", "linear", {}),
    ("halfcheetah", "linear", {}),
    ("walker2d", "linear", {}),
    ("humanoid", "linear", {"action_noise_stdev": 0.05}),
    ("humanoid", "lstm", {"compute_dtype": torch.bfloat16}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("env_name, kind, extra", ROLLOUTS)
def test_rollout_replays_what_eager_computes(device, registry, monkeypatch, env_name, kind, extra):
    env = make_env(env_name, device=device)
    policy = _policy(kind, env)
    params = _population(policy, LANES, device)
    kw = dict(
        num_episodes=2, episode_length=EPISODE_LENGTH, observation_normalization=True, decrease_rewards_by=1.0,
        eval_mode="budget", **extra,
    )  # fmt: skip

    def rounds():
        generator = torch.Generator(device=device).manual_seed(123_456_789_012)
        stats = stats_init(env.observation_size, device=device)
        out = []
        for _ in range(ROUNDS):
            result = vecrl.run_vectorized_rollout(env, policy, params, generator, stats, **kw)
            stats = result.stats
            out.append((result.scores, result.stats, result.total_episodes, result.telemetry, generator.get_state()))
        return out

    graphed = rounds()
    assert (registry.get(CAPTURES), registry.get(EAGER)) == (1, vecrl._GRAPH_WARMUP_STEPS)
    monkeypatch.setattr(vecrl, "_replays_bookkeeping", lambda *args: False)
    eager = rounds()
    assert registry.get(CAPTURES) == 1
    for ours, theirs in zip(graphed, eager):
        _assert_same(ours, theirs)


@pytest.mark.parametrize("eval_mode", ["budget", "episodes", "episodes_refill"])
def test_cpu_rollouts_neither_capture_nor_replay(registry, eval_mode):
    """On CPU tensors no contract captures or replays (the Humanoid's
    resets could be captured on the card); budget counts each step as
    eager, and the benchmark's share reads 0 there, None where no budget
    step ran."""
    from perfbench import harness

    env = make_env("humanoid", device="cpu")
    policy = FlatParamsPolicy(Linear(env.observation_size, env.action_size))
    params = _population(policy, 8, torch.device("cpu"))
    read = harness.reader("graphed_step_share")
    assert read({}) is None
    vecrl.run_vectorized_rollout(
        env, policy, params, torch.Generator().manual_seed(0), stats_init(env.observation_size, device="cpu"),
        num_episodes=1, episode_length=4, observation_normalization=True, eval_mode=eval_mode, refill_width=4,
    )  # fmt: skip
    budget = eval_mode == "budget"
    assert (registry.get(CAPTURES), registry.get(REPLAYED), registry.get(EAGER)) == (0, 0, 4 if budget else 0)
    assert read({}) == (0.0 if budget else None)
