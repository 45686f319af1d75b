"""The port's fused training spans (``parallel.make_training_span``,
``VecNE.make_training_span``/``consume_span``, ``device_episode_total``)
on the CPU: the cases of the JAX package's ``tests/test_training_span.py``.

- A span of K generations equals K sequential ``make_generation_step``
  calls given the same generator, bit for bit (state, scores, statistics,
  step counts, the telemetry rows and the stacked ``state_metrics``),
  under ``budget``, ``episodes`` and ``episodes_refill``, for a trunk-delta
  population, and over 3 gloo ranks at a popsize that does not divide
  them (padded), where it also equals the one-rank run bit for bit.
- ``episodes_compact``, ``span < 1``, a wrong number of generators and a
  reserved rollout keyword are refused, as in the JAX package.
- ``consume_span``: the counters and the decoded status keys equal those of
  the same generations consumed one span of 1 at a time; the last row of
  the stacked wire stays pending (lag-by-span).
- ``device_episode_total`` on 1-D, 2-D, 3-D and empty wires equals the
  JAX function.
- A whole span against the JAX package's ``make_training_span``: the
  population injected from JAX's ask noise, noise-free resets and the
  gentle population of ``tests/test_torch_pgpe.py``, at its tolerances
  (scores ``atol=1e-4``, ordered alike wherever they lie more than twice
  that apart, env steps exactly, the
  statistics ``rtol=1e-4, atol=1e-3``, the state ``rtol=1e-4, atol=1e-6``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.algorithms.functional import (
    pgpe,
    pgpe_ask,
    pgpe_ask_trunk_delta,
    pgpe_health,
    pgpe_tell,
    pgpe_tell_trunk_delta,
)
from evotorch_tpu_torch.envs import Pendulum
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, Tanh, stats_init
from evotorch_tpu_torch.observability.devicemetrics import device_episode_total
from evotorch_tpu_torch.parallel import default_mesh, make_generation_step, make_training_span
from test_torch_parallel import Spawn

SPAN = 3
POPSIZE = 10  # does not divide over 3 ranks: the sharded span pads
MODES = ("budget", "episodes", "episodes_refill")
NET = "Linear(obs_length, 4) >> Tanh() >> Linear(4, act_length)"


def _pendulum():
    env = Pendulum(device="cpu")
    return env, FlatParamsPolicy(Linear(env.observation_size, 4) >> Tanh() >> Linear(4, env.action_size))


def _state(policy, stdev=0.1):
    center = 0.1 * torch.randn(policy.parameter_count, generator=torch.Generator().manual_seed(3))
    return pgpe(
        center_init=center, center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=stdev
    )


def _rollout_kw(mode):
    kw = dict(num_episodes=1, episode_length=8, eval_mode=mode, observation_normalization=True)
    if mode == "episodes_refill":
        kw.update(refill_width=4, refill_period=1)
    return kw


def _flat(tree):
    """The leaves of a state: tensors, and the plain values of its
    configuration fields."""
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in _flat(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flat(item)]
    if isinstance(tree, dict):
        return [leaf for item in tree.values() for leaf in _flat(item)]
    return [tree]


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def _span_and_sequence(mode, *, mesh=None, trunk_delta=False, popsize=POPSIZE):
    """A span of ``SPAN`` generations and ``SPAN`` sequential generations
    from one state and one seed; each as ``(state, scores, stats, steps,
    telemetry, metrics)``."""
    env, policy = _pendulum()
    if trunk_delta:
        ask = lambda g, s: pgpe_ask_trunk_delta(g, s, popsize=popsize, rank=2, policy=policy)  # noqa: E731
        tell = pgpe_tell_trunk_delta
    else:
        ask, tell = (lambda g, s: pgpe_ask(g, s, popsize=popsize)), pgpe_tell
    kw = dict(ask=ask, tell=tell, popsize=popsize, mesh=mesh, device="cpu", **_rollout_kw(mode))
    stats0 = stats_init(env.observation_size, device="cpu")

    generation = make_generation_step(env, policy, **kw)
    state, stats, generator = _state(policy), stats0, torch.Generator().manual_seed(7)
    scores, steps, wires, metrics = [], [], [], []
    for _ in range(SPAN):
        state, s, stats, n, t = generation(state, generator, stats)
        scores.append(s)
        steps.append(n)
        wires.append(t)
        metrics.append(pgpe_health(state))
    sequence = (state, torch.stack(scores), stats, torch.tensor(steps), torch.stack(wires), metrics)

    training_span = make_training_span(env, policy, span=SPAN, state_metrics=pgpe_health, **kw)
    generator = torch.Generator().manual_seed(7)
    fused = training_span(_state(policy), [generator] * SPAN, stats0)
    return fused, sequence


def _assert_span_equals_sequence(fused, sequence, *, padded=False):
    """Bit for bit. ``padded``: one run sharded with padding lanes, the
    other not; the wire's ``capacity`` and ``lane_width`` (columns 2 and 3)
    count the physical lanes (as the JAX package's do) and are left out."""
    state, scores, stats, steps, telemetry, metrics = fused
    s_state, s_scores, s_stats, s_steps, s_telemetry, s_metrics = sequence
    assert scores.shape == (SPAN, s_scores.shape[1]) and telemetry.shape == (SPAN, 1, 20)
    assert steps.shape == (SPAN,) and steps.dtype == torch.int64
    for a, b in zip(_flat(state) + _flat(stats), _flat(s_state) + _flat(s_stats)):
        assert _equal(a, b)
    assert torch.equal(scores, s_scores)
    assert torch.equal(steps, s_steps)
    keep = [c for c in range(telemetry.shape[-1]) if not (padded and c in (2, 3))]
    assert torch.equal(telemetry[..., keep], s_telemetry[..., keep])
    for key in s_metrics[0]:
        assert torch.equal(metrics[key], torch.stack([m[key] for m in s_metrics])), key


@pytest.mark.parametrize("mode", MODES)
def test_span_equals_sequential_generations(mode):
    fused, sequence = _span_and_sequence(mode)
    _assert_span_equals_sequence(fused, sequence)
    assert not torch.equal(fused[1][0], fused[1][1])  # the generations differ


@pytest.mark.parametrize("mode", ["budget", "episodes"])
def test_trunk_delta_span_equals_sequential_generations(mode):
    fused, sequence = _span_and_sequence(mode, trunk_delta=True, popsize=8)
    _assert_span_equals_sequence(fused, sequence)


def test_span_refusals():
    env, policy = _pendulum()
    kw = dict(ask=lambda g, s: pgpe_ask(g, s, popsize=4), tell=pgpe_tell, popsize=4, device="cpu")
    with pytest.raises(ValueError, match="episodes_compact"):
        make_training_span(env, policy, span=2, eval_mode="episodes_compact", **kw)
    for span in (0, -1):
        with pytest.raises(ValueError, match="span must be >= 1"):
            make_training_span(env, policy, span=span, **kw)
    with pytest.raises(ValueError, match="lane_ids"):
        make_training_span(env, policy, span=2, lane_ids=torch.arange(4), **kw)
    training_span = make_training_span(env, policy, span=2, episode_length=4, **kw)
    stats = stats_init(env.observation_size, device="cpu")
    for generators in ([torch.Generator()], [torch.Generator()] * 3, torch.Generator(), []):
        with pytest.raises(ValueError, match="span=2 generators"):
            training_span(_state(policy), generators, stats)
    # telemetry off: a (span, 0) wire
    quiet = make_training_span(env, policy, span=2, episode_length=4, telemetry=False, **kw)
    _, scores, _, steps, wire = quiet(_state(policy), [torch.Generator().manual_seed(0)] * 2, stats)
    assert scores.shape == (2, 4) and steps.shape == (2,) and wire.shape == (2, 0)


def _vecne(mode):
    kw = dict(refill_config={"width": 4, "period": 1}) if mode == "episodes_refill" else {}
    return VecNE(
        "pendulum", NET, eval_mode=mode, observation_normalization=True, episode_length=8, device="cpu", seed=1, **kw
    )


@pytest.mark.parametrize("mode", MODES)
def test_consume_span_counters_and_lag(mode):
    """One span of ``SPAN`` consumed at once against ``SPAN`` spans of one
    generation consumed one by one: the same counters, statistics and
    decoded status keys; the last row pending."""
    fused_problem, single_problem = _vecne(mode), _vecne(mode)
    ask = lambda g, s: pgpe_ask(g, s, popsize=POPSIZE)  # noqa: E731
    state = _state(fused_problem.policy)

    training_span = fused_problem.make_training_span(ask=ask, tell=pgpe_tell, popsize=POPSIZE, span=SPAN)
    generator = torch.Generator().manual_seed(5)
    result = training_span(state, [generator] * SPAN, fused_problem.obs_norm.stats)
    scores = fused_problem.consume_span(result)
    assert torch.equal(scores, result[1]) and scores.shape == (SPAN, POPSIZE)

    one = single_problem.make_training_span(ask=ask, tell=pgpe_tell, popsize=POPSIZE, span=1)
    generator, single_state, single_scores = torch.Generator().manual_seed(5), state, []
    for _ in range(SPAN):
        out = one(single_state, [generator], single_problem.obs_norm.stats)
        single_state = out[0]
        single_scores.append(single_problem.consume_span(out))
    assert torch.equal(torch.cat(single_scores), scores)

    steps = int(result[3].sum())
    assert int(fused_problem.status["total_interaction_count"]) == steps
    episodes = int(fused_problem.status["total_episode_count"])
    if mode == "budget":
        assert episodes == int(device_episode_total(result[4]))
    else:
        assert episodes == SPAN * POPSIZE
    for a, b in zip(_flat(fused_problem.obs_norm.stats), _flat(single_problem.obs_norm.stats)):
        assert _equal(a, b)
    assert torch.equal(fused_problem._pending_telemetry, result[4][-1])
    assert torch.equal(single_problem._pending_telemetry, result[4][-1])
    keys = [k for k in fused_problem.status if k.startswith(("eval_", "total_"))]
    assert "eval_occupancy" in keys and "eval_score_mean" in keys
    assert keys == [k for k in single_problem.status if k.startswith(("eval_", "total_"))]
    for key in keys:
        assert np.array_equal(np.asarray(fused_problem.status[key]), np.asarray(single_problem.status[key])), key
    # the decoded row is generation K-2's
    from evotorch_tpu_torch.observability import GroupTelemetry

    assert fused_problem._last_group_telemetry.total() == GroupTelemetry.from_array(result[4][-2]).total()


def test_consume_span_without_telemetry_and_compact_refusal():
    # VecNE always carries telemetry; a span made without it counts
    # popsize x num_episodes x span episodes (budget: 0)
    for mode, expected in (("episodes", 2 * POPSIZE), ("budget", 0)):
        problem = _vecne(mode)
        env, policy = problem.env, problem.policy
        quiet = make_training_span(
            env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE, span=2,
            device="cpu", eval_mode=mode, episode_length=8, telemetry=False,
        )  # fmt: skip
        result = quiet(_state(policy), [torch.Generator().manual_seed(2)] * 2, problem.obs_norm.stats)
        problem.consume_span(result)
        assert int(problem.status["total_episode_count"]) == expected
        assert int(problem.status["total_interaction_count"]) == int(result[3].sum())
        assert problem._pending_telemetry is None
    compact = VecNE("pendulum", NET, eval_mode="episodes_compact", device="cpu")
    with pytest.raises(ValueError, match="episodes_compact"):
        compact.make_training_span(ask=lambda g, s: pgpe_ask(g, s, popsize=8), tell=pgpe_tell, popsize=8, span=2)


@pytest.mark.parametrize("shape", [(20,), (1, 20), (3, 1, 20), (2, 4, 20), (0,), (3, 0)])
def test_device_episode_total_matches_jax(shape):
    import jax.numpy as jnp

    from evotorch_tpu.observability.devicemetrics import device_episode_total as jax_device_episode_total

    wire = np.random.default_rng(sum(shape)).integers(0, 1000, size=shape).astype(np.int32)
    ours = device_episode_total(torch.from_numpy(wire))
    theirs = jax_device_episode_total(jnp.asarray(wire))
    assert ours.dtype == torch.int32 and ours.shape == ()
    assert int(ours) == int(theirs)


# ------------------------------------------------------ sharded over ranks


def case_sharded_span(payload):
    return {mode: _span_and_sequence(mode, mesh=default_mesh()) for mode in ("budget", "episodes_refill")}


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    return Spawn(tmp_path_factory.mktemp("span_ranks"), 3, [case_sharded_span]).results()


@pytest.mark.parametrize("mode", ["budget", "episodes_refill"])
def test_sharded_span_at_a_padded_popsize(three_ranks, mode):
    """Over 3 gloo ranks at popsize 10 the span equals the ranks' sequential
    generations and the one-rank run bit for bit, on every rank."""
    one_rank_fused, one_rank_sequence = _span_and_sequence(mode)
    for rank, saved in enumerate(three_ranks):
        fused, sequence = saved["case_sharded_span"][mode]
        _assert_span_equals_sequence(fused, sequence)
        _assert_span_equals_sequence(fused, one_rank_sequence, padded=True)
        _assert_span_equals_sequence(one_rank_fused, sequence, padded=True)
        if mode == "budget":  # 12 lanes over 3 ranks against 10
            assert fused[4][0, 0, 3] == 12 and one_rank_fused[4][0, 0, 3] == POPSIZE


# ------------------------------------------------------ against the JAX span


@pytest.mark.parametrize("obs_norm", [False, True])
def test_span_matches_jax_training_span(obs_norm):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
    from evotorch_tpu.algorithms.functional import pgpe_ask as jax_pgpe_ask
    from evotorch_tpu.algorithms.functional import pgpe_tell as jax_pgpe_tell
    from evotorch_tpu.envs import Humanoid as JaxHumanoid
    from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
    from evotorch_tpu.neuroevolution.net import tanh_mlp as jax_tanh_mlp
    from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm
    from evotorch_tpu.parallel import make_training_span as jax_make_training_span
    from evotorch_tpu_torch import interop
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp
    from test_torch_pgpe import PGPE_KW, _assert_states_close, _jax_state_to_numpy

    popsize, episode_length, span = 8, 10, 2
    kw = dict(num_episodes=1, episode_length=episode_length, eval_mode="budget", observation_normalization=obs_norm)
    jax_env = JaxHumanoid(reset_noise_scale=0.0)
    jax_policy = JaxFlatParamsPolicy(jax_tanh_mlp(jax_env.observation_size, jax_env.action_size, [64, 64]))
    jax_span = jax_make_training_span(
        jax_env, jax_policy, ask=lambda k, s: jax_pgpe_ask(k, s, popsize=popsize), tell=jax_pgpe_tell,
        popsize=popsize, span=span, mesh=Mesh(np.asarray(jax.devices()[:1]), ("pop",)), donate_state=False,
        telemetry=False, **kw,
    )  # fmt: skip
    L = jax_policy.parameter_count
    center = (0.01 * np.random.default_rng(5).normal(size=L)).astype(np.float32)
    jax_state = jax_pgpe(center_init=jnp.asarray(center), **dict(PGPE_KW, stdev_init=0.01))
    jax_stats = RunningNorm(jax_env.observation_size).stats
    if obs_norm:  # from non-trivial statistics, as in tests/test_torch_pgpe.py
        rng = np.random.default_rng(5)
        jax_stats = type(jax_stats)(
            count=jnp.float32(50.0),
            sum=jnp.asarray(rng.normal(size=109).astype(np.float32)),
            sum_of_squares=jnp.asarray(50.0 + rng.uniform(size=109).astype(np.float32)),
        )
    port_state = interop.pgpe_state_from_numpy(_jax_state_to_numpy(jax_state), device="cpu")
    port_stats = interop.stats_from_numpy(
        {name: np.asarray(getattr(jax_stats, name)) for name in ("count", "sum", "sum_of_squares")}, device="cpu"
    )
    keys = jax.random.split(jax.random.key(11), span)
    # what each JAX generation hands its ask: the first half of its key
    eps = [
        torch.from_numpy(np.array(jax.random.normal(jax.random.split(k)[0], (popsize // 2, L), dtype=jnp.float32)))
        for k in keys
    ]
    jax_state, jax_scores, jax_stats_out, jax_steps, _ = jax_span(jax_state, keys, jax_stats)

    env = Humanoid(reset_noise_scale=0.0, device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    draws = iter(eps)
    training_span = make_training_span(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize, eps=next(draws)), tell=pgpe_tell,
        popsize=popsize, span=span, device="cpu", **kw,
    )  # fmt: skip
    generator = torch.Generator().manual_seed(0)
    port_state, scores, stats_out, steps, telemetry = training_span(port_state, [generator] * span, port_stats)
    assert telemetry.shape == (span, 1, 20)

    jax_scores = np.asarray(jax_scores)
    assert scores.shape == jax_scores.shape == (span, popsize)
    np.testing.assert_allclose(scores.numpy(), jax_scores, rtol=0, atol=1e-4)
    for ours, theirs in zip(scores.numpy(), jax_scores):
        # the order of every pair of scores further apart than twice atol
        gaps, our_gaps = theirs[:, None] - theirs[None, :], ours[:, None] - ours[None, :]
        apart = np.abs(gaps) > 2e-4
        assert apart.sum() >= len(theirs) * (len(theirs) - 1) - 2
        np.testing.assert_array_equal(np.sign(our_gaps[apart]), np.sign(gaps[apart]))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jax_steps))
    for name, value in interop.stats_to_numpy(stats_out).items():
        np.testing.assert_allclose(value, np.asarray(getattr(jax_stats_out, name)), rtol=1e-4, atol=1e-3, err_msg=name)
    _assert_states_close(port_state, jax_state, rtol=1e-4, atol=1e-6)
