"""The port's recurrent and structured policies against the JAX package's,
on the CPU: the layers (``RNN``, ``LSTM``, ``FeedForwardNet``,
``StructuredControlNet``, ``LocomotorNet``), the state protocol and
``Policy``, the parameter-vector helpers, and recurrent rollouts under the
episodes contracts.

Every layer is given the JAX ``init``'s flat vectors (several keys, one per
solution), so the flat layouts must agree leaf for leaf. Rollouts inject
the JAX engine's reset draws (item ``j`` reset from ``split(fold_in(key,
j))[1]``, as ``tests/test_torch_contracts.py`` derives them) through
``reset_noise=``.

Tolerances:
- Layer forwards and ``Policy`` steps: ``rtol=1e-5, atol=1e-6`` (float32
  products of at most 109 terms summed in another order).
- Layouts, parameter counts, the parameter-vector round trip: exact.
- Rollouts against JAX: CartPole ``atol=1e-4`` with equal ranks (scores
  are episode lengths); Pendulum ``rtol=1e-4`` (returns of ~-100 to
  -400 summed over 40 smooth steps, the two engines' float32 round-off
  carried by the recurrent state).
- Within the port: every episodes contract equal to ``episodes`` bit for
  bit.
- ``compute_dtype=bfloat16``: the state stays bf16 in the carry; CartPole
  scores within 2 steps of the JAX package's bf16 run for at least 90% of
  the solutions (bf16 keeps 8 bits: the libraries round the products at
  different points, and a pole near its threshold falls a step earlier or
  later).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from scipy.stats import rankdata

from evotorch_tpu.envs import CartPole as JaxCartPole
from evotorch_tpu.envs import Pendulum as JaxPendulum
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import Policy as JaxPolicy
from evotorch_tpu.neuroevolution.net import count_parameters as jax_count_parameters
from evotorch_tpu.neuroevolution.net import layers as jax_layers
from evotorch_tpu.neuroevolution.net import run_vectorized_rollout as jax_rollout
from evotorch_tpu.neuroevolution.net import str_to_net as jax_str_to_net
from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm as JaxRunningNorm
from evotorch_tpu.neuroevolution.net.vecrl import run_vectorized_rollout_compacting as jax_compacting
from evotorch_tpu_torch.envs import CartPole, Pendulum
from evotorch_tpu_torch.neuroevolution import net as port_net
from evotorch_tpu_torch.neuroevolution.net import (
    LSTM,
    RNN,
    FeedForwardNet,
    FlatParamsPolicy,
    LocomotorNet,
    MultiLayered,
    Policy,
    Sequential,
    StatefulModule,
    StructuredControlNet,
    Tanh,
    count_parameters,
    device_of_module,
    ensure_stateful,
    fill_parameters,
    make_functional_module,
    parameter_vector,
    reset_tensors,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    str_to_net,
)
from evotorch_tpu_torch.neuroevolution.net import vecrl

POP = 5


def _layer_pairs():
    """``(name, port module, JAX module, input size)`` for every new layer."""
    return [
        ("rnn_tanh", RNN(6, 7), jax_layers.RNN(6, 7), 6),
        ("rnn_relu", RNN(6, 7, nonlinearity="relu"), jax_layers.RNN(6, 7, nonlinearity="relu"), 6),
        ("lstm", LSTM(6, 5), jax_layers.LSTM(6, 5), 6),
        (
            "feedforward",
            FeedForwardNet(6, [(8, Tanh()), (4, torch.relu), 3]),
            jax_layers.FeedForwardNet(6, [(8, jax_layers.Tanh()), (4, jax.nn.relu), 3]),
            6,
        ),
        (
            "scn",
            StructuredControlNet(in_features=6, out_features=3, num_layers=2, hidden_size=8),
            jax_layers.StructuredControlNet(in_features=6, out_features=3, num_layers=2, hidden_size=8),
            6,
        ),
        (
            "scn_no_bias",
            StructuredControlNet(in_features=6, out_features=3, num_layers=1, hidden_size=4, bias=False),
            jax_layers.StructuredControlNet(in_features=6, out_features=3, num_layers=1, hidden_size=4, bias=False),
            6,
        ),
        ("locomotor", LocomotorNet(in_features=6, out_features=3, num_sinusoids=4), jax_layers.LocomotorNet(in_features=6, out_features=3, num_sinusoids=4), 6),
    ]


LAYER_IDS = [name for name, *_ in _layer_pairs()]


def _jax_population(jax_module, n, seed=0):
    """``n`` flat vectors of the JAX ``init`` (one key each), and the leaf
    shapes of its pytree in ``ravel_pytree`` order."""
    flats = [ravel_pytree(jax_module.init(jax.random.key(seed + i)))[0] for i in range(n)]
    shapes = [leaf.shape for leaf in jax.tree_util.tree_leaves(jax_module.init(jax.random.key(seed)))]
    return np.stack([np.asarray(f) for f in flats]).astype(np.float32), shapes


def _jax_step(jax_module, params, x, state=None):
    """The JAX module over a population: one solution per row."""
    jax_policy = JaxFlatParamsPolicy(jax_module)
    if state is None:
        return jax.vmap(lambda p, o: jax_policy(p, o))(jnp.asarray(params), jnp.asarray(x))
    return jax.vmap(lambda p, o, s: jax_policy(p, o, s))(jnp.asarray(params), jnp.asarray(x), state)


def _close(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- layers


@pytest.mark.parametrize("index", range(len(LAYER_IDS)), ids=LAYER_IDS)
def test_layer_forward_matches_jax(index):
    """Layout, parameter count and two steps (the second from the first's
    state) on the JAX ``init``'s vectors; inputs of one row and of three
    rows per solution."""
    _, module, jax_module, n_in = _layer_pairs()[index]
    params, shapes = _jax_population(jax_module, POP)
    policy = FlatParamsPolicy(module)
    assert [shape for _, shape, _ in policy.layout] == [tuple(s) for s in shapes]
    assert policy.num_parameters == count_parameters(module) == jax_count_parameters(jax_module) == params.shape[1]
    assert module.is_stateful == jax_module.is_stateful
    rng = np.random.default_rng(index)
    x = rng.normal(size=(POP, n_in)).astype(np.float32)
    y, state = policy(torch.from_numpy(params), torch.from_numpy(x))
    jy, jstate = _jax_step(jax_module, params, x)
    _close(y, jy)
    if module.is_stateful:
        jax.tree_util.tree_map(lambda a, b: _close(a, b), jax.tree_util.tree_map(np.asarray, jstate), vecrl.map_state(lambda t: t.numpy(), state))
        x2 = rng.normal(size=(POP, n_in)).astype(np.float32)
        y2, _ = policy(torch.from_numpy(params), torch.from_numpy(x2), state)
        jy2, _ = _jax_step(jax_module, params, x2, jstate)
        _close(y2, jy2)
    else:
        assert state is None
    # several rows per solution: (popsize, rows, in)
    xr = rng.normal(size=(POP, 3, n_in)).astype(np.float32)
    yr, _ = policy(torch.from_numpy(params), torch.from_numpy(xr))
    jyr, _ = jax.vmap(lambda p, o: JaxFlatParamsPolicy(jax_module)(p, o))(jnp.asarray(params), jnp.asarray(xr))
    _close(yr, jyr)


def test_str_to_net_builds_every_layer_as_jax_does():
    """The network strings of the new layers parse in both packages to the
    same parameter counts, and the recurrent stack's forward agrees."""
    constants = dict(obs_length=5, act_length=2)
    specs = [
        "RNN(obs_length, 8) >> Linear(8, act_length)",
        "RNN(obs_length, 8, nonlinearity='relu') >> Tanh() >> Linear(8, act_length)",
        "LSTM(obs_length, 6) >> Linear(6, act_length)",
        "FeedForwardNet(obs_length, [(8, Tanh()), (act_length, None)])",
        "StructuredControlNet(in_features=obs_length, out_features=act_length, num_layers=2, hidden_size=4)",
        "LocomotorNet(in_features=obs_length, out_features=act_length, num_sinusoids=3)",
    ]
    for spec in specs:
        net, jax_net = str_to_net(spec, **constants), jax_str_to_net(spec, **constants)
        assert count_parameters(net) == jax_count_parameters(jax_net), spec
    spec = specs[2]
    params, _ = _jax_population(jax_str_to_net(spec, **constants), POP, seed=3)
    x = np.random.default_rng(4).normal(size=(POP, 5)).astype(np.float32)
    y, state = FlatParamsPolicy(str_to_net(spec, **constants))(torch.from_numpy(params), torch.from_numpy(x))
    jy, _ = _jax_step(jax_str_to_net(spec, **constants), params, x)
    _close(y, jy)
    assert state[0][0].shape == (POP, 6) and state[1] is None


def test_parameter_vector_round_trip_and_helpers():
    """``init`` -> ``parameter_vector`` -> ``fill_parameters`` gives the
    leaves back; ``init_parameters`` draws each leaf within the JAX
    ``init``'s bounds; the aliases and helpers of ``statefulmodule.py`` and
    ``misc.py``."""
    net = str_to_net("LSTM(4, 6) >> Linear(6, 2)")
    policy = make_functional_module(net)
    generator = torch.Generator().manual_seed(0)
    leaves = net.init(generator)
    assert [tuple(leaf.shape) for leaf in leaves] == [shape for _, shape, _ in policy.layout]
    vector = parameter_vector(leaves)
    assert vector.shape == (policy.num_parameters,)
    back = fill_parameters(leaves, vector)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))
    with pytest.raises(ValueError):
        fill_parameters(leaves, vector[:-1])
    flat = policy.init_parameters(torch.Generator().manual_seed(1))
    lstm_part = flat[: 4 * 6 * (6 + 4 + 2)]
    assert float(lstm_part.abs().max()) <= 1 / np.sqrt(6) and float(lstm_part.std()) > 0.1
    assert float(flat[lstm_part.shape[0] :].abs().max()) <= 1 / np.sqrt(6)
    amplitudes = FlatParamsPolicy(LocomotorNet(in_features=3, out_features=2, num_sinusoids=64)).init_parameters(
        torch.Generator().manual_seed(2)
    )[:64]
    assert 0.05 < float(amplitudes.std()) < 0.15  # normal x 0.1
    assert StatefulModule is port_net.Module and MultiLayered is Sequential and ensure_stateful(net) is net
    with pytest.raises(TypeError):
        ensure_stateful("LSTM")
    assert device_of_module(leaves) == torch.device("cpu") and device_of_module([]) is None
    assert policy.initial_state()[0][0].shape == (6,) and policy.initial_state()[1] is None


# --------------------------------------------------------- state threading


@pytest.mark.parametrize("spec", ["RNN(3, 5) >> Linear(5, 2)", "LSTM(3, 4) >> Tanh() >> Linear(4, 2)"])
def test_policy_threads_state_like_jax(spec):
    """Ten steps of a batch of 6 policies, a partial reset after step 4 (by
    index array) and after step 7 (by mask), then a full reset; and the
    single-solution form over a batch of observations."""
    jax_net, net = jax_str_to_net(spec), str_to_net(spec)
    params, _ = _jax_population(jax_net, 6, seed=9)
    rng = np.random.default_rng(5)
    ours, theirs = Policy(net), JaxPolicy(jax_net)
    ours.set_parameters(torch.from_numpy(params))
    theirs.set_parameters(jnp.asarray(params))
    mask = np.array([True, False, False, True, True, False])
    for t in range(10):
        obs = rng.normal(size=(6, 3)).astype(np.float32)
        _close(ours(torch.from_numpy(obs)), theirs(jnp.asarray(obs)))
        if t == 4:
            ours.reset(torch.tensor([1, 3]))
            theirs.reset(jnp.asarray([1, 3]))
        if t == 7:
            ours.reset(torch.from_numpy(mask))
            theirs.reset(jnp.asarray(mask))
    jax.tree_util.tree_map(lambda a, b: _close(a, b), jax.tree_util.tree_map(np.asarray, theirs.h), vecrl.map_state(lambda t: t.numpy(), ours.h))
    ours.reset()
    assert ours.h is None

    single, jax_single = Policy(FlatParamsPolicy(net)), JaxPolicy(jax_net)
    single.set_parameters(torch.from_numpy(params[2]))
    jax_single.set_parameters(jnp.asarray(params[2]))
    for _ in range(3):
        obs = rng.normal(size=(4, 3)).astype(np.float32)
        _close(single(torch.from_numpy(obs)), jax_single(jnp.asarray(obs)))
    assert single.parameter_count == params.shape[1]
    with pytest.raises(RuntimeError):
        Policy(net)(torch.zeros(3))


def test_reset_tensors_zeroes_masked_rows():
    h, c = torch.ones(4, 3), torch.full((4, 3), 2.0)
    mask = torch.tensor([True, False, True, False])
    (h2, c2), other = reset_tensors(((h, c), None), mask)
    assert other is None
    assert torch.equal(h2[mask], torch.zeros(2, 3)) and torch.equal(h2[~mask], h[~mask])
    assert torch.equal(c2[mask], torch.zeros(2, 3)) and torch.equal(c2[~mask], c[~mask])


# ---------------------------------------------------------- rollouts vs JAX

CARTPOLE_N, PENDULUM_N, STEPS = 24, 12, 40


def _item_keys(key, num_items):
    """The JAX engine's ``(chain, reset)`` keys of items ``0..num_items-1``:
    ``split(fold_in(key, item))``."""
    pairs = jax.vmap(lambda j: jax.random.split(jax.random.fold_in(key, j), 2))(jnp.arange(num_items, dtype=jnp.int32))
    return pairs[:, 0], pairs[:, 1]


def _reset_rows(env_name, key, num_items):
    """CartPole: ``uniform(split(key)[1], (4,))``; Pendulum: two successive
    splits, one uniform each."""
    keys = _item_keys(key, num_items)[1]
    if env_name == "cartpole":
        return np.array(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (4,)))(keys))

    def draws(k):
        k, sub1 = jax.random.split(k)
        _, sub2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(sub1, ()), jax.random.uniform(sub2, ())])

    return np.array(jax.vmap(draws)(keys))


def _case(env_name, cell):
    """Both envs, both policies (a recurrent cell feeding a Linear) and a
    population drawn with numpy."""
    if env_name == "cartpole":
        jax_env, env, n, obs, scale = JaxCartPole(continuous_actions=True), CartPole(continuous_actions=True, device="cpu"), CARTPOLE_N, 4, 1.0
    else:
        jax_env, env, n, obs, scale = JaxPendulum(), Pendulum(device="cpu"), PENDULUM_N, 3, 0.5
    spec = f"{cell}(obs_length, 6) >> Linear(6, act_length)"
    jax_policy = JaxFlatParamsPolicy(jax_str_to_net(spec, obs_length=obs, act_length=1))
    policy = FlatParamsPolicy(str_to_net(spec, obs_length=obs, act_length=1))
    rng = np.random.default_rng(len(env_name) + len(cell))
    params = (scale * rng.normal(size=(n, policy.parameter_count))).astype(np.float32)
    return jax_env, jax_policy, env, policy, params


def _assert_scores(env_name, ours, theirs):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert np.all(np.isfinite(ours))
    if env_name == "cartpole":
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(rankdata(ours), rankdata(theirs))
    else:
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=0)


def _jax_contract(jax_env, jax_policy, params, key, mode, **kw):
    stats = JaxRunningNorm(jax_env.observation_size).stats
    if mode == "episodes_compact":
        return jax_compacting(jax_env, jax_policy, jnp.asarray(params), key, stats, chunk_size=7, allowed_widths=(4, 8), **kw)
    extra = dict(refill_width=5) if mode == "episodes_refill" else {}
    return jax_rollout(jax_env, jax_policy, jnp.asarray(params), key, stats, eval_mode=mode, **extra, **kw)


def _port_contract(env, policy, params, mode, generator=None, **kw):
    generator = torch.Generator() if generator is None else generator
    if mode == "episodes_compact":
        return run_vectorized_rollout_compacting(
            env, policy, torch.from_numpy(params), generator, None, chunk_size=7, allowed_widths=(4, 8), **kw
        )
    extra = dict(refill_width=5) if mode == "episodes_refill" else {}
    return run_vectorized_rollout(env, policy, torch.from_numpy(params), generator, None, eval_mode=mode, **extra, **kw)


ROLLOUT_CASES = [
    (env_name, cell, mode, episodes)
    for env_name in ("cartpole", "pendulum")
    for cell in ("RNN", "LSTM")
    for mode, episodes in (("episodes", 1), ("episodes_refill", 1), ("episodes_compact", 1), ("episodes_refill", 2))
]


@pytest.mark.parametrize("env_name,cell,mode,episodes", ROLLOUT_CASES)
def test_recurrent_rollout_matches_jax(env_name, cell, mode, episodes):
    """Scores and counters against the JAX engine with its reset draws
    injected (two episodes: against the JAX refill engine, whose item
    seeding the port's every contract shares); the port's three episodes
    contracts equal bit for bit on the same rows."""
    jax_env, jax_policy, env, policy, params = _case(env_name, cell)
    n = params.shape[0]
    key = jax.random.key(17)
    kw = dict(num_episodes=episodes, episode_length=STEPS)
    theirs = _jax_contract(jax_env, jax_policy, params, key, mode, **kw)
    rows = torch.from_numpy(_reset_rows(env_name, key, n * episodes))
    ours = _port_contract(env, policy, params, mode, reset_noise=rows, **kw)
    _assert_scores(env_name, ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps)
    assert int(ours.total_episodes) == int(theirs.total_episodes) == n * episodes
    plain = _port_contract(env, policy, params, "episodes", reset_noise=rows, **kw)
    assert torch.equal(ours.scores, plain.scores) and ours.total_steps == plain.total_steps


def test_recurrent_contracts_agree_bit_for_bit_at_every_width():
    """The port's own draws (one seeded generator per run): ``episodes``,
    refill at 3 and 16 lanes and compaction agree bit for bit, at one and
    three episodes per solution, with an LSTM whose restarted lanes return
    to the initial state."""
    _, _, env, policy, params = _case("cartpole", "LSTM")
    for episodes in (1, 3):
        kw = dict(num_episodes=episodes, episode_length=STEPS)
        runs = [
            run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(3), None, **kw),
            run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(3), None,
                                   eval_mode="episodes_refill", refill_width=3, **kw),  # fmt: skip
            run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(3), None,
                                   eval_mode="episodes_refill", refill_width=16, **kw),  # fmt: skip
            run_vectorized_rollout_compacting(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(3), None,
                                              chunk_size=4, allowed_widths=(2, 4, 8), **kw),  # fmt: skip
        ]
        for run in runs[1:]:
            assert torch.equal(run.scores, runs[0].scores) and run.total_steps == runs[0].total_steps


def test_budget_recurrent_matches_jax_without_restarts():
    """``budget`` over one episode that no lane ends early (Pendulum runs to
    its time limit): the port's resets drawn from the JAX budget engine's
    per-lane keys, so the same trajectories; a lane's state is zeroed when
    its episode ends."""
    jax_env, jax_policy, env, policy, params = _case("pendulum", "LSTM")
    n = params.shape[0]
    key = jax.random.key(23)
    theirs = _jax_contract(jax_env, jax_policy, params, key, "budget", num_episodes=1, episode_length=STEPS)
    # the budget engine's initial reset keys: split(fold_in(key, i))[1]
    rows = torch.from_numpy(_reset_rows("pendulum", key, n))
    state, obs = env.batch_reset_from(rows)
    carry = vecrl._budget_init(env, policy, torch.from_numpy(params), torch.Generator(), None, vecrl._Options())
    carry = dataclasses.replace(carry, env_states=state, obs=obs)
    step = vecrl._make_budget_step(env, policy, torch.from_numpy(params), torch.Generator(), max_t=STEPS, options=vecrl._Options())
    for _ in range(STEPS):
        carry = step(carry)
    _assert_scores("pendulum", carry.scores, theirs.scores)
    # every lane ended its episode on the last step: its state was zeroed
    assert all(bool((leaf == 0).all()) for leaf in carry.policy_states[0])


def test_bf16_recurrent_state():
    """``compute_dtype=bfloat16``: the LSTM state is carried in bf16, and
    the CartPole scores track the JAX package's bf16 run (see the module
    note for the tolerance)."""
    jax_env, jax_policy, env, policy, params = _case("cartpole", "LSTM")
    n = params.shape[0]
    options = vecrl._make_options(False, None, None, torch.bfloat16, None)
    table = env.reset_noise(n, torch.Generator().manual_seed(0))
    carry = vecrl._episodes_init(env, policy, vecrl._params_cast(torch.from_numpy(params), options), table, None, options)
    step = vecrl._make_episodes_step(env, policy, table, None, popsize=n, num_episodes=1, max_t=STEPS, options=options)
    carry = step(step(carry))
    h, c = carry.policy_states[0]
    assert h.dtype == c.dtype == torch.bfloat16 and h.shape == (n, 6)

    key = jax.random.key(29)
    kw = dict(num_episodes=1, episode_length=STEPS)
    theirs = _jax_contract(jax_env, jax_policy, params, key, "episodes", compute_dtype=jnp.bfloat16, **kw)
    rows = torch.from_numpy(_reset_rows("cartpole", key, n))
    ours = _port_contract(env, policy, params, "episodes", reset_noise=rows, compute_dtype=torch.bfloat16, **kw)
    assert ours.scores.dtype == torch.float32 and bool(torch.isfinite(ours.scores).all())
    close = np.abs(ours.scores.numpy() - np.asarray(theirs.scores)) <= 2
    assert close.mean() >= 0.9, (ours.scores, theirs.scores)
