"""The port's action noise (``action_noise_stdev``) against the JAX
package's, on the CPU, with recurrent policies: the functional contracts,
``VecNE`` and the policy exports.

The JAX engine draws lane ``i``'s noise from its own key chain: the chain
starts at ``split(fold_in(key, i))[0]`` (item ``e * N + s`` in the refill
engine), each step splits it in three, and the noise is ``stdev *
normal(part 1, (act,))``. The tests replay that chain for every item and
step of its episode and inject the result as the port's ``action_noise=``
table (``(items, max_t, act)``), with the reset draws as ``reset_noise=``
(derived as in ``tests/test_torch_contracts.py``). At two episodes per
solution the JAX ``episodes`` engine runs one chain per lane across its
episodes, so the port is held against the JAX refill engine there, whose
item chains the port's tables index.

Tolerances:
- Against JAX: CartPole ``atol=1e-4`` with equal ranks (scores are episode
  lengths); Pendulum ``rtol=1e-4`` (see ``tests/test_torch_recurrent.py``).
  The injected noise equals JAX's bit for bit.
- Within the port: every episodes contract equal to ``episodes`` bit for
  bit, under the port's own noise.
- The port's own draws: 60,000 noise values per check; their mean within
  5 standard errors of 0 and their stdev within 2% of ``action_noise_stdev``
  (the stdev's standard error is 0.3% at this count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu.envs import CartPole as JaxCartPole
from evotorch_tpu.neuroevolution import VecNE as JaxVecNE
from evotorch_tpu_torch.core import SolutionBatch
from evotorch_tpu_torch.envs import CartPole, Pendulum
from evotorch_tpu_torch.envs.base import EnvState, Space
from evotorch_tpu_torch.envs.classic import _ClassicEnv
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, run_vectorized_rollout, str_to_net
from evotorch_tpu_torch.parallel import make_generation_step
from test_torch_recurrent import STEPS, _assert_scores, _case, _item_keys, _jax_contract, _port_contract, _reset_rows

STDEV = {"cartpole": 0.2, "pendulum": 0.3}


def _jax_noise(key, num_items, max_t, act, stdev):
    """The JAX engine's noise of every item and step of its episode,
    ``(items, max_t, act)``, replayed from the item chains."""

    def item(chain):
        def body(k, _):
            triple = jax.random.split(k, 3)
            return triple[0], stdev * jax.random.normal(triple[1], (act,))

        return jax.lax.scan(body, chain, None, length=max_t)[1]

    return np.array(jax.vmap(item)(_item_keys(key, num_items)[0]))


# ---------------------------------------------------------- against JAX

NOISE_CASES = [
    (env_name, cell, mode, episodes)
    for env_name, cell in (("pendulum", "RNN"), ("cartpole", "LSTM"))
    for mode, episodes in (("episodes", 1), ("episodes_refill", 1), ("episodes_compact", 1), ("episodes_refill", 2))
]


@pytest.mark.parametrize("env_name,cell,mode,episodes", NOISE_CASES)
def test_noisy_rollout_matches_jax(env_name, cell, mode, episodes):
    """A recurrent policy with action noise under each episodes contract,
    JAX's reset and noise draws injected; the port's ``episodes`` contract
    on the same tables scores the same bit for bit."""
    jax_env, jax_policy, env, policy, params = _case(env_name, cell)
    n, stdev = params.shape[0], STDEV[env_name]
    key = jax.random.key(31)
    kw = dict(num_episodes=episodes, episode_length=STEPS)
    theirs = _jax_contract(jax_env, jax_policy, params, key, mode, action_noise_stdev=stdev, **kw)
    tables = dict(
        reset_noise=torch.from_numpy(_reset_rows(env_name, key, n * episodes)),
        action_noise=torch.from_numpy(_jax_noise(key, n * episodes, STEPS, 1, stdev)),
    )
    ours = _port_contract(env, policy, params, mode, action_noise_stdev=stdev, **tables, **kw)
    _assert_scores(env_name, ours.scores, theirs.scores)
    assert ours.total_steps == int(theirs.total_steps)
    plain = _port_contract(env, policy, params, "episodes", action_noise_stdev=stdev, **tables, **kw)
    assert torch.equal(plain.scores, ours.scores)
    # the noise moved the scores
    quiet = _port_contract(env, policy, params, mode, reset_noise=tables["reset_noise"], **kw)
    assert not torch.equal(quiet.scores, ours.scores)


def test_vecne_lstm_with_noise_matches_jax():
    """``VecNE`` with an LSTM network string and ``action_noise_stdev``
    under ``episodes`` and ``episodes_refill``, given the JAX problem's
    tables (its next rollout key is ``split(problem._rng_key)[1]``); then
    ``max_num_envs`` splitting cuts both tables to each piece's items; then
    ``to_policy_callable``: the caller's ``(h, c)`` state, ``(B, hidden)``
    each, equal to JAX's, and fed back it moves the next action."""
    net = "LSTM(obs_length, 6) >> Linear(6, act_length)"
    n = 16
    for eval_mode, extra in (("episodes", {}), ("episodes_refill", dict(refill_config={"width": 6}))):
        kw = dict(episode_length=STEPS, eval_mode=eval_mode, action_noise_stdev=0.2, **extra)
        jax_problem = JaxVecNE(JaxCartPole(continuous_actions=True), net, seed=3, **kw)
        port_problem = VecNE(CartPole(continuous_actions=True, device="cpu"), net, device="cpu", **kw)
        values = np.random.default_rng(8).normal(size=(n, port_problem.solution_length)).astype(np.float32)
        key = jax.random.split(jax_problem._rng_key)[1]
        jb = JaxSolutionBatch(jax_problem, n, values=values)
        jax_problem.evaluate(jb)
        tables = dict(
            reset_noise=torch.from_numpy(_reset_rows("cartpole", key, n)),
            action_noise=torch.from_numpy(_jax_noise(key, n, STEPS, 1, 0.2)),
        )
        pb = SolutionBatch(port_problem, n, values=torch.from_numpy(values))
        port_problem.evaluate(pb, **tables)
        _assert_scores("cartpole", pb.evals[:, 0], np.asarray(jb.evals)[:, 0])
        assert int(port_problem.status["total_interaction_count"]) == int(jax_problem.status["total_interaction_count"])

    split = VecNE(CartPole(continuous_actions=True, device="cpu"), net, device="cpu", max_num_envs=5, **kw)
    sb = SolutionBatch(split, n, values=torch.from_numpy(values))
    split.evaluate(sb, **tables)
    assert torch.equal(sb.evals, pb.evals)

    # a gentle solution, whose actions stay inside the clip
    gentle = 0.1 * values[1]
    obs = np.random.default_rng(9).normal(size=(3, 4)).astype(np.float32)
    apply = port_problem.to_policy_callable(torch.from_numpy(gentle))
    jax_apply = jax_problem.to_policy_callable(gentle)
    actions, state = apply(torch.from_numpy(obs))
    jax_actions, jax_state = jax_apply(jnp.asarray(obs))
    h, c = state[0]
    assert h.shape == c.shape == (3, 6) and state[1] is None
    np.testing.assert_allclose(actions.numpy(), np.asarray(jax_actions), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jax_state[0][0]), rtol=1e-5, atol=1e-6)
    again, state2 = apply(torch.from_numpy(obs), state)
    jax_again, _ = jax_apply(jnp.asarray(obs), jax_state)
    np.testing.assert_allclose(again.numpy(), np.asarray(jax_again), rtol=1e-5, atol=1e-6)
    assert not torch.equal(again, actions) and not torch.equal(state2[0][0], h)
    module = port_problem.to_policy(torch.from_numpy(gentle))
    assert module.is_stateful
    out, module_state = module([], torch.from_numpy(obs))
    assert torch.equal(out, actions) and torch.equal(module_state[0][0][0], h)


# ------------------------------------------------------------- within the port


def test_noisy_contracts_agree_bit_for_bit():
    """The port's own reset and noise tables (one seeded generator per run):
    ``episodes``, refill at 3 and 16 lanes and compaction agree bit for bit
    with an LSTM, at one and two episodes per solution."""
    _, _, env, policy, params = _case("cartpole", "LSTM")
    for episodes in (1, 2):
        kw = dict(num_episodes=episodes, episode_length=STEPS, action_noise_stdev=0.2)
        runs = [
            _port_contract(env, policy, params, "episodes", torch.Generator().manual_seed(5), **kw),
            _port_contract(env, policy, params, "episodes_refill", torch.Generator().manual_seed(5), **kw),
            run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(5), None,
                                   eval_mode="episodes_refill", refill_width=16, **kw),  # fmt: skip
            _port_contract(env, policy, params, "episodes_compact", torch.Generator().manual_seed(5), **kw),
        ]
        for run in runs[1:]:
            assert torch.equal(run.scores, runs[0].scores) and run.total_steps == runs[0].total_steps


class _Recorder(_ClassicEnv):
    """An env with an unbounded 3-dim action space that records the actions
    it is given; observations are zeros and episodes never end early."""

    reset_width = 1
    max_episode_steps = 1000

    def __init__(self):
        self._setup("cpu")
        self.observation_space = Space(shape=(2,))
        self.action_space = Space(shape=(3,))
        self.actions = []

    def batch_reset_from(self, noise_rows):
        n = noise_rows.shape[0]
        return self._fresh(torch.zeros(n, 2)), torch.zeros(n, 2)

    def batch_step(self, state, actions):
        self.actions.append(actions.clone())
        n = actions.shape[0]
        return EnvState(obs_state=state.obs_state, t=state.t + 1), torch.zeros(n, 2), actions.sum(dim=1), torch.zeros(n, dtype=torch.bool)


@pytest.mark.parametrize("eval_mode", ["episodes", "budget"])
def test_port_noise_statistics(eval_mode):
    """With zero parameters the raw output is 0 and the env receives the
    noise itself: its mean and stdev (see the module note), and no two
    steps or lanes given the same draws."""
    env = _Recorder()
    policy = FlatParamsPolicy(Linear(2, 3))
    n, steps, stdev = 500, 40, 0.3
    run_vectorized_rollout(env, policy, torch.zeros(n, policy.parameter_count), torch.Generator().manual_seed(0), None,
                           eval_mode=eval_mode, episode_length=steps, action_noise_stdev=stdev)  # fmt: skip
    noise = torch.stack(env.actions[:steps]).double()
    assert noise.shape == (steps, n, 3)
    count = noise.numel()
    assert abs(float(noise.mean())) < 5 * stdev / np.sqrt(count)
    assert abs(float(noise.std()) / stdev - 1) < 0.02
    assert bool((noise[1:] != noise[:-1]).any(dim=-1).all()) and bool((noise[:, 1:] != noise[:, :-1]).any(dim=-1).all())


def test_noise_ignored_for_discrete_actions_and_checked():
    """A discrete action space takes no noise (argmax of the raw output);
    the tables are checked; ``make_generation_step`` passes the option on
    under ``budget``."""
    env = CartPole(device="cpu")
    policy = FlatParamsPolicy(str_to_net("LSTM(4, 5) >> Linear(5, 2)"))
    params = torch.from_numpy(np.random.default_rng(2).normal(size=(10, policy.parameter_count)).astype(np.float32))
    kw = dict(episode_length=STEPS)
    quiet = run_vectorized_rollout(env, policy, params, torch.Generator().manual_seed(1), None, **kw)
    noisy = run_vectorized_rollout(env, policy, params, torch.Generator().manual_seed(1), None, action_noise_stdev=5.0, **kw)
    assert torch.equal(quiet.scores, noisy.scores)

    env = Pendulum(device="cpu")
    policy = FlatParamsPolicy(str_to_net("RNN(3, 4) >> Linear(4, 1)"))
    params = torch.zeros(4, policy.parameter_count)
    with pytest.raises(ValueError, match="action_noise_stdev"):
        run_vectorized_rollout(env, policy, params, torch.Generator(), None, episode_length=5, action_noise=torch.zeros(4, 5, 1))
    with pytest.raises(ValueError, match=r"\(items, max_t, act\)"):
        run_vectorized_rollout(env, policy, params, torch.Generator(), None, episode_length=5, action_noise_stdev=0.1,
                               action_noise=torch.zeros(4, 6, 1))  # fmt: skip
    with pytest.raises(ValueError, match="budget"):
        run_vectorized_rollout(env, policy, params, None, None, eval_mode="budget", action_noise_stdev=0.1,
                               action_noise=torch.zeros(4, 5, 1))  # fmt: skip

    state = type("S", (), {})()
    generation = make_generation_step(
        env, policy, ask=lambda g, s: params, tell=lambda s, v, f: s, popsize=4, device="cpu", eval_mode="budget",
        episode_length=5, action_noise_stdev=0.5,
    )  # fmt: skip
    _, noisy_scores, *_ = generation(state, torch.Generator().manual_seed(0), None)
    quiet = make_generation_step(
        env, policy, ask=lambda g, s: params, tell=lambda s, v, f: s, popsize=4, device="cpu", eval_mode="budget",
        episode_length=5,
    )(state, torch.Generator().manual_seed(0), None)[1]  # fmt: skip
    assert bool(torch.isfinite(noisy_scores).all()) and not torch.equal(noisy_scores, quiet)
