"""The port's ``VecNE`` (and ``NEProblem``, ``str_to_net``, the policy
layers, ``RunningNorm`` and ``compute_dtype``) against the JAX package's on
the CPU.

``VecNE.evaluate`` runs under each of the four contracts, with observation
normalization off and on, for two generations on each side; the JAX
problem's next rollout key is derived from its key chain and the JAX
engine's reset draws for it are injected into the port as ``reset_noise=``
(``budget`` draws resets every step, so it runs the Humanoid with
noise-free resets). With normalization on, both sides start from the same
made-up statistics of 50 observations: from none, the first update sees
near-identical reset observations, the stdev hits its floor and
normalization multiplies round-off by up to 1e4.

Tolerances:
- Counters (``total_interaction_count``, ``total_episode_count``) and the
  telemetry's integer status keys: exact.
- Scores: CartPole ``atol=1e-4`` (whole episode lengths); Humanoid
  ``rtol=1e-4``: a gentle population (center and stdev 0.01) over 10
  steps, where the two engines' round-off (XLA contracts ``a * b + c``
  into FMAs on the CPU) grows through the foot contacts to ~3e-5 of the
  returns (~48).
  ``eval_score_mean`` (rounded to 6 decimals): ``atol=1e-4``;
  ``eval_score_std``: ``rtol=1e-3``, since it comes from float32 sums of
  the scores and of their squares (~8e4 at the Humanoid), whose
  difference cancels most of their digits.
- Observation statistics: the count exactly; the sums to ``rtol=1e-5,
  atol=1e-4`` at CartPole (float32 sums taken in another order), and at
  the Humanoid (370 observations, sums up to ~1.3e3) to ``rtol=1e-3,
  atol=1e-2``: a few contact-driven components (velocities) carry the
  round-off above, grown to ~3e-4 of their sums.
- ``compute_dtype=bfloat16``: the policy forward to ``atol=2e-2`` (outputs
  in [-1, 1]; bf16 keeps 8 bits of mantissa, and the two libraries round
  the matmul's and the bias add's results at different points), and a
  10-step budget rollout's scores (~50) to ``atol=0.05``.
- ``str_to_net``: parameter counts and layouts exactly; forwards to
  ``rtol=1e-5, atol=1e-6``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
from evotorch_tpu.envs import CartPole as JaxCartPole
from evotorch_tpu.envs import Humanoid as JaxHumanoid
from evotorch_tpu.neuroevolution import NEProblem as JaxNEProblem
from evotorch_tpu.neuroevolution import VecNE as JaxVecNE
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import str_to_net as jax_str_to_net
from evotorch_tpu.neuroevolution.net.rl import ObsNormLayer as JaxObsNormLayer
from evotorch_tpu.neuroevolution.net.runningnorm import CollectedStats as JaxCollectedStats
from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm as JaxRunningNorm
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.core import SolutionBatch
from evotorch_tpu_torch.envs import CartPole, Humanoid
from evotorch_tpu_torch.neuroevolution import NEProblem, VecNE
from evotorch_tpu_torch.neuroevolution.net import (
    FlatParamsPolicy,
    FrozenModule,
    NetParsingError,
    ObsNormLayer,
    RunningNorm,
    str_to_net,
)

EXAMPLE_NET = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
SMALL_NET = "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)"
CONTRACT_KW = {
    "episodes": {},
    "episodes_refill": dict(refill_config={"width": 8}),
    "episodes_compact": dict(compact_config={"chunk_size": 5, "allowed_widths": (4, 8, 16)}),
    "budget": {},
}


# ---------------------------------------------------------------- helpers


def _next_key(jax_problem):
    """The key the JAX problem's next ``next_rng_key()`` returns."""
    return jax.random.split(jax_problem._rng_key)[1]


def _item_reset_keys(key, num_items):
    return jax.vmap(lambda j: jax.random.split(jax.random.fold_in(key, j), 2)[1])(jnp.arange(num_items, dtype=jnp.int32))


def _cartpole_rows(key, num_items):
    subs = jax.vmap(lambda k: jax.random.split(k)[1])(_item_reset_keys(key, num_items))
    return np.array(jax.vmap(lambda s: jax.random.uniform(s, (4,)))(subs))


def _humanoid_rows(key, num_items, nb):
    def draws(k):
        parts = jax.random.split(k, 3)
        return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

    return np.array(jax.vmap(draws)(_item_reset_keys(key, num_items)))


def _prior_stats(n, seed=6):
    rng = np.random.default_rng(seed)
    return {
        "count": np.float32(50.0),
        "sum": rng.normal(size=n).astype(np.float32),
        "sum_of_squares": (50.0 + rng.random(n)).astype(np.float32),
    }


def _setup(env_name, eval_mode, obs_norm, *, n, episode_length, compute_dtype=None):
    if env_name == "cartpole":
        jax_env, env = JaxCartPole(continuous_actions=True), CartPole(continuous_actions=True, device="cpu")
        net = "Linear(obs_length, act_length) >> Tanh()"
    else:
        scale = 0.0 if eval_mode == "budget" else 0.01
        jax_env, env = JaxHumanoid(reset_noise_scale=scale), Humanoid(reset_noise_scale=scale, device="cpu")
        net = SMALL_NET
    kw = dict(observation_normalization=obs_norm, episode_length=episode_length, eval_mode=eval_mode, **CONTRACT_KW[eval_mode])
    jax_problem = JaxVecNE(jax_env, net, compute_dtype=None if compute_dtype is None else jnp.bfloat16, seed=1, **kw)
    port_problem = VecNE(env, net, compute_dtype=compute_dtype, device="cpu", **kw)
    if obs_norm:
        prior = _prior_stats(env.observation_size)
        jax_problem._obs_norm.stats = JaxCollectedStats(**{k: jnp.asarray(v) for k, v in prior.items()})
        port_problem.obs_norm.stats = interop.stats_from_numpy(prior, device="cpu")
    return jax_problem, port_problem


def _population(env_name, length, n, seed):
    rng = np.random.default_rng(seed)
    if env_name == "cartpole":
        return rng.normal(size=(n, length)).astype(np.float32)
    center = 0.01 * rng.normal(size=length)
    return (center + 0.01 * rng.normal(size=(n, length))).astype(np.float32)


def _evaluate_both(env_name, jax_problem, port_problem, values, eval_mode):
    n = values.shape[0]
    key = _next_key(jax_problem)
    jb = JaxSolutionBatch(jax_problem, n, values=values)
    pb = SolutionBatch(port_problem, n, values=torch.from_numpy(values))
    jax_problem.evaluate(jb)
    if eval_mode == "budget":
        port_problem.evaluate(pb)
    else:
        if env_name == "cartpole":
            rows = _cartpole_rows(key, n)
        else:
            rows = _humanoid_rows(key, n, port_problem.env.sys.num_bodies)
        port_problem.evaluate(pb, reset_noise=torch.from_numpy(rows))
    return jb, pb


def _assert_status_equal(port_problem, jax_problem):
    port_status, jax_status = dict(port_problem.status.items()), dict(jax_problem.status.items())
    for key in ("total_interaction_count", "total_episode_count"):
        assert int(port_status[key]) == int(jax_status[key]), key
    eval_keys = sorted(k for k in jax_status if k.startswith("eval_"))
    assert eval_keys and eval_keys == sorted(k for k in port_status if k.startswith("eval_"))
    for key in eval_keys:
        if isinstance(jax_status[key], (int, np.integer)):
            assert port_status[key] == jax_status[key], key
        elif key == "eval_score_std":
            assert port_status[key] == pytest.approx(float(jax_status[key]), rel=1e-3), key
        else:
            assert port_status[key] == pytest.approx(float(jax_status[key]), abs=1e-4), key


def _assert_stats_close(port_problem, jax_problem, **tol):
    ours, theirs = port_problem.obs_norm.stats, jax_problem.obs_norm.stats
    assert float(ours.count) == float(theirs.count)
    for name in ("sum", "sum_of_squares"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)), **tol)


# ------------------------------------------------------------ VecNE against JAX

VECNE_CASES = [
    (env_name, eval_mode, obs_norm)
    for env_name in ("cartpole", "humanoid")
    for eval_mode in ("episodes", "episodes_refill", "episodes_compact", "budget")
    for obs_norm in (False, True)
    if not (env_name == "cartpole" and eval_mode == "budget")
]


@pytest.mark.parametrize("env_name,eval_mode,obs_norm", VECNE_CASES)
def test_vecne_evaluate_matches_jax(env_name, eval_mode, obs_norm):
    """Two generations: scores, counters, the decoded ``eval_*`` keys (one
    generation behind, so the second generation shows the first's) and the
    observation statistics."""
    n, steps, tol = (24, 60, dict(rtol=0, atol=1e-4)) if env_name == "cartpole" else (16, 10, dict(rtol=1e-4, atol=0))
    jax_problem, port_problem = _setup(env_name, eval_mode, obs_norm, n=n, episode_length=steps)
    assert port_problem.solution_length == jax_problem.solution_length
    for generation in range(2):
        values = _population(env_name, port_problem.solution_length, n, seed=generation)
        jb, pb = _evaluate_both(env_name, jax_problem, port_problem, values, eval_mode)
        np.testing.assert_allclose(pb.evals.numpy(), np.asarray(jb.evals), **tol)
    _assert_status_equal(port_problem, jax_problem)
    if obs_norm:
        stats_tol = dict(rtol=1e-5, atol=1e-4) if env_name == "cartpole" else dict(rtol=1e-3, atol=1e-2)
        _assert_stats_close(port_problem, jax_problem, **stats_tol)
    assert port_problem.status["best_eval"] == pytest.approx(jax_problem.status["best_eval"], rel=1e-4, abs=1e-4)


def test_two_episodes_and_max_num_envs():
    """Two episodes per solution under ``episodes_refill`` (the JAX refill
    engine seeds items as the port does), and ``max_num_envs`` splitting
    within the port: the pieces, each given its items' rows, score like the
    whole population."""
    n = 20
    jax_problem = JaxVecNE(JaxCartPole(continuous_actions=True), "Linear(obs_length, act_length)", num_episodes=2,
                           episode_length=50, eval_mode="episodes_refill", refill_config={"width": 6}, seed=2)  # fmt: skip
    kw = dict(num_episodes=2, episode_length=50, device="cpu")
    port_problem = VecNE(CartPole(continuous_actions=True, device="cpu"), "Linear(obs_length, act_length)",
                         eval_mode="episodes_refill", refill_config={"width": 6}, **kw)  # fmt: skip
    values = _population("cartpole", port_problem.solution_length, n, seed=4)
    key = _next_key(jax_problem)
    jb = JaxSolutionBatch(jax_problem, n, values=values)
    jax_problem.evaluate(jb)
    rows = torch.from_numpy(_cartpole_rows(key, 2 * n))
    pb = SolutionBatch(port_problem, n, values=torch.from_numpy(values))
    port_problem.evaluate(pb, reset_noise=rows)
    np.testing.assert_allclose(pb.evals.numpy(), np.asarray(jb.evals), rtol=0, atol=1e-4)
    split = VecNE(CartPole(continuous_actions=True, device="cpu"), "Linear(obs_length, act_length)", max_num_envs=7, **kw)
    sb = SolutionBatch(split, n, values=torch.from_numpy(values))
    split.evaluate(sb, reset_noise=rows)
    assert torch.equal(sb.evals, pb.evals)
    assert int(split.status["total_episode_count"]) == 2 * n


def test_bf16_forward_and_rollout_match_jax():
    """``compute_dtype=bfloat16``: the example network's forward on one
    population, and a 10-step budget rollout of VecNE on the noise-free
    Humanoid (see the module note for the tolerances)."""
    policy = FlatParamsPolicy(str_to_net(EXAMPLE_NET, obs_length=109, act_length=17))
    jax_policy = JaxFlatParamsPolicy(jax_str_to_net(EXAMPLE_NET, obs_length=109, act_length=17))
    rng = np.random.default_rng(12)
    params = (0.1 * rng.normal(size=(6, policy.parameter_count))).astype(np.float32)
    obs = rng.normal(size=(6, 109)).astype(np.float32)
    ours = policy(torch.from_numpy(params).bfloat16(), torch.from_numpy(obs).bfloat16())[0].float().numpy()
    theirs = jax.vmap(lambda p, x: jax_policy(p, x)[0])(
        jnp.asarray(params).astype(jnp.bfloat16), jnp.asarray(obs).astype(jnp.bfloat16)
    ).astype(jnp.float32)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=2e-2)
    f32 = policy(torch.from_numpy(params), torch.from_numpy(obs))[0].numpy()
    assert np.abs(ours - f32).max() > 0  # the forward did run in bf16

    jax_problem, port_problem = _setup("humanoid", "budget", False, n=8, episode_length=10, compute_dtype=torch.bfloat16)
    values = _population("humanoid", port_problem.solution_length, 8, seed=3)
    jb, pb = _evaluate_both("humanoid", jax_problem, port_problem, values, "budget")
    np.testing.assert_allclose(pb.evals.numpy(), np.asarray(jb.evals), rtol=0, atol=0.05)
    assert int(port_problem.status["total_interaction_count"]) == 80


# -------------------------------------------------- network strings and layers

NETS = [
    EXAMPLE_NET,
    "Linear(obs_length, 16) >> ReLU() >> Linear(16, act_length) >> Clip(-0.5, 0.5)",
    "Bias(obs_length) >> Linear(obs_length, 2 * 4, bias=False) >> Sigmoid() >> Linear(8, act_length) >> Softmax()",
    "Linear(obs_length, 6) >> Round(1) >> Slice(1, 4) >> Linear(3, act_length) >> Bin(-1, 1)",
    "Linear(obs_length, 5) >> Tanh() >> Linear(5, act_length, bias=False)",
]


@pytest.mark.parametrize("spec", NETS)
def test_str_to_net_matches_jax(spec):
    constants = dict(obs_length=11, act_length=3)
    net, jax_net = str_to_net(spec, **constants), jax_str_to_net(spec, **constants)
    policy, jax_policy = FlatParamsPolicy(net), JaxFlatParamsPolicy(jax_net)
    assert policy.parameter_count == jax_policy.parameter_count
    leaves = jax.tree_util.tree_leaves(jax_net.init(jax.random.key(0)))
    assert [shape for _, shape, _ in policy.layout] == [tuple(x.shape) for x in leaves]
    rng = np.random.default_rng(13)
    params = rng.normal(size=(5, policy.parameter_count)).astype(np.float32)
    obs = rng.normal(size=(5, 11)).astype(np.float32)
    ours = policy(torch.from_numpy(params), torch.from_numpy(obs))[0].numpy()
    theirs = np.asarray(jax.vmap(lambda p, x: jax_policy(p, x)[0])(params, obs))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def test_str_to_net_refuses_unknown_and_unported_layers():
    # every layer of the JAX DSL is ported now: the recurrent cells parse
    # (tests/test_torch_recurrent.py holds them against the JAX package)
    assert str_to_net("LSTM(obs_length, 8)", obs_length=3).is_stateful
    assert str_to_net("Linear(3, 4) >> RNN(4, 4)").is_stateful
    with pytest.raises(NetParsingError):
        str_to_net("Linear(3, 4) >> Nonsense()")
    with pytest.raises(NetParsingError):
        str_to_net("__import__('os')")
    with pytest.raises(NetParsingError):
        str_to_net("Linear(unknown_name, 4)")


def test_running_norm_and_obs_norm_layer_match_jax():
    """``RunningNorm`` updates (masked too), merges, normalizes with a clip
    and freezes into an ``ObsNormLayer``; tolerance ``rtol=1e-5``."""
    rng = np.random.default_rng(14)
    batches = [rng.normal(2.0, 3.0, size=(7, 5)).astype(np.float32) for _ in range(3)]
    mask = np.array([True, False, True, True, False, True, True])
    ours, theirs = RunningNorm(5, device="cpu", clip=(-2.0, 2.0)), JaxRunningNorm(5, clip=(-2.0, 2.0))
    for i, b in enumerate(batches):
        m = mask if i == 1 else None
        ours.update(torch.from_numpy(b), None if m is None else torch.from_numpy(m))
        theirs.update(jnp.asarray(b), None if m is None else jnp.asarray(m))
    other, jax_other = RunningNorm(5, device="cpu"), JaxRunningNorm(5)
    other.update(torch.from_numpy(batches[0]))
    jax_other.update(jnp.asarray(batches[0]))
    ours.update(other)
    theirs.update(jax_other)
    assert ours.count == theirs.count == 26
    x = rng.normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(ours.normalize(torch.from_numpy(x)).numpy(), np.asarray(theirs.normalize(x)), rtol=1e-5)
    layer, jax_layer = ours.to_layer(), theirs.to_layer()
    assert isinstance(layer, ObsNormLayer) and isinstance(jax_layer, JaxObsNormLayer)
    np.testing.assert_allclose(layer([], torch.from_numpy(x))[0].numpy(), np.asarray(jax_layer.apply((), x)[0]), rtol=1e-5)
    ours.reset()
    assert ours.count == 0


def test_policy_exports_and_save_solution(tmp_path):
    """``to_policy`` / ``to_policy_callable`` carry the solution's weights,
    the frozen normalization and the action clipping, as JAX's do;
    ``save_solution`` reads back. Tolerance ``rtol=1e-5, atol=1e-6``."""
    jax_problem, port_problem = _setup("humanoid", "episodes", True, n=8, episode_length=5)
    values = _population("humanoid", port_problem.solution_length, 8, seed=5) * 50
    _evaluate_both("humanoid", jax_problem, port_problem, values, "episodes")
    # the same statistics on both sides (the wide population's trajectories
    # part by round-off): the exports are held, not the rollout
    jax_stats = jax_problem.obs_norm.stats
    port_problem.obs_norm.stats = interop.stats_from_numpy(
        {k: np.asarray(getattr(jax_stats, k)) for k in ("count", "sum", "sum_of_squares")}, device="cpu"
    )
    obs = np.random.default_rng(15).normal(size=(3, 109)).astype(np.float32)
    ours, state = port_problem.to_policy(torch.from_numpy(values[2]))([], torch.from_numpy(obs))
    ours = ours.numpy()
    assert state is None
    jax_policy = jax_problem.to_policy(values[2])
    theirs = np.asarray(jax.vmap(lambda x: jax_policy(jax_policy.init(jax.random.key(0)), x)[0])(obs))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    # the JAX calling contract: apply(x, state=None) -> (actions, state);
    # with two observations the old apply(x) -> actions unpacked the rows
    apply = port_problem.to_policy_callable(torch.from_numpy(values[2]))
    actions, policy_state = apply(torch.from_numpy(obs[:2]))
    assert actions.shape == (2, 17) and policy_state is None
    np.testing.assert_allclose(actions.numpy(), theirs[:2], rtol=1e-5, atol=1e-6)
    actions, policy_state = apply(torch.from_numpy(obs), state=None)
    np.testing.assert_allclose(actions.numpy(), theirs, rtol=1e-5, atol=1e-6)
    jax_actions, jax_state = jax_problem.to_policy_callable(values[2])(obs[0])
    assert jax_state is None and policy_state is None
    np.testing.assert_allclose(actions[0].numpy(), np.asarray(jax_actions), rtol=1e-5, atol=1e-6)
    path = tmp_path / "solution.pkl"
    port_problem.save_solution(torch.from_numpy(values[2]), str(path))
    saved = pickle.loads(path.read_bytes())
    np.testing.assert_array_equal(saved["values"], values[2])
    np.testing.assert_allclose(saved["obs_mean"], port_problem.obs_norm.mean.numpy())
    assert saved["network_spec"] == SMALL_NET
    module, leaves = port_problem.make_net(torch.from_numpy(values[2]))
    frozen = FrozenModule(module, leaves)
    assert frozen.param_shapes() == [] and len(frozen.wrapped_params) == 4


def test_interop_carries_obs_stats_into_a_searcher():
    from evotorch_tpu_torch.algorithms import PGPE

    _, problem = _setup("cartpole", "episodes", True, n=4, episode_length=5)
    searcher = PGPE(problem, popsize=4, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1)
    prior = _prior_stats(4, seed=9)
    interop.load_searcher_state(searcher, {f"obs_norm.{k}": v for k, v in prior.items()})
    state = interop.searcher_state_to_numpy(searcher)
    for k, v in prior.items():
        np.testing.assert_array_equal(state[f"obs_norm.{k}"], v)


def test_neproblem_vectorized_network_eval_matches_jax():
    """``NEProblem`` with a network evaluation function: the port's takes
    the whole population, the JAX one (vmapped) one network."""
    x = np.random.default_rng(16).normal(size=(4, 3)).astype(np.float32)
    jax_problem = JaxNEProblem("max", "Linear(3, 2) >> Tanh()", lambda policy, flat: jnp.sum(jax.vmap(lambda o: policy(flat, o)[0])(x)))
    port_problem = NEProblem(
        "max",
        "Linear(3, 2) >> Tanh()",
        lambda policy, values: torch.stack([policy(row.expand(4, -1), torch.from_numpy(x))[0].sum() for row in values]),
        device="cpu",
    )
    values = np.random.default_rng(17).normal(size=(5, port_problem.solution_length)).astype(np.float32)
    jb = JaxSolutionBatch(jax_problem, 5, values=values)
    pb = SolutionBatch(port_problem, 5, values=torch.from_numpy(values))
    jax_problem.evaluate(jb)
    port_problem.evaluate(pb)
    np.testing.assert_allclose(pb.evals.numpy(), np.asarray(jb.evals), rtol=1e-5, atol=1e-6)
    net = port_problem.parameterize_net(torch.from_numpy(values[0]))
    np.testing.assert_allclose(net(torch.from_numpy(x))[0].numpy(), np.asarray(jax.vmap(lambda o: jax_problem.parameterize_net(values[0])(o)[0])(x)), rtol=1e-5, atol=1e-6)


def test_vecne_unported_options_raise(monkeypatch):
    env = CartPole(device="cpu")
    net = "Linear(obs_length, act_length)"
    # action_noise_stdev is ported (tests/test_torch_action_noise.py)
    VecNE(env, net, device="cpu", action_noise_stdev=0.1)
    # num_actors and obs_norm_sync="step" are ported (multi-GPU;
    # tests/test_torch_distributed_oo.py holds them against the JAX package)
    VecNE(env, net, device="cpu", num_actors=2, obs_norm_sync="step")
    for option, item in (
        (dict(solution_groups=[0, 1]), "A.12"),
        (dict(slo=[]), "A.12"),
        (dict(eval_backend=object()), "A.12"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            VecNE(env, net, device="cpu", **option)
    # make_training_span is ported (tests/test_torch_span.py): it builds
    problem = VecNE(env, net, device="cpu")
    assert callable(problem.make_training_span(ask=None, tell=None, popsize=4, span=2))
    with pytest.raises(ValueError, match="compact_config"):
        VecNE(env, net, device="cpu", compact_config={"prewarm": True})
    with pytest.raises(ValueError, match="eval_mode"):
        VecNE(env, net, device="cpu", eval_mode="fast")
    monkeypatch.setenv("EVOTORCH_FAULTS", "eval.scores:nonfinite@1")
    with pytest.raises(NotImplementedError, match="A.13"):
        VecNE(env, net, device="cpu")
    monkeypatch.delenv("EVOTORCH_FAULTS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VecNE("cartpole", net)
