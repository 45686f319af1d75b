"""The port's shared-trunk populations (``TrunkDeltaParamsBatch``) against
the JAX package's, on the CPU: ``sample_trunk_delta_factors`` and
``pgpe_ask_trunk_delta`` given the JAX sampler's draws, the trunk-delta
forward, its lane-blocked form, rollouts under the three contracts of
``make_generation_step`` and compaction, and ``pgpe_tell_trunk_delta``.

The JAX ask splits its key in two (factors, coefficients); leaf ``j``'s
``a`` comes from ``fold_in(key_factors, 2 j)`` and its ``b`` from
``fold_in(key_factors, 2 j + 1)``, and the coefficients from
``split(key_coefficients)[1]``. The tests patch the port's private draw
steps with those draws.

Tolerances:
- Factors and the materialized basis given JAX's draws: exact (products of
  the same float32 numbers; the stdev is uniform, so the block RMS is
  exact).
- Forwards (port against its dense forward and against JAX's trunk-delta
  forward): ``rtol=1e-5, atol=1e-6``.
- Blocked against unblocked: ``rtol=1e-6, atol=1e-6``. Not bit for bit: a
  product over fewer rows may round differently (the JAX package's own
  bit-identity test fails on the CPU by 2.4e-7).
- Tells: against JAX's ``rtol=1e-5, atol=1e-6``; against the dense tell of
  the materialized population ``rtol=1e-4, atol=1e-6`` (see
  ``tests/test_torch_lowrank.py``).
- Rollouts, trunk-delta against dense: CartPole scores ``atol=1e-4``,
  steps exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
from evotorch_tpu.algorithms.functional import pgpe_ask_trunk_delta as jax_pgpe_ask_trunk_delta
from evotorch_tpu.algorithms.functional import pgpe_tell_trunk_delta as jax_pgpe_tell_trunk_delta
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import layers as jax_layers
from evotorch_tpu.neuroevolution.net.lowrank import _Factor as JaxFactor
from evotorch_tpu.neuroevolution.net.lowrank import trunk_delta_forward as jax_trunk_delta_forward
from evotorch_tpu_torch import distributions, interop
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask_trunk_delta, pgpe_tell, pgpe_tell_trunk_delta
from evotorch_tpu_torch.envs import CartPole
from evotorch_tpu_torch.neuroevolution.net import (
    LSTM,
    RNN,
    FlatParamsPolicy,
    Linear,
    Tanh,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    stats_init,
    trunk_delta_forward,
)
from evotorch_tpu_torch.neuroevolution.net import lowrank as port_lowrank
from evotorch_tpu_torch.neuroevolution.net.layers import state_leaves
from evotorch_tpu_torch.neuroevolution.net.lowrank import prepare_trunk_delta, trunk_delta_supported
from evotorch_tpu_torch.parallel import make_generation_step
from evotorch_tpu_torch.tools.lowrank import TrunkDeltaParamsBatch, is_factored

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TELL_TOL = dict(rtol=1e-5, atol=1e-6)
DENSE_TELL_TOL = dict(rtol=1e-4, atol=1e-6)
BLOCK_TOL = dict(rtol=1e-6, atol=1e-6)
PGPE_KW = dict(center_learning_rate=0.2, stdev_learning_rate=0.1, objective_sense="max")

NETS = {
    "mlp": (lambda: Linear(9, 16) >> Tanh() >> Linear(16, 4) >> Tanh(), lambda: jax_layers.Linear(9, 16) >> jax_layers.Tanh() >> jax_layers.Linear(16, 4) >> jax_layers.Tanh(), 9),
    "rnn": (lambda: RNN(5, 7) >> Tanh() >> Linear(7, 3), lambda: jax_layers.RNN(5, 7) >> jax_layers.Tanh() >> jax_layers.Linear(7, 3), 5),
    "lstm": (lambda: LSTM(5, 7) >> Linear(7, 3), lambda: jax_layers.LSTM(5, 7) >> jax_layers.Linear(7, 3), 5),
}


def _center(L):
    return (np.random.default_rng(0).normal(size=L) * 0.2).astype(np.float32)


def _states(L, stdev=0.5):
    center = _center(L)
    jax_state = jax_pgpe(center_init=jnp.asarray(center), stdev_init=stdev, **PGPE_KW)
    return pgpe(center_init=torch.from_numpy(center), stdev_init=stdev, **PGPE_KW), jax_state


def _inject_jax_draws(monkeypatch, key, n, k):
    """Patch the port's draw steps with the JAX ask's draws from ``key``."""
    key_factors, key_coeffs = jax.random.split(key)

    def factor_noise(generator, stream, shape, dtype):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key_factors, stream), shape, jnp.float32)))

    z = np.array(jax.random.normal(jax.random.split(key_coeffs)[1], (n // 2, k), jnp.float32))
    monkeypatch.setattr(port_lowrank, "_draw_factor_noise", factor_noise)
    monkeypatch.setattr(distributions, "_draw_lowrank_coeffs", lambda generator, shape, dtype: torch.from_numpy(z))


def _jax_factor_pairs(batch):
    leaves = jax.tree_util.tree_leaves(batch.factors, is_leaf=lambda x: isinstance(x, JaxFactor))
    return [(np.asarray(f.a), np.asarray(f.b)) for f in leaves]


def _asked(name, monkeypatch, *, n=12, k=4, seed=1):
    """One trunk-delta ask in both packages from the same draws: the port's
    policy, the JAX policy, both batches, both states."""
    make_port, make_jax, in_dim = NETS[name]
    policy, jax_policy = FlatParamsPolicy(make_port()), JaxFlatParamsPolicy(make_jax())
    state, jax_state = _states(policy.parameter_count)
    key = jax.random.key(seed)
    jax_batch = jax_pgpe_ask_trunk_delta(key, jax_state, popsize=n, rank=k, policy=jax_policy)
    _inject_jax_draws(monkeypatch, key, n, k)
    batch = pgpe_ask_trunk_delta(torch.Generator(), state, popsize=n, rank=k, policy=policy)
    monkeypatch.undo()
    return policy, jax_policy, batch, jax_batch, state, jax_state, in_dim


@pytest.mark.parametrize("name", list(NETS))
def test_factors_and_basis_equal_jax(name, monkeypatch):
    policy, _, batch, jax_batch, _, _, _ = _asked(name, monkeypatch)
    theirs = _jax_factor_pairs(jax_batch)
    assert len(batch.factors) == len(theirs) == len(policy.layout)
    for (shape_name, shape, _), ours, (a, b) in zip(policy.layout, batch.factors, theirs):
        np.testing.assert_array_equal(ours.a.numpy(), a, shape_name)
        np.testing.assert_array_equal(ours.b.numpy(), b, shape_name)
        assert ours.a.shape[0] == (shape[1] if len(shape) == 2 else 0)
    for field in ("center", "basis", "coeffs"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(), np.asarray(getattr(jax_batch, field)), field)
    # the batch carried across by interop is the same population
    carried = interop.trunk_delta_batch_from_numpy(
        {**{f: np.asarray(getattr(jax_batch, f)) for f in ("center", "basis", "coeffs")}, "factors": theirs}, device="cpu"
    )
    back = interop.trunk_delta_batch_to_numpy(carried)
    for (a0, b0), (a1, b1) in zip(back["factors"], interop.trunk_delta_batch_to_numpy(batch)["factors"]):
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)


def test_batch_shape_and_take():
    policy = FlatParamsPolicy(NETS["mlp"][0]())
    state, _ = _states(policy.parameter_count)
    batch = pgpe_ask_trunk_delta(torch.Generator().manual_seed(0), state, popsize=10, rank=3, policy=policy)
    assert isinstance(batch, TrunkDeltaParamsBatch) and is_factored(batch)
    assert batch.popsize == 10 and batch.rank == 3 and trunk_delta_supported(policy.module)
    sub = batch.take(torch.tensor([1, 3, 5]))
    assert isinstance(sub, TrunkDeltaParamsBatch) and sub.coeffs.shape == (3, 3) and sub.factors is batch.factors
    assert batch.materialize().shape == (10, policy.parameter_count)
    torch.testing.assert_close(batch.coeffs[0::2], -batch.coeffs[1::2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="symmetric"):
        pgpe_ask_trunk_delta(torch.Generator(), pgpe(center_init=torch.zeros(3), stdev_init=0.1, symmetric=False, **PGPE_KW), popsize=4, rank=2, policy=policy)


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_dense_and_jax(name, monkeypatch):
    policy, jax_policy, batch, jax_batch, _, _, in_dim = _asked(name, monkeypatch)
    rng = np.random.default_rng(4)
    prepared = prepare_trunk_delta(policy, batch)
    states = dense_states = jax_states = None
    for _ in range(3):
        obs = rng.normal(size=(12, in_dim)).astype(np.float32)
        out, states = trunk_delta_forward(policy, batch, prepared, torch.from_numpy(obs), states)
        dense, dense_states = policy(batch.materialize(), torch.from_numpy(obs), dense_states)
        jax_out, jax_states = jax_trunk_delta_forward(jax_policy, jax_batch, None, jnp.asarray(obs), jax_states)
        np.testing.assert_allclose(out.numpy(), dense.numpy(), **FWD_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **FWD_TOL)
        for a, b, c in zip(state_leaves(states), state_leaves(dense_states), jax.tree_util.tree_leaves(jax_states)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **FWD_TOL)


@pytest.mark.parametrize("name", ["mlp", "lstm"])
def test_blocked_forward_matches_unblocked(name):
    make_port, _, in_dim = NETS[name]
    policy = FlatParamsPolicy(make_port())
    state, _ = _states(policy.parameter_count)
    batch = pgpe_ask_trunk_delta(torch.Generator().manual_seed(5), state, popsize=12, rank=4, policy=policy)
    obs = torch.from_numpy(np.random.default_rng(6).normal(size=(12, in_dim)).astype(np.float32))
    one, one_states = trunk_delta_forward(policy, batch, prepare_trunk_delta(policy, batch), obs, None)
    blocked, blocked_states = trunk_delta_forward(policy, batch, prepare_trunk_delta(policy, batch, trunk_block=4), obs, None)
    torch.testing.assert_close(blocked, one, **BLOCK_TOL)
    for a, b in zip(state_leaves(blocked_states), state_leaves(one_states)):
        torch.testing.assert_close(a, b, **BLOCK_TOL)
    # a block that does not divide the lanes runs one block (the JAX rule)
    odd, _ = trunk_delta_forward(policy, batch, prepare_trunk_delta(policy, batch, trunk_block=5), obs, None)
    torch.testing.assert_close(odd, one, rtol=0, atol=0)


def _cartpole():
    env = CartPole(continuous_actions=True, device="cpu")
    return env, FlatParamsPolicy(Linear(env.observation_size, 16) >> Tanh() >> Linear(16, env.action_size))


@pytest.mark.parametrize("mode", ["budget", "episodes", "episodes_refill"])
def test_generation_matches_dense(mode):
    # one make_generation_step generation of the trunk-delta ask and tell
    # against the same generation with the materialized population and the
    # dense tell; the ask draws the same generator state in both
    env, policy = _cartpole()
    state, _ = _states(policy.parameter_count, stdev=0.3)
    kw = dict(popsize=16, device="cpu", eval_mode=mode, episode_length=60, observation_normalization=True)
    if mode == "episodes_refill":
        kw["refill_width"] = 4
    factored = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask_trunk_delta(g, s, popsize=16, rank=4, policy=policy),
        tell=pgpe_tell_trunk_delta, **kw,
    )  # fmt: skip
    dense = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask_trunk_delta(g, s, popsize=16, rank=4, policy=policy).materialize(),
        tell=pgpe_tell, **kw,
    )  # fmt: skip
    out_f = factored(state, torch.Generator().manual_seed(9), stats_init(4, device="cpu"))
    out_d = dense(state, torch.Generator().manual_seed(9), stats_init(4, device="cpu"))
    np.testing.assert_allclose(out_f[1].numpy(), out_d[1].numpy(), atol=1e-4)
    assert out_f[3] == out_d[3]
    np.testing.assert_allclose(out_f[0].optimizer_state.center.numpy(), out_d[0].optimizer_state.center.numpy(), **DENSE_TELL_TOL)
    np.testing.assert_allclose(out_f[0].stdev.numpy(), out_d[0].stdev.numpy(), **DENSE_TELL_TOL)


def test_compacting_rollout_accepts_trunk_delta():
    env, policy = _cartpole()
    state, _ = _states(policy.parameter_count, stdev=0.3)
    batch = pgpe_ask_trunk_delta(torch.Generator().manual_seed(8), state, popsize=16, rank=4, policy=policy)
    kw = dict(num_episodes=2, episode_length=80)
    mono = run_vectorized_rollout(env, policy, batch, torch.Generator().manual_seed(2), None, eval_mode="episodes", **kw)
    comp = run_vectorized_rollout_compacting(
        env, policy, batch, torch.Generator().manual_seed(2), None, chunk_size=10, allowed_widths=(4, 8), **kw
    )
    dense = run_vectorized_rollout(env, policy, batch.materialize(), torch.Generator().manual_seed(2), None, **kw)
    torch.testing.assert_close(comp.scores, mono.scores, rtol=0, atol=0)
    np.testing.assert_allclose(mono.scores.numpy(), dense.scores.numpy(), atol=1e-4)
    assert comp.total_steps == mono.total_steps == dense.total_steps


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_rollout_trunk_block(compute_dtype):
    env, policy = _cartpole()
    state, _ = _states(policy.parameter_count, stdev=0.3)
    batch = pgpe_ask_trunk_delta(torch.Generator().manual_seed(9), state, popsize=12, rank=4, policy=policy)
    kw = dict(episode_length=40, eval_mode="budget", compute_dtype=compute_dtype)
    plain = run_vectorized_rollout(env, policy, batch, torch.Generator().manual_seed(3), None, **kw)
    blocked = run_vectorized_rollout(env, policy, batch, torch.Generator().manual_seed(3), None, trunk_block=4, **kw)
    assert plain.total_steps == blocked.total_steps == 12 * 40
    assert bool(torch.isfinite(blocked.scores).all())
    if compute_dtype is None:
        np.testing.assert_allclose(blocked.scores.numpy(), plain.scores.numpy(), atol=1e-4)


def test_pgpe_tell_trunk_delta_matches_jax_and_dense(monkeypatch):
    _, _, batch, jax_batch, state, jax_state, _ = _asked("mlp", monkeypatch, n=24, k=6, seed=3)
    evals = np.random.default_rng(11).normal(size=24).astype(np.float32)
    ours = pgpe_tell_trunk_delta(state, batch, torch.from_numpy(evals))
    theirs = jax_pgpe_tell_trunk_delta(jax_state, jax_batch, jnp.asarray(evals))
    dense = pgpe_tell(state, batch.materialize(), torch.from_numpy(evals))
    np.testing.assert_allclose(ours.stdev.numpy(), np.asarray(theirs.stdev), **TELL_TOL)
    np.testing.assert_allclose(ours.stdev.numpy(), dense.stdev.numpy(), **DENSE_TELL_TOL)
    for field in ("center", "velocity"):
        value = getattr(ours.optimizer_state, field).numpy()
        np.testing.assert_allclose(value, np.asarray(getattr(theirs.optimizer_state, field)), **TELL_TOL)
        np.testing.assert_allclose(value, getattr(dense.optimizer_state, field).numpy(), **DENSE_TELL_TOL)


def test_pgpe_trunk_delta_improves_sphere():
    policy = FlatParamsPolicy(Linear(4, 8) >> Tanh() >> Linear(8, 2) >> Tanh())
    L = policy.parameter_count
    state = pgpe(center_init=torch.full((L,), 3.0), center_learning_rate=0.5, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.5, optimizer="adam")
    generator = torch.Generator().manual_seed(0)
    first = None
    for _ in range(60):
        params = pgpe_ask_trunk_delta(generator, state, popsize=64, rank=8, policy=policy)
        evals = -torch.sum(params.materialize() ** 2, dim=-1)
        state = pgpe_tell_trunk_delta(state, params, evals)
        mean_eval = float(evals.mean())
        first = mean_eval if first is None else first
    assert mean_eval > first * 0.2 and mean_eval > -L  # from about -9 L


def test_trunk_arrays_rest_sharded_over_the_model_axis(tmp_path):
    """4 gloo ranks on a ``{"pop": 2, "model": 2}`` mesh: each rank keeps
    half of the trunk arrays (center and basis, 26 parameters) at rest and
    gathers the whole trunk for the rollout and for the tell. Everything
    (scores, statistics, state, wire) equals the ``{"pop": 4}`` run over the
    same lane blocks bit for bit, and the one-rank run's scores and state
    too; the observation statistics hold to the one-rank run at
    ``tests/test_torch_parallel.py``'s ``STATS_TOL`` (a factored forward over
    a block of lanes rounds otherwise than over all of them, as there)."""
    from test_torch_parallel import STATS_TOL, Spawn, case_trunk_model_axis, trunk_delta_generations

    one = trunk_delta_generations(None)
    assert one["trunk_bytes"] == [] and one["parameters"] == 26
    whole = 26 * (1 + 4) * 4  # float32 center and rank-4 basis
    for rank, saved in enumerate(Spawn(tmp_path, 4, [case_trunk_model_axis]).results()):
        got = saved["case_trunk_model_axis"]
        sharded, flat = got[(("pop", 2), ("model", 2))], got[(("pop", 4),)]
        # a rollout and a tell a generation, each from half of the trunk
        assert sharded["trunk_bytes"] == [(whole // 2, whole)] * 4 and flat["trunk_bytes"] == [], rank
        for ours, pop4, theirs in zip(sharded["generations"], flat["generations"], one["generations"]):
            for key in ("scores", "center", "stdev", "stats", "telemetry"):
                assert torch.equal(ours[key], pop4[key]), (rank, key)
            for key in ("scores", "center", "stdev"):
                assert torch.equal(ours[key], theirs[key]), (rank, key)
            np.testing.assert_allclose(ours["stats"].numpy(), theirs["stats"].numpy(), **STATS_TOL)
            assert ours["steps"] == theirs["steps"]
