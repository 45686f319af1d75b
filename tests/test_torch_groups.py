"""Per-group telemetry, stacked observation statistics and per-solution
table rows of the port's rollout engine, against the JAX package on the
CPU.

The JAX engine's reset draws are injected into the port as in
``tests/test_torch_contracts.py`` (item ``j``'s reset from
``split(fold_in(key, j))[1]``), so both engines run the same items.

Tolerances:
- The per-group counter and histogram columns: exact, against JAX and, as
  column sums, against the port's own one-group wire.
- The health block: CartPole's scores are whole numbers, so its per-group
  sums are exact in any order; on arbitrary scores ``rtol=1e-6``.
- Scores: ``atol=1e-4`` with equal ranks against JAX (the contracts tests'
  tolerance: FMA rounding in the dynamics); bit for bit within the port.
- Stacked statistics: ``rtol=1e-6`` against JAX's ``group_stats_*`` on the
  same inputs (float sums in another order); counts exact. After a refill
  rollout with normalization: ``rtol=1e-4, atol=1e-4``, as the contracts
  tests' masked statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.envs import Pendulum as JaxPendulum
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
from evotorch_tpu.neuroevolution.net import runningnorm as jax_rn
from evotorch_tpu.neuroevolution.net.vecrl import run_vectorized_rollout_compacting as jax_compacting
from evotorch_tpu.observability import devicemetrics as jax_dm
from evotorch_tpu_torch.envs import Pendulum
from evotorch_tpu_torch.interop import group_stats_from_numpy
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, runningnorm
from evotorch_tpu_torch.neuroevolution.net.vecrl import (
    SolutionTables,
    draw_solution_tables,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
)
from evotorch_tpu_torch.observability import GroupTelemetry
from evotorch_tpu_torch.observability import devicemetrics as dm
from evotorch_tpu_torch.parallel import make_generation_step
from test_torch_contracts import CARTPOLE_N, CARTPOLE_STEPS, _cartpole, _cartpole_rows, _jax_run, _port_run

NUM_GROUPS = 4


def _groups(n, seed=0, num_groups=NUM_GROUPS):
    return np.random.default_rng(seed).integers(0, num_groups, size=n).astype(np.int32)


def _kw(groups, num_groups=NUM_GROUPS):
    return dict(groups=groups, num_groups=num_groups)


def _assert_group_wire(ours, theirs, num_groups=NUM_GROUPS, *, health=True):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape == (num_groups, 20 if health else 15) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours[:, :15], theirs[:, :15])
    if health:
        np.testing.assert_array_equal(ours, theirs)  # whole-number scores: exact sums


# ------------------------------------------------------ against the JAX package


@pytest.mark.parametrize("num_episodes,width,period", [(1, 5, 1), (2, 5, 1), (1, 16, 1), (2, 8, 4)])
def test_refill_group_wire_matches_jax(num_episodes, width, period):
    jax_env, jax_policy, env, policy, params = _cartpole()
    groups = _groups(CARTPOLE_N)
    key = jax.random.key(21)
    kw = dict(num_episodes=num_episodes, episode_length=CARTPOLE_STEPS, eval_mode="episodes_refill", refill_width=width, refill_period=period)
    theirs = _jax_run(jax_env, jax_policy, params, key, **kw, **_kw(jnp.asarray(groups)))
    ours = _port_run(env, policy, params, _cartpole_rows(key, CARTPOLE_N * num_episodes), **kw, **_kw(torch.from_numpy(groups)))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=0, atol=1e-4)
    _assert_group_wire(ours.telemetry, theirs.telemetry)
    if period > 1:  # waits in the histogram, per group
        assert GroupTelemetry.from_array(ours.telemetry).hist[:, 1:].sum() > 0


def test_episodes_group_wire_matches_jax():
    jax_env, jax_policy, env, policy, params = _cartpole()
    groups = _groups(CARTPOLE_N, seed=1)
    key = jax.random.key(22)
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS)
    theirs = _jax_run(jax_env, jax_policy, params, key, eval_mode="episodes", **kw, **_kw(jnp.asarray(groups)))
    ours = _port_run(env, policy, params, _cartpole_rows(key, CARTPOLE_N), **kw, **_kw(torch.from_numpy(groups)))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=0, atol=1e-4)
    _assert_group_wire(ours.telemetry, theirs.telemetry)


def test_compacting_group_wire_matches_jax():
    """A lane dropped at a compaction charges its group the capacity of the
    steps it was held, as the JAX runner folds it."""
    jax_env, jax_policy, env, policy, params = _cartpole()
    groups = _groups(CARTPOLE_N, seed=2)
    key = jax.random.key(23)
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS, chunk_size=10, allowed_widths=(4, 8, 16))
    theirs = jax_compacting(jax_env, jax_policy, jnp.asarray(params), key, jax_rn.RunningNorm(4).stats, **kw, **_kw(jnp.asarray(groups)))
    ours = run_vectorized_rollout_compacting(
        env, policy, torch.from_numpy(params), torch.Generator(), None,
        reset_noise=torch.from_numpy(_cartpole_rows(key, CARTPOLE_N)), **kw, **_kw(torch.from_numpy(groups)),
    )  # fmt: skip
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=0, atol=1e-4)
    _assert_group_wire(ours.telemetry, theirs.telemetry)


def test_budget_group_wire_matches_jax():
    """Pendulum's episodes end only by time: the budget's per-group counters
    are fixed whatever the resets (which come from different generators)."""
    jax_env, env = JaxPendulum(), Pendulum(device="cpu")
    jax_policy, policy = JaxFlatParamsPolicy(JaxLinear(3, 1)), FlatParamsPolicy(Linear(3, 1))
    params = np.random.default_rng(6).normal(size=(11, 4)).astype(np.float32)
    groups = _groups(11, seed=3)
    kw = dict(num_episodes=2, episode_length=25, eval_mode="budget")
    theirs = _jax_run(jax_env, jax_policy, params, jax.random.key(1), **kw, **_kw(jnp.asarray(groups)))
    ours = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator().manual_seed(0), None, **kw, **_kw(torch.from_numpy(groups)))
    np.testing.assert_array_equal(ours.telemetry.numpy()[:, :15], np.asarray(theirs.telemetry)[:, :15])


def test_quarantined_solutions_count_in_their_groups_like_jax():
    jax_env, env = JaxPendulum(), Pendulum(device="cpu")
    jax_policy, policy = JaxFlatParamsPolicy(JaxLinear(3, 1)), FlatParamsPolicy(Linear(3, 1))
    params = np.random.default_rng(7).normal(size=(10, 4)).astype(np.float32)
    params[[1, 4, 5], 0] = np.nan
    groups = np.array([0, 1, 1, 2, 2, 3, 3, 0, 1, 2], dtype=np.int32)
    kw = dict(num_episodes=1, episode_length=20, eval_mode="episodes_refill", refill_width=4, nonfinite_quarantine=True, nonfinite_penalty=-5.0)
    rows = env.reset_noise(10, torch.Generator().manual_seed(1))
    ours = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, reset_noise=rows, **kw, **_kw(torch.from_numpy(groups)))
    theirs = _jax_run(jax_env, jax_policy, params, jax.random.key(2), **kw, **_kw(jnp.asarray(groups)))
    ours_gt, theirs_gt = GroupTelemetry.from_array(ours.telemetry), GroupTelemetry.from_array(np.asarray(theirs.telemetry))
    for g in range(NUM_GROUPS):
        assert ours_gt.group(g).nonfinite == theirs_gt.group(g).nonfinite
    assert [ours_gt.group(g).nonfinite for g in range(NUM_GROUPS)] == [0, 1, 1, 1]


# ------------------------------------------------------------- within the port


CONTRACTS = [("budget", 1), ("episodes", 1), ("episodes", 2), ("episodes_refill", 1), ("episodes_refill", 2), ("episodes_compact", 1), ("episodes_compact", 2)]


@pytest.mark.parametrize("eval_mode,num_episodes", CONTRACTS, ids=[f"{m}-{e}" for m, e in CONTRACTS])
def test_group_column_sums_equal_one_group_wire(eval_mode, num_episodes):
    """Every counter and histogram column of the per-group wire sums to the
    one-group wire's, and grouping changes no score (bit for bit)."""
    _, _, env, policy, params = _cartpole(n=29, seed=4)
    groups = torch.from_numpy(_groups(29, seed=5))

    def run(**extra):
        kw = dict(num_episodes=num_episodes, episode_length=60, **extra)
        generator = torch.Generator().manual_seed(3)
        if eval_mode == "episodes_compact":
            return run_vectorized_rollout_compacting(env, policy, torch.from_numpy(params), generator, None, chunk_size=7, allowed_widths=(8, 16), **kw)
        width = dict(refill_width=6, refill_period=3) if eval_mode == "episodes_refill" else {}
        return run_vectorized_rollout(env, policy, torch.from_numpy(params), generator, None, eval_mode=eval_mode, **width, **kw)

    one, grouped = run(), run(**_kw(groups))
    assert torch.equal(one.scores, grouped.scores)
    assert grouped.telemetry.shape == (NUM_GROUPS, 20)
    np.testing.assert_array_equal(grouped.telemetry.numpy()[:, :15].sum(axis=0), one.telemetry.numpy()[0, :15])
    decoded = GroupTelemetry.from_array(grouped.telemetry)
    if eval_mode != "episodes_refill":  # one lane per solution
        assert [decoded.group(g).lane_width for g in range(NUM_GROUPS)] == [int((groups == g).sum()) for g in range(NUM_GROUPS)]
    if eval_mode != "budget":
        for g in range(NUM_GROUPS):
            assert decoded.group(g).episodes == int((groups == g).sum()) * num_episodes
    # CartPole pays 1 a step: each group's env steps are its solutions' returns
    if eval_mode != "budget":
        for g in range(NUM_GROUPS):
            mask = (groups == g).numpy()
            assert decoded.group(g).env_steps == int(round(float(grouped.scores.numpy()[mask].sum()) * num_episodes))
    stats = decoded.score_stats(0)
    mine = grouped.scores.numpy()[(groups == 0).numpy()]
    assert stats["count"] == len(mine) and stats["max"] == float(mine.max())


def test_one_group_or_telemetry_off_keeps_the_one_group_form():
    _, _, env, policy, params = _cartpole(n=6)
    groups = torch.tensor([0, 1, 0, 1, 0, 1])
    kw = dict(episode_length=30, eval_mode="episodes_refill", refill_width=3)
    res = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, groups=groups, **kw)
    assert res.telemetry.shape == (1, 20)
    off = run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, groups=groups, num_groups=2, telemetry=False, **kw)
    assert off.telemetry is None
    with pytest.raises(ValueError, match="groups array"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, num_groups=2, **kw)
    with pytest.raises(ValueError, match="num_groups"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, groups=groups * 3, num_groups=2, **kw)


def test_generation_step_health_block_per_group():
    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_tell

    _, _, env, policy, _ = _cartpole()
    popsize = 12
    groups = torch.arange(popsize) % 3
    state = pgpe(center_init=torch.zeros(policy.parameter_count), center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.5)
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize), tell=pgpe_tell, popsize=popsize, device="cpu",
        eval_mode="episodes_refill", episode_length=40, groups=groups, num_groups=3,
    )  # fmt: skip
    _, scores, _, _, telemetry = generation(state, torch.Generator().manual_seed(0), None)
    decoded = GroupTelemetry.from_array(telemetry)
    assert telemetry.shape == (3, 20)
    for g in range(3):
        mine = scores[groups == g]
        assert decoded.score_stats(g)["count"] == 4 and decoded.score_stats(g)["max"] == float(mine.max())


# --------------------------------------------------------- health block per group


def test_health_block_per_group_matches_jax():
    rng = np.random.default_rng(8)
    scores = rng.normal(size=50).astype(np.float32) * 30
    groups = rng.integers(0, 5, size=50).astype(np.int32)
    groups[groups == 3] = 4  # group 3 empty: zeros
    ours = dm.compute_health_block(torch.from_numpy(scores), torch.from_numpy(groups), 5).numpy()
    theirs = np.asarray(jax_dm.compute_health_block(jnp.asarray(scores), jnp.asarray(groups), 5))
    assert ours.shape == theirs.shape == (5, 5)
    np.testing.assert_array_equal(ours[:, [0, 3, 4]], theirs[:, [0, 3, 4]])  # counts, min, max
    np.testing.assert_allclose(ours[:, 1:3], theirs[:, 1:3], rtol=1e-6)
    assert (ours[3] == 0).all()
    # one group: the one-row block of the plain form
    np.testing.assert_array_equal(
        dm.compute_health_block(torch.from_numpy(scores), torch.zeros(50, dtype=torch.int64), 1).numpy()[:, [0, 3, 4]],
        dm.compute_health_block(torch.from_numpy(scores)).numpy()[:, [0, 3, 4]],
    )


# ------------------------------------------------------------- stacked statistics


def test_group_stats_match_jax():
    rng = np.random.default_rng(9)
    obs = rng.normal(size=(40, 6)).astype(np.float32)
    groups = rng.integers(0, 3, size=40).astype(np.int32)
    mask = rng.random(40) > 0.3
    theirs = jax_rn.group_stats_update(jax_rn.group_stats_init(3, 6), jnp.asarray(obs), jnp.asarray(groups), jnp.asarray(mask), 3)
    ours = runningnorm.group_stats_update(
        runningnorm.group_stats_init(3, 6, device="cpu"), torch.from_numpy(obs), torch.from_numpy(groups), torch.from_numpy(mask), 3
    )
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(theirs.count))
    for name in ("sum", "sum_of_squares"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)), rtol=1e-6, atol=1e-6)
    # the normalization of each row by its group's slot, from JAX's slots
    carried = group_stats_from_numpy({k: np.asarray(getattr(theirs, k)) for k in ("count", "sum", "sum_of_squares")}, device="cpu")
    np.testing.assert_allclose(
        runningnorm.group_stats_normalize(carried, torch.from_numpy(obs), torch.from_numpy(groups)).numpy(),
        np.asarray(jax_rn.group_stats_normalize(theirs, jnp.asarray(obs), jnp.asarray(groups))),
        rtol=1e-6, atol=1e-6,
    )  # fmt: skip
    for g in range(3):
        slot, jax_slot = runningnorm.stats_slot(carried, g), jax_rn.stats_slot(theirs, g)
        assert float(slot.count) == float(jax_slot.count)
        np.testing.assert_array_equal(slot.sum.numpy(), np.asarray(jax_slot.sum))
    with pytest.raises(ValueError, match="stacked"):
        group_stats_from_numpy({"count": np.zeros(()), "sum": np.zeros(3), "sum_of_squares": np.zeros(3)}, device="cpu")


def test_refill_with_stacked_statistics_matches_jax():
    """Each lane normalizes by its group's slot and updates only that slot,
    a fresh reset's observation going to the incoming item's group."""
    jax_env, jax_policy, env, policy, params = _cartpole(n=20, seed=10)
    groups = _groups(20, seed=11, num_groups=3)
    key = jax.random.key(24)
    kw = dict(num_episodes=1, episode_length=50, eval_mode="episodes_refill", refill_width=6, observation_normalization=True)
    from evotorch_tpu.neuroevolution.net import run_vectorized_rollout as jax_rollout

    theirs = jax_rollout(jax_env, jax_policy, jnp.asarray(params), key, jax_rn.group_stats_init(3, 4), groups=jnp.asarray(groups), num_groups=3, **kw)
    ours = run_vectorized_rollout(
        env, policy, torch.from_numpy(params), torch.Generator(), runningnorm.group_stats_init(3, 4, device="cpu"),
        reset_noise=torch.from_numpy(_cartpole_rows(key, 20)), groups=torch.from_numpy(groups), num_groups=3, **kw,
    )  # fmt: skip
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=0, atol=1e-4)
    assert ours.stats.count.shape == (3,)
    np.testing.assert_array_equal(ours.stats.count.numpy(), np.asarray(theirs.stats.count))
    for name in ("sum", "sum_of_squares"):
        np.testing.assert_allclose(getattr(ours.stats, name).numpy(), np.asarray(getattr(theirs.stats, name)), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ours.telemetry.numpy()[:, :15], np.asarray(theirs.telemetry)[:, :15])
    # the count: the 6 first resets, then every observation a running lane
    # consumes next (each env step but the last of each episode), plus the
    # refilled items' resets
    decoded = GroupTelemetry.from_array(ours.telemetry).total()
    assert float(ours.stats.count.sum()) == 6 + decoded.env_steps - decoded.episodes + decoded.refill_events
    with pytest.raises(ValueError, match="stacked"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), runningnorm.group_stats_init(3, 4, device="cpu"), **kw)


# -------------------------------------------------------- per-solution table rows


@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill", "episodes_compact"])
@pytest.mark.parametrize("num_episodes", [1, 2])
def test_solution_tables_reproduce_each_owners_standalone_run(eval_mode, num_episodes):
    """Two owners' solutions interleaved in one rollout, each with the rows
    its own generator drew at its own size, score what each owner's
    standalone run scores, bit for bit, and leave each generator as that
    run leaves it. Pendulum with action noise: both tables matter."""
    env, policy = Pendulum(device="cpu"), FlatParamsPolicy(Linear(3, 1))
    sizes, seeds = (5, 7), (31, 32)
    params = [np.random.default_rng(s).normal(size=(n, 4)).astype(np.float32) for n, s in zip(sizes, seeds)]
    kw = dict(num_episodes=num_episodes, episode_length=30, action_noise_stdev=0.2)

    def run(values, generator, **extra):
        if eval_mode == "episodes_compact":
            return run_vectorized_rollout_compacting(env, policy, values, generator, None, chunk_size=4, allowed_widths=(4,), **kw, **extra)
        width = dict(refill_width=4) if eval_mode == "episodes_refill" else {}
        return run_vectorized_rollout(env, policy, values, generator, None, eval_mode=eval_mode, **width, **kw, **extra)

    standalone, after = [], []
    for p, s in zip(params, seeds):
        g = torch.Generator().manual_seed(s)
        standalone.append(run(torch.from_numpy(p), g).scores)
        after.append(g.get_state())
    tables, drawn = [], []
    for (n, s) in zip(sizes, seeds):
        g = torch.Generator().manual_seed(s)
        tables.append(draw_solution_tables(env, n, g, num_episodes=num_episodes, episode_length=30, action_noise_stdev=0.2))
        drawn.append(g.get_state())
    for a, b in zip(after, drawn):
        assert torch.equal(a, b)
    # interleave the owners' rows: 0, 5, 1, 6, ...
    order = [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2), (0, 3), (1, 3), (0, 4), (1, 4), (1, 5), (1, 6)]
    values = torch.stack([torch.from_numpy(params[o][i]) for o, i in order])
    packed = SolutionTables(
        torch.stack([tables[o].reset[i] for o, i in order]), torch.stack([tables[o].action_noise[i] for o, i in order])
    )
    scores = run(values, torch.Generator().manual_seed(99), solution_tables=packed).scores
    for k, (o, i) in enumerate(order):
        assert torch.equal(scores[k], standalone[o][i]), (k, o, i)


def test_solution_keys_are_refused_naming_the_tables():
    """Torch generators cannot be folded per item, so the JAX engine's
    ``solution_keys`` have no meaning here: the call names the port's form
    instead of quietly drawing from the shared generator."""
    _, _, env, policy, params = _cartpole(n=4)
    for run in (run_vectorized_rollout, run_vectorized_rollout_compacting):
        with pytest.raises(TypeError, match="solution_tables"):
            run(env, policy, torch.from_numpy(params), torch.Generator(), None, solution_keys=jax.random.split(jax.random.key(0), 4))
    tables = draw_solution_tables(env, 4, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="replaces"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, solution_tables=tables, reset_noise=tables.reset[:, 0])
    with pytest.raises(ValueError, match="num_episodes"):
        run_vectorized_rollout(env, policy, torch.from_numpy(params), torch.Generator(), None, solution_tables=tables, num_episodes=2)


# ------------------------------------------------------------------ VecNE


def test_vecne_solution_groups_slo_and_tuned_config_source(tmp_path, monkeypatch):
    """``VecNE(solution_groups=, slo=)``: the per-group status keys and the
    watchdog's verdict (one evaluation behind, as the telemetry decode);
    the refill width from the tuned-config cache when none is given, and
    ``tuned_config_source`` saying where it came from."""
    import importlib

    from evotorch_tpu_torch.neuroevolution import VecNE

    timings = importlib.import_module("evotorch_tpu_torch.observability.timings")
    monkeypatch.setenv("EVOTORCH_TUNED_CACHE", str(tmp_path / "tuned.json"))
    timings.load_tuned_cache(force=True)
    groups = [0, 1, 1, 0, 1, 1, 0, 1]

    def problem(**kw):
        return VecNE(
            "cartpole", "Linear(obs_length, act_length)", env_config=None, episode_length=30, eval_mode="episodes_refill",
            solution_groups=groups, slo=[{"kind": "occupancy_floor", "threshold": 1.5}], seed=1, device="cpu", **kw,
        )  # fmt: skip

    def evaluate_twice(p):
        for _ in range(2):
            batch = p.generate_batch(8)
            p.evaluate(batch)
        return p.status

    status = evaluate_twice(problem())
    assert status["eval_g0_episodes"] == 3 and status["eval_g1_episodes"] == 5
    assert status["slo_ok"] is False and "occupancy" in status["slo_detail"]
    assert status["tuned_config_source"] == "fallback"
    shape = {"env": "cartpole", "popsize": 8, "episode_length": 30, "num_episodes": 1, "params": 10, "dtype": "float32", "mesh": "none"}
    timings.save_tuned_entry(timings.TunedEntry(group="refill", shape=shape, machine=timings.machine_fingerprint(), config={"width": 3}))
    cached = problem()
    status = evaluate_twice(cached)
    assert status["tuned_config_source"] == "cache" and cached.last_group_telemetry.total().lane_width == 3
    status = evaluate_twice(problem(refill_config={"width": 4}))
    assert status["tuned_config_source"] == "override"
    monkeypatch.delenv("EVOTORCH_TUNED_CACHE")
    timings.load_tuned_cache(force=True)
