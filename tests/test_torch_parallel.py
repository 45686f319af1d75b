"""The port's parallel layer (``evotorch_tpu_torch/parallel``) over gloo ranks
on the CPU: sharded evaluation and whole generations at world sizes 2 and 3
against the port's one-rank run, and against the JAX package's sharded
generation on its 8-device CPU mesh.

Ranks are spawned once per module (``spawn`` start method, a ``file://``
store under the test's temporary directory, no TCP port), each running
every check of the module in one process group; every rank saves what it
computed and the tests compare. A spawn has its own time limit
(``RANK_TIMEOUT``), every group a collective timeout, and a rank that
fails ends the spawn at once, so a fault cannot hold the suite.

Tolerances:
- Ranks of scores: exact. Counters (env steps, episodes, refill events,
  queue wait) and the histogram: exact.
- Against the one-rank run: scores ``atol=rtol=1e-4``, the center and the
  stdev ``atol=rtol=1e-5`` (the JAX package holds its sharded generation
  to the unsharded one so, ``tests/test_parallel.py``), the observation
  statistics (sums over 40 observations) ``rtol=atol=1e-4``. A dense
  population's sharded generation is in fact exact on the CPU: every rank
  draws the global tables and gathers the block observations into the
  one-rank statistics update. A low-rank one's is not: its forward's
  products over a block of lanes round differently from the whole
  population's (~4e-5 relative in the statistics after 3 steps).
- Against the JAX package (``episodes`` with JAX's ask noise and reset
  draws injected, a gentle population as in ``tests/test_torch_pgpe.py``):
  scores ``atol=1e-4`` with equal ranks, the state ``rtol=1e-4,
  atol=1e-6``, env steps exactly.
- The per-rank form with ``stats_sync`` (statistics merged every step)
  against the one-rank run: the JAX package's own tolerance for that case
  (``tests/test_vecrl.py``, step sync against unsharded): scores
  ``atol=2e-2``, the observation count exactly, the mean ``rtol=atol=1e-4``.
  Both start from made-up statistics of 50 observations (as in
  ``tests/test_torch_vecne.py``): from none, the first update sees
  near-identical reset observations, the stdev hits its floor and
  normalization multiplies the merge's round-off by up to 1e4.
- Padding (popsize 10 over 3 ranks): the wire's ``lane_width`` and
  ``capacity`` count the 12 physical lanes, as the JAX package's do; every
  other counter, the scores and the health block count the 10 solutions.
- Per-group telemetry (``groups=``) over the ranks, against the one-rank
  grouped run: the scores, the ``(G, 20)`` wire (counters, histogram and
  health block) and the statistics bit for bit, in the default form (its
  refill lanes split over the ranks included: on the CPU a block of lanes
  rounds as the whole width does), the per-rank form and the sharded
  compaction without normalization, ``make_generation_step(mesh=,
  groups=)``, ``VecNE(solution_groups=, num_actors=)`` and
  ``EvalServer(mesh=)``; where the popsize is padded, row 0's group also
  holds the padding lanes' ``lane_width`` and ``capacity`` (the JAX
  package's rule), and where compaction narrows each rank's lanes apart,
  ``capacity`` counts each rank's own lanes. Against the JAX package's
  grouped evaluator on its 2-device mesh (CartPole, JAX's reset draws
  injected): every integer column exactly, the health block too (whole
  scores), the scores ``atol=1e-4``.
"""

import datetime
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from evotorch_tpu_torch import vectorized
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_ask_lowrank, pgpe_tell, pgpe_tell_lowrank
from evotorch_tpu_torch.core import Problem
from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian
from evotorch_tpu_torch.envs import CartPole, Humanoid
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import (
    FlatParamsPolicy,
    Linear,
    Tanh,
    run_vectorized_rollout,
    stats_init,
    stats_update,
)
from evotorch_tpu_torch.neuroevolution.net.runningnorm import group_stats_init, stats_psum
from evotorch_tpu_torch.neuroevolution.net.vecrl import (
    run_vectorized_rollout_compacting,
    run_vectorized_rollout_compacting_sharded,
)
from evotorch_tpu_torch.observability import GroupTelemetry
from evotorch_tpu_torch.observability.devicemetrics import compute_health_block
from evotorch_tpu_torch.parallel import (
    default_mesh,
    make_generation_step,
    make_mesh,
    make_sharded_evaluator,
    make_sharded_rollout_evaluator,
    make_training_span,
    mesh_label,
    parse_mesh_shape,
    population_spec,
)
from evotorch_tpu_torch.serving import EvalServer

#: seconds one spawn of ranks may take before it is killed and fails
RANK_TIMEOUT = 120
#: every collective of a rank's group
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
WORLDS = (2, 3)

POPSIZE, STEPS, GENERATIONS = 10, 3, 3
MODES = ("budget", "episodes", "episodes_refill")
PER_RANK_POPSIZE = 12  # divides over 2 and 3 ranks
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_NET = "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)"
NUM_GROUPS = 3
GROUPED_WIDTH = 6  # a refill width that divides over 2 and 3 ranks
CARTPOLE_N, CARTPOLE_STEPS = 37, 120  # the JAX comparison (tests/test_torch_contracts.py's sizes)


# ------------------------------------------------------------------ ranks


def _rank_main(world, rank, store, out_dir, cases, payload):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from evotorch_tpu_torch.parallel import init_distributed

    results = {}
    try:
        init_distributed(f"file://{store}", world_size=world, rank=rank, device="cpu", timeout=GROUP_TIMEOUT)
        for case in cases:
            results[case.__name__] = case(payload)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, os.path.join(out_dir, f"rank{rank}.pt"))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


class Spawn:
    """``cases`` (module-level functions ``case(payload) -> dict``) started
    on ``world`` gloo ranks; ``results()`` waits for them and returns each
    rank's ``{case name: result}``, failing if a rank fails or the spawn
    outlasts ``timeout`` seconds from its start."""

    def __init__(self, tmp_dir, world, cases, payload=None, timeout=RANK_TIMEOUT):
        self.world = world
        self.out_dir = os.path.join(str(tmp_dir), f"world{world}")
        os.makedirs(self.out_dir, exist_ok=True)
        store = os.path.join(self.out_dir, "store")
        ctx = mp.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, args=(world, r, store, self.out_dir, list(cases), payload), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self):
        try:
            while any(p.is_alive() for p in self.procs):
                if time.monotonic() > self.deadline:
                    raise AssertionError(f"{self.world} ranks outlasted their {self.timeout} s limit")
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break  # a rank failed: the others would wait for it
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.out_dir, f"rank{r}.pt")
            saved = torch.load(path, weights_only=False) if os.path.exists(path) else {"error": f"exit code {p.exitcode}"}
            if "error" in saved:
                raise AssertionError(f"rank {r} of {self.world} failed:\n{saved['error']}")
            results.append(saved)
        return results


# ------------------------------------------------------------------ setup


def _humanoid():
    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(Linear(env.observation_size, 8) >> Tanh() >> Linear(8, env.action_size))
    return env, policy


def _state(policy, center=None):
    if center is None:
        center = 0.01 * torch.randn(policy.parameter_count, generator=torch.Generator().manual_seed(4))
    return pgpe(
        center_init=torch.as_tensor(center), center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max",
        stdev_init=0.01,
    )  # fmt: skip


def _rollout_kw(mode, obs_norm):
    kw = dict(num_episodes=1, episode_length=STEPS, eval_mode=mode, observation_normalization=obs_norm)
    if mode == "episodes_refill":
        kw["refill_width"] = 4
    return kw


def _snapshot(state, scores, stats, steps, telemetry):
    return dict(
        scores=scores.clone(),
        center=state.optimizer_state.center.clone(),
        stdev=state.stdev.clone(),
        stats=torch.cat([stats.count.reshape(1), stats.sum, stats.sum_of_squares]),
        steps=int(steps),
        telemetry=telemetry.clone(),
    )


def _generations(mode, obs_norm, mesh, *, popsize=POPSIZE, eps=None, rows=None, center=None, lowrank=None, groups=None):
    """``GENERATIONS`` generations of the small Humanoid from one seed,
    sharded over ``mesh`` (None: one rank); ``eps``/``rows``: per-generation
    ask noise and reset tables to inject; ``lowrank``: a factored
    population of that rank; ``groups``: per-group telemetry over
    ``NUM_GROUPS`` groups."""
    env, policy = _humanoid()
    state = _state(policy, center)
    stats = stats_init(env.observation_size, device="cpu")
    generator = torch.Generator().manual_seed(0)
    out = []
    for i in range(GENERATIONS):
        kw = _rollout_kw(mode, obs_norm)
        if groups is not None:
            kw.update(groups=groups, num_groups=NUM_GROUPS)
        if rows is not None:
            kw["reset_noise"] = rows[i]
        if lowrank is not None:
            ask, tell = (lambda g, s: pgpe_ask_lowrank(g, s, popsize=popsize, rank=lowrank)), pgpe_tell_lowrank
        else:
            ask, tell = (lambda g, s, e=None if eps is None else eps[i]: pgpe_ask(g, s, popsize=popsize, eps=e)), pgpe_tell
        generation = make_generation_step(env, policy, ask=ask, tell=tell, popsize=popsize, mesh=mesh, device="cpu", **kw)
        state, scores, stats, steps, telemetry = generation(state, generator, stats)
        out.append(_snapshot(state, scores, stats, steps, telemetry))
    return out


def _assert_generations_close(ours, theirs):
    for i, (a, b) in enumerate(zip(ours, theirs)):
        where = f"generation {i}"
        np.testing.assert_allclose(a["scores"].numpy(), b["scores"].numpy(), **SCORE_TOL, err_msg=where)
        np.testing.assert_array_equal(np.argsort(a["scores"].numpy()), np.argsort(b["scores"].numpy()), err_msg=where)
        for key in ("center", "stdev"):
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), **STATE_TOL, err_msg=f"{where} {key}")
        np.testing.assert_allclose(a["stats"].numpy(), b["stats"].numpy(), **STATS_TOL, err_msg=f"{where} stats")
        assert a["steps"] == b["steps"], where


def _prior_stats(n):
    from evotorch_tpu_torch.neuroevolution.net import CollectedStats

    g = torch.Generator().manual_seed(6)
    return CollectedStats(torch.tensor(50.0), torch.randn(n, generator=g), 50.0 + torch.rand(n, generator=g))


def _counters(telemetry):
    t = GroupTelemetry.from_array(telemetry).total()
    return dict(env_steps=t.env_steps, episodes=t.episodes, refill_events=t.refill_events, queue_wait=t.queue_wait)


# ------------------------------------------------------------ rank cases


def case_mesh(payload):
    mesh = default_mesh()
    return dict(
        label=mesh_label(mesh), spec=population_spec(mesh), size=mesh.size, rank=mesh.rank, block=mesh.block(POPSIZE)
    )


def case_generations(payload):
    return {(mode, obs_norm): _generations(mode, obs_norm, default_mesh()) for mode in MODES for obs_norm in (False, True)}


def case_jax_injected(payload):
    return _generations(
        "episodes", False, default_mesh(), popsize=payload["popsize"], eps=payload["eps"], rows=payload["rows"],
        center=payload["center"],
    )  # fmt: skip


def case_lowrank(payload):
    return _generations("budget", True, default_mesh(), lowrank=4)


def case_stats_psum(payload):
    mesh = default_mesh()
    obs = payload["obs"]
    per = obs.shape[0] // mesh.size
    local = stats_update(stats_init(obs.shape[1], device="cpu"), obs[mesh.rank * per : (mesh.rank + 1) * per])
    merged = stats_psum(local, mesh)
    return torch.cat([merged.count.reshape(1), merged.sum, merged.sum_of_squares])


def case_padding(payload):
    env, policy = _humanoid()
    values = payload["values"]
    evaluate = make_sharded_rollout_evaluator(
        env, policy, num_episodes=1, episode_length=STEPS, eval_mode="budget", nonfinite_quarantine=True
    )
    result, per_shard = evaluate(values, torch.Generator().manual_seed(1), stats_init(env.observation_size, device="cpu"))
    return dict(scores=result.scores, steps=result.total_steps, episodes=int(result.total_episodes), telemetry=result.telemetry, per_shard=per_shard)


def case_per_rank(payload):
    env, policy = _humanoid()
    values = payload["per_rank_values"]
    out = {}
    for mode in MODES:
        for obs_norm, stats_sync in ((False, False), (True, False), (True, True)):
            kw = _rollout_kw(mode, obs_norm)
            if mode == "episodes_refill":
                kw["refill_width"] = 6
            evaluate = make_sharded_rollout_evaluator(env, policy, stats_sync=stats_sync, use_shard_map=True, **kw)
            result, per_shard = evaluate(values, torch.Generator().manual_seed(2), _prior_stats(env.observation_size))
            out[(mode, obs_norm, stats_sync)] = dict(
                scores=result.scores, stats=torch.cat([result.stats.count.reshape(1), result.stats.mean]),
                telemetry=result.telemetry, steps=result.total_steps, per_shard=per_shard,
            )  # fmt: skip
    try:
        make_sharded_rollout_evaluator(env, policy, use_shard_map=True, eval_mode="episodes_refill", refill_width=5)
    except ValueError as e:
        out["indivisible_width"] = str(e)
    return out


def case_compacting(payload):
    env, policy = _humanoid()
    result = run_vectorized_rollout_compacting_sharded(
        env, policy, payload["per_rank_values"], torch.Generator().manual_seed(3),
        stats_init(env.observation_size, device="cpu"), mesh=default_mesh(), num_episodes=1, episode_length=STEPS,
        chunk_size=1, allowed_widths=(2, 4),
    )  # fmt: skip
    return dict(scores=result.scores, steps=result.total_steps, telemetry=result.telemetry)


def case_sharded_evaluator(payload):
    evaluate = make_sharded_evaluator(lambda x: (x**2).sum(dim=-1), device="cpu")
    return evaluate(payload["values"])


@vectorized
def sum_of_squares(values):
    return (values**2).sum(dim=-1)


def _sub_mesh_runs(num_actors):
    """A vectorized objective through ``Problem(num_actors=)`` (an
    evaluation, then a sharded gradient estimate), two
    ``VecNE`` evaluations with normalization (reset draws from the
    problem's generator) and one under compaction (popsize 10: over 3 ranks
    it steps down to 2 shards, as in the JAX package; without
    normalization, whose statistics the sharded compaction merges per
    rank), each with its mesh's shard count and this rank's membership."""
    env, _ = _humanoid()
    out = {}
    problem = Problem("min", sum_of_squares, solution_length=6, initial_bounds=(-1, 1), device="cpu", num_actors=num_actors)
    batch = problem.generate_batch(POPSIZE)
    problem.evaluate(batch)
    mesh = problem._eval_mesh
    out["plain"] = dict(evals=batch.evals, mesh=None if mesh is None else (mesh.size, mesh.member))
    params = {"mu": torch.full((6,), 0.5), "sigma": torch.ones(6)}
    grads = problem.sample_and_compute_gradients(SymmetricSeparableGaussian(params), 12, ranking_method="centered")[0]
    out["grads"] = dict(grads["gradients"], mean_eval=grads["mean_eval"])
    for mode in ("episodes", "episodes_compact"):
        vecne = VecNE(
            env, SMALL_NET, episode_length=STEPS, observation_normalization=mode == "episodes", eval_mode=mode,
            num_actors=num_actors, device="cpu", seed=1,
        )  # fmt: skip
        scores = []
        for _ in range(2 if mode == "episodes" else 1):
            batch = vecne.generate_batch(POPSIZE)
            vecne.evaluate(batch)
            scores.append(batch.evals[:, 0])
        stats = vecne.obs_norm.stats
        mesh = vecne._num_actors_mesh(POPSIZE)
        out[mode] = dict(
            scores=torch.stack(scores), stats=torch.cat([stats.count.reshape(1), stats.sum, stats.sum_of_squares]),
            counters=(int(vecne.status["total_interaction_count"]), int(vecne.status["total_episode_count"])),
            generator=vecne.generator.get_state(), mesh=None if mesh is None else (mesh.size, mesh.member),
        )  # fmt: skip
    return out


def case_num_actors_below_world(payload):
    return _sub_mesh_runs(2)


def trunk_delta_generations(mesh):
    """Two trunk-delta generations of a small Pendulum policy (26
    parameters, rank 4) over ``mesh`` (None: one rank), with the bytes of
    the trunk arrays each gather found at rest and rebuilt. The rank case of
    ``tests/test_torch_trunk_delta.py`` (kept here: a rank case imports no
    JAX)."""
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask_trunk_delta, pgpe_tell_trunk_delta
    from evotorch_tpu_torch.envs import Pendulum
    from evotorch_tpu_torch.parallel import evaluate, mesh as mesh_module

    env = Pendulum(device="cpu")
    policy = FlatParamsPolicy(Linear(env.observation_size, 5) >> Tanh() >> Linear(5, env.action_size))
    seen = []
    real_gather = evaluate.gather_trunk

    def gather(shard, m):
        whole = real_gather(shard, m)
        seen.append((mesh_module.trunk_nbytes(shard), mesh_module.trunk_nbytes(whole)))
        return whole

    evaluate.gather_trunk = gather
    try:
        generation = make_generation_step(
            env, policy, ask=lambda g, s: pgpe_ask_trunk_delta(g, s, popsize=POPSIZE, rank=4, policy=policy),
            tell=pgpe_tell_trunk_delta, popsize=POPSIZE, mesh=mesh, device="cpu", num_episodes=1,
            episode_length=STEPS, eval_mode="budget", observation_normalization=True,
        )  # fmt: skip
        state = _state(policy, center=0.1 * torch.randn(policy.parameter_count, generator=torch.Generator().manual_seed(4)))
        stats, generator, out = stats_init(env.observation_size, device="cpu"), torch.Generator().manual_seed(0), []
        for _ in range(2):
            state, scores, stats, steps, telemetry = generation(state, generator, stats)
            out.append(_snapshot(state, scores, stats, steps, telemetry))
    finally:
        evaluate.gather_trunk = real_gather
    return dict(generations=out, trunk_bytes=seen, parameters=policy.parameter_count)


def case_trunk_model_axis(payload):
    return {shape: trunk_delta_generations(make_mesh(dict(shape))) for shape in ((("pop", 2), ("model", 2)), (("pop", 4),))}


def case_dryrun(payload):
    from evotorch_tpu_torch.parallel import dryrun_multihost

    return dryrun_multihost(popsize=10, episode_length=5, generations=2, device="cpu")


TUNED_WIDTH = 6  # the cached refill width: global, not the default (12) at popsize 12


def _save_tuned_refill(path, label):
    """A refill entry for the small Humanoid at PER_RANK_POPSIZE under the
    mesh label ``label`` on this machine's CPU."""
    from evotorch_tpu_torch.observability.timings import TunedEntry, machine_fingerprint, save_tuned_entry

    _, policy = _humanoid()
    shape = {
        "env": "humanoid", "popsize": PER_RANK_POPSIZE, "episode_length": STEPS, "num_episodes": 1,
        "params": policy.parameter_count, "dtype": "float32", "mesh": label,
    }  # fmt: skip
    entry = TunedEntry("refill", shape, machine_fingerprint("cpu"), {"width": TUNED_WIDTH, "period": 1}, {"steps_per_sec": 1.0})
    save_tuned_entry(entry, path)


def _tuned_refill_sources(values):
    """Both forms of the sharded rollout evaluator over the default mesh
    (the tuned cache at ``EVOTORCH_TUNED_CACHE``): for each case, the
    source before the first evaluation, after it, and the wire's lane
    width. The cached popsize hits; another popsize falls back; an
    explicit width or period overrides."""
    env, policy = _humanoid()
    stats = stats_init(env.observation_size, device="cpu")
    out = {}
    for per_rank in (False, True):
        for n, extra in ((PER_RANK_POPSIZE, {}), (6, {}), (PER_RANK_POPSIZE, {"refill_width": 6}), (PER_RANK_POPSIZE, {"refill_period": 2})):
            evaluate = make_sharded_rollout_evaluator(
                env, policy, use_shard_map=per_rank, num_episodes=1, episode_length=STEPS, eval_mode="episodes_refill",
                **extra,
            )  # fmt: skip
            before = evaluate.tuned_config_source
            result, _ = evaluate(values[:n], torch.Generator().manual_seed(2), stats)
            width = GroupTelemetry.from_array(result.telemetry).total().lane_width
            out[(per_rank, n, tuple(extra))] = (before, evaluate.tuned_config_source, width)
    return out


def case_tuned_refill(payload):
    os.environ["EVOTORCH_TUNED_CACHE"] = payload["tuned_cache"]
    return _tuned_refill_sources(payload["per_rank_values"])


# ------------------------------------------------ per-group rows over ranks


def _group_ids(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, NUM_GROUPS, size=n))


def _grouped_kw(mode, obs_norm, groups):
    kw = dict(_rollout_kw(mode, obs_norm), groups=groups, num_groups=NUM_GROUPS)
    if mode == "episodes_refill":
        kw["refill_width"] = GROUPED_WIDTH
    return kw


def _flat_stats(stats):
    return torch.cat([stats.count.reshape(-1), stats.sum.reshape(-1), stats.sum_of_squares.reshape(-1)])


def _grouped_out(result):
    return dict(scores=result.scores, telemetry=result.telemetry, steps=result.total_steps, stats=_flat_stats(result.stats))


def _grouped_runs(mesh, payload):
    """Every grouped form on the small Humanoid over ``mesh`` (None: the
    one-rank run of each): the default form under each contract with
    normalization off and on, the default form's refill with stacked
    statistics, the per-rank form and the sharded compaction (each also
    ungrouped, for the column sums), and ``GENERATIONS`` generations of
    ``make_generation_step(mesh=, groups=)``."""
    env, policy = _humanoid()
    values, values12 = payload["values"], payload["per_rank_values"]
    groups, groups12 = _group_ids(POPSIZE), _group_ids(PER_RANK_POPSIZE, seed=1)
    out = {}

    def run(values, stats, seed, use_shard_map=False, **kw):
        if mesh is None:
            return run_vectorized_rollout(env, policy, values, torch.Generator().manual_seed(seed), stats, **kw)
        evaluate = make_sharded_rollout_evaluator(env, policy, mesh=mesh, use_shard_map=use_shard_map, **kw)
        return evaluate(values, torch.Generator().manual_seed(seed), stats)[0]

    for mode in MODES:
        for obs_norm in (False, True):
            stats = stats_init(env.observation_size, device="cpu")
            out[("default", mode, obs_norm)] = _grouped_out(run(values, stats, 7, **_grouped_kw(mode, obs_norm, groups)))
        kw = _grouped_kw(mode, False, groups12)
        out[("per_rank", mode)] = _grouped_out(run(values12, _prior_stats(env.observation_size), 2, use_shard_map=True, **kw))
        del kw["groups"], kw["num_groups"]
        out[("per_rank_ungrouped", mode)] = _grouped_out(
            run(values12, _prior_stats(env.observation_size), 2, use_shard_map=True, **kw)
        )
    stacked = group_stats_init(NUM_GROUPS, env.observation_size, device="cpu")
    out["stacked"] = _grouped_out(run(values, stacked, 8, **_grouped_kw("episodes_refill", True, groups)))
    for key, grouping in (("compact", dict(groups=groups12, num_groups=NUM_GROUPS)), ("compact_ungrouped", {})):
        kw = dict(num_episodes=1, episode_length=STEPS, chunk_size=1, allowed_widths=(2, 4), **grouping)
        stats, generator = stats_init(env.observation_size, device="cpu"), torch.Generator().manual_seed(3)
        if mesh is None:
            result = run_vectorized_rollout_compacting(env, policy, values12, generator, stats, **kw)
        else:
            result = run_vectorized_rollout_compacting_sharded(env, policy, values12, generator, stats, mesh=mesh, **kw)
        out[key] = _grouped_out(result)
    for mode in MODES:
        out[("generation", mode)] = _generations(mode, True, mesh, groups=groups)
    span = make_training_span(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE, span=GENERATIONS,
        mesh=mesh, device="cpu", groups=groups, num_groups=NUM_GROUPS, **_rollout_kw("budget", True),
    )  # fmt: skip
    generator = torch.Generator().manual_seed(0)
    _, scores, _, _, telemetry = span(_state(policy), [generator] * GENERATIONS, stats_init(env.observation_size, device="cpu"))
    out["span"] = dict(scores=scores, telemetry=telemetry)
    return out


def case_grouped(payload):
    return _grouped_runs(default_mesh(), payload)


def _grouped_vecne(num_actors):
    """``VecNE(solution_groups=...)`` (``ROADMAP.md`` C.13's reproduction:
    CartPole, ``Linear(obs_length, act_length)``, groups of 3 and 5) under
    each contract (refill at 4 lanes, so that items wait), two evaluations
    each: the ``eval_g*`` status keys, the latest wire and the generator's
    state."""
    out = {}
    for mode in ("episodes", "episodes_refill", "episodes_compact", "budget"):
        problem = VecNE(
            "cartpole", "Linear(obs_length, act_length)", eval_mode=mode, episode_length=50,
            refill_config={"width": 4} if mode == "episodes_refill" else None,
            solution_groups=[0, 0, 0, 1, 1, 1, 1, 1], num_actors=num_actors, device="cpu", seed=1,
        )  # fmt: skip
        for _ in range(2):
            problem.evaluate(problem.generate_batch(8))
        keys = {k: v for k, v in problem.status.items() if k.startswith("eval_g")}
        out[mode] = dict(keys=keys, wire=problem._pending_telemetry, generator=problem.generator.get_state())
    return out


def case_grouped_vecne(payload):
    return {num_actors: _grouped_vecne(num_actors) for num_actors in (2, "max")}


def _grouped_jax_port(mesh, payload):
    """The port's side of the JAX comparison: the grouped evaluator on
    CartPole (``episodes``, 120 steps) with JAX's reset draws injected."""
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(Linear(4, 1) >> Tanh())
    kw = dict(num_episodes=1, episode_length=CARTPOLE_STEPS, eval_mode="episodes")
    evaluate = make_sharded_rollout_evaluator(env, policy, mesh=mesh, groups=payload["cartpole_groups"], num_groups=4, **kw)
    result, _ = evaluate(payload["cartpole_params"], torch.Generator(), None, reset_noise=payload["cartpole_rows"])
    return dict(scores=result.scores, telemetry=result.telemetry)


def case_grouped_jax(payload):
    return _grouped_jax_port(default_mesh(), payload)


def _grouped_server(mesh):
    """Two CartPole tenants (8 and 7 rows) on one ``EvalServer`` over
    ``mesh`` (None: one rank), a slab of 12 at refill width 6 with
    per-tenant normalization, so that one tenant's items span two
    dispatches: each tenant's scores, wire and normalization slot, the
    last dispatch's whole wire, the program key and the dispatch count."""
    env = CartPole(continuous_actions=True, device="cpu")
    policy = FlatParamsPolicy(Linear(4, 1) >> Tanh())
    server = EvalServer(
        env, policy, slab_size=12, max_tenants=2, refill_width=GROUPED_WIDTH, episode_length=CARTPOLE_STEPS,
        observation_normalization=True, mesh=mesh, device="cpu",
    )  # fmt: skip
    rng = np.random.default_rng(13)
    futures = {}
    for name, rows in (("a", 8), ("b", 7)):
        tenant = server.admit(name)
        values = rng.normal(size=(rows, policy.parameter_count)).astype(np.float32)
        futures[name] = (tenant, server.submit(tenant, values, torch.Generator().manual_seed(len(futures) + 11)))
    dispatches = server.drain()
    out = dict(key=server.program.key, dispatches=dispatches, last=server.last_telemetry.to_wire())
    for name, (tenant, future) in futures.items():
        result = future.result()
        out[name] = dict(scores=result.scores, telemetry=result.telemetry, stats=_flat_stats(server.tenant_stats(tenant)))
    return out


def case_grouped_server(payload):
    return _grouped_server(default_mesh())


CASES = (
    case_mesh,
    case_generations,
    case_jax_injected,
    case_lowrank,
    case_stats_psum,
    case_padding,
    case_per_rank,
    case_compacting,
    case_sharded_evaluator,
    case_num_actors_below_world,
    case_dryrun,
    case_tuned_refill,
    case_grouped,
    case_grouped_vecne,
    case_grouped_jax,
    case_grouped_server,
)


# ------------------------------------------------------------ JAX side


def _jax_injected_runs():
    """The JAX package's sharded ``episodes`` generations on its 8-device CPU
    mesh (popsize 8, the small Humanoid, gentle population), and the ask
    noise and reset draws they use, to inject into the port: returns the
    payload and a function that runs the JAX generations."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
    from evotorch_tpu.algorithms.functional import pgpe_ask as jax_pgpe_ask
    from evotorch_tpu.algorithms.functional import pgpe_tell as jax_pgpe_tell
    from evotorch_tpu.envs import Humanoid as JaxHumanoid
    from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
    from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
    from evotorch_tpu.neuroevolution.net import Tanh as JaxTanh
    from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm
    from evotorch_tpu.parallel import make_generation_step as jax_make_generation_step

    popsize = 8
    env = JaxHumanoid()
    policy = JaxFlatParamsPolicy(JaxLinear(env.observation_size, 8) >> JaxTanh() >> JaxLinear(8, env.action_size))
    L = policy.parameter_count
    center = (0.01 * np.random.default_rng(5).normal(size=L)).astype(np.float32)
    generation = jax_make_generation_step(
        env, policy, ask=lambda k, s: jax_pgpe_ask(k, s, popsize=popsize), tell=jax_pgpe_tell, popsize=popsize,
        mesh=Mesh(np.asarray(jax.devices()[:8]), ("pop",)), num_episodes=1, episode_length=STEPS, eval_mode="episodes",
    )  # fmt: skip
    state = jax_pgpe(
        center_init=jnp.asarray(center), center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max",
        stdev_init=0.01,
    )  # fmt: skip
    stats = RunningNorm(env.observation_size).stats
    nb = Humanoid(device="cpu").sys.num_bodies

    def reset_rows(key):
        def draws(lane):
            parts = jax.random.split(jax.random.split(jax.random.fold_in(key, lane), 2)[1], 3)
            return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

        return torch.from_numpy(np.array(jax.vmap(draws)(jnp.arange(popsize, dtype=jnp.int32))))

    keys = [jax.random.key(100 + i) for i in range(GENERATIONS)]
    eps, rows = [], []
    for key in keys:
        k_ask, k_eval = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(k_ask, (popsize // 2, L), dtype=jnp.float32))))
        rows.append(reset_rows(k_eval))

    def run():
        nonlocal state, stats
        theirs = []
        for key in keys:
            state, scores, stats, steps, _ = generation(state, key, stats)
            theirs.append(
                dict(
                    scores=np.asarray(scores), center=np.asarray(state.optimizer_state.center),
                    stdev=np.asarray(state.stdev), steps=int(steps),
                )  # fmt: skip
            )
        return theirs

    return dict(popsize=popsize, eps=eps, rows=rows, center=torch.from_numpy(center)), run


def _jax_grouped_run():
    """The JAX package's grouped sharded evaluator on a 2-device CPU mesh
    (CartPole, ``episodes``, 120 steps, 4 groups), and the parameters, ids
    and reset draws to give the port: returns the payload entries and the
    JAX result's scores and wire."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from evotorch_tpu.envs import CartPole as JaxCartPole
    from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
    from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
    from evotorch_tpu.neuroevolution.net import Tanh as JaxTanh
    from evotorch_tpu.neuroevolution.net.runningnorm import RunningNorm
    from evotorch_tpu.parallel import make_sharded_rollout_evaluator as jax_make_sharded_rollout_evaluator
    from test_torch_contracts import _cartpole_rows

    rng = np.random.default_rng(17)
    params = rng.normal(size=(CARTPOLE_N, 5)).astype(np.float32)
    groups = rng.integers(0, 4, size=CARTPOLE_N).astype(np.int32)
    key = jax.random.key(24)
    evaluate = jax_make_sharded_rollout_evaluator(
        JaxCartPole(continuous_actions=True), JaxFlatParamsPolicy(JaxLinear(4, 1) >> JaxTanh()),
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("pop",)), num_episodes=1, episode_length=CARTPOLE_STEPS,
        eval_mode="episodes", groups=jnp.asarray(groups), num_groups=4,
    )  # fmt: skip
    result, _ = evaluate(jnp.asarray(params), key, RunningNorm(4).stats)
    payload = dict(
        cartpole_params=torch.from_numpy(params), cartpole_groups=torch.from_numpy(groups.astype(np.int64)),
        cartpole_rows=torch.from_numpy(_cartpole_rows(key, CARTPOLE_N)),
    )  # fmt: skip
    return payload, dict(scores=np.asarray(result.scores), telemetry=np.asarray(result.telemetry))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the module on 2 and on 3 gloo ranks (both spawns run
    at once, while the JAX package's run is made here), the payload they
    were given, and the JAX run."""
    rng = np.random.default_rng(9)
    env, policy = _humanoid()
    L = policy.parameter_count
    jax_payload, run_jax = _jax_injected_runs()
    grouped_payload, jax_grouped = _jax_grouped_run()
    payload = dict(
        jax_payload,
        **grouped_payload,
        obs=torch.from_numpy(rng.normal(size=(12, 7)).astype(np.float32)),
        values=torch.from_numpy((0.01 * rng.normal(size=(POPSIZE, L))).astype(np.float32)),
        per_rank_values=torch.from_numpy((0.01 * rng.normal(size=(PER_RANK_POPSIZE, L))).astype(np.float32)),
    )
    tmp = tmp_path_factory.mktemp("ranks")
    payload["tuned_cache"] = str(tmp / "tuned_configs.json")
    for world in WORLDS:
        _save_tuned_refill(payload["tuned_cache"], f"pop{world}")
    spawns = {world: Spawn(tmp, world, CASES, payload) for world in WORLDS}
    jax_results = run_jax()
    return dict(
        results={world: spawn.results() for world, spawn in spawns.items()}, payload=payload, jax=jax_results,
        jax_grouped=jax_grouped,
    )  # fmt: skip


def _each_rank(ranks, case):
    for world in WORLDS:
        for rank, saved in enumerate(ranks["results"][world]):
            yield world, rank, saved[case]


# ------------------------------------------------------------------ tests


def test_mesh_shape_forms_match_jax():
    """``parse_mesh_shape`` and ``mesh_label`` give the JAX package's forms
    (``tests/test_gspmd.py``); labels of shapes larger than this process's
    world are taken from the shape dict."""
    from evotorch_tpu.parallel import make_mesh as jax_make_mesh
    from evotorch_tpu.parallel import mesh_label as jax_mesh_label
    from evotorch_tpu.parallel import parse_mesh_shape as jax_parse_mesh_shape

    for spec in ("8", 8, "4x2", "pop=4,model=2", "2"):
        assert parse_mesh_shape(spec) == jax_parse_mesh_shape(spec)
    for bad in ("2x2x2",):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)
    for shape in ({"pop": 8}, {"pop": 4, "model": 2}, {"pop": 8, "model": 1}, {"pop": 1, "model": 1}):
        assert mesh_label(shape) == jax_mesh_label(jax_make_mesh(shape))
    assert mesh_label(None) == "none" == mesh_label(default_mesh())
    assert mesh_label(make_mesh({"pop": 1, "model": 1})) == "none"
    with pytest.raises(ValueError, match="ranks"):
        make_mesh({"pop": 2})


def test_mesh_over_ranks(ranks):
    for world, rank, got in _each_rank(ranks, "case_mesh"):
        per = -(-POPSIZE // world)
        assert got["label"] == f"pop{world}" and got["spec"] == ("pop",) and got["size"] == world and got["rank"] == rank
        assert got["block"] == (min(rank * per, POPSIZE), min(rank * per + per, POPSIZE), per)


@pytest.mark.parametrize("obs_norm", [False, True], ids=["plain", "obs_norm"])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_generations_equal_one_rank(ranks, mode, obs_norm):
    """Three generations of the small Humanoid, popsize 10 (padded to 12
    over 3 ranks): every rank's scores, center, stdev, statistics and env
    steps equal the one-rank run's, and the wire's counters too."""
    one = _generations(mode, obs_norm, None)
    for world, rank, got in _each_rank(ranks, "case_generations"):
        ours = got[(mode, obs_norm)]
        _assert_generations_close(ours, one)
        for a, b in zip(ours, one):
            assert _counters(a["telemetry"]) == _counters(b["telemetry"]), (world, rank)
            stats = GroupTelemetry.from_array(a["telemetry"]).score_stats()
            assert stats["count"] == POPSIZE


def test_sharded_episodes_generation_matches_jax_mesh(ranks):
    """The ``episodes`` generation against the JAX package's on its
    8-device mesh, with JAX's ask noise and reset draws injected (the
    tables are global: each rank takes its rows)."""
    theirs = ranks["jax"]
    for world, rank, ours in _each_rank(ranks, "case_jax_injected"):
        for i, (a, b) in enumerate(zip(ours, theirs)):
            np.testing.assert_allclose(a["scores"].numpy(), b["scores"], rtol=0, atol=1e-4, err_msg=f"{world} {i}")
            np.testing.assert_array_equal(np.argsort(a["scores"].numpy()), np.argsort(b["scores"]))
            np.testing.assert_allclose(a["center"].numpy(), b["center"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a["stdev"].numpy(), b["stdev"], rtol=1e-4, atol=1e-6)
            assert a["steps"] == b["steps"]


def test_sharded_lowrank_generation_equals_one_rank(ranks):
    """A factored (low-rank) population's coefficient rows split over the
    ranks; center and basis stay whole on each."""
    one = _generations("budget", True, None, lowrank=4)
    for _, _, ours in _each_rank(ranks, "case_lowrank"):
        _assert_generations_close(ours, one)


def test_stats_psum_equals_global_cohort(ranks):
    obs = ranks["payload"]["obs"]
    whole = stats_update(stats_init(obs.shape[1], device="cpu"), obs)
    expected = torch.cat([whole.count.reshape(1), whole.sum, whole.sum_of_squares])
    for world, _, got in _each_rank(ranks, "case_stats_psum"):
        if obs.shape[0] % world == 0:
            np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=1e-6, atol=1e-6)


def test_padding_is_masked_out_of_the_wire(ranks):
    """Popsize 10 over 3 ranks pads to 12 lanes: the padding earns no score,
    env step, episode, quarantine count or health entry; ``lane_width`` and
    ``capacity`` count the physical lanes (the JAX package's rule,
    ``tests/test_gspmd.py``)."""
    env, policy = _humanoid()
    values = ranks["payload"]["values"]
    one = run_vectorized_rollout(
        env, policy, values, torch.Generator().manual_seed(1), stats_init(env.observation_size, device="cpu"),
        num_episodes=1, episode_length=STEPS, eval_mode="budget", nonfinite_quarantine=True,
    )  # fmt: skip
    for world, _, got in _each_rank(ranks, "case_padding"):
        lanes = -(-POPSIZE // world) * world
        np.testing.assert_array_equal(got["scores"].numpy(), one.scores.numpy())
        assert got["steps"] == one.total_steps == POPSIZE * STEPS and got["episodes"] == int(one.total_episodes)
        wire = GroupTelemetry.from_array(got["telemetry"])
        total = wire.total()
        assert total.env_steps == POPSIZE * STEPS and total.nonfinite == 0
        assert total.lane_width == lanes and total.capacity == lanes * STEPS
        assert wire.score_stats()["count"] == POPSIZE
        np.testing.assert_allclose(wire.score_stats()["mean"], float(one.scores.mean()), rtol=1e-6)
        assert got["per_shard"].tolist() == [POPSIZE * STEPS]


@pytest.mark.parametrize("mode", MODES)
def test_per_rank_form_equals_one_rank_without_normalization(ranks, mode):
    """``use_shard_map=True``: each rank's rollout on its rows (its own
    refill queue), global lane ids and tables: without normalization the
    scores and counters equal the one-rank run's."""
    env, policy = _humanoid()
    values = ranks["payload"]["per_rank_values"]
    kw = _rollout_kw(mode, False)
    one = run_vectorized_rollout(env, policy, values, torch.Generator().manual_seed(2), _prior_stats(env.observation_size), **kw)
    for world, rank, got in _each_rank(ranks, "case_per_rank"):
        ours = got[(mode, False, False)]
        np.testing.assert_array_equal(ours["scores"].numpy(), one.scores.numpy())
        assert ours["steps"] == one.total_steps
        assert _counters(ours["telemetry"])["env_steps"] == one.total_steps
        assert _counters(ours["telemetry"])["episodes"] == int(one.total_episodes)
        assert ours["per_shard"].shape == (world,) and int(ours["per_shard"].sum()) == one.total_steps


@pytest.mark.parametrize("mode", MODES)
def test_per_rank_form_statistics_cohort_and_step(ranks, mode):
    """With normalization the per-rank form normalizes by each rank's own
    statistics (merged at the end: every observation counted once, the
    scores differ by design) or, with ``stats_sync``, by every rank's,
    merged each step: then the scores equal the one-rank run's to the JAX
    package's tolerance for step sync (see the module note). Not under
    ``episodes_refill``: per-rank queues run another schedule than the one
    queue, so the lanes see other statistics mid-rollout (the JAX engine's
    documented schedule-dependent cohort); the count still matches."""
    env, policy = _humanoid()
    values = ranks["payload"]["per_rank_values"]
    one = run_vectorized_rollout(
        env, policy, values, torch.Generator().manual_seed(2), _prior_stats(env.observation_size),
        **_rollout_kw(mode, True),
    )  # fmt: skip
    for world, _, got in _each_rank(ranks, "case_per_rank"):
        cohort, step = got[(mode, True, False)], got[(mode, True, True)]
        for form in (cohort, step):
            assert float(form["stats"][0]) == float(one.stats.count)
        if mode != "episodes_refill":
            np.testing.assert_allclose(step["scores"].numpy(), one.scores.numpy(), rtol=0, atol=2e-2)
            np.testing.assert_allclose(step["stats"][1:].numpy(), one.stats.mean.numpy(), rtol=1e-4, atol=1e-4)
        assert not np.array_equal(cohort["scores"].numpy(), one.scores.numpy())
        assert "divisible" in got["indivisible_width"]


def test_compacting_sharded_equals_episodes(ranks):
    env, policy = _humanoid()
    values = ranks["payload"]["per_rank_values"]
    one = run_vectorized_rollout(
        env, policy, values, torch.Generator().manual_seed(3), stats_init(env.observation_size, device="cpu"),
        num_episodes=1, episode_length=STEPS,
    )  # fmt: skip
    for _, _, got in _each_rank(ranks, "case_compacting"):
        np.testing.assert_array_equal(got["scores"].numpy(), one.scores.numpy())
        assert got["steps"] == one.total_steps
        assert _counters(got["telemetry"])["episodes"] == PER_RANK_POPSIZE


def test_sharded_evaluator_gathers_every_row(ranks):
    values = ranks["payload"]["values"]
    for _, _, got in _each_rank(ranks, "case_sharded_evaluator"):
        np.testing.assert_array_equal(got.numpy(), (values**2).sum(dim=-1).numpy())


def test_dryrun_multihost_agrees_with_one_rank(ranks):
    """``dryrun_multihost`` (the CLI's body) on 2 and 3 ranks reports the
    one-rank run's global figures on every rank."""
    from evotorch_tpu_torch.parallel import dryrun_multihost

    one = dryrun_multihost(popsize=10, episode_length=5, generations=2, device="cpu")
    for world, rank, got in _each_rank(ranks, "case_dryrun"):
        assert (got["process_index"], got["process_count"], got["mesh"], got["devices"]) == (rank, world, f"pop{world}", world)
        for key in ("total_steps", "mean_score", "stdev_norm", "popsize", "generations"):
            assert got[key] == one[key], key


def test_one_rank_mesh_runs_the_sharded_path():
    """Without a process group a mesh has one rank and its collectives are
    the identity: the sharded generation equals the plain one bit for
    bit."""
    for mode in MODES:
        a, b = _generations(mode, True, default_mesh()), _generations(mode, True, None)
        for x, y in zip(a, b):
            for key in ("scores", "center", "stats", "telemetry"):
                assert torch.equal(x[key], y[key]), (mode, key)


def test_sharded_entry_points_default_to_the_card(monkeypatch):
    """No card and no ``device="cpu"``: the sharded entry points raise, and
    so does ``init_distributed`` (it does not drop to the CPU)."""
    from evotorch_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, policy = _humanoid()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_sharded_evaluator(lambda x: x.sum(-1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_generation_step(env, policy, ask=None, tell=None, popsize=4, mesh=default_mesh())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_distributed("file:///nonexistent/store", world_size=1, rank=0)
    assert init_distributed() is False  # no launcher environment: a single process, untouched


def test_num_actors_below_the_world_size(ranks):
    """``num_actors=2`` over 3 ranks: the first two evaluate over a
    sub-group, the third takes their result through one ``all_reduce``;
    every rank holds the one-rank run's evals, statistics, counters and
    generator state bit for bit (the plain evaluator and the rollout
    evaluator). Under compaction popsize 10 steps down to 2 shards over 3
    ranks (and over 2), as in the JAX package."""
    one = _sub_mesh_runs(None)
    assert one["plain"]["mesh"] is None and one["episodes"]["mesh"] is None
    for world, rank, got in _each_rank(ranks, "case_num_actors_below_world"):
        where = f"world {world} rank {rank}"
        assert got["plain"]["mesh"] == (2, rank < 2), where
        assert torch.equal(got["plain"]["evals"], one["plain"]["evals"]), where
        # the sharded gradient pipeline against the one-rank one, at
        # tests/test_torch_distributed_oo.py's tolerance
        for key, value in one["grads"].items():
            np.testing.assert_allclose(got["grads"][key].numpy(), value.numpy(), atol=1e-5, err_msg=f"{where} {key}")
        for mode in ("episodes", "episodes_compact"):
            assert got[mode]["mesh"] == (2, rank < 2), (where, mode)
            for key in ("scores", "stats", "generator"):
                assert torch.equal(got[mode][key], one[mode][key]), (where, mode, key)
            assert got[mode]["counters"] == one[mode]["counters"], (where, mode)


def _assert_tuned_sources(got, where):
    for per_rank in (False, True):
        key = f"{where} per_rank={per_rank}"
        assert got[(per_rank, PER_RANK_POPSIZE, ())] == (None, "cache", TUNED_WIDTH), key
        assert got[(per_rank, 6, ())][:2] == (None, "fallback"), key
        assert got[(per_rank, PER_RANK_POPSIZE, ("refill_width",))][:2] == (None, "override"), key
        # an explicit period skips the cache for the whole group: the
        # engine's default width (all 12 items), not the cached 6
        assert got[(per_rank, PER_RANK_POPSIZE, ("refill_period",))][:2] == (None, "override"), key
        assert got[(per_rank, PER_RANK_POPSIZE, ("refill_period",))][2] != TUNED_WIDTH, key


def test_sharded_evaluator_consults_the_tuned_cache_per_popsize(tmp_path, monkeypatch):
    """Counterpart of ``tests/test_autotune.py::
    test_sharded_evaluator_consults_cache_per_popsize`` at world size 1
    (a one-rank mesh, label ``none``): both forms report
    ``tuned_config_source`` per popsize and run at the cached global
    width."""
    monkeypatch.setenv("EVOTORCH_TUNED_CACHE", str(tmp_path / "tuned.json"))
    _save_tuned_refill(str(tmp_path / "tuned.json"), "none")
    values = 0.01 * torch.randn((PER_RANK_POPSIZE, _humanoid()[1].parameter_count), generator=torch.Generator().manual_seed(5))
    _assert_tuned_sources(_tuned_refill_sources(values), "world 1")


def test_sharded_evaluator_tuned_cache_over_ranks(ranks):
    """The same over 2 and 3 gloo ranks, each world's entry under its own
    mesh label (``pop2``, ``pop3``): the cached width is global, floored per
    rank under the per-rank form, and the summed wire counts it whole."""
    for world, rank, got in _each_rank(ranks, "case_tuned_refill"):
        _assert_tuned_sources(got, f"world {world} rank {rank}")


# ------------------------------------------------ per-group rows over ranks


_COL = {name: i for i, name in enumerate(("env_steps", "episodes", "capacity", "lane_width"))}


def _padded(one, pad_lanes, pad_group):
    """The one-rank wire with ``pad_lanes`` padding lanes charged to
    ``pad_group``: each adds a lane to its ``lane_width`` and the
    evaluation's steps a lane to its ``capacity`` (the JAX package's
    rule)."""
    wire = one.clone()
    steps = int(one[:, _COL["capacity"]].sum()) // int(one[:, _COL["lane_width"]].sum())
    wire[pad_group, _COL["lane_width"]] += pad_lanes
    wire[pad_group, _COL["capacity"]] += pad_lanes * steps
    return wire


def _pad_lanes(world, n=POPSIZE):
    return -(-n // world) * world - n


def _assert_rows(ours, theirs, columns, where):
    """The named integer columns, and the health block, exactly."""
    cols = [_COL[c] if c in _COL else c for c in columns]
    np.testing.assert_array_equal(ours[:, cols].numpy(), theirs[:, cols].numpy(), err_msg=where)
    np.testing.assert_array_equal(ours[:, 15:].numpy(), theirs[:, 15:].numpy(), err_msg=f"{where} health")


@pytest.fixture(scope="module")
def grouped_one(ranks):
    return _grouped_runs(None, ranks["payload"])


@pytest.mark.parametrize("obs_norm", [False, True], ids=["plain", "obs_norm"])
@pytest.mark.parametrize("mode", MODES)
def test_grouped_default_form_equals_one_rank(ranks, grouped_one, mode, obs_norm):
    """C.14: ``make_sharded_rollout_evaluator(groups=, num_groups=)``, the
    default form, at 2 and 3 ranks: the scores, statistics and the ``(3,
    20)`` wire of the one-rank grouped run bit for bit (refill's 6 lanes
    split 3 + 3 and 2 + 2 + 2), the padding lanes of popsize 10 over 3
    ranks charged to row 0's group."""
    one = grouped_one[("default", mode, obs_norm)]
    groups = _group_ids(POPSIZE)
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        ours, where = got[("default", mode, obs_norm)], f"world {world} rank {rank}"
        assert torch.equal(ours["scores"], one["scores"]), where
        assert torch.equal(ours["stats"], one["stats"]), where
        assert ours["steps"] == one["steps"], where
        pad = 0 if mode == "episodes_refill" else _pad_lanes(world)
        assert torch.equal(ours["telemetry"], _padded(one["telemetry"], pad, int(groups[0]))), where
        assert ours["telemetry"].shape == (NUM_GROUPS, 20)


def test_grouped_refill_with_stacked_statistics_equals_one_rank(ranks, grouped_one):
    """Stacked (per-group) statistics under the default form's refill: each
    step's observations of every rank gathered into the one-rank update,
    so the slots, scores and wire are the one-rank run's bit for bit."""
    one = grouped_one["stacked"]
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        for key in ("scores", "stats", "telemetry"):
            assert torch.equal(got["stacked"][key], one[key]), (world, rank, key)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_per_rank_form_equals_one_rank(ranks, grouped_one, mode):
    """The per-rank form with groups: the scores bit for bit; each group's
    env steps, episodes, quarantine count and health block exactly; the
    other rows sum to the ungrouped per-rank wire (each rank's own queue
    schedules otherwise than the one queue)."""
    one = grouped_one[("per_rank", mode)]
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        ours, where = got[("per_rank", mode)], f"world {world} rank {rank}"
        assert torch.equal(ours["scores"], one["scores"]), where
        _assert_rows(ours["telemetry"], one["telemetry"], ("env_steps", "episodes", 6), where)
        ungrouped = got[("per_rank_ungrouped", mode)]["telemetry"]
        assert torch.equal(ours["telemetry"][:, :15].sum(0), ungrouped[0, :15]), where


def test_grouped_sharded_compaction_equals_one_rank(ranks, grouped_one):
    """``run_vectorized_rollout_compacting_sharded(groups=)``: the scores
    bit for bit, each group's env steps, episodes and health block exactly;
    the rows sum to the ungrouped sharded wire (each rank narrows its own
    lanes)."""
    one = grouped_one["compact"]
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        ours, where = got["compact"], f"world {world} rank {rank}"
        assert torch.equal(ours["scores"], one["scores"]), where
        _assert_rows(ours["telemetry"], one["telemetry"], ("env_steps", "episodes", 6), where)
        assert torch.equal(ours["telemetry"][:, :15].sum(0), got["compact_ungrouped"]["telemetry"][0, :15]), where


@pytest.mark.parametrize("mode", MODES)
def test_grouped_generation_step_equals_one_rank(ranks, grouped_one, mode):
    """``make_generation_step(mesh=, groups=)``: three generations with
    normalization, the state, scores and statistics of the one-rank grouped
    generations bit for bit, and their ``(3, 20)`` wires (the padding lanes
    over 3 ranks charged to row 0's group)."""
    one = grouped_one[("generation", mode)]
    groups = _group_ids(POPSIZE)
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        where = f"world {world} rank {rank}"
        # refill at _rollout_kw's 4 lanes: 2 + 2 over 2 ranks, 2 + 2 + 2 (2 idle) over 3
        pad = (-(-4 // world) * world - 4) if mode == "episodes_refill" else _pad_lanes(world)
        for a, b in zip(got[("generation", mode)], one):
            for key in ("scores", "center", "stdev", "stats"):
                assert torch.equal(a[key], b[key]), (where, key)
            assert torch.equal(a["telemetry"], _padded(b["telemetry"], pad, int(groups[0]))), where


def test_grouped_training_span_over_ranks_equals_one_rank_generations(ranks, grouped_one):
    """``make_training_span(mesh=, groups=)``: a span of three grouped
    ``budget`` generations over the ranks gives the one-rank generations'
    scores and ``(3, 3, 20)`` wires (padding lanes on row 0's group)."""
    one = grouped_one[("generation", "budget")]
    groups = _group_ids(POPSIZE)
    for world, rank, got in _each_rank(ranks, "case_grouped"):
        span = got["span"]
        assert span["telemetry"].shape == (GENERATIONS, NUM_GROUPS, 20)
        for i, b in enumerate(one):
            assert torch.equal(span["scores"][i], b["scores"]), (world, rank, i)
            assert torch.equal(span["telemetry"][i], _padded(b["telemetry"], _pad_lanes(world), int(groups[0]))), (world, rank, i)


def test_grouped_rows_match_the_jax_mesh(ranks):
    """The grouped evaluator against the JAX package's
    ``make_sharded_rollout_evaluator(groups=)`` on its 2-device CPU mesh
    (CartPole, ``episodes``, JAX's reset draws injected): every integer
    column and the health block (whole-number scores) exactly; popsize 37
    pads to 38 on both meshes of 2, to 39 over 3 ranks (one more lane on
    row 0's group)."""
    theirs = ranks["jax_grouped"]
    groups = ranks["payload"]["cartpole_groups"]
    for world, rank, got in _each_rank(ranks, "case_grouped_jax"):
        np.testing.assert_allclose(got["scores"].numpy(), theirs["scores"], rtol=0, atol=1e-4)
        expected = torch.from_numpy(theirs["telemetry"].copy())
        if world == 3:
            expected = _padded(expected, 1, int(groups[0]))
        assert got["telemetry"].shape == (4, 20)
        assert torch.equal(got["telemetry"], expected), (world, rank)


def test_vecne_groups_over_num_actors(ranks):
    """C.13: ``VecNE(solution_groups=, num_actors=)`` keeps its per-group
    rows under every contract, on a mesh of every rank (``"max"``) and on
    one over the first two ranks (``num_actors=2``, the others taking the
    ``(2, 20)`` wire through the spread): the same ``eval_g*`` keys as the
    one-rank run, equal but for the occupancy (padding and per-rank
    compaction lanes change the capacity), and the same generator state."""
    one = _grouped_vecne(None)
    for world, rank, got in _each_rank(ranks, "case_grouped_vecne"):
        for num_actors, runs in got.items():
            for mode, ours in runs.items():
                where = f"world {world} rank {rank} num_actors={num_actors} {mode}"
                theirs = one[mode]
                assert set(ours["keys"]) == set(theirs["keys"]) and theirs["keys"], where
                for key, value in theirs["keys"].items():
                    if not key.endswith("_occupancy"):
                        assert ours["keys"][key] == value, (where, key)
                assert ours["wire"].shape == (2, 20), where
                assert torch.equal(ours["generator"], theirs["generator"]), where


def test_vecne_groups_on_a_one_rank_group(tmp_path):
    """C.13's reproduction (``ROADMAP.md``): under a process group of one
    rank, ``VecNE(solution_groups=[0, 0, 0, 1, 1, 1, 1, 1])`` reports
    ``eval_g0_episodes`` 3 and ``eval_g1_episodes`` 5 after two
    evaluations, and so does it with ``num_actors="max"`` (which used to
    drop every ``eval_g*`` key)."""
    import torch.distributed as dist

    from evotorch_tpu_torch.parallel import init_distributed

    init_distributed(f"file://{tmp_path}/store", world_size=1, rank=0, device="cpu", timeout=GROUP_TIMEOUT)
    try:
        status = {}
        for num_actors in (None, "max"):
            problem = VecNE(
                "cartpole", "Linear(obs_length, act_length)", eval_mode="episodes",
                solution_groups=[0, 0, 0, 1, 1, 1, 1, 1], num_actors=num_actors, device="cpu", seed=1,
            )  # fmt: skip
            for _ in range(2):
                problem.evaluate(problem.generate_batch(8))
            status[num_actors] = {k: v for k, v in problem.status.items() if k.startswith("eval_g")}
            assert (num_actors is None) == (problem._num_actors_mesh(8) is None)
    finally:
        dist.destroy_process_group()
    for keys in status.values():
        assert keys["eval_g0_episodes"] == 3 and keys["eval_g1_episodes"] == 5
    assert status[None] == status["max"]


def test_grouped_server_over_ranks_equals_one_rank(ranks):
    """C.15: ``EvalServer(mesh=default_mesh())`` on 2 and 3 ranks, every
    rank making the same calls: each tenant's scores, wire and
    normalization slot, the last dispatch's whole wire and the dispatch
    count equal the one-rank server's bit for bit (6 refill lanes split
    3 + 3 and 2 + 2 + 2); the program key differs only in its mesh label."""
    one = _grouped_server(None)
    assert one["dispatches"] == 2 and one["key"][5] == "none"
    for world, rank, got in _each_rank(ranks, "case_grouped_server"):
        where = f"world {world} rank {rank}"
        assert got["dispatches"] == one["dispatches"] and np.array_equal(got["last"], one["last"]), where
        assert got["key"][5] == f"pop{world}" and got["key"][:5] + got["key"][6:] == one["key"][:5] + one["key"][6:]
        for name in ("a", "b"):
            for key in ("scores", "telemetry", "stats"):
                assert torch.equal(got[name][key], one[name][key]), (where, name, key)


def test_sum_over_ranks_appends_the_per_group_health_block():
    """``sum_over_ranks(groups=, num_groups=)`` on a one-rank mesh: the
    counter rows as given and the health block ``compute_health_block``
    gives per group on the scores and ids, bit for bit."""
    from evotorch_tpu_torch.observability.devicemetrics import sum_over_ranks

    g = torch.Generator().manual_seed(3)
    rows = torch.randint(0, 100, (NUM_GROUPS, 15), generator=g, dtype=torch.int32)
    scores, groups = torch.randn(10, generator=g), _group_ids(10)
    wire = sum_over_ranks(rows, default_mesh(), scores, groups, NUM_GROUPS)
    assert wire.shape == (NUM_GROUPS, 20) and torch.equal(wire[:, :15], rows)
    assert torch.equal(wire[:, 15:], compute_health_block(scores, groups, NUM_GROUPS).view(torch.int32))
    assert torch.equal(sum_over_ranks(rows[:1], default_mesh(), scores)[:, 15:], compute_health_block(scores).view(torch.int32))


def test_grouped_sharded_combinations_return_rows_or_raise():
    """No combination drops the per-group rows silently: the one-rank mesh
    returns them in both forms; ids that do not match the population,
    ``num_groups`` without ids and stacked statistics in the per-rank form
    raise; the resident program's key carries the mesh label."""
    from evotorch_tpu_torch.parallel import make_resident_rollout_program

    env, policy = _humanoid()
    values, groups = 0.01 * torch.randn((POPSIZE, policy.parameter_count), generator=torch.Generator().manual_seed(2)), _group_ids(POPSIZE)
    stats = stats_init(env.observation_size, device="cpu")
    for use_shard_map in (False, True):
        evaluate = make_sharded_rollout_evaluator(env, policy, use_shard_map=use_shard_map, **_grouped_kw("episodes", False, groups))
        result, _ = evaluate(values, torch.Generator().manual_seed(1), stats)
        assert result.telemetry.shape == (NUM_GROUPS, 20)
        with pytest.raises(ValueError, match="groups maps 10 solutions"):
            evaluate(values[:6], torch.Generator(), stats)
    with pytest.raises(ValueError, match="requires a groups array"):
        make_sharded_rollout_evaluator(env, policy, eval_mode="episodes", num_groups=3)
    evaluate = make_sharded_rollout_evaluator(env, policy, use_shard_map=True, **_grouped_kw("episodes_refill", True, groups))
    with pytest.raises(ValueError, match="stacked"):
        evaluate(values, torch.Generator(), group_stats_init(NUM_GROUPS, env.observation_size, device="cpu"))
    program = make_resident_rollout_program(env, policy, mesh=make_mesh({"pop": 1}), device="cpu", num_groups=NUM_GROUPS)
    assert program.key[4:6] == (NUM_GROUPS, "none")
