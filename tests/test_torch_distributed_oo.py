"""The port's object API over gloo ranks on the CPU: ``Problem(num_actors=)``
and ``use_sharded_evaluation``, ``sample_and_compute_gradients`` and
``make_sharded_grad_estimator`` under both semantics, ``PGPE(distributed=
True)``, and ``VecNE(num_actors=)`` with observation normalization against
the JAX package's ``VecNE`` on its 8-device mesh.

Ranks are spawned once per module, at world sizes 2 and 3, through
``tests/test_torch_parallel.py``'s harness (``Spawn``: a ``file://`` store,
a time limit of its own), while the JAX side runs in the test process.

Tolerances:
- Gradients against the one-rank oracle (global ranking) and against the
  per-rank oracle (local ranking): ``atol=1e-5``, as the JAX package's own
  tests (``tests/test_distributed_oo.py``); the oracles' gradient math is
  the JAX package's ``rank`` and ``_compute_gradients`` on the port's
  samples, to ``atol=1e-5``.
- ``VecNE`` against the JAX ``VecNE`` (the small Humanoid net, a gentle
  population of 12, 5-step episodes, JAX's reset draws injected, both
  sides from the same made-up statistics of 50 observations): the JAX
  package's own tolerance for a sharded normalized evaluation held to
  another (``tests/test_vecrl.py``, step sync against unsharded): scores
  ``atol=2e-2``, the observation count exactly, the statistics' mean
  ``rtol=atol=1e-4``. The cohort form is held to the JAX cohort form at
  the same tolerance: both normalize each rank's (device's) lanes by that
  shard's own statistics until the end.
"""

import math
import os

import numpy as np
import pytest
import torch

from evotorch_tpu_torch import vectorized
from evotorch_tpu_torch.algorithms import PGPE
from evotorch_tpu_torch.core import Problem, SolutionBatch
from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian
from evotorch_tpu_torch.envs import Humanoid
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import CollectedStats
from evotorch_tpu_torch.parallel import default_mesh, make_sharded_grad_estimator
from evotorch_tpu_torch.parallel.grad import _rank_generator
from evotorch_tpu_torch.tools.ranking import rank
from test_torch_parallel import WORLDS, Spawn

SMALL_NET = "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)"
VECNE_POPSIZE, VECNE_STEPS = 12, 5
SYNCS = ("cohort", "step")
FORMS = ("default", "shard_map")


@vectorized
def sphere(xs):
    return torch.sum(xs**2, dim=-1)


def _problem(**kwargs):
    return Problem("min", sphere, solution_length=6, initial_bounds=(-1, 1), device="cpu", seed=2, **kwargs)


def _dist_params():
    return {
        "mu": torch.full((6,), 4.0),
        "sigma": torch.ones(6),
        "divide_mu_grad_by": "num_directions",
        "divide_sigma_grad_by": "num_directions",
    }


def _prior_stats(n):
    g = torch.Generator().manual_seed(6)
    return CollectedStats(torch.tensor(50.0), torch.randn(n, generator=g), 50.0 + torch.rand(n, generator=g))


def _set_form(form):
    os.environ["EVOTORCH_SHARD_MAP"] = "1" if form == "shard_map" else "0"


# ------------------------------------------------------------ rank cases


def case_grads(payload):
    out = {}
    for form in FORMS:
        estimate = make_sharded_grad_estimator(
            SymmetricSeparableGaussian, sphere, objective_sense="min", with_aux=True, use_shard_map=form == "shard_map"
        )
        out[form] = estimate(torch.Generator().manual_seed(123), 12, _dist_params())
    lowrank = make_sharded_grad_estimator(
        SymmetricSeparableGaussian, sphere, objective_sense="min", with_aux=True, lowrank_rank=3
    )
    out["lowrank"] = lowrank(torch.Generator().manual_seed(123), 12, _dist_params())
    return out


def case_problem(payload):
    out = {}
    for form in FORMS:
        _set_form(form)
        problem = _problem(num_actors="max")
        batch = SolutionBatch(problem, values=payload["values"])
        problem.evaluate(batch)
        dist = SymmetricSeparableGaussian(_dist_params())
        even = problem.sample_and_compute_gradients(dist, 12, ranking_method="centered")
        uneven = problem.sample_and_compute_gradients(dist, 20, ranking_method="centered")
        out[form] = dict(evals=batch.evals, even=even[0], uneven=uneven[0]["num_solutions"], sharded=problem._eval_mesh is not None)
    _set_form("default")
    searcher = PGPE(
        _problem(num_actors="max"), popsize=64, center_learning_rate=0.5, stdev_learning_rate=0.1, stdev_init=1.0,
        center_init=torch.full((6,), 3.0), distributed=True,
    )  # fmt: skip
    searcher.run(40)
    out["pgpe"] = dict(center=searcher.status["center"], mean_eval=searcher.status["mean_eval"])
    return out


def case_vecne_factored(payload):
    """One sharded evaluation of a low-rank population through
    ``VecNE(num_actors=)``: its coefficient rows split over the ranks."""
    _set_form("default")
    problem = VecNE(Humanoid(device="cpu"), SMALL_NET, episode_length=VECNE_STEPS, num_actors="max", device="cpu", seed=1)
    dist = SymmetricSeparableGaussian({"mu": torch.zeros(problem.solution_length), "sigma": torch.full((problem.solution_length,), 0.01)})
    values = dist.sample_lowrank(VECNE_POPSIZE, 3, generator=torch.Generator().manual_seed(5))
    batch = SolutionBatch(problem, values=values)
    problem.evaluate(batch, reset_noise=payload["vecne_rows"])
    return batch.evals[:, 0]


def case_vecne(payload):
    out = {}
    for form in FORMS:
        _set_form(form)
        for sync in SYNCS:
            problem = VecNE(
                Humanoid(device="cpu"), SMALL_NET, observation_normalization=True, obs_norm_sync=sync,
                episode_length=VECNE_STEPS, num_actors="max", device="cpu", seed=1,
            )  # fmt: skip
            problem.obs_norm.stats = _prior_stats(problem.env.observation_size)
            batch = SolutionBatch(problem, values=payload["vecne_values"])
            problem.evaluate(batch, reset_noise=payload["vecne_rows"])
            stats = problem.obs_norm.stats
            out[(form, sync)] = dict(
                scores=batch.evals[:, 0], count=float(stats.count), mean=stats.mean,
                steps=int(problem.status["total_interaction_count"]),
            )  # fmt: skip
    _set_form("default")
    return out


CASES = (case_grads, case_problem, case_vecne, case_vecne_factored)


# ------------------------------------------------------------ JAX side


def _jax_vecne_runs(monkeypatch):
    """The population and JAX's reset draws for it, and a function that
    makes the JAX ``VecNE``'s sharded evaluations per (world, form, sync).
    The JAX default (GSPMD) form is the unsharded evaluation whatever
    ``obs_norm_sync`` says, so it runs once per world for both values."""
    import jax
    import jax.numpy as jnp

    from evotorch_tpu.core import SolutionBatch as JaxSolutionBatch
    from evotorch_tpu.envs import Humanoid as JaxHumanoid
    from evotorch_tpu.neuroevolution import VecNE as JaxVecNE
    from evotorch_tpu.neuroevolution.net.runningnorm import CollectedStats as JaxCollectedStats

    nb = Humanoid(device="cpu").sys.num_bodies
    L = VecNE(Humanoid(device="cpu"), SMALL_NET, device="cpu").solution_length
    rng = np.random.default_rng(3)
    values = (0.01 * rng.normal(size=L) + 0.01 * rng.normal(size=(VECNE_POPSIZE, L))).astype(np.float32)
    prior = _prior_stats(JaxHumanoid().observation_size)

    def make(world, sync):
        problem = JaxVecNE(
            JaxHumanoid(), SMALL_NET, observation_normalization=True, obs_norm_sync=sync, episode_length=VECNE_STEPS,
            num_actors=world, seed=1,
        )  # fmt: skip
        problem._obs_norm.stats = JaxCollectedStats(
            *(jnp.asarray(x.numpy()) for x in (prior.count, prior.sum, prior.sum_of_squares))
        )
        return problem

    # the problem's next key seeds lane i's reset from fold_in(key, i)
    key = jax.random.split(make(2, "cohort")._rng_key)[1]

    def draws(lane):
        parts = jax.random.split(jax.random.split(jax.random.fold_in(key, lane), 2)[1], 3)
        return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

    rows = torch.from_numpy(np.array(jax.vmap(draws)(jnp.arange(VECNE_POPSIZE, dtype=jnp.int32))))

    def run():
        results = {}
        for world in WORLDS:
            for form in FORMS:
                monkeypatch.setenv("EVOTORCH_SHARD_MAP", "1" if form == "shard_map" else "0")
                for sync in SYNCS if form == "shard_map" else ("cohort",):
                    problem = make(world, sync)
                    batch = JaxSolutionBatch(problem, VECNE_POPSIZE, values=jnp.asarray(values))
                    problem.evaluate(batch)
                    stats = problem._obs_norm.stats
                    results[(world, form, sync)] = dict(
                        scores=np.asarray(batch.evals[:, 0]), count=float(stats.count),
                        mean=np.asarray(stats.sum) / float(stats.count),
                    )  # fmt: skip
                if form == "default":
                    results[(world, form, "step")] = results[(world, form, "cohort")]
        monkeypatch.delenv("EVOTORCH_SHARD_MAP")
        return results

    return dict(vecne_values=torch.from_numpy(values), vecne_rows=rows), run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        vecne_payload, run_jax = _jax_vecne_runs(mp)
        payload = dict(vecne_payload, values=torch.randn(10, 6, generator=torch.Generator().manual_seed(8)))
        spawns = {world: Spawn(tmp_path_factory.mktemp("ranks_oo"), world, CASES, payload) for world in WORLDS}
        jax_results = run_jax()
    finally:
        mp.undo()
    return dict(results={world: spawn.results() for world, spawn in spawns.items()}, payload=payload, jax=jax_results)


def _each_rank(ranks, case):
    for world in WORLDS:
        for r, saved in enumerate(ranks["results"][world]):
            yield world, r, saved[case]


def _oracle(samples, fitnesses):
    weights = rank(fitnesses, "centered", higher_is_better=False)
    return SymmetricSeparableGaussian._compute_gradients(_dist_params(), samples, weights, "centered")


def _jax_grads(samples, fitnesses):
    """The JAX package's ranking and gradient math on the same samples."""
    import jax.numpy as jnp

    from evotorch_tpu.distributions import SymmetricSeparableGaussian as JaxGaussian
    from evotorch_tpu.tools.ranking import rank as jax_rank

    params = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for k, v in _dist_params().items()}
    weights = jax_rank(jnp.asarray(fitnesses.numpy()), "centered", higher_is_better=False)
    grads = JaxGaussian._compute_gradients(params, jnp.asarray(samples.numpy()), weights, "centered")
    return {k: np.asarray(v) for k, v in grads.items()}


class _RankOf:
    """The (size, rank) of a mesh, to replay a rank's generator here."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


# ------------------------------------------------------------------ tests


def test_grad_estimator_ranks_globally(ranks):
    """Default form: the one-rank estimate on every rank at any world size
    (the JAX package's ``test_distributed_gradients_gspmd_ranks_globally``)."""
    samples = SymmetricSeparableGaussian._sample(torch.Generator().manual_seed(123), _dist_params(), 12)
    fitnesses = sphere(samples)
    oracle, theirs = _oracle(samples, fitnesses), _jax_grads(samples, fitnesses)
    for k in ("mu", "sigma"):
        np.testing.assert_allclose(oracle[k].numpy(), theirs[k], atol=1e-5)
    for _, _, got in _each_rank(ranks, "case_grads"):
        grads, aux = got["default"]
        for k in ("mu", "sigma"):
            np.testing.assert_allclose(grads[k].numpy(), oracle[k].numpy(), atol=1e-5, err_msg=k)
        assert float(aux["mean_eval"]) == pytest.approx(float(fitnesses.mean()), abs=1e-4)


def test_grad_estimator_ranks_locally(ranks):
    """``use_shard_map``: each rank samples its own sub-population from a
    generator of its own, ranks it locally, and the gradients are averaged
    (the JAX package's per-shard oracle, ``tests/test_distributed_oo.py``);
    local ranking differs from global ranking over the same samples."""
    for world, _, got in _each_rank(ranks, "case_grads"):
        grads, aux = got["shard_map"]
        parts = []
        for r in range(world):
            g = _rank_generator(torch.Generator().manual_seed(123), _RankOf(world, r))
            samples = SymmetricSeparableGaussian._sample(g, _dist_params(), 12 // world)
            parts.append((samples, sphere(samples)))
        per_rank = [_oracle(s, f) for s, f in parts]
        for k in ("mu", "sigma"):
            oracle = sum(p[k] for p in per_rank) / world
            theirs = sum(_jax_grads(s, f)[k] for s, f in parts) / world
            np.testing.assert_allclose(grads[k].numpy(), oracle.numpy(), atol=1e-5, err_msg=k)
            np.testing.assert_allclose(grads[k].numpy(), theirs, atol=1e-5, err_msg=k)
        all_samples = torch.cat([s for s, _ in parts])
        all_fits = torch.cat([f for _, f in parts])
        assert not np.allclose(grads["mu"].numpy(), _oracle(all_samples, all_fits)["mu"].numpy(), atol=1e-6)
        assert float(aux["mean_eval"]) == pytest.approx(float(all_fits.mean()), abs=1e-4)


def test_lowrank_grad_estimator_ranks_globally(ranks):
    """The factored form of the default estimator: the one-rank low-rank
    sample, ranked globally, its gradients from the factors."""
    samples = SymmetricSeparableGaussian._sample_lowrank(torch.Generator().manual_seed(123), _dist_params(), 12, 3)
    fitnesses = sphere(samples.materialize())
    oracle = _oracle(samples, fitnesses)
    for _, _, got in _each_rank(ranks, "case_grads"):
        grads, aux = got["lowrank"]
        for k in ("mu", "sigma"):
            np.testing.assert_allclose(grads[k].numpy(), oracle[k].numpy(), atol=1e-5, err_msg=k)
        assert torch.equal(aux["basis"], samples.basis)


def test_vecne_evaluates_a_factored_population_over_ranks(ranks):
    """``VecNE.evaluate_sharded`` keeps a low-rank population factored, its
    coefficient rows split over the ranks: the one-rank scores."""
    one = VecNE(Humanoid(device="cpu"), SMALL_NET, episode_length=VECNE_STEPS, device="cpu", seed=1)
    dist = SymmetricSeparableGaussian({"mu": torch.zeros(one.solution_length), "sigma": torch.full((one.solution_length,), 0.01)})
    batch = SolutionBatch(one, values=dist.sample_lowrank(VECNE_POPSIZE, 3, generator=torch.Generator().manual_seed(5)))
    one.evaluate(batch, reset_noise=ranks["payload"]["vecne_rows"])
    for _, _, got in _each_rank(ranks, "case_vecne_factored"):
        np.testing.assert_allclose(got.numpy(), batch.evals[:, 0].numpy(), rtol=1e-4, atol=1e-4)


def test_num_actors_shards_a_vectorized_objective(ranks):
    values = ranks["payload"]["values"]
    for _, _, got in _each_rank(ranks, "case_problem"):
        for form in FORMS:
            assert got[form]["sharded"]
            np.testing.assert_array_equal(got[form]["evals"][:, 0].numpy(), sphere(values).numpy())


def test_sample_and_compute_gradients_over_ranks(ranks):
    """Default form: the problem's generator draws the whole population on
    every rank, so the result is the one-rank one; under
    ``EVOTORCH_SHARD_MAP=1`` uneven popsizes round up to an equal, even
    share per rank (``tests/test_distributed_oo.py``: 20 over 2 ranks stays
    20, over 3 ranks becomes 24)."""
    one = _problem()
    expected = one.sample_and_compute_gradients(SymmetricSeparableGaussian(_dist_params()), 12, ranking_method="centered")[0]
    # the one-rank problem evaluated a batch of 10 first, as the ranks did
    for world, _, got in _each_rank(ranks, "case_problem"):
        even = got["default"]["even"]
        assert even["num_solutions"] == 12 and got["default"]["uneven"] == 20
        assert torch.isfinite(even["mean_eval"]) and set(even["gradients"]) == set(expected["gradients"])
        assert got["shard_map"]["even"]["num_solutions"] == 12
        assert got["shard_map"]["uneven"] == {2: 20, 3: 24}[world]


def test_sample_and_compute_gradients_default_form_equals_one_rank(ranks):
    """Both the ranks and a one-rank problem of the same seed evaluate a
    batch first (no draw), then estimate: the same gradients."""
    one = _problem()
    one.evaluate(SolutionBatch(one, values=ranks["payload"]["values"]))
    expected = one.sample_and_compute_gradients(SymmetricSeparableGaussian(_dist_params()), 12, ranking_method="centered")[0]
    for _, _, got in _each_rank(ranks, "case_problem"):
        for k in ("mu", "sigma"):
            np.testing.assert_allclose(
                got["default"]["even"]["gradients"][k].numpy(), expected["gradients"][k].numpy(), atol=1e-5
            )


def test_pgpe_distributed_converges_on_sphere(ranks):
    for _, _, got in _each_rank(ranks, "case_problem"):
        center = got["pgpe"]["center"]
        assert float(torch.sum(center**2)) < 1.0 and math.isfinite(got["pgpe"]["mean_eval"])


@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("form", FORMS)
def test_vecne_num_actors_matches_jax_vecne(ranks, form, sync):
    """``VecNE(num_actors=...)`` with observation normalization against the
    JAX ``VecNE(num_actors=...)`` on its mesh, same world size, same form,
    same ``obs_norm_sync`` (see the module note for the tolerance). The
    default form is the one-rank evaluation under either value."""
    for world, _, got in _each_rank(ranks, "case_vecne"):
        ours, theirs = got[(form, sync)], ranks["jax"][(world, form, sync)]
        np.testing.assert_allclose(ours["scores"].numpy(), theirs["scores"], rtol=0, atol=2e-2)
        assert ours["count"] == theirs["count"]
        np.testing.assert_allclose(ours["mean"].numpy(), theirs["mean"], rtol=1e-4, atol=1e-4)
        assert ours["steps"] == VECNE_POPSIZE * VECNE_STEPS


def test_vecne_default_form_equals_one_rank(ranks):
    """The default form equals the one-rank ``VecNE`` evaluation under both
    values of ``obs_norm_sync``; the cohort form does not (by design)."""
    one = VecNE(Humanoid(device="cpu"), SMALL_NET, observation_normalization=True, episode_length=VECNE_STEPS, device="cpu", seed=1)
    one.obs_norm.stats = _prior_stats(one.env.observation_size)
    batch = SolutionBatch(one, values=ranks["payload"]["vecne_values"])
    one.evaluate(batch, reset_noise=ranks["payload"]["vecne_rows"])
    for _, _, got in _each_rank(ranks, "case_vecne"):
        for sync in SYNCS:
            np.testing.assert_array_equal(got[("default", sync)]["scores"].numpy(), batch.evals[:, 0].numpy())
            np.testing.assert_array_equal(got[("default", sync)]["mean"].numpy(), one.obs_norm.mean.numpy())
        assert not np.array_equal(got[("shard_map", "cohort")]["scores"].numpy(), batch.evals[:, 0].numpy())


def test_num_actors_without_a_group():
    """No process group: ``num_actors`` leaves a vectorized objective
    unsharded, and an unknown request is refused
    (``parallel.mesh.num_actors_mesh``; a request for fewer shards than
    ranks makes a sub-group, ``tests/test_torch_parallel.py``)."""
    problem = _problem(num_actors="max")
    problem.evaluate(problem.generate_batch(4))
    assert problem._eval_mesh is None
    with pytest.raises(ValueError, match="num_actors"):
        _problem(num_actors="many").evaluate(problem.generate_batch(2))
    assert default_mesh().size == 1
