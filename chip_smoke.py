#!/usr/bin/env python3
"""Pass/fail check of the PyTorch/CUDA port (``evotorch_tpu_torch``) on one
card, at the flagship's scale.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

It checks and does not time: a kernel alone is timed by
``python3 -m evotorch_tpu_torch.ops.kernel_times``, and a benchmark cell,
its layers and its kernels by ``python3 perfbench/run.py --workload <cell>
--trace 1``. Kernel launches are read from the counter registry
(``observability.programs.kernel_launches``): where a path's launches are
checked, those of the sampling and the ranking kernel are. The phases, in
order; the first failed check exits non-zero:

1. Device: prints the card's name and power limit.
2. Build: compiles every kernel of ``evotorch_tpu_torch/csrc`` with ``nvcc``
   and prints ``-Xptxas -v``.
3. Kernels: each equal to its plain PyTorch version, bit for bit, at every
   shape the paths below launch it at: ranking n = 10,000, 5,000, 2,500,
   1,000, 512, 64 and 16 on random values, ties, signed-zero ties, a batch
   of rows, NaN and infinities, and float64, in both senses; the ranks
   within one float32 ulp of the double argsort's. Sampling at 10,000 x
   12,305 (the flagship), 5,000 x 12,305 (``serving_vecne``), 10,000 x
   9,800 (Ant), 1,000 x 8,646 (HalfCheetah), 10,000 x 6,337 (the supervised
   net), 10,000 x 45,905 (the recurrent flagship), 10,000 x 98,321 (the
   wide network) and 512 x 5,123 (``GymNE``), rows 16-byte aligned only at
   9,800; the injected-noise entry equal to its plain version, antithetic
   pairs exact at mu = 0, the noise's mean, stdev and the Box-Muller pair's
   correlation within 5 standard errors. Then a small generation on the
   card against the same generation on the CPU, observation normalization
   off and on: scores within 1e-4 with the same ranks, center, stdev and
   statistics within their tolerances.
4. Contracts reference: CartPole (continuous actions, ``Linear(4, 1)``,
   popsize 1,000, 200 steps, one seeded reset table) under ``episodes``,
   ``episodes_refill`` (128 lanes and the default width) and
   ``episodes_compact``, at one and two episodes a solution, on the card
   and on the CPU: the counters and the telemetry wire exact on each
   device, the contracts agreeing within each, and the card against the
   CPU (99.9% of the scores within 1e-4, env steps within 0.1%). Then one
   forward each of ``RNN``, ``LSTM``, ``FeedForwardNet``,
   ``StructuredControlNet`` and ``LocomotorNet`` at popsize 1,000, card
   against CPU; and ``RNN >> Linear`` and ``LSTM >> Linear`` on CartPole
   under the three contracts with one reset and one action-noise table:
   equal bit for bit across the contracts, the card against the CPU as
   above.
5. Main path: 2 flagship PGPE generations (Humanoid, popsize 10,000, 64-64
   tanh MLP, ``budget`` with 200 steps, the JAX benchmark's
   ``fresh_pgpe_state`` constants): each 2,000,000 env steps, finite
   scores, the center moved, the telemetry's counts, each kernel launched
   once.
6. The flagship under ``episodes``, ``episodes_refill`` (2,048 lanes) and
   ``episodes_compact`` (chunks of 25), one generation each, checked as in
   5 (one episode a solution).
7. ``oo``: ``examples/humanoid_pgpe.py`` through the object API
   (``VecNE`` in bf16 with normalization, ``PGPE`` with ClipUp,
   ``StdOutLogger``), ``run(2)``: 4,000,000 interactions, the sampling
   kernel launched twice and the ranking kernel once, every ``mean_eval``
   finite, the observation count, ``save_solution`` read back; then one
   ``episodes`` population evaluated by ``VecNE.evaluate`` and by
   ``run_vectorized_rollout`` on one reset table, equal bit for bit.
8. ``ant``: Ant at popsize 10,000 (9,800 parameters): a ``budget`` and an
   ``episodes`` generation checked as in 5, then ``VecNE("ant")`` +
   ``PGPE`` ``run(2)``.
9. ``locomotion``: the rigid-body kernel against its plain loop at 10,000
   and 2,048 Humanoid lanes driven into contact and joint limits, one
   launch each, within ``PHYSICS_TOL``, and the main path's launches on the
   same lanes: ``batch_step`` (its state the physics launch's bit for bit;
   observation, reward, done and clock against the plain path) and
   ``batch_reset_from``; Ant, HalfCheetah, Walker2D and
   Hopper at popsize 1,000, 50 steps, card against CPU with lanes ended by
   the time limit and by the healthy band: done masks and env steps exact,
   the first step within the CPU parity tests' tolerances, 99% of the
   returns and scores within 1e-2; then a HalfCheetah ``episodes``
   generation checked as in 5.
10. ``supervised_checkpoint``: ``SupervisedNE`` (65,536 x 32, popsize
    10,000), ``run(3)``: 64 losses against a float64 recomputation on the
    CPU; ``save_searcher``/``load_searcher`` on the card and one more step
    of each, equal bit for bit; a functional PGPE state round-tripped.
11. ``recurrent``: the Humanoid with ``LSTM(obs_length, 64) >> Linear(64,
    act_length)`` (45,905 parameters): a ``budget`` generation and one
    under each episodes contract, checked as in 5; ``VecNE`` + ``PGPE``
    ``run(2)`` with action noise; ``to_policy_callable``'s ``(h, c)``
    state, whose feedback changes the next action.
12. ``searchers``: a GA and a CoSyNE generation on the flagship ``VecNE``
    (the rank kernel launched at the n each ranks at, the sampling kernel
    never, the evaluations counted); the black-box searchers, MAP-Elites,
    the multi-objective GA and Pareto sorting of 20,000 points, batched CEM
    through ``make_search_span`` and ``examples/mpc_cem.py``'s planner,
    each finite or improving; then each card against CPU at a small size
    with the same draws (GA, CoSyNE, a CMA-ES, SNES and XNES tell, a
    MAP-Elites step, Pareto ranks exactly and crowding, batched CEM).
13. ``factored``: at the wide network (98,321 parameters)
    ``examples/wide_policy_lowrank.py`` ``run(3)``, the population held
    factored (no ``materialize``, no dense fallback), the rank kernel
    launched twice and the sampling kernel never; the dense, low-rank and
    trunk-delta forms one generation each (trunk-delta under every
    contract and blocked), checked as in 5; the blocked forward against
    the unblocked one; each factored piece card against CPU at a small size
    with the same draws.
14. ``multigpu``: (a) one rank over NCCL on a ``file://`` store: the
    flagship ``budget`` and ``episodes`` generations sharded against
    unsharded (5's and 6's), scores and centers equal within
    ``MULTIGPU_TOL`` with the same ranks; (c) ``PGPE(distributed=True)`` on
    ``VecNE(num_actors="max")``, ``run(1)``, each kernel launched once;
    (b) two ranks spawned on the card over gloo: the sharded ``budget``
    generation, both ranks equal, equal bit for bit to their two blocks
    evaluated here, mean and median score within ``MULTIGPU_STATS_TOL`` of
    (a)'s, each kernel launched once a rank.
15. ``span``: a span of 2 ``budget`` generations against 2 sequential
    ``make_generation_step`` calls, bit for bit (state, scores, statistics,
    steps, telemetry rows), in 2 rounds, 0 host syncs and 2 launches of
    each kernel; the span under ``episodes`` with ``pgpe_health``;
    ``VecNE.make_training_span`` + ``consume_span`` against the same
    generations (counters, scores bit for bit, the last wire row pending).
16. ``object_ga``: ``examples/object_dtype_ga.py`` on the card: CUDA evals,
    an ``ObjectArray`` population, the best fitness never falling.
17. ``gymne``: ``GymNE`` + ``PGPE`` at popsize 512, 32 lanes, a 500-step
    horizon (Hopper-v5 where gymnasium and MuJoCo are installed, else
    ``HopperWidthEnv``), 2 generations under ``"pipelined"`` and
    ``"chunked"`` each: finite evals on the card, 512 episodes, the sampler
    launched once a generation and the rank from the second; ``"sync"``
    against ``"pipelined"`` on one population, bit for bit; 8 solutions
    serially against a vectorized run within ``GYMNE_SERIAL_TOL``.
18. ``structures``: a ``CList``, ``CMemory`` and ``CBag`` per member of a
    10,000 population and a 10,000-row ``TensorFrame``, card against CPU
    bit for bit (the bag's random pop held by its counts).
19. ``faults``: the flagship ``VecNE`` + ``PGPE`` under
    ``eval.scores:nonfinite@1:0.25``: 2,500 scores at numpy's
    ``default_rng(1235)`` indices quarantined to the worst finite score,
    the others untouched, the next tell finite.
20. ``serving``: one ``EvalServer`` (slab 10,000, 4 tenants of 2,500
    rows, ``episodes_refill``): one dispatch serves the four, each
    tenant's scores equal to its standalone run at the server's width bit
    for bit; 3 tenants charge their padding to group 0 only; churn keeps
    the residency key, one dispatch a step, no kernel rebuilt.
21. ``serving_vecne``: two ``VecNE`` + ``PGPE`` searches (popsize 5,000)
    through ``RemoteEvalBackend`` on one server, co-dispatched from two
    threads, equal to the standalone searches bit for bit, each kernel
    launched once a tenant a generation; a tenant below its
    ``occupancy_floor`` suspended and drained; MetricsHub rows in
    ``build/serving_metrics.jsonl``; a stdio round trip.
22. ``autotune``: ``tune_group(RefillHarness(widths=(2,048, 4,096)))`` at
    the flagship: finite scores, occupancies in [0, 1], no first-use work
    in the timed trials, a peak captured, the cache written exactly when
    the winner meets the 0.9 floor; the winner read back from a cache (the
    card's machine; ``VecNE`` and the one-rank sharded evaluator at the
    tuned width); ``report --flagship``: every registered program captured
    with its inputs untouched, its launches those ``REPORT_LAUNCHES``
    says.
23. ``optim``: ``PGPE`` with ``TorchOptimizer(torch.optim.Adam)``
    ``run(2)`` at the flagship; ``TorchOptimizer`` Adam and SGD with
    momentum against the port's own and the CPU's, within ``OPTIM_TOL``,
    0 host syncs an ``ascent``.
24. ``sharded_groups``: 4 groups of 2,500 at the flagship. (a) One NCCL
    rank: the grouped generation sharded against unsharded, bit for bit
    (scores, center, the ``(4, 20)`` wire), each group's env steps and
    capacity 500,000, the health blocks those of
    ``compute_health_block``. (b) In ``multigpu``'s two-rank spawn: the
    grouped generation, its rows summing to the ungrouped generation's,
    scores equal to it bit for bit, the health blocks of the gathered
    scores. (c) There too: ``EvalServer(mesh=default_mesh())`` with 2
    tenants, both ranks equal, each tenant within
    ``SHARDED_GROUPS_STATS_TOL`` of the one-rank server and its counts
    exact.

It prints a line as each phase ends, the card's name and power limit on
the line before the last, and ``{"ok": true, "device": ...}`` last.
Without a CUDA device it exits 1 and prints no result. It imports no JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

POPSIZE = 10_000
EPISODE_LENGTH = 200
HIDDEN = [64, 64]
MAIN_GENERATIONS = 2
ONE_EACH = {"symmetric_gaussian": 1, "centered_rank": 1}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(condition: bool, what: str) -> None:
    if not condition:
        raise AssertionError(what)


def build_phase():
    from evotorch_tpu_torch.ops import _build

    # graftlint: allow(first-use): the smoke test builds every kernel once, with -Xptxas -v, to print the report
    reports = _build.build(verbose=True)
    print(f"[build] {len(reports)} sources with {' '.join(_build.NVCC_FLAGS)}")
    for name, report in reports.items():
        print(f"[build] {name}.cu -Xptxas -v:\n{report.strip()}")


def _rank_cases(n, device):
    """Centered-rank inputs of length ``n``: random, ties, signed-zero ties, a
    batch of 4 rows, NaN and infinities, and float64 with all of them."""
    import torch

    g = torch.Generator(device=device).manual_seed(n)
    special = torch.randn(n, generator=g, device=device)
    special[::7] = float("nan")
    special[1::11] = float("inf")
    special[2::13] = -float("inf")
    # values in {-2, ..., 2} with random signs, so that -0 and +0 tie
    signed_zero = torch.copysign(
        torch.randint(-2, 3, (n,), generator=g, device=device).float(), torch.randn(n, generator=g, device=device)
    )
    special64 = special.double()
    special64[3::17] = -0.0
    return {
        "random": torch.randn(n, generator=g, device=device),
        "ties": torch.randint(0, 50, (n,), generator=g, device=device).float(),
        "signed_zero_ties": signed_zero,
        "batch": torch.randn((4, n), generator=g, device=device),
        "nan_inf": special,
        "float64": torch.randn(n, generator=g, device=device, dtype=torch.float64),
        "float64_nan_inf_zero": special64,
    }


def ranking_phase(device):
    """Centered-rank kernel against its plain version at every n the paths
    below rank: 10,000 (the flagship, the Ant, ``supervised_checkpoint``,
    the ``searchers`` phase's GA tournament and CoSyNE's linear rank),
    5,000 (each ``serving_vecne`` tenant's PGPE), 2,500 (CoSyNE's
    tournament among its parents), 1,000 (the ``locomotion`` phase's
    HalfCheetah), 512 (``gymne``), and 64 and 16 (the ``searchers`` phase's
    GA and CoSyNE held card against CPU); then against the double argsort
    at the flagship's n."""
    import torch

    from evotorch_tpu_torch.ops import ranking

    sizes = (POPSIZE, SERVE_VECNE_POPSIZE, COSYNE_PARENTS, LOCOMOTION_POPSIZE, GYMNE_POPSIZE, SMALL_POPSIZE, SMALL_POPSIZE // 4)
    for size in sizes:
        cases = _rank_cases(size, device)
        for name, values in cases.items():
            for higher_is_better in (True, False):
                got = ranking.centered_rank(values, higher_is_better=higher_is_better)
                ref = ranking.centered_rank_plain(values, higher_is_better=higher_is_better)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"centered_rank differs from its plain version on {name}, n={size} ({higher_is_better=})")
    x = _rank_cases(POPSIZE, device)["random"]
    order = torch.argsort(x, stable=True)
    composed = torch.argsort(order, stable=True).float() / (POPSIZE - 1) - 0.5
    # the same ranks; the values within one float32 ulp of 0.5, since
    # division by a Python number multiplies by its reciprocal on the card
    composed_err = float((composed - ranking.centered_rank(x)).abs().max())
    check(composed_err <= 2.0**-24, f"centered_rank differs from the double argsort by {composed_err}")
    print(
        f"[kernel] centered_rank n in {sizes}: equal to plain on {len(cases)} inputs x 2 senses each; within"
        f" {composed_err:.3g} of the double argsort at n={POPSIZE}"
    )


def sampling_shapes(device):
    """Every ``(popsize, L)`` at which the paths below launch the sampling
    kernel: the flagship (``main``, ``flagship``, ``oo``), the Ant (``ant``),
    the ``locomotion`` phase's HalfCheetah generation, the
    ``supervised_checkpoint`` phase, the ``recurrent`` phase, the
    ``factored`` phase's dense leg of the wide network, the ``gymne``
    phase's 512 x 5,123 and each ``serving_vecne`` tenant's 5,000 x
    12,305."""
    from evotorch_tpu_torch.envs import HalfCheetah
    from evotorch_tpu_torch.models import MLPPolicy
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net, tanh_mlp

    cheetah = HalfCheetah(device=device)
    return {
        "flagship": (POPSIZE, FlatParamsPolicy(tanh_mlp(109, 17, HIDDEN)).parameter_count),
        "ant": (POPSIZE, FlatParamsPolicy(tanh_mlp(79, 8, HIDDEN)).parameter_count),
        "halfcheetah": (LOCOMOTION_POPSIZE, FlatParamsPolicy(tanh_mlp(cheetah.observation_size, cheetah.action_size, HIDDEN)).parameter_count),
        "supervised": (POPSIZE, FlatParamsPolicy(str_to_net(SUPERVISED_NETWORK)).parameter_count),
        "recurrent": (POPSIZE, FlatParamsPolicy(str_to_net(RECURRENT_NETWORK, obs_length=109, act_length=17)).parameter_count),
        "wide": (POPSIZE, FlatParamsPolicy(str_to_net(WIDE_NETWORK, obs_length=109, act_length=17)).parameter_count),
        "gymne": (GYMNE_POPSIZE, FlatParamsPolicy(MLPPolicy(GYMNE_OBS, GYMNE_ACT)).parameter_count),
        "serving_vecne": (SERVE_VECNE_POPSIZE, FlatParamsPolicy(tanh_mlp(109, 17, HIDDEN)).parameter_count),
    }


def sampling_phase(device):
    """Sampling kernel against its plain Philox version, bit for bit, at
    every shape of :func:`sampling_shapes` (rows of ``L`` floats that are
    16-byte aligned when ``L`` is a multiple of 4 and realigned one by one
    otherwise: the flagship's 12,305 is 1 mod 4, the HalfCheetah's 8,646 is
    2, the supervised net's 6,337 is 1, the recurrent flagship's 45,905 is
    1, the wide network's 98,321 is 1, the Ant's 9,800 is 0); then, at the
    flagship's, the injected-noise entry and the noise's statistics."""
    import torch

    from evotorch_tpu_torch.ops import sampling

    shapes = sampling_shapes(device)
    for what, (popsize, length) in shapes.items():
        _sampling_at(device, popsize, length)
        print(f"[kernel] symmetric_gaussian {popsize}x{length} ({what}, L mod 4 = {length % 4}): equal to plain")
    L = shapes["flagship"][1]

    half = POPSIZE // 2
    g = torch.Generator(device=device).manual_seed(2)
    mu = torch.randn(L, generator=g, device=device)
    sigma = torch.full((L,), 0.1, device=device)
    seed = sampling.draw_seed(g, device)
    eps = torch.randn((half, L), generator=g, device=device)
    injected = sampling.sample_symmetric_gaussian(mu, sigma, POPSIZE, eps=eps)
    check(
        torch.equal(injected, sampling.sample_symmetric_gaussian_plain(mu, sigma, POPSIZE, eps=eps)),
        "the injected-noise entry differs from its plain version",
    )
    del injected, eps
    # antithetic pairs around the flagship's first center (zeros) sum to 2 mu = 0 exactly
    zeros = torch.zeros(L, device=device)
    at_zero = sampling.sample_symmetric_gaussian(zeros, sigma, POPSIZE, seed=seed)
    check(bool(torch.all(at_zero[0::2] + at_zero[1::2] == 0)), "antithetic pairs do not sum to 2 mu")
    eps = (at_zero[0::2] / sigma).double()
    count = eps.numel()
    mean, std = float(eps.mean()), float(eps.std())
    check(abs(mean) < 5 / math.sqrt(count), f"sample mean {mean}")
    check(abs(std - 1) < 5 / math.sqrt(2 * count), f"sample std {std}")
    # the cosine and sine normals of one Box-Muller pair (columns 4q, 4q+1)
    width = 4 * (L // 4)
    corr = float(torch.corrcoef(torch.stack([eps[:, 0:width:4].reshape(-1), eps[:, 1:width:4].reshape(-1)]))[0, 1])
    check(abs(corr) < 5 / math.sqrt(half * (L // 4)), f"cosine and sine normals correlate: {corr}")
    print(
        f"[kernel] symmetric_gaussian {POPSIZE}x{L}: injected noise equal, pairs exact at mu=0, noise mean {mean:.3g}"
        f" std {std:.6f}, cos/sin corr {corr:.3g}"
    )


def _sampling_at(device, popsize, L):
    """The sampling kernel against its plain version at ``(popsize, L)``, bit
    for bit (the kernel and the plain version evaluate the same float32
    functions without fast math: ``logf``, ``sqrtf``, and ``sincosf``, which
    gives the values of ``sinf`` and ``cosf`` that ``torch.sin`` and
    ``torch.cos`` call; the scale and +/- cannot be contracted into an FMA)."""
    import torch

    from evotorch_tpu_torch.ops import sampling

    g = torch.Generator(device=device).manual_seed(L)
    mu = torch.randn(L, generator=g, device=device)
    sigma = torch.full((L,), 0.1, device=device)
    seed = sampling.draw_seed(g, device)
    got = sampling.sample_symmetric_gaussian(mu, sigma, popsize, seed=seed)
    ref = sampling.sample_symmetric_gaussian_plain(mu, sigma, popsize, seed=seed)
    torch.cuda.synchronize()
    max_err = float((got - ref).abs().max())
    check(got.shape == (popsize, L), f"sampling shape {tuple(got.shape)}")
    check(torch.equal(got, ref), f"sampling kernel differs from its plain version at {popsize}x{L} by {max_err}")


def fresh_pgpe_state(L, device, *, center=None, stdev_init=0.1):
    """A PGPE state with the JAX benchmark's ``fresh_pgpe_state`` constants:
    center zero unless given, center and stdev learning rates 0.1, stdev
    0.1 unless given, ClipUp, maximize."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe

    return pgpe(
        center_init=torch.zeros(L, device=device) if center is None else center.to(device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=stdev_init,
    )


def flagship(device, *, env=None, network=None, center=None, stdev_init=0.1, reset_noise_scale=0.01):
    """An env (the flagship's Humanoid unless given), its policy (the 64-64
    tanh MLP unless a ``network`` string is given), a fresh PGPE state and
    empty observation statistics."""
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, str_to_net, tanh_mlp

    if env is None:
        env = Humanoid(device=device, reset_noise_scale=reset_noise_scale)
    if network is None:
        policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, HIDDEN))
    else:
        policy = FlatParamsPolicy(str_to_net(network, obs_length=env.observation_size, act_length=env.action_size))
    state = fresh_pgpe_state(policy.parameter_count, device, center=center, stdev_init=stdev_init)
    return env, policy, state, stats_init(env.observation_size, device=device)


def reference_phase(device):
    """A small generation on the card (kernels) against the same generation
    on the CPU (plain versions), with observation normalization off and on:
    popsize 8, 10 steps, noise-free resets and a gentle population (center
    and stdev 0.01, where round-off does not grow chaotically), injected
    noise. With normalization on, the statistics start from 50 made-up
    observations: from none, the first update sees 8 identical noise-free
    reset observations, the stdev hits its 1e-4 floor and the normalization
    multiplies round-off by 1e4. Scores must agree to 1e-4 (returns ~50)
    with equal ranks, the new center and stdev to 1e-5 relative, and the
    observation statistics (sums over 88 observations of magnitude up to
    ~10, taken in another order) to 1e-4 relative or 1e-3 absolute."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.neuroevolution.net import CollectedStats, FlatParamsPolicy, tanh_mlp
    from evotorch_tpu_torch.parallel import make_generation_step

    popsize, steps = 8, 10
    L = FlatParamsPolicy(tanh_mlp(109, 17, HIDDEN)).parameter_count
    center = 0.01 * torch.randn(L, generator=torch.Generator().manual_seed(4))
    eps = torch.randn((popsize // 2, L), generator=torch.Generator().manual_seed(5))
    prior = torch.Generator().manual_seed(6)
    prior_stats = (torch.tensor(50.0), torch.randn(109, generator=prior), 50.0 + torch.rand(109, generator=prior))
    for obs_norm in (False, True):
        results = {}
        for dev in (torch.device("cpu"), device):
            env, policy, state, stats = flagship(dev, center=center, stdev_init=0.01, reset_noise_scale=0.0)
            if obs_norm:
                stats = CollectedStats(*(x.to(dev) for x in prior_stats))
            generation = make_generation_step(
                env,
                policy,
                ask=lambda gen, s, eps=eps.to(dev): pgpe_ask(gen, s, popsize=popsize, eps=eps),
                tell=pgpe_tell,
                popsize=popsize,
                device=dev,
                num_episodes=1,
                episode_length=steps,
                eval_mode="budget",
                observation_normalization=obs_norm,
            )
            new_state, scores, new_stats, total, _ = generation(state, torch.Generator(device=dev).manual_seed(0), stats)
            results[dev.type] = [
                total,
                scores.cpu(),
                new_state.optimizer_state.center.cpu(),
                new_state.stdev.cpu(),
                new_stats.sum.cpu(),
                new_stats.sum_of_squares.cpu(),
            ]
        (n_cpu, s_cpu, *rest_cpu), (n_dev, s_dev, *rest_dev) = results["cpu"], results[device.type]
        score_err = float((s_cpu - s_dev).abs().max())
        check(n_cpu == n_dev == popsize * steps, "reference step counts")
        check(bool(torch.isfinite(s_dev).all()) and score_err <= 1e-4, f"card vs CPU scores differ by {score_err}")
        check(torch.equal(torch.argsort(s_cpu), torch.argsort(s_dev)), "card vs CPU score ranks differ")
        tolerances = ((1e-5, 1e-7), (1e-5, 1e-7), (1e-4, 1e-3), (1e-4, 1e-3))
        names = ("center", "stdev", "stats sum", "stats sum of squares")
        for name, (rtol, atol), a, b in zip(names, tolerances, rest_dev, rest_cpu):
            check(torch.allclose(a, b, rtol=rtol, atol=atol), f"card vs CPU {name} differs")
        print(
            f"[reference] popsize {popsize} x {steps} steps, observation normalization {obs_norm}, card vs CPU:"
            f" max score diff {score_err:.3g} (tolerance 1e-4), same ranks; center, stdev and stats agree"
        )


def main_path_phase(device):
    """The flagship generation, ``MAIN_GENERATIONS`` of them from one state.
    Returns each generation's scores and new center (the ``multigpu`` phase
    holds its sharded generations against them)."""
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.parallel import make_generation_step

    env, policy, state, stats = flagship(device)
    generation = make_generation_step(
        env,
        policy,
        ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE),
        tell=pgpe_tell,
        popsize=POPSIZE,
        device=device,
        num_episodes=1,
        episode_length=EPISODE_LENGTH,
        eval_mode="budget",
    )
    scores, centers = [], []
    _run_generations(
        "[main]", generation, state, stats, device, [f"generation {i}" for i in range(MAIN_GENERATIONS)],
        popsize=POPSIZE, steps_each=EPISODE_LENGTH, restarts=True, scores_out=scores, centers_out=centers,
    )  # fmt: skip
    return scores, centers


CONTRACT_POPSIZE = 1_000


def _contract_runs(device, num_episodes):
    """The contracts reference on one device: CartPole, continuous actions,
    a seeded ``Linear(4, 1)`` policy, reset noise from one seeded table."""
    import torch

    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import (
        FlatParamsPolicy,
        Linear,
        run_vectorized_rollout,
        run_vectorized_rollout_compacting,
    )

    n = CONTRACT_POPSIZE
    env = CartPole(continuous_actions=True, device=device)
    policy = FlatParamsPolicy(Linear(4, 1))
    params = torch.randn((n, policy.parameter_count), generator=torch.Generator().manual_seed(21)).to(device)
    table = env.reset_noise(n * num_episodes, torch.Generator().manual_seed(22)).to(device)
    kw = dict(num_episodes=num_episodes, episode_length=EPISODE_LENGTH, reset_noise=table)
    runs = {
        "episodes": run_vectorized_rollout(env, policy, params, None, None, **kw),
        "episodes_refill@128": run_vectorized_rollout(env, policy, params, None, None, eval_mode="episodes_refill", refill_width=128, **kw),
        "episodes_refill@default": run_vectorized_rollout(env, policy, params, None, None, eval_mode="episodes_refill", **kw),
        "episodes_compact": run_vectorized_rollout_compacting(
            env, policy, params, None, None, allowed_widths=(64, 128, 256), chunk_size=10, **kw
        ),
    }
    return runs


def _scores_agree(a, b):
    """Share of scores within 1e-4 relative, and the worst lanes."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    rel = (a - b).abs() / torch.clamp(b.abs(), min=1e-12)
    share = float((rel <= 1e-4).double().mean())
    worst = torch.argsort(rel, descending=True)[:3].tolist()
    return share, [(i, float(a[i]), float(b[i])) for i in worst]


def contracts_phase(device):
    """The episodes contracts on the card against the same contracts on the
    CPU. Exact on each device: episodes = N * E, the telemetry's env_steps
    and episodes equal the result's counters, lane_width is N (or W for
    refill), refill_events = N * E - W, the health count is N, and at E = 1
    the contracts' scores agree (bit for bit on the CPU, 99.9% within 1e-4
    relative on the card). Card against CPU: an episode ends when a
    threshold is crossed, so one ulp can move an end by a step: at least
    99.9% of the scores within 1e-4 relative, total_steps within 0.1%."""
    import torch

    from evotorch_tpu_torch.neuroevolution.net.vecrl import _default_refill_width
    from evotorch_tpu_torch.observability import GroupTelemetry

    n = CONTRACT_POPSIZE
    for num_episodes in (1, 2):
        results = {}
        for dev in (device, torch.device("cpu")):
            runs = _contract_runs(dev, num_episodes)
            for name, result in runs.items():
                tele = GroupTelemetry.from_array(result.telemetry)
                tot = tele.total()
                width = {"episodes_refill@128": 128, "episodes_refill@default": _default_refill_width(n * num_episodes)}.get(name, n)
                where = f"[contracts] {dev.type} {name} E={num_episodes}"
                check(int(result.total_episodes) == n * num_episodes == tot.episodes, f"{where}: episodes {tot.summary()}")
                check(tot.env_steps == result.total_steps, f"{where}: env_steps {tot.env_steps} vs {result.total_steps}")
                check(tot.lane_width == width, f"{where}: lane_width {tot.lane_width}, expected {width}")
                expected_refills = n * num_episodes - width if name.startswith("episodes_refill") else 0
                check(tot.refill_events == expected_refills, f"{where}: refill_events {tot.refill_events}")
                check(tele.score_stats()["count"] == n, f"{where}: health count {tele.score_stats()['count']}")
                check(bool(torch.isfinite(result.scores).all()), f"{where}: scores not finite")
            if num_episodes == 1:
                ref = runs["episodes"].scores
                for name, result in runs.items():
                    if dev.type == "cpu":
                        check(torch.equal(result.scores, ref), f"[contracts] cpu {name}: differs from episodes")
                    else:
                        share, worst = _scores_agree(result.scores, ref)
                        check(share >= 0.999, f"[contracts] card {name}: {share:.4%} agree with episodes, worst {worst}")
            results[dev.type] = runs
        for name in results["cpu"]:
            card, cpu = results[device.type][name], results["cpu"][name]
            share, worst = _scores_agree(card.scores, cpu.scores)
            steps_off = abs(card.total_steps - cpu.total_steps) / cpu.total_steps
            tele = GroupTelemetry.from_array(card.telemetry).total()
            print(
                f"[contracts] {name} E={num_episodes}: card vs CPU {share:.4%} of scores within 1e-4 relative,"
                f" worst lanes (lane, card, CPU) {worst}; total_steps {card.total_steps} vs {cpu.total_steps}"
                f" ({steps_off:.3%}); card telemetry {tele.summary()}"
            )
            check(share >= 0.999, f"[contracts] {name} E={num_episodes}: only {share:.4%} of scores agree")
            check(steps_off <= 0.001, f"[contracts] {name} E={num_episodes}: total_steps differ by {steps_off:.3%}")
    recurrent_layers_reference(device)
    recurrent_contracts_reference(device)


# float32 products of at most 16 terms of magnitude up to ~2 (the inputs are
# normal, the weights uniform within 1/sqrt(fan)), summed in another order on
# the card: a few ulps of the partial sums
LAYER_ATOL, LAYER_RTOL = 1e-5, 1e-5
RECURRENT_LAYERS = {
    "RNN": "RNN(4, 16)",
    "LSTM": "LSTM(4, 16)",
    "FeedForwardNet": "FeedForwardNet(4, [(16, Tanh()), (8, ReLU()), (1, None)])",
    "StructuredControlNet": "StructuredControlNet(in_features=4, out_features=1, num_layers=2, hidden_size=16)",
    "LocomotorNet": "LocomotorNet(in_features=4, out_features=1, num_sinusoids=16)",
}


def recurrent_layers_reference(device):
    """One forward of each new layer at popsize 1,000 on the card against
    the CPU, from parameters drawn with the JAX ``init``'s distributions and
    a state from one earlier step for the recurrent cells."""
    import torch

    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net
    from evotorch_tpu_torch.neuroevolution.net.layers import map_state, state_leaves

    n = CONTRACT_POPSIZE
    for name, spec in RECURRENT_LAYERS.items():
        policy = FlatParamsPolicy(str_to_net(spec))
        g = torch.Generator().manual_seed(31)
        params = torch.stack([policy.init_parameters(g) for _ in range(n)])
        x0, x1 = torch.randn((2, n, 4), generator=g)
        _, state = policy(params, x0)
        outs = {}
        for dev in (torch.device("cpu"), device):
            y, new_state = policy(params.to(dev), x1.to(dev), map_state(lambda t: t.to(dev), state))
            outs[dev.type] = [y.cpu()] + [t.cpu() for t in state_leaves(new_state)]
        errs = [float((a - b).abs().max()) for a, b in zip(outs[device.type], outs["cpu"])]
        for a, b in zip(outs[device.type], outs["cpu"]):
            check(torch.allclose(a, b, rtol=LAYER_RTOL, atol=LAYER_ATOL), f"[contracts] {name}: card vs CPU differ by {max(errs):.3g}")
        print(
            f"[contracts] {spec}, popsize {n}, L {policy.parameter_count}: one forward{'' if state is None else ' from a state'},"
            f" card vs CPU max abs diff {max(errs):.3g} (tolerance atol {LAYER_ATOL}, rtol {LAYER_RTOL})"
        )


def recurrent_contracts_reference(device):
    """``RNN >> Linear`` and ``LSTM >> Linear`` on CartPole (continuous
    actions, popsize 1,000, 200 steps, one episode) under ``episodes``,
    refill at 128 lanes and compaction, with one reset table and one
    action-noise table (stdev 0.2): equal bit for bit across the contracts
    on each device, and the card against the CPU as in
    :func:`contracts_phase`. The population is drawn with the JAX
    ``init``'s distributions (``init_parameters``): at N(0, 1) weights the
    RNN's closed loop is chaotic (a one-ulp change of the parameters moves
    1.2% of the CPU's scores by more than 1e-4), at the init's scale it
    moves none."""
    import torch

    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import (
        FlatParamsPolicy,
        run_vectorized_rollout,
        run_vectorized_rollout_compacting,
        str_to_net,
    )

    n, stdev = CONTRACT_POPSIZE, 0.2
    for cell in ("RNN", "LSTM"):
        policy = FlatParamsPolicy(str_to_net(f"{cell}(4, 16) >> Linear(16, 1)"))
        g = torch.Generator().manual_seed(23)
        params = torch.stack([policy.init_parameters(g) for _ in range(n)])
        results = {}
        for dev in (device, torch.device("cpu")):
            env = CartPole(continuous_actions=True, device=dev)
            kw = dict(
                episode_length=EPISODE_LENGTH,
                action_noise_stdev=stdev,
                reset_noise=env.reset_noise(n, torch.Generator().manual_seed(24)).to(dev),
                action_noise=(stdev * torch.randn((n, EPISODE_LENGTH, 1), generator=torch.Generator().manual_seed(25))).to(dev),
            )
            p = params.to(dev)
            runs = {
                "episodes": run_vectorized_rollout(env, policy, p, None, None, **kw),
                "episodes_refill@128": run_vectorized_rollout(env, policy, p, None, None, eval_mode="episodes_refill", refill_width=128, **kw),
                "episodes_compact": run_vectorized_rollout_compacting(
                    env, policy, p, None, None, allowed_widths=(64, 128, 256), chunk_size=10, **kw
                ),
            }
            for name, result in runs.items():
                where = f"[contracts] {cell} {dev.type} {name}"
                check(bool(torch.isfinite(result.scores).all()), f"{where}: scores not finite")
                check(int(result.total_episodes) == n, f"{where}: episodes {int(result.total_episodes)}")
                ref = runs["episodes"]
                check(
                    torch.equal(result.scores, ref.scores) and result.total_steps == ref.total_steps,
                    f"{where}: differs from episodes ({_scores_agree(result.scores, ref.scores)})",
                )
            results[dev.type] = runs
            print(f"[contracts] {cell} >> Linear {dev.type}: 3 contracts equal bit for bit")
        for name in results["cpu"]:
            card, cpu = results[device.type][name], results["cpu"][name]
            share, worst = _scores_agree(card.scores, cpu.scores)
            steps_off = abs(card.total_steps - cpu.total_steps) / cpu.total_steps
            print(
                f"[contracts] {cell} >> Linear {name}, action noise {stdev}: card vs CPU {share:.4%} of scores within 1e-4"
                f" relative, worst lanes {worst}; total_steps {card.total_steps} vs {cpu.total_steps} ({steps_off:.3%})"
            )
            check(share >= 0.999, f"[contracts] {cell} {name}: only {share:.4%} of scores agree")
            check(steps_off <= 0.001, f"[contracts] {cell} {name}: total_steps differ by {steps_off:.3%}")


def flagship_contracts_phase(device, *, network=None, tag="[flagship]", episodes_labels=("generation 0",), episodes_out=None):
    """The flagship generation (with the ``network`` string's policy when
    given) under each episodes contract, one generation each (one per
    ``episodes_labels`` under ``episodes``). ``episodes_out`` (a list)
    receives the ``episodes`` generations' scores and new centers."""
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout_compacting
    from evotorch_tpu_torch.parallel import make_generation_step

    for contract in ("episodes", "episodes_refill", "episodes_compact"):
        env, policy, state, stats = flagship(device, network=network)
        kw = dict(num_episodes=1, episode_length=EPISODE_LENGTH)
        if contract == "episodes_compact":

            def generation(s, generator, st):
                values = pgpe_ask(generator, s, popsize=POPSIZE)
                result = run_vectorized_rollout_compacting(env, policy, values, generator, st, chunk_size=25, **kw)
                return pgpe_tell(s, values, result.scores), result.scores, result.stats, result.total_steps, result.telemetry

        else:
            generation = make_generation_step(
                env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE,
                device=device, eval_mode=contract, **kw,
            )  # fmt: skip
        runs = ([], []) if contract == "episodes" else (None, None)
        _run_generations(
            f"{tag} {contract}", generation, state, stats, device,
            episodes_labels if contract == "episodes" else ("generation 0",), popsize=POPSIZE, scores_out=runs[0],
            centers_out=runs[1],
        )  # fmt: skip
        if contract == "episodes" and episodes_out is not None:
            episodes_out.extend(runs)
        del env, policy, state, stats, generation


OO_NETWORK = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
OO_GENERATIONS = 2


def oo_phase(device):
    """The flagship example through the object API (see the module note)."""
    import pickle
    import tempfile

    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout

    problem = VecNE(
        "humanoid",
        OO_NETWORK,
        observation_normalization=True,
        episode_length=EPISODE_LENGTH,
        eval_mode="budget",
        compute_dtype=torch.bfloat16,
        seed=0,
    )
    searcher = PGPE(
        problem,
        popsize=POPSIZE,
        center_learning_rate=0.06,
        stdev_learning_rate=0.1,
        radius_init=0.27,
        optimizer="clipup",
        optimizer_config={"max_speed": 0.12},
        ranking_method="centered",
    )
    StdOutLogger(searcher, interval=1)
    rows = _oo_run("[oo]", searcher, OO_GENERATIONS)

    interactions = int(searcher.status["total_interaction_count"])
    check(interactions == OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[oo] total_interaction_count {interactions}")
    obs_count = problem.obs_norm.count
    check(obs_count == OO_GENERATIONS * POPSIZE * (EPISODE_LENGTH + 1), f"[oo] observation count {obs_count}")
    center = searcher.status["center"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "humanoid_center.pkl")
        problem.save_solution(center, path)
        with open(path, "rb") as f:
            saved = pickle.load(f)
    check(
        saved["values"].shape == (problem.solution_length,)
        and bool((torch.from_numpy(saved["values"]) == center.cpu()).all())
        and saved["obs_mean"].shape == (problem.env.observation_size,),
        "[oo] save_solution did not read back",
    )
    mean_evals = ", ".join("%.3f" % r["mean_eval"] for r in rows)
    print(
        f"[oo] flagship example, popsize {POPSIZE}, L {problem.solution_length}, budget {EPISODE_LENGTH} steps, bf16,"
        f" observation normalization: mean_eval {mean_evals}; {interactions:,} interactions; observation count"
        f" {obs_count:,.0f}; save_solution read back"
    )

    # one more generation: episodes, float32, no normalization; VecNE and
    # the functional engine on one population and one reset table
    plain = VecNE("humanoid", OO_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="episodes", seed=1)
    generator = torch.Generator(device=device).manual_seed(3)
    values = searcher.distribution.sample(POPSIZE, generator=generator)
    table = plain.env.reset_noise(POPSIZE, generator)
    batch = SolutionBatch(plain, POPSIZE, values=values)
    plain.evaluate(batch, reset_noise=table)
    oo_scores = batch.evals[:, 0].clone()
    result = run_vectorized_rollout(
        plain.env,
        plain.policy,
        values,
        generator,
        plain.obs_norm.stats,
        eval_mode="episodes",
        episode_length=EPISODE_LENGTH,
        nonfinite_quarantine=True,
        reset_noise=table,
    )
    check(bool(torch.isfinite(oo_scores).all()), "[oo] episodes scores not finite")
    check(torch.equal(oo_scores, result.scores), f"[oo] VecNE and the functional engine differ by {float((oo_scores - result.scores).abs().max())}")
    check(int(plain.status["total_interaction_count"]) == result.total_steps, "[oo] episodes interaction counts differ")
    print(
        f"[oo] episodes, float32, no normalization: VecNE.evaluate and run_vectorized_rollout on one population and"
        f" one reset table score the same bit for bit ({result.total_steps:,} env steps)"
    )


def _launches(since=None) -> dict:
    """The sampling and ranking kernels' launches since ``since`` (an earlier
    return of this function; from the process's start when None), read
    from the counter registry (``programs.kernel_launches``)."""
    from evotorch_tpu_torch.observability.programs import kernel_launches

    now, since = kernel_launches(), since or {}
    return {k: now.get(k, 0) - since.get(k, 0) for k in ONE_EACH}


def _run_generations(
    tag, generation, state, stats, device, labels, *, popsize, steps_each=None, restarts=False,
    expected_launches=ONE_EACH, scores_out=None, centers_out=None,
):  # fmt: skip
    """One generation per label, its kernel launches counted: each must
    launch each kernel as ``expected_launches`` says (by default once: one
    ask, one tell), give finite scores, move the center and count
    ``popsize`` scores on its telemetry, ``popsize`` episodes unless lanes
    that end restart (``restarts``, the ``budget`` contract) and, with
    ``steps_each``, that many env steps for each solution. ``scores_out``
    (a list) receives each generation's scores and ``centers_out`` its new
    center."""
    import torch

    from evotorch_tpu_torch.observability import GroupTelemetry

    generator = torch.Generator(device=device).manual_seed(0)
    for label in labels:
        center_before = state.optimizer_state.center.clone()
        before = _launches()
        state, scores, stats, total_steps, telemetry = generation(state, generator, stats)
        launches = _launches(before)
        if scores_out is not None:
            scores_out.append(scores)
        if centers_out is not None:
            centers_out.append(state.optimizer_state.center.clone())
        decoded = GroupTelemetry.from_array(telemetry)
        tot = decoded.total()
        where = f"{tag} {label}"
        check(scores.shape == (popsize,) and bool(torch.isfinite(scores).all()), f"{where}: scores not finite")
        check(not torch.equal(center_before, state.optimizer_state.center), f"{where}: the center did not move")
        check(tot.env_steps == total_steps, f"{where}: env_steps {tot.env_steps} vs total_steps {total_steps}")
        check(decoded.score_stats()["count"] == popsize, f"{where}: health count {decoded.score_stats()['count']}")
        check(launches == expected_launches, f"{where}: launches {launches}, expected {expected_launches}")
        if not restarts:
            check(tot.episodes == popsize, f"{where}: episodes {tot.episodes}")
        if steps_each is not None:
            check(total_steps == popsize * steps_each and tot.capacity == total_steps, f"{where}: total_steps {total_steps}")
        print(
            f"{where}: {tot.env_steps} env steps, {tot.episodes} episodes; launches {launches}; mean score"
            f" {float(scores.mean()):.3f}, best {float(scores.max()):.3f}"
        )


def _oo_run(tag, searcher, generations, expected=None):
    """``searcher.run(generations)``; returns the logged rows. The kernels'
    launches must be ``expected`` (by default one sampling a generation,
    and one ranking for every tell: none in the first generation)."""
    rows = []
    searcher.log_hook.append(rows.append)
    before = _launches()
    searcher.run(generations)
    launches = _launches(before)
    searcher.log_hook.remove(rows.append)
    if expected is None:
        expected = {"symmetric_gaussian": generations, "centered_rank": generations - 1}
    check(launches == expected, f"{tag} launches {launches}")
    check(len(rows) == generations and all(math.isfinite(r["mean_eval"]) for r in rows), f"{tag} a logged mean_eval is not finite")
    return rows


ANT_BUDGET_GENERATIONS = 1
ANT_OO_GENERATIONS = 2


def ant_phase(device):
    """``bench.py``'s ``BENCH_ENV=ant`` configuration (Ant, popsize 10,000,
    ``tanh_mlp(79, 8, [64, 64])``, 9,800 parameters, 200-step episodes, the
    flagship's PGPE constants): ``ANT_BUDGET_GENERATIONS`` generation under
    ``budget`` and 1 under ``episodes`` through ``make_generation_step``,
    then ``run(2)`` through ``VecNE("ant", ...)``, ``PGPE`` and
    ``StdOutLogger``."""
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.envs import Ant
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.parallel import make_generation_step

    env = Ant(device=device)
    for contract, count in (("budget", ANT_BUDGET_GENERATIONS), ("episodes", 1)):
        env, policy, state, stats = flagship(device, env=env)
        L = policy.parameter_count
        check((env.observation_size, env.action_size, L) == (79, 8, 9_800), f"[ant] dimensions {env.observation_size}, {env.action_size}, {L}")
        generation = make_generation_step(
            env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE,
            device=device, eval_mode=contract, num_episodes=1, episode_length=EPISODE_LENGTH,
        )  # fmt: skip
        _run_generations(
            f"[ant] {contract}", generation, state, stats, device, [f"generation {i}" for i in range(count)],
            popsize=POPSIZE, steps_each=EPISODE_LENGTH if contract == "budget" else None, restarts=contract == "budget",
        )  # fmt: skip
    del generation, state, stats

    problem = VecNE("ant", OO_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="episodes", seed=0)
    searcher = PGPE(
        problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, optimizer="clipup",
    )  # fmt: skip
    StdOutLogger(searcher, interval=1)
    rows = _oo_run("[ant] oo", searcher, ANT_OO_GENERATIONS)
    interactions = int(searcher.status["total_interaction_count"])
    check(0 < interactions <= ANT_OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[ant] oo total_interaction_count {interactions}")
    print(
        f"[ant] oo: VecNE('ant') + PGPE + StdOutLogger, popsize {POPSIZE}, L {problem.solution_length}, episodes of"
        f" {EPISODE_LENGTH} steps: mean_eval {', '.join('%.3f' % r['mean_eval'] for r in rows)}; {interactions:,}"
        f" interactions"
    )


LOCOMOTION_POPSIZE = 1_000
LOCOMOTION_STEPS = 50
# parameter scale of each env's population in the card-against-CPU check: a
# gentle population for the rigid bodies, whose closed loops part through
# round-off within a few steps at wider ones (a one-ulp change of the
# parameters and reset rows on the CPU leaves 0-13% of the Ant's,
# HalfCheetah's and Humanoid's 50-step returns within 1e-4 at scale 0.1, and
# 75-100% at 0.001); the SLIP Hopper is smooth at any scale (100% at 0.5)
LOCOMOTION_SCALE = {"ant": 0.001, "halfcheetah": 0.001, "walker2d": 0.001, "hopper": 0.5}


def _with_ends(env, state):
    """Lanes that end, so that the done masks are compared where they are
    set: every 10th lane starts 1-50 steps short of the time limit (2 lanes
    end on each of the 50 steps), and, on a rigid body with a healthy band,
    every 10th lane from the 5th is launched straight up at 1.2-1.6 times
    the speed that carries the torso to the band's top: it leaves the band
    on a step that its own floats decide and, at the lower speeds, falls
    back into it within the 50 steps, in free flight, where round-off does
    not grow enough to move the step of either crossing."""
    import dataclasses

    import torch

    lanes = torch.arange(state.t.shape[0], device=state.t.device)
    short = env.max_episode_steps - 1 - (lanes // 10) % LOCOMOTION_STEPS
    t = torch.where(lanes % 10 == 0, short.to(state.t.dtype), state.t)
    st = state.obs_state
    if getattr(env, "alive_bonus", 0.0) and isinstance(st, tuple):
        top = env.healthy_z_range[1]
        g = -float(env.sys.gravity[2])
        speed = torch.sqrt(2 * g * torch.clamp(top - st.pos[0, 2], min=0.0)) * (1.2 + 0.4 * ((lanes // 10) % 10) / 9)
        vz = torch.where(lanes % 10 == 5, st.vel[:, 2] + speed, st.vel[:, 2])
        st = st._replace(vel=torch.stack((st.vel[:, 0], st.vel[:, 1], vz), dim=1))
    return dataclasses.replace(state, obs_state=st, t=t)


def _locomotion_run(name, device):
    """``LOCOMOTION_STEPS`` control steps of a seeded ``Linear(obs, act)``
    population from one seeded reset table, by ``batch_step`` from the
    table's states with :func:`_with_ends` (the first step's observations
    and rewards, every step's done mask, the returns up to the first done)
    and by the ``episodes`` contract from the table alone."""
    import torch

    from evotorch_tpu_torch.envs import make_env
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, run_vectorized_rollout

    n = LOCOMOTION_POPSIZE
    env = make_env(name, device=device)
    policy = FlatParamsPolicy(Linear(env.observation_size, env.action_size))
    g = torch.Generator().manual_seed(41)
    params = (LOCOMOTION_SCALE[name] * torch.randn((n, policy.parameter_count), generator=g)).to(device)
    table = env.reset_noise(n, torch.Generator().manual_seed(42)).to(device)
    state, obs = env.batch_reset_from(table)
    state = _with_ends(env, state)
    returns = torch.zeros(n, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    dones = []
    first = None
    for step in range(LOCOMOTION_STEPS):
        state, obs, reward, done = env.batch_step(state, policy(params, obs)[0])
        if first is None:
            first = (obs.clone(), reward.clone())
        returns = returns + torch.where(alive, reward, 0.0)
        alive = alive & ~done
        dones.append(done)
    rollout = run_vectorized_rollout(
        env, policy, params, None, None, num_episodes=1, episode_length=LOCOMOTION_STEPS, reset_noise=table
    )
    return {
        "obs": first[0].cpu(),
        "reward": first[1].cpu(),
        "dones": torch.stack(dones).cpu(),
        "returns": returns.cpu(),
        "scores": rollout.scores.cpu(),
        "total_steps": rollout.total_steps,
    }


PHYSICS_TOL = 1e-3  # the widest |x - x_plain| / max(1, |x_plain|) of one control step
# the widest such gap of the fused step's observation and reward against the
# plain ones of the kernel's own new state: the same bodies, so only the
# order of float32 operations differs (a Humanoid observation's entries are
# of order 0.1-10)
EPILOGUE_TOL = 1e-4


def _widest_gap(got, want) -> float:
    return max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(got, want))


def _fused_step_check(env, st, t, rows, where):
    """One ``batch_step`` of the Humanoid's CUDA lanes ``st`` at clocks ``t``
    with actions ``rows`` ``(B, num_act)``: one launch, counted as
    ``env.step.fused``; its state bit for bit the physics-alone launch's on
    the clamped actions; the observation and reward within ``EPILOGUE_TOL``
    of ``_batch_obs`` and ``_batch_reward_done`` of that state, done and
    ``t + 1`` exact. Returns the clamped actions ``(num_act, B)``, the state
    and the done mask."""
    import torch

    from evotorch_tpu_torch.envs import rigidbody as rb
    from evotorch_tpu_torch.envs.base import EnvState
    from evotorch_tpu_torch.observability import counters
    from evotorch_tpu_torch.observability.programs import kernel_launches

    lanes = rows.shape[0]
    before = counters.snapshot(("env.step.fused", "env.step.eager"))
    launches = kernel_launches()["rigid_body_step"]
    stepped, obs, reward, done = env.batch_step(EnvState(obs_state=st, t=t), rows)
    check(kernel_launches()["rigid_body_step"] - launches == 1, f"{where}: not one launch")
    check(counters.delta(before) == {"env.step.fused": 1, "env.step.eager": 0}, f"{where}: counted {counters.delta(before)}")
    a = torch.clamp(rows, env.action_space.lb, env.action_space.ub).t()
    alone = rb.physics_step_batched(env.sys, st, a, env.dt, env.substeps)
    check(all(torch.equal(x, y) for x, y in zip(stepped.obs_state, alone)), f"{where}: the state is not the physics launch's")
    check(
        obs.shape == (lanes, env.observation_size) and obs.dtype == torch.float32 and obs.is_contiguous(),
        f"{where}: observations {tuple(obs.shape)} {obs.dtype}",
    )
    want_reward, want_done = env._batch_reward_done(stepped.obs_state, a, t + 1)
    gap = _widest_gap((obs, reward), (env._batch_obs(stepped.obs_state), want_reward))
    check(gap <= EPILOGUE_TOL, f"{where}: observation or reward off the plain path by {gap}")
    check(torch.equal(done, want_done), f"{where}: {int((done != want_done).sum())} done flags differ")
    check(torch.equal(stepped.t, t + 1), f"{where}: the episode clocks differ from t + 1")
    return a, stepped.obs_state, done, gap


def _physics_kernel_check(device):
    """The rigid-body kernel against the plain loop of substeps on the card,
    at the benchmark cells' lanes (10,000 and 2,048, neither a whole number
    of 64-lane blocks): one Humanoid control step from states that 30 steps
    of a random policy drove into contact and joint limits, one launch each,
    within ``PHYSICS_TOL``. Then the main path's launches on the same lanes
    (:func:`_fused_step_check`), episode clocks at the time limit on every
    4th lane: ``batch_step`` with the same actions, its state also within
    ``PHYSICS_TOL`` of the plain loop; ``batch_step`` with the actions 1.5
    times as large (a third of each range past the action space) and every
    4th lane from the 3rd lifted 1 m, above the healthy band; and
    ``batch_reset_from`` (one launch), its observation within
    ``EPILOGUE_TOL`` of ``_batch_obs``."""
    import torch

    from evotorch_tpu_torch.envs import rigidbody as rb
    from evotorch_tpu_torch.observability.programs import kernel_launches
    from evotorch_tpu_torch.ops import kernel_times

    for lanes in kernel_times.PHYSICS_LANES:
        env, st, actions = kernel_times.humanoid_states(lanes, device, seed=lanes)
        sys = env.sys
        launches = kernel_launches().get("rigid_body_step", 0)
        got = rb.physics_step_batched(sys, st, actions, env.dt, env.substeps)
        check(kernel_launches()["rigid_body_step"] - launches == 1, f"[locomotion] physics at {lanes} lanes: not one launch")
        want = rb.physics_step_batched_plain(sys, st, actions, env.dt, env.substeps)
        gap = _widest_gap(got, want)
        check(gap <= PHYSICS_TOL, f"[locomotion] physics at {lanes} lanes: kernel and plain loop differ by {gap}")
        contact = int((rb.sphere_penetrations_batched(sys, st) > 0).any(0).sum())
        angles = rb.joint_angles_batched(sys, st)
        past = (angles > sys.limit_hi[:, :, None]) | (angles < sys.limit_lo[:, :, None])
        limit = int((past & (sys.free[:, :, None] > 0)).flatten(0, 1).any(0).sum())
        check(contact > 0 and limit > 0, f"[locomotion] physics at {lanes} lanes: {contact} lanes in contact, {limit} at a limit")

        # the main path: the env's whole step on the same lanes and actions
        where = f"[locomotion] fused step at {lanes} lanes"
        lane = torch.arange(lanes, device=device, dtype=torch.int32)
        t = torch.where(lane % 4 == 0, env.max_episode_steps - 1, lane % 97)
        _, new, done, obs_gap = _fused_step_check(env, st, t, actions.t(), where)
        state_gap = _widest_gap(new, want)
        check(state_gap <= PHYSICS_TOL, f"{where}: the state differs from the plain loop by {state_gap}")
        ended, by_band = int(done.sum()), int((done & (t + 1 < env.max_episode_steps)).sum())

        # actions past the bounds and lanes above the band
        pos = st.pos.clone()
        pos[:, 2, 2::4] += 1.0
        lifted = st._replace(pos=pos)
        a, new, done, wide_gap = _fused_step_check(env, lifted, t, 1.5 * actions.t(), f"{where}, saturated and lifted")
        plain_gap = _widest_gap(new, rb.physics_step_batched_plain(sys, lifted, a, env.dt, env.substeps))
        lifted_out = int((done & (lane % 4 == 2)).sum())
        check(ended > by_band and lifted_out > 0, f"{where}: {ended} lanes done, {by_band} by the band, {lifted_out} lifted")

        noise = env.reset_noise(lanes, torch.Generator(device=device).manual_seed(lanes + 1))
        launches = kernel_launches()["rigid_body_step"]
        reset, reset_obs = env.batch_reset_from(noise)
        check(kernel_launches()["rigid_body_step"] - launches == 1, f"[locomotion] reset at {lanes} lanes: not one launch")
        reset_gap = _widest_gap((reset_obs,), (env._batch_obs(reset.obs_state),))
        check(reset_gap <= EPILOGUE_TOL, f"[locomotion] reset at {lanes} lanes: observation off the plain one by {reset_gap}")
        print(
            f"[locomotion] rigid_body_step, Humanoid at {lanes} lanes ({contact} in contact, {limit} past a joint"
            f" limit): one launch; widest gap to the plain loop {gap:.3g}. The fused step: one launch, its state"
            f" the physics launch's bit for bit ({state_gap:.3g} from the plain loop), observation and reward"
            f" {obs_gap:.3g}, done ({ended}, {by_band} by the band) and t exact; saturated and lifted: the same,"
            f" observation and reward {wide_gap:.3g}, {lifted_out} lifted lanes done, state {plain_gap:.3g} from"
            f" the plain loop (printed: PHYSICS_TOL holds the physics on the unlifted lanes); the reset one launch,"
            f" observation {reset_gap:.3g}"
        )


def locomotion_phase(device):
    """The rigid-body kernel against its plain loop at the benchmark's lanes
    (:func:`_physics_kernel_check`), then Ant, HalfCheetah, Walker2D and
    Hopper on the card against the CPU,
    from the same reset rows and parameters. Exact: the done mask of every
    step (at least the 100 lanes that :func:`_with_ends` ends by the time
    limit end, and on the Ant and Walker2D 100 more leave the healthy band)
    and the rollout's env steps. The first step's observations within
    ``rtol=1e-5, atol=2e-4`` and rewards within ``rtol=1e-5, atol=1e-5`` (the
    CPU parity tests' tolerances for one step). The returns up to the first
    done and the ``episodes`` scores: at least 99% of each within 1e-2
    relative (the shares within 1e-4 and 1e-3 are printed; the closed loops
    are chaotic, see ``LOCOMOTION_SCALE``). Then one HalfCheetah
    ``episodes`` generation under PGPE, so that both kernels run on a
    planar env."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.envs import HalfCheetah
    from evotorch_tpu_torch.parallel import make_generation_step

    _physics_kernel_check(device)
    for name in LOCOMOTION_SCALE:
        card = _locomotion_run(name, device)
        cpu = _locomotion_run(name, torch.device("cpu"))
        where = f"[locomotion] {name}"
        obs_err = float((card["obs"] - cpu["obs"]).abs().max())
        check(torch.allclose(card["obs"], cpu["obs"], rtol=1e-5, atol=2e-4), f"{where}: first-step observations differ by {obs_err}")
        check(torch.allclose(card["reward"], cpu["reward"], rtol=1e-5, atol=1e-5), f"{where}: first-step rewards differ")
        check(torch.equal(card["dones"], cpu["dones"]), f"{where}: done masks differ at steps {torch.nonzero((card['dones'] != cpu['dones']).any(1)).flatten().tolist()}")
        check(card["total_steps"] == cpu["total_steps"], f"{where}: env steps {card['total_steps']} vs {cpu['total_steps']}")
        ended = int(cpu["dones"].any(0).sum())
        check(ended >= LOCOMOTION_POPSIZE // 10, f"{where}: only {ended} lanes end")
        # lanes whose done flag falls back (a torso back in the healthy band)
        returned = int((cpu["dones"][:-1] & ~cpu["dones"][1:]).any(0).sum())
        shares = {}
        for key in ("returns", "scores"):
            check(bool(torch.isfinite(card[key]).all()), f"{where}: {key} not finite")
            a, b = card[key].double(), cpu[key].double()
            rel = (a - b).abs() / torch.clamp(b.abs(), min=1e-12)
            shares[key] = [float((rel <= tol).double().mean()) for tol in (1e-4, 1e-3, 1e-2)]
            check(shares[key][2] >= 0.99, f"{where}: only {shares[key][2]:.2%} of the {key} within 1e-2 relative")
        within = "; ".join(f"{key} {'/'.join(f'{x:.2%}' for x in v)}" for key, v in shares.items())
        print(
            f"{where}: popsize {LOCOMOTION_POPSIZE}, Linear({card['obs'].shape[1]}, .), scale {LOCOMOTION_SCALE[name]},"
            f" {LOCOMOTION_STEPS} steps; done masks equal ({ended} lanes"
            f" end, {returned} of them back in the band later), {card['total_steps']} env steps on both; first step"
            f" max obs diff {obs_err:.3g}; within 1e-4/1e-3/1e-2 relative: {within}"
        )

    env, policy, state, stats = flagship(device, env=HalfCheetah(device=device))
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=LOCOMOTION_POPSIZE), tell=pgpe_tell,
        popsize=LOCOMOTION_POPSIZE, device=device, eval_mode="episodes", num_episodes=1, episode_length=EPISODE_LENGTH,
    )  # fmt: skip
    # HalfCheetah never terminates: every episode runs its 200 steps
    _run_generations(
        "[locomotion] halfcheetah episodes", generation, state, stats, device, ["generation 0"],
        popsize=LOCOMOTION_POPSIZE, steps_each=EPISODE_LENGTH,
    )  # fmt: skip


SUPERVISED_ROWS = 65_536
SUPERVISED_FEATURES = 32
SUPERVISED_NETWORK = "Linear(32, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, 1)"
SUPERVISED_MINIBATCH = 256
SUPERVISED_MINIBATCHES = 4
SUPERVISED_GENERATIONS = 3
SUPERVISED_CHECKED = 64


def _supervised_searcher(device, seed):
    """``SupervisedNE`` on a regression set made with numpy from ``seed``:
    inputs ``(65,536, 32)``, targets from a seeded teacher of the student's
    shape; PGPE at popsize 10,000 with ClipUp."""
    import numpy as np
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import SupervisedNE
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(SUPERVISED_ROWS, SUPERVISED_FEATURES)).astype(np.float32)
    teacher = FlatParamsPolicy(str_to_net(SUPERVISED_NETWORK))
    w = rng.normal(scale=0.3, size=(1, teacher.parameter_count)).astype(np.float32)
    y = teacher(torch.from_numpy(w), torch.from_numpy(X)[None])[0][0].numpy()
    problem = SupervisedNE(
        (X, y), SUPERVISED_NETWORK, minibatch_size=SUPERVISED_MINIBATCH, num_minibatches=SUPERVISED_MINIBATCHES,
        seed=seed, device=device,
    )  # fmt: skip
    searcher = PGPE(
        problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1,
        optimizer="clipup", ranking_method="centered",
    )  # fmt: skip
    return problem, searcher


def supervised_checkpoint_phase(device, seed=0):
    """``SupervisedNE`` at popsize 10,000 (minibatch 256, 4 minibatches),
    ``run(3)`` under PGPE; 64 solutions' losses against a CPU recomputation
    in float64 on the same rows (``rtol=1e-4``); then ``save_searcher`` /
    ``load_searcher`` on the card and one more ``step()`` of each, equal bit
    for bit; then ``save_state`` / ``load_state`` of a functional PGPE state
    on the card."""
    import tempfile

    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.checkpoint import load_searcher, load_state, save_searcher, save_state
    from evotorch_tpu_torch.core import SolutionBatch

    problem, searcher = _supervised_searcher(device, seed)
    rows = _oo_run("[supervised]", searcher, SUPERVISED_GENERATIONS)
    losses = ", ".join("%.4f" % r["mean_eval"] for r in rows)
    print(
        f"[supervised] SupervisedNE {SUPERVISED_ROWS}x{SUPERVISED_FEATURES}, {SUPERVISED_NETWORK},"
        f" L {problem.solution_length}, popsize {POPSIZE}, {SUPERVISED_MINIBATCHES} minibatches of"
        f" {SUPERVISED_MINIBATCH}: mean loss {losses}"
    )

    # 64 solutions' losses against a float64 recomputation on the CPU, on the
    # minibatches the evaluation draws (a twin of the problem's generator)
    values = searcher.population.values[:SUPERVISED_CHECKED].clone()
    twin = torch.Generator(device=device)
    twin.set_state(problem.generator.get_state())
    minibatches = [problem._sample_minibatch(twin) for _ in range(SUPERVISED_MINIBATCHES)]
    batch = SolutionBatch(problem, values=values)
    problem.evaluate(batch)
    got = batch.evals[:, 0].double().cpu()
    params = [p.double() for p in problem.policy.unravel(values.double().cpu())]
    expected = torch.zeros(SUPERVISED_CHECKED, dtype=torch.float64)
    for x, y in minibatches:
        h = x.double().cpu().expand(SUPERVISED_CHECKED, -1, -1)
        for i, (bias, weight) in enumerate(zip(params[0::2], params[1::2])):  # [bias, weight] per Linear
            h = torch.einsum("kmi,koi->kmo", h, weight) + bias[:, None, :]
            if i < 2:
                h = torch.tanh(h)
        expected += ((h - y.double().cpu()) ** 2).mean(dim=(1, 2))
    expected /= SUPERVISED_MINIBATCHES
    loss_err = float(((got - expected).abs() / expected.abs()).max())
    check(torch.allclose(got, expected, rtol=1e-4, atol=0), f"[supervised] card losses differ from the CPU's by {loss_err:.3g} relative")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "searcher.pkl")
        save_searcher(path, searcher)
        loaded = load_searcher(path)
        check(
            loaded.population.values.device == device and loaded.problem.generator.device == device,
            "[checkpoint] the loaded searcher is not on the card",
        )
        searcher.step()
        loaded.step()
        torch.cuda.synchronize()
        same = (
            torch.equal(loaded.population.values, searcher.population.values)
            and torch.equal(loaded.population.evals, searcher.population.evals)
            and torch.equal(loaded.status["center"], searcher.status["center"])
        )
        check(same, "[checkpoint] the loaded searcher's step differs from the saved one's")

        state = fresh_pgpe_state(problem.solution_length, device)
        g = torch.Generator(device=device).manual_seed(5)
        values = pgpe_ask(g, state, popsize=POPSIZE)
        state = pgpe_tell(state, values, -(values**2).sum(dim=1))
        state_path = os.path.join(tmp, "pgpe_state.pt")
        save_state(state_path, state)
        back = load_state(state_path, fresh_pgpe_state(problem.solution_length, device))
        check(
            back.optimizer_state.center.device == device
            and torch.equal(back.optimizer_state.center, state.optimizer_state.center)
            and torch.equal(back.optimizer_state.velocity, state.optimizer_state.velocity)
            and torch.equal(back.stdev, state.stdev),
            "[checkpoint] the functional PGPE state did not round-trip",
        )
    print(
        f"[supervised] 64 losses equal the CPU's float64 recomputation within {loss_err:.3g} relative (rtol 1e-4);"
        f" [checkpoint] searcher saved and loaded, its next step equal to the saved searcher's bit for bit;"
        f" functional PGPE state round-trips on the card"
    )


RECURRENT_NETWORK = "LSTM(obs_length, 64) >> Linear(64, act_length)"
RECURRENT_PARAMETERS = 45_905  # LSTM(109, 64): 4 * 64 * (64 + 109 + 2); Linear(64, 17): 17 * 65
RECURRENT_OO_GENERATIONS = 2
RECURRENT_ACTION_NOISE = 0.05


def recurrent_phase(device):
    """The slice's full-width path (see the module note): the flagship with
    the LSTM policy through ``make_generation_step`` under the four
    contracts, then through ``VecNE`` + ``PGPE`` + ``StdOutLogger`` with
    action noise, and the policy export's state."""
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.parallel import make_generation_step

    env, policy, state, stats = flagship(device, network=RECURRENT_NETWORK)
    L = policy.parameter_count
    check(L == RECURRENT_PARAMETERS, f"[recurrent] {L} parameters, expected {RECURRENT_PARAMETERS}")
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE, device=device,
        eval_mode="budget", num_episodes=1, episode_length=EPISODE_LENGTH,
    )  # fmt: skip
    _run_generations(
        "[recurrent] budget", generation, state, stats, device, ("generation 0",), popsize=POPSIZE,
        steps_each=EPISODE_LENGTH, restarts=True,
    )  # fmt: skip
    del env, policy, state, stats, generation
    flagship_contracts_phase(device, network=RECURRENT_NETWORK, tag="[recurrent]")

    problem = VecNE(
        "humanoid", RECURRENT_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="episodes",
        action_noise_stdev=RECURRENT_ACTION_NOISE, seed=0,
    )  # fmt: skip
    check(problem.solution_length == RECURRENT_PARAMETERS, f"[recurrent] oo solution length {problem.solution_length}")
    searcher = PGPE(
        problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, optimizer="clipup",
        ranking_method="centered",
    )  # fmt: skip
    StdOutLogger(searcher, interval=1)
    rows = _oo_run("[recurrent] oo", searcher, RECURRENT_OO_GENERATIONS)
    interactions = int(searcher.status["total_interaction_count"])
    check(0 < interactions <= RECURRENT_OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[recurrent] oo interactions {interactions}")
    print(
        f"[recurrent] oo: VecNE('humanoid', {RECURRENT_NETWORK!r}, action_noise_stdev={RECURRENT_ACTION_NOISE}) + PGPE +"
        f" StdOutLogger, popsize {POPSIZE}, L {problem.solution_length}, episodes of {EPISODE_LENGTH} steps: mean_eval"
        f" {', '.join('%.3f' % r['mean_eval'] for r in rows)}; {interactions:,} interactions"
    )

    # the policy export: the caller holds the LSTM's (h, c) and hands it back
    batch = 8
    _, obs = problem.env.batch_reset(batch, torch.Generator(device=device).manual_seed(7))
    apply = problem.to_policy_callable(searcher.status["center"])
    first, policy_state = apply(obs)
    check(policy_state is not None and policy_state[1] is None, f"[recurrent] to_policy_callable state {type(policy_state)}")
    h, c = policy_state[0]
    check(h.shape == c.shape == (batch, 64), f"[recurrent] state shapes {tuple(h.shape)}, {tuple(c.shape)}")
    again, _ = apply(obs)
    fed, _ = apply(obs, policy_state)
    check(torch.equal(first, again), "[recurrent] to_policy_callable without a state is not repeatable")
    check(not torch.equal(fed, first), "[recurrent] feeding the state back did not change the next action")
    print(
        f"[recurrent] to_policy_callable(center): (h, c) of shape {tuple(h.shape)} each; fed back, the next actions"
        f" move by up to {float((fed - first).abs().max()):.3g}"
    )


SEARCHERS_TOURNAMENT = 4
SEARCHERS_ETA = 8.0
SEARCHERS_MUTATION = 0.03
COSYNE_PARENTS = POPSIZE // 4
BBO_SNES_GENERATIONS = 300
BBO_CMAES_GENERATIONS = 300
BBO_WIDE_DIMENSION = 1_000
BBO_WIDE_GENERATIONS = 100
MAPELITES_EXAMPLE_GENERATIONS = 50
MAPELITES_WIDE_BINS = 100
MAPELITES_WIDE_DIMENSION = 100
MAPELITES_WIDE_GENERATIONS = 20
MOO_POPSIZE = 64
MOO_GENERATIONS = 100
PARETO_POINTS = 20_000
BATCHED_SEARCHES = 8
BATCHED_POPSIZE = 50
BATCHED_DIMENSION = 20
BATCHED_GENERATIONS = 100
MPC_HORIZON = 15
MPC_POPSIZE = 100
MPC_ITERATIONS = 8
MPC_STEPS = 20
# the card-against-CPU checks, with the same draws on both devices
SMALL_POPSIZE = 64
SMALL_LENGTH = 32
SMALL_CMAES_DIMENSION = 1_000
SMALL_PARETO_POINTS = 2_000
SMALL_TOL = dict(rtol=1e-5, atol=1e-6)


def _rastrigin(x):
    import torch

    return 10 * x.shape[-1] + torch.sum(x**2 - 10 * torch.cos(2 * torch.pi * x), dim=-1)


def _rosenbrock(x):
    import torch

    return torch.sum(100 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1 - x[..., :-1]) ** 2, dim=-1)


def _kursawe(x):
    import torch

    f1 = torch.sum(-10 * torch.exp(-0.2 * torch.sqrt(x[:, :-1] ** 2 + x[:, 1:] ** 2)), dim=-1)
    f2 = torch.sum(torch.abs(x) ** 0.8 + 5 * torch.sin(x**3), dim=-1)
    return torch.stack([f1, f2], dim=1)


def _rastrigin_with_features(x):
    return _rastrigin(x)[:, None], x[:, :2]


def _host_fitness(x):
    """A fitness computed on the host in float64 from the values' bits, so
    that the card's run and the CPU's score equal values equally."""
    import torch

    h = x.detach().double().cpu()
    return (torch.sum(h**2, dim=-1) + torch.sum(torch.cos(3 * h), dim=-1)).float().to(x.device)


def _count_syncs(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: its result and the
    host syncs it made."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own first-use notice ("... a prototype feature ...") is not a sync
    return out, sum(1 for w in caught if "called a synchronizing" in str(w.message).lower())


def _searcher_run(tag, searcher, generations):
    """``searcher.run(generations)`` with its kernel launches counted, the
    solutions each evaluation takes counted (hooks on the problem) and the
    sizes of the centered ranks taken. Returns a dict of these."""
    from evotorch_tpu_torch.tools import ranking as tools_ranking

    problem = searcher.problem
    evaluated, sizes = [], []

    def after(batch):
        evaluated.append(len(batch))

    real_rank = tools_ranking.centered_rank

    def recording_rank(x, **kw):
        sizes.append(int(x.shape[-1]))
        return real_rank(x, **kw)

    problem.after_eval_hook.append(after)
    tools_ranking.centered_rank = recording_rank
    try:
        before = _launches()
        searcher.run(generations)
        launches = _launches(before)
    finally:
        tools_ranking.centered_rank = real_rank
        problem.after_eval_hook.remove(after)
    out = {
        "evaluations": len(evaluated),
        "evaluated": sum(evaluated),
        "launches": launches,
        "rank_sizes": sizes,
        "env_steps": int(problem.status["total_interaction_count"]) if problem.has_status_key("total_interaction_count") else None,
    }
    steps = "" if out["env_steps"] is None else f" {out['env_steps']:,} env steps;"
    print(
        f"{tag}: {generations} generation(s), {out['evaluations']} evaluations of {out['evaluated']:,} solutions;{steps}"
        f" launches {launches}, centered ranks at n = {sorted(set(sizes))} ({len(sizes)} calls)"
    )
    return out


def _flagship_searcher(device, make_searcher, tag, *, rank_sizes, evaluated):
    """One generation of a population searcher on the flagship problem:
    ``VecNE("humanoid", tanh_mlp(109, 17, [64, 64]))``, 200-step episodes,
    one each, contract ``episodes``. The centered-rank kernel must launch
    once per rank of ``rank_sizes`` and the sampling kernel never; the
    population must stay ``POPSIZE`` with finite evals."""
    import torch

    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp

    problem = VecNE("humanoid", tanh_mlp(109, 17, HIDDEN), episode_length=EPISODE_LENGTH, eval_mode="episodes", seed=0)
    check(problem.solution_length == 12_305, f"{tag} solution length {problem.solution_length}")
    searcher = make_searcher(problem)
    out = _searcher_run(tag, searcher, 1)
    population = searcher.population
    check(len(population) == POPSIZE and bool(torch.isfinite(population.evals[:, 0]).all()), f"{tag} population evals")
    check(out["launches"] == {"symmetric_gaussian": 0, "centered_rank": len(rank_sizes)}, f"{tag} launches {out['launches']}")
    check(sorted(out["rank_sizes"]) == sorted(rank_sizes), f"{tag} ranked at n = {out['rank_sizes']}")
    check(out["evaluated"] == evaluated, f"{tag} evaluated {out['evaluated']} solutions, expected {evaluated}")
    check(0 < out["env_steps"] <= evaluated * EPISODE_LENGTH, f"{tag} env steps {out['env_steps']}")
    print(f"{tag}: best {float(searcher.status['pop_best_eval']):.3f}, mean {searcher.status['mean_eval']:.3f}")


class _SharedDraws:
    """The operators', CMA-ES's and the functional samplers' draws taken
    from one seeded CPU generator and moved to the caller's device, so that
    a run on the card and a run on the CPU start from the same draws."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        import torch

        from evotorch_tpu_torch import distributions
        from evotorch_tpu_torch.algorithms.functional import funccmaes
        from evotorch_tpu_torch.neuroevolution.net import lowrank
        from evotorch_tpu_torch.operators import functional as F

        g = torch.Generator().manual_seed(self.seed)
        self._saved = [
            (F, "_draw_tournament", F._draw_tournament),
            (F, "_draw_cut_points", F._draw_cut_points),
            (F, "_draw_uniform", F._draw_uniform),
            (F, "_draw_normal", F._draw_normal),
            (funccmaes, "_draw_local_coordinates", funccmaes._draw_local_coordinates),
            (distributions, "_draw_sampler_noise", distributions._draw_sampler_noise),
            (distributions, "_draw_lowrank_basis", distributions._draw_lowrank_basis),
            (distributions, "_draw_lowrank_coeffs", distributions._draw_lowrank_coeffs),
            (lowrank, "_draw_factor_noise", lowrank._draw_factor_noise),
        ]

        def on_cpu(draw):
            def wrapped(generator, *args):
                *rest, device = args
                out = draw(g, *rest, "cpu")
                return tuple(t.to(device) for t in out) if isinstance(out, tuple) else out.to(device)

            return wrapped

        F._draw_tournament = on_cpu(self._saved[0][2])
        F._draw_cut_points = on_cpu(self._saved[1][2])
        F._draw_uniform = on_cpu(self._saved[2][2])
        F._draw_normal = on_cpu(self._saved[3][2])
        funccmaes._draw_local_coordinates = lambda generator, state: torch.randn(
            (state.popsize, state.m.shape[0]), generator=g, dtype=state.m.dtype
        ).to(state.m.device)
        distributions._draw_sampler_noise = lambda generator, shape, dtype: torch.randn(
            shape, generator=g, dtype=dtype
        ).to(generator.device)
        distributions._draw_lowrank_basis = distributions._draw_sampler_noise
        distributions._draw_lowrank_coeffs = distributions._draw_sampler_noise
        lowrank._draw_factor_noise = lambda generator, stream, shape, dtype: torch.randn(
            shape, generator=g, dtype=dtype
        ).to(generator.device)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _close(a, b, what, tol=SMALL_TOL):
    import torch

    a, b = a.cpu(), b.cpu()
    check(a.shape == b.shape, f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    check(torch.allclose(a, b, equal_nan=True, **tol), f"{what}: card and CPU differ by {float((a - b).abs().nan_to_num().max())}")
    return float((a.double() - b.double()).abs().nan_to_num().max())


def _small_population_searchers(device):
    """One generation each of a GA (SBX and mutation, the flagship's
    operators) and of CoSyNE at popsize 64 on the card and on the CPU, from
    one initial population and the same draws, on a fitness computed on the
    host: the selected populations' values and evals within
    ``SMALL_TOL``, their order equal."""
    import torch

    from evotorch_tpu_torch.algorithms import Cosyne, GeneticAlgorithm
    from evotorch_tpu_torch.core import Problem, SolutionBatch
    from evotorch_tpu_torch.operators.real import GaussianMutation, SimulatedBinaryCrossOver

    start = torch.randn((SMALL_POPSIZE, SMALL_LENGTH), generator=torch.Generator().manual_seed(31))
    errors = {}
    for name in ("ga", "cosyne"):
        results = {}
        for dev in (device, torch.device("cpu")):
            problem = Problem("min", _host_fitness, solution_length=SMALL_LENGTH, initial_bounds=(-1, 1), vectorized=True, device=dev)
            if name == "ga":
                searcher = GeneticAlgorithm(
                    problem, popsize=SMALL_POPSIZE,
                    operators=[
                        SimulatedBinaryCrossOver(problem, tournament_size=SEARCHERS_TOURNAMENT, eta=SEARCHERS_ETA),
                        GaussianMutation(problem, stdev=SEARCHERS_MUTATION),
                    ],
                )  # fmt: skip
            else:
                searcher = Cosyne(problem, popsize=SMALL_POPSIZE, tournament_size=SEARCHERS_TOURNAMENT, mutation_stdev=SEARCHERS_MUTATION)
            searcher._population = SolutionBatch(problem, values=start.to(dev))
            with _SharedDraws(32):
                searcher.step()
            results[dev.type] = searcher.population
        card, cpu = results[device.type], results["cpu"]
        errors[name] = _close(card.values, cpu.values, f"[searchers] small {name} values")
        _close(card.evals, cpu.evals, f"[searchers] small {name} evals")
        check(torch.equal(card.argsort().cpu(), cpu.argsort()), f"[searchers] small {name}: the selections' order differs")
    return errors


def _small_cmaes_and_nes(device):
    """One full CMA-ES tell at d = 1,000 (the factor refreshed: the limit
    off), one XNES and one SNES tell at d = 100, card against CPU from the
    same state and draws; fitnesses from the CPU's population, so both
    tells rank the same bits."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import cmaes, cmaes_ask, cmaes_tell, snes, snes_ask, snes_tell, xnes, xnes_ask, xnes_tell

    errors = {}
    center = torch.randn(SMALL_CMAES_DIMENSION, generator=torch.Generator().manual_seed(33))
    states = {}
    for dev in (device, torch.device("cpu")):
        state = cmaes(center_init=center.to(dev), stdev_init=0.5, objective_sense="min", limit_C_decomposition=False)
        with _SharedDraws(34):
            state, xs = cmaes_ask(None, state)
        states[dev.type] = (state, xs)
    f = _rosenbrock(states["cpu"][1].double()).float()
    told = {k: cmaes_tell(s, xs, f.to(xs.device)) for k, (s, xs) in states.items()}
    for field in ("m", "sigma", "p_sigma", "p_c", "C"):
        errors[f"cmaes_{field}"] = _close(getattr(told[device.type], field), getattr(told["cpu"], field), f"[searchers] small cmaes {field}")
    errors["cmaes_A"] = _close(told[device.type].A, told["cpu"].A, "[searchers] small cmaes A", dict(rtol=1e-4, atol=1e-5))
    for name, init, ask, tell, fields in (
        ("snes", snes, snes_ask, snes_tell, ("center", "stdev")),
        ("xnes", xnes, xnes_ask, xnes_tell, ("center", "A", "A_inv")),
    ):
        out = {}
        for dev in (device, torch.device("cpu")):
            state = init(center_init=center[:100].to(dev), objective_sense="min", stdev_init=0.5)
            with _SharedDraws(35):
                xs = ask(torch.Generator(device=dev), state, popsize=24)
            out[dev.type] = (state, xs)
        f = _rosenbrock(out["cpu"][1].double()).float()
        for field in fields:
            a = getattr(tell(out[device.type][0], out[device.type][1], f.to(device)), field)
            b = getattr(tell(out["cpu"][0], out["cpu"][1], f), field)
            errors[f"{name}_{field}"] = _close(a, b, f"[searchers] small {name} {field}", dict(rtol=1e-4, atol=1e-5))
    return errors


def _small_mapelites_pareto_batched(device):
    """One MAP-Elites step (100-d Rastrigin, a 10 x 10 grid, 100 cells)
    from one archive; ``pareto_ranks`` and ``crowding_distances`` of 2,000
    Kursawe points (ranks exactly); 5 generations of 8 batched CEM searches
    through ``make_search_span``: card against CPU, with the same draws."""
    from functools import partial

    import torch

    from evotorch_tpu_torch.algorithms import MAPElites
    from evotorch_tpu_torch.algorithms.functional import cem, cem_ask, cem_tell, make_search_span
    from evotorch_tpu_torch.core import Problem, SolutionBatch
    from evotorch_tpu_torch.operators import functional as F
    from evotorch_tpu_torch.operators.real import GaussianMutation

    errors = {}
    start = torch.rand((100, MAPELITES_WIDE_DIMENSION), generator=torch.Generator().manual_seed(36)) * 10.24 - 5.12
    archives = {}
    for dev in (device, torch.device("cpu")):
        problem = Problem(
            "min", _rastrigin_with_features, solution_length=MAPELITES_WIDE_DIMENSION, initial_bounds=(-5.12, 5.12),
            eval_data_length=2, vectorized=True, device=dev,
        )  # fmt: skip
        grid = MAPElites.make_feature_grid([-5.12, -5.12], [5.12, 5.12], num_bins=10, device=dev)
        searcher = MAPElites(problem, operators=[GaussianMutation(problem, stdev=0.5)], feature_grid=grid)
        searcher._population = SolutionBatch(problem, values=start.to(dev))
        with _SharedDraws(37):
            searcher.step()
        archives[dev.type] = searcher
    card, cpu = archives[device.type], archives["cpu"]
    check(torch.equal(card.filled.cpu(), cpu.filled), "[searchers] small mapelites: filled cells differ")
    errors["mapelites_values"] = _close(card.population.values[card.filled], cpu.population.values[cpu.filled], "[searchers] small mapelites values")

    points = torch.rand((SMALL_PARETO_POINTS, 3), generator=torch.Generator().manual_seed(38)) * 10 - 5
    evals = _kursawe(points)
    sense = ["min", "min"]
    ranks = F.pareto_ranks(evals.to(device), objective_sense=sense)
    check(torch.equal(ranks.cpu(), F.pareto_ranks(evals, objective_sense=sense)), "[searchers] small pareto ranks differ")
    errors["crowding"] = _close(
        F.crowding_distances(evals.to(device), objective_sense=sense),
        F.crowding_distances(evals, objective_sense=sense),
        "[searchers] small crowding distances",
        dict(rtol=1e-6, atol=0.0),
    )

    centers = torch.randn((BATCHED_SEARCHES, BATCHED_DIMENSION), generator=torch.Generator().manual_seed(39)) * 3
    finals = {}
    for dev in (device, torch.device("cpu")):
        span = make_search_span(lambda x: torch.sum(x**2, dim=-1), ask=partial(cem_ask, popsize=BATCHED_POPSIZE), tell=cem_tell)
        state = cem(center_init=centers.to(dev), parenthood_ratio=0.5, objective_sense="min", stdev_init=2.0, stdev_max_change=0.2)
        with _SharedDraws(40):
            finals[dev.type], _ = span(state, [torch.Generator(device=dev)] * 5)
    errors["batched_cem_center"] = _close(finals[device.type].center, finals["cpu"].center, "[searchers] small batched cem", dict(rtol=1e-4, atol=1e-5))
    return errors


def searchers_phase(device):
    """The slice's paths (see the module note): GA and CoSyNE at the
    flagship, then the black-box searchers, MAP-Elites, the multi-objective
    GA and Pareto sorting, and the batched functional searches; then each
    held card against CPU at a small size."""
    from functools import partial

    import torch

    from evotorch_tpu_torch.algorithms import CMAES, SNES, XNES, Cosyne, GeneticAlgorithm, MAPElites
    from evotorch_tpu_torch.algorithms.functional import cem, cem_ask, cem_tell, make_search_span
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.envs import Pendulum
    from evotorch_tpu_torch.envs.base import EnvState
    from evotorch_tpu_torch.operators import functional as F
    from evotorch_tpu_torch.operators.real import GaussianMutation, SimulatedBinaryCrossOver

    _flagship_searcher(
        device,
        lambda problem: GeneticAlgorithm(
            problem, popsize=POPSIZE,
            operators=[
                SimulatedBinaryCrossOver(problem, tournament_size=SEARCHERS_TOURNAMENT, eta=SEARCHERS_ETA),
                GaussianMutation(problem, stdev=SEARCHERS_MUTATION),
            ],
        ),
        "[searchers] ga flagship",
        rank_sizes=[POPSIZE],
        evaluated=2 * POPSIZE,
    )  # fmt: skip
    _flagship_searcher(
        device,
        lambda problem: Cosyne(
            problem, popsize=POPSIZE, tournament_size=SEARCHERS_TOURNAMENT, mutation_stdev=SEARCHERS_MUTATION,
            permute_all=False,
        ),
        "[searchers] cosyne flagship",
        rank_sizes=[COSYNE_PARENTS, POPSIZE],
        evaluated=POPSIZE + 2 * COSYNE_PARENTS + POPSIZE,
    )  # fmt: skip

    # the black-box searchers: examples/bbo_vectorized.py, then full
    # covariance at d = 1,000
    best = {}
    for name, make, seed, generations in (
        ("SNES popsize 1000", lambda p: SNES(p, popsize=1000, stdev_init=10.0), 1, BBO_SNES_GENERATIONS),
        ("separable CMA-ES popsize 64", lambda p: CMAES(p, stdev_init=2.0, popsize=64, separable=True), 2, BBO_CMAES_GENERATIONS),
    ):
        problem = Problem("min", _rastrigin, solution_length=100, initial_bounds=(-5.12, 5.12), vectorized=True, seed=seed)
        _searcher_run(f"[searchers] bbo {name}, 100-d Rastrigin", make(problem), generations)
        best[name] = float(problem.status["best_eval"])
    for name, make in (("CMA-ES", lambda p: CMAES(p, stdev_init=0.5)), ("XNES", lambda p: XNES(p, stdev_init=0.5))):
        problem = Problem("min", _rosenbrock, solution_length=BBO_WIDE_DIMENSION, initial_bounds=(-2.0, 2.0), vectorized=True, seed=3)
        _searcher_run(f"[searchers] full {name}, {BBO_WIDE_DIMENSION}-d Rosenbrock", make(problem), BBO_WIDE_GENERATIONS)
        best[f"full {name}"] = float(problem.status["best_eval"])
    check(all(math.isfinite(v) for v in best.values()), f"[searchers] bbo best {best}")
    print(f"[searchers] bbo best evals {best}")

    # MAP-Elites: examples/mapelites_illumination.py, then 10,000 cells
    for dimension, bins, generations in (
        (6, [8, 8], MAPELITES_EXAMPLE_GENERATIONS),
        (MAPELITES_WIDE_DIMENSION, [MAPELITES_WIDE_BINS] * 2, MAPELITES_WIDE_GENERATIONS),
    ):
        problem = Problem(
            "min", _rastrigin_with_features, solution_length=dimension, initial_bounds=(-5.12, 5.12), eval_data_length=2,
            vectorized=True, seed=0,
        )  # fmt: skip
        grid = MAPElites.make_feature_grid([-5.12, -5.12], [5.12, 5.12], num_bins=bins)
        searcher = MAPElites(problem, operators=[GaussianMutation(problem, stdev=0.5)], feature_grid=grid)
        _searcher_run(f"[searchers] MAP-Elites {dimension}-d, {bins[0]}x{bins[1]} grid", searcher, generations)
        filled = searcher.filled
        check(int(filled.sum()) > 0, "[searchers] MAP-Elites filled no cell")
        print(
            f"[searchers] MAP-Elites {dimension}-d: {int(filled.sum())}/{len(filled)} cells filled, best"
            f" {float(searcher.population.evals[:, 0][filled].min()):.3f}"
        )

    # multi-objective: examples/moo_pareto.py, then Pareto sorting of 20,000 points
    problem = Problem(["min", "min"], _kursawe, solution_length=3, initial_bounds=(-5.0, 5.0), vectorized=True, seed=0)
    ga_moo = GeneticAlgorithm(
        problem, popsize=MOO_POPSIZE,
        operators=[SimulatedBinaryCrossOver(problem, tournament_size=4, eta=8.0), GaussianMutation(problem, stdev=0.03)],
    )  # fmt: skip
    _searcher_run(f"[searchers] moo GA popsize {MOO_POPSIZE}, Kursawe", ga_moo, MOO_GENERATIONS)
    fronts = ga_moo.population.arg_pareto_sort()
    front0 = ga_moo.population.evals[fronts[0]]
    print(
        f"[searchers] moo: {len(fronts)} fronts in the final population, front 0 of {len(fronts[0])}, objective ranges"
        f" {front0.amin(0).tolist()} to {front0.amax(0).tolist()}"
    )
    points = torch.rand((PARETO_POINTS, 3), generator=torch.Generator(device=device).manual_seed(43), device=device) * 10 - 5
    evals = _kursawe(points)
    ranks = F.pareto_ranks(evals, objective_sense=["min", "min"])
    crowd = F.crowding_distances(evals, objective_sense=["min", "min"], ranks=ranks)
    num_fronts = int(ranks.max()) + 1
    check(bool(torch.isfinite(crowd).any()) and int((ranks == 0).sum()) > 0, "[searchers] pareto sort")
    print(f"[searchers] pareto_ranks of {PARETO_POINTS:,} Kursawe points: {num_fronts} fronts; crowding_distances finite")

    # batched and functional: examples/functional_batched_search.py and the
    # planner of examples/mpc_cem.py
    g = torch.Generator(device=device).manual_seed(0)
    centers = torch.randn((BATCHED_SEARCHES, BATCHED_DIMENSION), generator=g, device=device) * 3.0
    state = cem(center_init=centers, parenthood_ratio=0.5, objective_sense="min", stdev_init=2.0, stdev_max_change=0.2)
    span = make_search_span(
        lambda x: torch.sum(x**2, dim=-1), ask=partial(cem_ask, popsize=BATCHED_POPSIZE), tell=cem_tell,
        metrics=lambda pop, fit: torch.amin(fit, dim=-1),
    )  # fmt: skip
    state, best_per_gen = span(state, [g] * BATCHED_GENERATIONS)
    check(best_per_gen.shape == (BATCHED_GENERATIONS, BATCHED_SEARCHES), f"[searchers] span metrics {tuple(best_per_gen.shape)}")
    check(bool((best_per_gen[-1] < best_per_gen[0]).all()), "[searchers] a batched CEM search did not improve")
    print(
        f"[searchers] batched CEM: {BATCHED_SEARCHES} searches, popsize {BATCHED_POPSIZE}, d {BATCHED_DIMENSION},"
        f" {BATCHED_GENERATIONS} generations through make_search_span; final best per search"
        f" {[round(v, 4) for v in best_per_gen[-1].tolist()]}"
    )

    env = Pendulum(device=device)

    def plan(env_state):
        batched = env._to_batched(env_state)
        state = cem(center_init=torch.zeros(MPC_HORIZON, device=device), parenthood_ratio=0.2, objective_sense="min", stdev_init=1.0)
        for _ in range(MPC_ITERATIONS):
            seqs = cem_ask(g, state, popsize=MPC_POPSIZE)
            lanes = EnvState(obs_state=batched.obs_state.expand(MPC_POPSIZE, -1), t=batched.t.expand(MPC_POPSIZE))
            costs = torch.zeros(MPC_POPSIZE, device=device)
            clipped = torch.clamp(seqs, -2.0, 2.0)
            for h in range(MPC_HORIZON):
                lanes, _, reward, _ = env.batch_step(lanes, clipped[:, h : h + 1])
                costs = costs - reward
            state = cem_tell(state, seqs, costs)
        return torch.clamp(state.center[0], -2.0, 2.0)

    env_state, _ = env.reset(torch.Generator(device=device).manual_seed(0))
    total = torch.zeros((), device=device)
    for _ in range(MPC_STEPS):
        action = plan(env_state)
        env_state, _, reward, _ = env.step(env_state, action.reshape(1))
        total = total + reward
    check(math.isfinite(float(total)), "[searchers] mpc total reward")
    print(
        f"[searchers] MPC with CEM on Pendulum: horizon {MPC_HORIZON}, popsize {MPC_POPSIZE}, {MPC_ITERATIONS} iterations,"
        f" {MPC_STEPS} control steps: total reward {float(total):.2f}"
    )

    errors = _small_population_searchers(device)
    errors.update(_small_cmaes_and_nes(device))
    errors.update(_small_mapelites_pareto_batched(device))
    print(f"[searchers] card against CPU, same draws: every check held; largest differences {errors}")


WIDE_NETWORK = "Linear(obs_length, 256) >> Tanh() >> Linear(256, 256) >> Tanh() >> Linear(256, act_length)"
WIDE_PARAMETERS = 98_321  # Linear(109, 256): 256 * 110; Linear(256, 256): 256 * 257; Linear(256, 17): 17 * 257
WIDE_RANK = 32  # examples/wide_policy_lowrank.py
TRUNK_RANK = 4  # bench.py's trunk-delta rank when none is tuned
TRUNK_BLOCK = 2_500
WIDE_OO_GENERATIONS = 3
WIDE_EPISODE_LENGTH = 100  # the dense, low-rank and trunk-delta generations (200 before the autotune phase came: the script's time limit)
# blocked against unblocked trunk-delta forward at full width (float32,
# TF32 off): one product over 2,500 rows where there were 10,000 may round
# otherwise
TRUNK_BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
FACTORED_SMALL_POPSIZE = 64
FACTORED_SMALL_RANK = 4
FACTORED_SMALL_NETWORKS = {
    "mlp": "Linear(obs_length, 32) >> Tanh() >> Linear(32, act_length)",
    "rnn": "RNN(obs_length, 16) >> Linear(16, act_length)",
    "lstm": "LSTM(obs_length, 16) >> Linear(16, act_length)",
}
# forwards card against CPU, and factored against dense: each output sums
# ~109 products of magnitude ~1 that cancel, so the round-off is absolute
# (a chip run saw 2.0e-6 at an output near zero, with each step's input
# made from the last step's outputs; the inputs are drawn afresh now)
FACTORED_FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# the dense and the factored tells of one population sum their gradients in
# other orders (over the population, over the basis's rank), and ClipUp
# normalizes them (tests/test_torch_lowrank.py)
FACTORED_TELL_TOL = dict(rtol=1e-4, atol=1e-6)


def _wide_example(device):
    """``examples/wide_policy_lowrank.py`` as written, at full scale, for
    ``WIDE_OO_GENERATIONS``: the population must stay factored (no call of
    ``materialize``, no dense fallback)."""
    import warnings

    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch

    problem = VecNE(
        "humanoid", WIDE_NETWORK, observation_normalization=True, episode_length=EPISODE_LENGTH, eval_mode="budget",
        compute_dtype=torch.bfloat16, seed=0,
    )  # fmt: skip
    check(problem.solution_length == WIDE_PARAMETERS, f"[factored] example solution length {problem.solution_length}")
    searcher = PGPE(
        problem, popsize=POPSIZE, center_learning_rate=0.06, stdev_learning_rate=0.1, radius_init=0.27,
        optimizer="clipup", optimizer_config={"max_speed": 0.12}, ranking_method="centered", lowrank_rank=WIDE_RANK,
    )  # fmt: skip
    StdOutLogger(searcher, interval=1)

    def checked_step(real_step=searcher._step):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            real_step()
        fallbacks = [str(w.message) for w in caught if "fell back to materializing" in str(w.message)]
        check(not fallbacks, f"[factored] the example's population fell back to dense: {fallbacks}")

    searcher._step = checked_step
    densified = []
    real_materialize = LowRankParamsBatch.materialize

    def counting(self):
        densified.append(self.popsize)
        return real_materialize(self)

    LowRankParamsBatch.materialize = counting
    try:
        with warnings.catch_warnings():
            # a dense fallback of the wide population fails the run
            warnings.filterwarnings("error", message=".*fell back to materializing.*")
            out = _searcher_run("[factored] wide example", searcher, WIDE_OO_GENERATIONS)
    finally:
        LowRankParamsBatch.materialize = real_materialize
        del searcher._step
    population = searcher.population
    check(isinstance(population.values, LowRankParamsBatch), f"[factored] example population {type(population.values)}")
    check(not densified, f"[factored] the example's population was materialized: {densified}")
    check(out["launches"] == {"symmetric_gaussian": 0, "centered_rank": WIDE_OO_GENERATIONS - 1}, f"[factored] example launches {out['launches']}")
    check(out["rank_sizes"] == [POPSIZE] * (WIDE_OO_GENERATIONS - 1), f"[factored] example ranked at {out['rank_sizes']}")
    interactions = out["env_steps"]
    check(interactions == WIDE_OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[factored] example interactions {interactions}")
    capture = searcher.status["basis_capture"]
    check(capture is not None and 0.0 <= capture <= 1.0, f"[factored] basis_capture {capture}")
    values = population.values
    print(
        f"[factored] wide example: VecNE('humanoid', 256x256, bf16, normalization, budget) + PGPE(lowrank_rank={WIDE_RANK}),"
        f" popsize {POPSIZE}, L {problem.solution_length}: population held factored, coeffs"
        f" {tuple(values.coeffs.shape)} + basis {tuple(values.basis.shape)} instead of ({POPSIZE},"
        f" {problem.solution_length}), materialize called {len(densified)} times; basis_capture {capture:.4f}"
        f" (random-basis expectation sqrt(k/L) = {math.sqrt(WIDE_RANK / problem.solution_length):.4f})"
    )


def _wide_functional(device):
    """The three policy forms at the wide network's full width through the
    functional API (see the module note)."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import (
        pgpe_ask,
        pgpe_ask_lowrank,
        pgpe_ask_trunk_delta,
        pgpe_tell,
        pgpe_tell_lowrank,
        pgpe_tell_trunk_delta,
    )
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout_compacting
    from evotorch_tpu_torch.neuroevolution.net.lowrank import _trunk_forward_prepared, prepare_trunk_delta
    from evotorch_tpu_torch.parallel import make_generation_step

    factored = {"symmetric_gaussian": 0, "centered_rank": 1}
    forms = {
        "dense": (lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), pgpe_tell, ONE_EACH),
        "lowrank": (lambda g, s: pgpe_ask_lowrank(g, s, popsize=POPSIZE, rank=WIDE_RANK), pgpe_tell_lowrank, factored),
    }
    blocked_scores, unblocked_scores = [], []
    runs = [("dense", "budget", 0), ("lowrank", "budget", 0)] + [
        ("trunk_delta", c, 0) for c in ("budget", "episodes", "episodes_refill", "episodes_compact")
    ] + [("trunk_delta", "budget", TRUNK_BLOCK)]  # fmt: skip
    for form, contract, block in runs:
        env, policy, state, stats = flagship(device, network=WIDE_NETWORK)
        check(policy.parameter_count == WIDE_PARAMETERS, f"[factored] {policy.parameter_count} parameters")
        if form == "trunk_delta":
            ask = lambda g, s, policy=policy: pgpe_ask_trunk_delta(g, s, popsize=POPSIZE, rank=TRUNK_RANK, policy=policy)  # noqa: E731
            tell, expected = pgpe_tell_trunk_delta, factored
        else:
            ask, tell, expected = forms[form]
        kw = dict(num_episodes=1, episode_length=WIDE_EPISODE_LENGTH)
        if contract == "episodes_compact":

            def generation(s, generator, st, env=env, policy=policy, ask=ask, tell=tell, kw=kw):
                values = ask(generator, s)
                result = run_vectorized_rollout_compacting(env, policy, values, generator, st, chunk_size=25, **kw)
                return tell(s, values, result.scores), result.scores, result.stats, result.total_steps, result.telemetry

        else:
            if block:
                kw["trunk_block"] = block
            generation = make_generation_step(
                env, policy, ask=ask, tell=tell, popsize=POPSIZE, device=device, eval_mode=contract, **kw
            )
        tag = f"[factored] wide {form}" + (f" rank {WIDE_RANK}" if form == "lowrank" else "")
        tag += f" rank {TRUNK_RANK}" if form == "trunk_delta" else ""
        tag += f" {contract}" + (f" trunk_block {block}" if block else "")
        scores_out = blocked_scores if block else (unblocked_scores if (form, contract) == ("trunk_delta", "budget") else None)
        _run_generations(
            tag, generation, state, stats, device, ("generation 0",), popsize=POPSIZE,
            steps_each=WIDE_EPISODE_LENGTH if contract == "budget" else None, restarts=contract == "budget",
            expected_launches=expected, scores_out=scores_out,
        )  # fmt: skip
        del env, policy, state, stats, generation

    # the blocked forward against the unblocked one at full width, on one
    # batch and one input, then the two generations' scores (same draws)
    env, policy, state, _ = flagship(device, network=WIDE_NETWORK)
    batch = pgpe_ask_trunk_delta(torch.Generator(device=device).manual_seed(0), state, popsize=POPSIZE, rank=TRUNK_RANK, policy=policy)
    _, obs = env.batch_reset(POPSIZE, torch.Generator(device=device).manual_seed(1))
    one, _ = _trunk_forward_prepared(policy.module, prepare_trunk_delta(policy, batch), batch.coeffs, obs, None)
    blocked, _ = _trunk_forward_prepared(policy.module, prepare_trunk_delta(policy, batch, trunk_block=TRUNK_BLOCK), batch.coeffs, obs, None)
    forward_err = float((one - blocked).abs().max())
    check(torch.allclose(one, blocked, **TRUNK_BLOCK_TOL), f"[factored] blocked trunk forward differs by {forward_err}")
    a, b = blocked_scores[0], unblocked_scores[0]
    equal = float((a == b).double().mean())
    share, worst = _scores_agree(a, b)
    # a forward equal bit for bit gives the same trajectories, so the same
    # scores; a forward that rounds otherwise parts the chaotic closed loops
    # within a few steps, and then only the forward's tolerance is held
    check(forward_err > 0 or equal == 1.0, f"[factored] blocked scores differ ({equal:.4f} equal) though the forward is equal")
    check(bool(torch.isfinite(a).all()), "[factored] blocked scores not finite")
    print(
        f"[factored] trunk_block {TRUNK_BLOCK}: one forward at ({POPSIZE}, 109) against the unblocked one, max abs"
        f" difference {forward_err:.3g} (tolerance {TRUNK_BLOCK_TOL}); the blocked generation's scores against the"
        f" unblocked one's from the same draws: {equal:.4f} equal bit for bit, {share:.4f} within 1e-4 relative,"
        f" worst {worst}"
    )


def _factored_small_checks(device):
    """Each factored piece on the card against the CPU at a small size with
    the same draws (one CPU generator patched into the draw steps): the
    forwards of an MLP, an RNN and an LSTM, each also against the port's
    dense forward of the materialized population; an LSTM low-rank rollout
    on CartPole under ``episodes`` and ``episodes_refill``; one
    ``pgpe_tell_lowrank`` against ``pgpe_tell`` of the materialized
    population. A disagreement fails the run."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask_lowrank, pgpe_ask_trunk_delta, pgpe_tell, pgpe_tell_lowrank
    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import (
        FlatParamsPolicy,
        lowrank_forward,
        run_vectorized_rollout,
        str_to_net,
        trunk_delta_forward,
    )
    from evotorch_tpu_torch.neuroevolution.net.layers import state_leaves

    errors = {}
    n, k = FACTORED_SMALL_POPSIZE, FACTORED_SMALL_RANK
    for name, spec in FACTORED_SMALL_NETWORKS.items():
        for form, ask, forward in (
            ("lowrank", lambda g, s, p: pgpe_ask_lowrank(g, s, popsize=n, rank=k), lowrank_forward),
            ("trunk_delta", lambda g, s, p: pgpe_ask_trunk_delta(g, s, popsize=n, rank=k, policy=p), trunk_delta_forward),
        ):
            outs = []  # CPU, then the card
            for dev in (torch.device("cpu"), device):
                policy = FlatParamsPolicy(str_to_net(spec, obs_length=109, act_length=17))
                center = 0.1 * torch.randn(policy.parameter_count, generator=torch.Generator().manual_seed(3))
                state = fresh_pgpe_state(policy.parameter_count, dev, center=center)
                with _SharedDraws(5):
                    batch = ask(torch.Generator(device=dev), state, policy)
                inputs = torch.Generator().manual_seed(6)
                states, dense_states, steps = None, None, []
                for _ in range(3):
                    obs_in = torch.randn((n, 109), generator=inputs).to(dev)
                    y, states = forward(policy, batch, None, obs_in, states)
                    dense, dense_states = policy(batch.materialize(), obs_in, dense_states)
                    _close(y, dense, f"[factored] {form} {name} forward against dense on {dev.type}", FACTORED_FWD_TOL)
                    for a, b in zip(state_leaves(states), state_leaves(dense_states)):
                        _close(a, b, f"[factored] {form} {name} state against dense on {dev.type}", FACTORED_FWD_TOL)
                    steps.append(y)
                outs.append(steps)
            errors[f"{form}_{name}"] = max(
                _close(a, b, f"[factored] {form} {name} forward, card against CPU", FACTORED_FWD_TOL)
                for a, b in zip(outs[1], outs[0])
            )

    # an LSTM low-rank rollout on CartPole, card against CPU, one reset table
    spec = "LSTM(obs_length, 8) >> Linear(8, act_length)"
    for contract in ("episodes", "episodes_refill"):
        scores = []
        for dev in (torch.device("cpu"), device):
            env = CartPole(continuous_actions=True, device=dev)
            policy = FlatParamsPolicy(str_to_net(spec, obs_length=4, act_length=1))
            state = fresh_pgpe_state(policy.parameter_count, dev, stdev_init=0.5)
            with _SharedDraws(7):
                batch = pgpe_ask_lowrank(torch.Generator(device=dev), state, popsize=CONTRACT_POPSIZE, rank=k)
            table = CartPole(continuous_actions=True, device="cpu").reset_noise(CONTRACT_POPSIZE, torch.Generator().manual_seed(8))
            extra = dict(refill_width=128) if contract == "episodes_refill" else {}
            result = run_vectorized_rollout(
                env, policy, batch, torch.Generator(device=dev), None, eval_mode=contract, episode_length=EPISODE_LENGTH,
                reset_noise=table.to(dev), **extra,
            )  # fmt: skip
            scores.append(result.scores.cpu())
        share, worst = _scores_agree(scores[1], scores[0])
        check(share >= 0.99, f"[factored] LSTM low-rank {contract}: card against CPU, {share:.4f} within 1e-4, worst {worst}")
        errors[f"lstm_lowrank_{contract}_share_within_1e-4"] = share

    # one factored tell against the dense tell of the materialized population
    tells = []
    for dev in (torch.device("cpu"), device):
        policy = FlatParamsPolicy(str_to_net(FACTORED_SMALL_NETWORKS["mlp"], obs_length=109, act_length=17))
        state = fresh_pgpe_state(policy.parameter_count, dev)
        with _SharedDraws(9):
            batch = pgpe_ask_lowrank(torch.Generator(device=dev), state, popsize=n, rank=k)
        evals = torch.randn(n, generator=torch.Generator().manual_seed(10)).to(dev)
        factored_state = pgpe_tell_lowrank(state, batch, evals)
        dense_state = pgpe_tell(state, batch.materialize(), evals)
        for field in ("center", "velocity"):
            _close(
                getattr(factored_state.optimizer_state, field), getattr(dense_state.optimizer_state, field),
                f"[factored] tell {field} against the dense tell on {dev.type}", FACTORED_TELL_TOL,
            )  # fmt: skip
        _close(factored_state.stdev, dense_state.stdev, f"[factored] tell stdev against the dense tell on {dev.type}", FACTORED_TELL_TOL)
        tells.append(factored_state)
    errors["tell_center"] = _close(tells[1].optimizer_state.center, tells[0].optimizer_state.center, "[factored] tell, card against CPU")
    errors["tell_stdev"] = _close(tells[1].stdev, tells[0].stdev, "[factored] tell stdev, card against CPU")
    print(f"[factored] card against CPU, same draws: every check held; largest differences {errors}")


def factored_phase(device):
    """The slice's paths (see the module note): the wide-policy example,
    the three policy forms at its width, then the small card-against-CPU
    checks."""
    _wide_example(device)
    _wide_functional(device)
    _factored_small_checks(device)


SPAN = 2
SPAN_ROUNDS = 2
SPAN_EPISODE_LENGTH = 100  # the flagship's 200 before the autotune phase came (the script's time limit)
OBJECT_GA_POPSIZE = 32
OBJECT_GA_GENERATIONS = 10
OBJECT_GA_TARGET = 42


def _same_tree(a, b) -> bool:
    """Two states (dataclasses, tuples, dicts of tensors and plain values)
    equal leaf for leaf, the tensors bit for bit."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_same_tree(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _counted(fn):
    """``fn()`` with its kernel launches and host syncs counted; returns its
    result, launches and syncs."""
    before = _launches()
    out, syncs = _count_syncs(fn)
    return out, _launches(before), syncs


def span_phase(device):
    """Fused training spans (``make_training_span``) at the flagship: a span
    of ``SPAN`` ``budget`` generations against ``SPAN`` sequential
    ``make_generation_step`` calls from the same state and seed, bit for bit,
    run in turns; the span under ``episodes`` with ``pgpe_health``; and
    ``VecNE.make_training_span`` + ``consume_span`` against the same
    generations."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_health, pgpe_tell
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp
    from evotorch_tpu_torch.observability import GroupTelemetry
    from evotorch_tpu_torch.parallel import make_generation_step, make_training_span

    env, policy, state0, stats0 = flagship(device)
    kw = dict(
        ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE, device=device,
        num_episodes=1, episode_length=SPAN_EPISODE_LENGTH, nonfinite_quarantine=True,
    )  # fmt: skip
    each = {"symmetric_gaussian": SPAN, "centered_rank": SPAN}

    generation = make_generation_step(env, policy, eval_mode="budget", **kw)
    training_span = make_training_span(env, policy, span=SPAN, eval_mode="budget", **kw)

    def sequential():
        generator = torch.Generator(device=device).manual_seed(0)
        state, stats, rows = state0, stats0, []
        for _ in range(SPAN):
            state, scores, stats, steps, wire = generation(state, generator, stats)
            rows.append((scores, steps, wire))
        steps = torch.tensor([r[1] for r in rows], dtype=torch.int64)
        return state, torch.stack([r[0] for r in rows]), stats, steps, torch.stack([r[2] for r in rows])

    def fused():
        generator = torch.Generator(device=device).manual_seed(0)
        return training_span(state0, [generator] * SPAN, stats0)

    reference = None
    for round_index in range(SPAN_ROUNDS):
        order = ("sequential", "span") if round_index % 2 == 0 else ("span", "sequential")
        for name in order:
            out, launches, syncs = _counted(sequential if name == "sequential" else fused)
            check(launches == each, f"[span] {name} launches {launches}, expected {each}")
            check(syncs == 0, f"[span] {name}: {syncs} host syncs under budget, expected 0")
            state, scores, stats, steps, wire = out
            check(scores.shape == (SPAN, POPSIZE) and bool(torch.isfinite(scores).all()), f"[span] {name} scores")
            check(wire.shape == (SPAN, 1, 20) and wire.dtype == torch.int32, f"[span] {name} wire {tuple(wire.shape)}")
            for g in range(SPAN):
                check(GroupTelemetry.from_array(wire[g]).total().env_steps == int(steps[g]) == POPSIZE * SPAN_EPISODE_LENGTH, f"[span] {name} generation {g} steps")
            if reference is None:
                reference = (state, scores, stats, steps.cpu(), wire)
            else:
                same = [_same_tree(a, b) for a, b in zip((state, scores, stats, steps.cpu(), wire), reference)]
                check(all(same), f"[span] {name} round {round_index} against the first run: state, scores, stats, steps, wire equal {same}")
    print(
        f"[span] Humanoid popsize {POPSIZE}, L {policy.parameter_count}, budget {SPAN_EPISODE_LENGTH} steps, span"
        f" {SPAN}: the span equals {SPAN} sequential make_generation_step calls bit for bit (state, scores, statistics,"
        f" total_steps, telemetry rows), in {SPAN_ROUNDS} rounds; 0 host syncs in each; launches {each} a span"
    )

    episodes_span = make_training_span(env, policy, span=SPAN, eval_mode="episodes", state_metrics=pgpe_health, **kw)
    generator = torch.Generator(device=device).manual_seed(0)
    out, launches, syncs = _counted(lambda: episodes_span(state0, [generator] * SPAN, stats0))
    _, scores, _, steps, wire, metrics = out
    check(launches == each, f"[span] episodes launches {launches}")
    check(scores.shape == (SPAN, POPSIZE) and bool(torch.isfinite(scores).all()), "[span] episodes scores")
    check(all(GroupTelemetry.from_array(wire[g]).total().episodes == POPSIZE for g in range(SPAN)), "[span] episodes: episode counts")
    check(
        set(metrics) == {"stdev_norm", "velocity_norm"} and all(v.shape == (SPAN,) and bool(torch.isfinite(v).all()) for v in metrics.values()),
        f"[span] episodes metrics {metrics}",
    )  # fmt: skip
    print(
        f"[span] episodes, span {SPAN}, state_metrics=pgpe_health: {int(steps.sum())} env steps,"
        f" {syncs} host syncs ({SPAN} generations), launches {launches}, stdev_norm"
        f" {', '.join('%.6f' % v for v in metrics['stdev_norm'].tolist())}"
    )

    problem = VecNE(env, tanh_mlp(env.observation_size, env.action_size, HIDDEN), episode_length=SPAN_EPISODE_LENGTH, eval_mode="budget", device=device, seed=0)
    vecne_span = problem.make_training_span(ask=kw["ask"], tell=pgpe_tell, popsize=POPSIZE, span=SPAN)
    generator = torch.Generator(device=device).manual_seed(0)
    out, launches, _ = _counted(lambda: problem.consume_span(vecne_span(state0, [generator] * SPAN, problem.obs_norm.stats)))
    _, ref_scores, _, ref_steps, ref_wire = reference
    interactions, episodes = int(problem.status["total_interaction_count"]), int(problem.status["total_episode_count"])
    ref_episodes = sum(GroupTelemetry.from_array(ref_wire[g]).total().episodes for g in range(SPAN))
    check(launches == each, f"[span] VecNE launches {launches}")
    check(interactions == int(ref_steps.sum()), f"[span] VecNE interactions {interactions} against {int(ref_steps.sum())}")
    check(episodes == ref_episodes, f"[span] VecNE episodes {episodes} against {ref_episodes}")
    check(torch.equal(out, ref_scores), "[span] VecNE scores differ from the sequential generations'")
    check(torch.equal(problem._pending_telemetry, ref_wire[-1]), "[span] VecNE: the last row is not the pending one")
    print(
        f"[span] VecNE.make_training_span + consume_span, span {SPAN}: interactions {interactions} and"
        f" episodes {episodes} equal to the {SPAN} generations driven one by one, scores bit for bit, the last wire row"
        f" pending (lag-by-span); launches {launches}"
    )


def object_ga_phase(device):
    """The counterpart of ``examples/object_dtype_ga.py`` with the problem on
    the card: variable-length integer sequences, ``CutAndSplice`` and a
    mutation operator, ``GeneticAlgorithm`` (elitist)."""
    import numpy as np

    from evotorch_tpu_torch.algorithms import GeneticAlgorithm
    from evotorch_tpu_torch.core import Problem, SolutionBatch
    from evotorch_tpu_torch.operators.base import CopyingOperator
    from evotorch_tpu_torch.operators.sequence import CutAndSplice
    from evotorch_tpu_torch.tools import ObjectArray

    class SequenceProblem(Problem):
        def __init__(self):
            super().__init__("max", dtype=object, seed=0, device=device)
            self._rng = np.random.default_rng(0)

        def _fill(self, n, generator):
            arr = ObjectArray(n)
            for i in range(n):
                arr[i] = [int(v) for v in self._rng.integers(0, 10, size=int(self._rng.integers(1, 8)))]
            return arr

        def _evaluate(self, solution):
            seq = list(solution.values)
            solution.set_evals(float(-abs(sum(seq) - OBJECT_GA_TARGET) - 0.1 * len(seq)))

    class SequenceMutation(CopyingOperator):
        def __init__(self, problem):
            super().__init__(problem)
            self._rng = np.random.default_rng(1)

        def _do(self, batch):
            result = SolutionBatch(self._problem, len(batch), empty=True)
            for i in range(len(batch)):
                seq = list(batch[i].values)
                roll = self._rng.random()
                if roll < 0.3 and len(seq) > 1:
                    seq.pop(int(self._rng.integers(len(seq))))
                elif roll < 0.6:
                    seq.insert(int(self._rng.integers(len(seq) + 1)), int(self._rng.integers(0, 10)))
                elif seq:
                    seq[int(self._rng.integers(len(seq)))] = int(self._rng.integers(0, 10))
                result[i].set_values(seq)
            return result

    problem = SequenceProblem()
    ga = GeneticAlgorithm(problem, operators=[CutAndSplice(problem, tournament_size=3), SequenceMutation(problem)], popsize=OBJECT_GA_POPSIZE)
    best = []
    before = _launches()
    for _ in range(OBJECT_GA_GENERATIONS):
        ga.step()
        evals = ga.population.evals
        check(evals.is_cuda and evals.shape == (OBJECT_GA_POPSIZE, 1), f"[object_ga] evals on {evals.device}, {tuple(evals.shape)}")
        check(isinstance(ga.population.values, ObjectArray), "[object_ga] the population is not an ObjectArray")
        best.append(float(ga.status["pop_best_eval"]))
    launches = _launches(before)
    check(all(b >= a for a, b in zip(best, best[1:])), f"[object_ga] the best fitness fell under elitism: {best}")
    check(launches["symmetric_gaussian"] == 0, f"[object_ga] launches {launches}")
    top = ga.status["best"]
    print(
        f"[object_ga] examples/object_dtype_ga.py on {device}: popsize {OBJECT_GA_POPSIZE}, {OBJECT_GA_GENERATIONS}"
        f" generations; best fitness per generation {best}; best sequence {list(top.values)}"
        f" (sum {sum(top.values)}); evals on {ga.population.evals.device}; launches {launches}"
    )


MULTIGPU_GENERATIONS = 1  # two before the autotune phase came (the script's time limit)
MULTIGPU_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_parallel.py's scores tolerance
# (b) against (a): the population's mean and median score within 5%. On the
# card a lane computed in a block of 5,000 lanes does not round as in one of
# 10,000 (cuBLAS picks its kernels by shape), and the flagship's closed loop
# at stdev 0.1 grows one ulp into a different trajectory within the 200
# steps, so the lanes' scores part and only their statistics agree (robust
# ones: the scores' right tail, a few lanes near 1,500 against a mean near
# 180, moves their stdev by 6% between two such runs)
MULTIGPU_STATS_TOL = 0.05
MULTIGPU_TIMEOUT = 300  # seconds the two spawned ranks may take, start-up included
MULTIGPU_OO_GENERATIONS = 1  # two before the autotune phase came (the script's time limit)


def _world_one_generations(device, mesh, unsharded):
    """(a): the flagship under ``budget`` and ``episodes``, sharded over the
    one-rank NCCL ``mesh`` against unsharded, MULTIGPU_GENERATIONS each from
    one seed: scores and centers equal (and whether bit for bit). The
    unsharded generations are the main path's (``budget``) and the
    contracts phase's (``episodes``), from the same seed, state and
    constants: ``unsharded[contract]`` holds their scores and centers.
    Returns the sharded ``budget`` generations' scores."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.parallel import make_generation_step

    labels = [f"generation {i}" for i in range(MULTIGPU_GENERATIONS)]
    check(all(len(u[0]) == MULTIGPU_GENERATIONS for u in unsharded.values()), "[multigpu] (a) unsharded generations")
    budget_scores = None
    for contract in ("budget", "episodes"):
        env, policy, state, stats = flagship(device)
        generation = make_generation_step(
            env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE,
            mesh=mesh, device=device, num_episodes=1, episode_length=EPISODE_LENGTH, eval_mode=contract,
        )  # fmt: skip
        s_scores, s_centers = [], []
        _run_generations(
            f"[multigpu] (a) {contract} sharded", generation, state, stats, device, labels, popsize=POPSIZE,
            steps_each=EPISODE_LENGTH if contract == "budget" else None, restarts=contract == "budget",
            scores_out=s_scores, centers_out=s_centers,
        )  # fmt: skip
        del env, policy, state, stats, generation
        u_scores, u_centers = unsharded[contract]
        for i, (a, b, ca, cb) in enumerate(zip(s_scores, u_scores, s_centers, u_centers)):
            check(torch.allclose(a, b, **MULTIGPU_TOL), f"[multigpu] (a) {contract} generation {i}: scores differ by {float((a - b).abs().max())}")
            check(torch.equal(torch.argsort(a), torch.argsort(b)), f"[multigpu] (a) {contract} generation {i}: score ranks differ")
            check(torch.allclose(ca, cb, rtol=1e-5, atol=1e-5), f"[multigpu] (a) {contract} generation {i}: centers differ")
        bitwise = all(torch.equal(a, b) for a, b in zip(s_scores + s_centers, u_scores + u_centers))
        print(
            f"[multigpu] (a) {contract}, world size 1 over NCCL against unsharded, {MULTIGPU_GENERATIONS} generations from"
            f" one seed: scores and centers equal{' bit for bit' if bitwise else ' to the tolerance, not bit for bit'}"
        )
        if contract == "budget":
            budget_scores = s_scores
    return budget_scores


def _two_rank_main(rank, store, out_dir):
    """(b), one of two ranks spawned on the one card, over gloo: the flagship
    ``budget`` generations sharded over both; saves its scores, steps,
    telemetry and launches."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from evotorch_tpu_torch import resolve_device
    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.parallel import default_mesh, init_distributed, make_generation_step

    init_distributed(
        f"file://{store}", world_size=2, rank=rank, backend="gloo", timeout=datetime.timedelta(seconds=MULTIGPU_TIMEOUT)
    )
    try:
        device = resolve_device()
        env, policy, state, stats = flagship(device)
        generation = make_generation_step(
            env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE,
            mesh=default_mesh(), device=device, num_episodes=1, episode_length=EPISODE_LENGTH, eval_mode="budget",
        )  # fmt: skip
        generator = torch.Generator(device=device).manual_seed(0)
        out = {"scores": [], "launches": [], "steps": [], "telemetry": []}
        for _ in range(MULTIGPU_GENERATIONS):
            before = _launches()
            state, scores, stats, steps, telemetry = generation(state, generator, stats)
            out["launches"].append(_launches(before))
            out["scores"].append(scores.cpu())
            out["steps"].append(int(steps))
            out["telemetry"].append(telemetry.cpu())
        del env, policy, state, stats, generation
        out["groups"] = _two_rank_groups(device)  # phase 24's (b) and (c), in this spawn
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()  # graftlint: allow(process-group): the world is this phase's two ranks
    finally:
        dist.destroy_process_group()


def _blockwise_scores(device, world):
    """Generation 0 of (b) evaluated here, one rank's block after the other:
    the same population, generator state, lane ids and global tables, each
    block at the shape its rank ran it."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout
    from evotorch_tpu_torch.neuroevolution.net.vecrl import global_lane_ids

    env, policy, state, stats = flagship(device)
    generator = torch.Generator(device=device).manual_seed(0)
    values = pgpe_ask(generator, state, popsize=POPSIZE)
    after_ask, per, scores = generator.get_state(), POPSIZE // world, []
    for r in range(world):
        # graftlint: allow(generator): each block starts from the state after the ask, as every rank does
        generator.set_state(after_ask)
        result = run_vectorized_rollout(
            env, policy, values[r * per : (r + 1) * per], generator, stats, lane_ids=global_lane_ids(r, per),
            seed_stride=POPSIZE, num_episodes=1, episode_length=EPISODE_LENGTH, eval_mode="budget",
        )  # fmt: skip
        scores.append(result.scores)
    return torch.cat(scores).cpu()


def _two_ranks_one_card(device, budget_scores):
    """(b): two ranks spawned on the one card over gloo (NCCL refuses two
    ranks on one card), the kernels built here beforehand. Their generation
    0 is held bit for bit against the same blocks evaluated here one after
    the other; every generation's score statistics against (a)'s (see
    MULTIGPU_STATS_TOL)."""
    import multiprocessing
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_two_rank_main, args=(r, os.path.join(tmp, "store"), tmp)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MULTIGPU_TIMEOUT
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        check(all(p.exitcode == 0 for p in procs), f"[multigpu] (b) ranks exited with {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    blockwise = _blockwise_scores(device, 2)
    stats_gaps = []
    for r, out in enumerate(ranks):
        check(torch.equal(out["scores"][0], blockwise), f"[multigpu] (b) rank {r} generation 0 differs from its blocks evaluated here")
        for i, (a, b) in enumerate(zip(out["scores"], budget_scores)):
            b = b.cpu()
            check(bool(torch.isfinite(a).all()) and out["steps"][i] == POPSIZE * EPISODE_LENGTH, f"[multigpu] (b) rank {r} generation {i}")
            check(torch.equal(a, ranks[0]["scores"][i]), f"[multigpu] (b) generation {i}: the ranks' scores differ")
            gaps = [abs(float(f(a)) - float(f(b))) / abs(float(f(b))) for f in (torch.mean, torch.median)]
            check(max(gaps) <= MULTIGPU_STATS_TOL, f"[multigpu] (b) rank {r} generation {i}: mean and median score {gaps} from (a)'s")
            stats_gaps.append(max(gaps))
        check(all(x == ONE_EACH for x in out["launches"]), f"[multigpu] (b) rank {r} launches {out['launches']}")
    bitwise = all(torch.equal(a, b.cpu()) for out in ranks for a, b in zip(out["scores"], budget_scores))
    diff = max(float((a - b.cpu()).abs().max()) for a, b in zip(ranks[0]["scores"], budget_scores))
    print(
        f"[multigpu] (b) two ranks sharing one card over gloo (a test of the layout, not a scaling figure), budget,"
        f" {MULTIGPU_GENERATIONS} generations: both ranks hold the same scores; generation 0 equals its two blocks"
        f" evaluated here one after the other bit for bit; against (a) {'bit for bit' if bitwise else f'the lanes part (max difference {diff:.3f}: blocks of 5,000 lanes round otherwise than 10,000 and the closed loop is chaotic), mean and median score within {max(stats_gaps):.4f} relative'};"
        f" launches per generation on each rank {ranks[0]['launches'][-1]}"
    )
    # phase 24's (b) and (c) ran in this spawn; they are checked there, with
    # the ungrouped generation 0 of each rank to hold the grouped one to
    return [dict(out["groups"], ungrouped=(out["scores"][0], out["telemetry"][0])) for out in ranks]


def _distributed_pgpe(device):
    """(c): ``PGPE(distributed=True)`` on ``VecNE(num_actors="max")`` at
    world size 1 over NCCL: the problem samples, evaluates through its
    sharded evaluator, and estimates the gradients, every generation."""
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE

    problem = VecNE("humanoid", OO_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="budget", num_actors="max", seed=0)
    searcher = PGPE(
        problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, optimizer="clipup",
        distributed=True,
    )  # fmt: skip
    StdOutLogger(searcher, interval=1)
    each = {"symmetric_gaussian": MULTIGPU_OO_GENERATIONS, "centered_rank": MULTIGPU_OO_GENERATIONS}
    rows = _oo_run("[multigpu] (c)", searcher, MULTIGPU_OO_GENERATIONS, expected=each)
    interactions = int(searcher.status["total_interaction_count"])
    check(interactions == MULTIGPU_OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[multigpu] (c) interactions {interactions}")
    check(problem._num_actors_mesh(POPSIZE) is not None, "[multigpu] (c) VecNE did not shard")
    print(
        f"[multigpu] (c) PGPE(distributed=True) on VecNE(num_actors='max'), world size 1 over NCCL, popsize {POPSIZE},"
        f" budget {EPISODE_LENGTH} steps: mean_eval {', '.join('%.3f' % r['mean_eval'] for r in rows)}"
    )


def multigpu_phase(device, unsharded):
    """The multi-GPU paths on the one card (see the module note): (a) and
    (c) in this process, one rank over NCCL on a ``file://`` store; (b) two
    spawned ranks over gloo. ``unsharded``: the main path's ``budget`` and
    the contracts phase's ``episodes`` generations. Returns what the two
    ranks saved of phase 24's (b) and (c)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from evotorch_tpu_torch.parallel import default_mesh, init_distributed

    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", world_size=1, rank=0, timeout=datetime.timedelta(seconds=MULTIGPU_TIMEOUT))
        try:
            backend = "nccl" if device.type == "cuda" else "gloo"
            check(dist.get_backend() == backend, f"[multigpu] backend {dist.get_backend()}")
            budget_scores = _world_one_generations(device, default_mesh(), unsharded)
            _distributed_pgpe(device)
        finally:
            dist.destroy_process_group()
    return _two_ranks_one_card(device, budget_scores)


# ---------------------------------------------------------------------------
# the host backends (GymNE), the structures and fault injection
# ---------------------------------------------------------------------------

GYMNE_POPSIZE = 512  # bench_common.py's real-MuJoCo configuration: popsize 512,
GYMNE_LANES = 32  # 32 env lanes,
GYMNE_HORIZON = 500  # half the -v5 horizon of 1,000 (cut with phase 24: the script's time limit),
GYMNE_OBS, GYMNE_ACT = 11, 3  # Hopper's widths; models.MLPPolicy's 64-64 tanh MLP has 5,123 parameters there
GYMNE_GENERATIONS = 2  # each of "pipelined" and "chunked", in turns
GYMNE_STDEV = 0.5  # PGPE's first stdev: first actions over all of [-1, 1], so long and short episodes
GYMNE_SERIAL = 8  # solutions evaluated serially against the vectorized run
GYMNE_SERIAL_BATCH = 64
#: serial (one row a forward) against vectorized (blocks of lanes): the
#: forwards round differently by shape, and the smooth, contractive env
#: keeps that near float32 rounding over an episode
GYMNE_SERIAL_TOL = dict(rtol=1e-4, atol=1e-3)
STRUCTURES_POPSIZE = 10_000
STRUCTURES_LIST = (64, 17)  # CList slots, value width
STRUCTURES_MEMORY_KEYS = 256
STRUCTURES_BAG_KEYS = 64
STRUCTURES_FRAME_COLUMNS = 8
FAULT_SPEC = "eval.scores:nonfinite@1:0.25"
FAULT_SHARE = 0.25


class HopperWidthEnv:
    """A gym-API env in numpy with Hopper-v5's widths (11 observations, 3
    actions in a Box of [-1, 1]), for the ``gymne`` phase on a machine
    without gymnasium or MuJoCo. The first action of an episode sets its
    length, ``1 + floor(999 * (a0 + 1) / 2)`` steps (1 to 1,000), so long
    and short episodes both occur and the refill scheduler has work. The
    dynamics are smooth and contractive, ``s <- 0.95 s + 0.05 tanh(W a)``
    with a fixed ``W``, observed as ``s + c``; the reward is ``1 + 0.1 s_0 -
    0.01 |a|^2``. Every episode starts from the same state, so every run is
    reproducible. Its step holds the interpreter lock (numpy on small
    arrays), so the physics thread overlaps the main thread's waits only."""

    class _Box:
        def __init__(self, n, low, high):
            import numpy as np

            self.shape = (n,)
            self.low = np.full(n, low, dtype=np.float32)
            self.high = np.full(n, high, dtype=np.float32)

    def __init__(self):
        import numpy as np

        self.observation_space = self._Box(GYMNE_OBS, -1e9, 1e9)
        self.action_space = self._Box(GYMNE_ACT, -1.0, 1.0)
        self._w = np.cos(np.arange(GYMNE_OBS * GYMNE_ACT).reshape(GYMNE_OBS, GYMNE_ACT) * 0.7)
        self._c = np.linspace(-0.5, 0.5, GYMNE_OBS)
        self.reset()

    def reset(self, seed=None):
        import numpy as np

        self._s = np.zeros(GYMNE_OBS)
        self._t, self._length = 0, 1
        return (self._s + self._c).astype(np.float32), {}

    def step(self, action):
        import numpy as np

        a = np.clip(np.asarray(action, dtype=np.float64).reshape(-1), -1.0, 1.0)
        if self._t == 0:
            self._length = 1 + int(999 * (a[0] + 1.0) / 2.0)
        self._t += 1
        self._s = 0.95 * self._s + 0.05 * np.tanh(self._w @ a)
        reward = 1.0 + 0.1 * self._s[0] - 0.01 * float(a @ a)
        return (self._s + self._c).astype(np.float32), reward, self._t >= self._length, False, {}

    def close(self):
        pass


def _gymne_env():
    """The env spec of the ``gymne`` phase and its name: Hopper-v5 through
    gymnasium where gymnasium and MuJoCo are installed, else
    :class:`HopperWidthEnv`."""
    import importlib.util

    if importlib.util.find_spec("gymnasium") and importlib.util.find_spec("mujoco"):
        return "Hopper-v5", "Hopper-v5 (gymnasium, MjVecEnv over mujoco.rollout)"
    return HopperWidthEnv, "HopperWidthEnv (numpy in chip_smoke.py; gymnasium or mujoco missing)"


def _gymne_problem(device, env, host_pipeline, *, normalization=True, num_envs=GYMNE_LANES):
    from evotorch_tpu_torch.models import MLPPolicy
    from evotorch_tpu_torch.neuroevolution import GymNE

    problem = GymNE(
        env, MLPPolicy(GYMNE_OBS, GYMNE_ACT), num_envs=num_envs, host_pipeline=host_pipeline,
        observation_normalization=normalization, episode_length=GYMNE_HORIZON, device=device, seed=0,
    )  # fmt: skip
    if num_envs is not None:  # the lanes' reset draws, as bench_common.py seeds them
        problem._make_vector_env().seed(range(1000, 1000 + num_envs))
    return problem


def gymne_phase(device):
    """``GymNE`` + ``PGPE`` (ClipUp, centered ranking) at the JAX package's
    real-MuJoCo benchmark size (``bench_common.py``): popsize 512, 32 lanes,
    a ``GYMNE_HORIZON``-step horizon (500, half of it: the script's time
    limit), ``models.MLPPolicy`` (64-64 tanh, 5,123 parameters
    on 11 observations and 3 actions), observation normalization, on the
    card. ``GYMNE_GENERATIONS`` generations under ``"pipelined"`` and as
    many under ``"chunked"``, in turns, each with its episodes and launches
    checked (the sampler at 512 x 5,123 each generation, the rank at n =
    512 from the second on: the first has no tell). Then ``mode="sync"``
    against ``"pipelined"`` on one population, bit for bit; then the first
    ``GYMNE_SERIAL`` solutions serially against a vectorized run,
    normalization off, within ``GYMNE_SERIAL_TOL`` and episode lengths
    exact."""
    import numpy as np
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.core import SolutionBatch

    env, env_name = _gymne_env()
    print(f"[gymne] env: {env_name}")
    searchers = {}
    for mode in ("pipelined", "chunked"):
        problem = _gymne_problem(device, env, mode)
        check(problem.solution_length == 5_123, f"[gymne] {problem.solution_length} parameters, expected 5,123")
        searchers[mode] = PGPE(
            problem, popsize=GYMNE_POPSIZE, center_learning_rate=0.05, stdev_learning_rate=0.1, stdev_init=GYMNE_STDEV,
            optimizer="clipup", optimizer_config={"max_speed": 0.1}, ranking_method="centered",
        )  # fmt: skip
    for generation in range(GYMNE_GENERATIONS):
        for mode in ("pipelined", "chunked") if generation % 2 == 0 else ("chunked", "pipelined"):
            searcher = searchers[mode]
            problem = searcher.problem
            before = int(problem.status.get("total_interaction_count", 0))
            episodes_before = int(problem.status.get("total_episode_count", 0))
            launched = _launches()
            searcher.step()
            launches = _launches(launched)
            env_steps = int(problem.status["total_interaction_count"]) - before
            episodes = int(problem.status["total_episode_count"]) - episodes_before
            expected = {"symmetric_gaussian": 1, "centered_rank": 0 if generation == 0 else 1}
            check(launches == expected, f"[gymne] {mode} generation {generation}: launches {launches}, expected {expected}")
            evals = searcher.population.evals
            check(evals.device == device and evals.shape == (GYMNE_POPSIZE, 1) and bool(torch.isfinite(evals).all()), f"[gymne] {mode} evals")
            check(episodes == GYMNE_POPSIZE, f"[gymne] {mode}: {episodes} episodes")
            print(
                f"[gymne] {mode} generation {generation}: {env_steps:,} env steps, {episodes} episodes, launches"
                f" {launches}, mean eval {float(evals.mean()):.3f}"
            )

    # sync against pipelined on one population
    generator = torch.Generator(device=device).manual_seed(5)
    values = searchers["pipelined"].distribution.sample(GYMNE_POPSIZE, generator=generator)
    out = {}
    for mode in ("sync", "pipelined"):
        problem = _gymne_problem(device, env, mode)
        batch = SolutionBatch(problem, GYMNE_POPSIZE, values=values.clone())
        problem.evaluate(batch)
        out[mode] = (batch.evals[:, 0].cpu(), int(problem.status["total_interaction_count"]), int(problem.status["total_episode_count"]))
    (sa, ia, ea), (sb, ib, eb) = out["sync"], out["pipelined"]
    check(torch.equal(sa, sb) and ia == ib and ea == eb, f"[gymne] sync and pipelined differ: {float((sa - sb).abs().max())}, {ia} vs {ib}, {ea} vs {eb}")
    print(f"[gymne] mode='sync' equals 'pipelined' bit for bit on one population ({ia:,} interactions, {ea} episodes)")

    if env is not HopperWidthEnv:
        print("[gymne] serial against vectorized: not held on Hopper-v5 (its resets draw noise and its closed loop is chaotic)")
        return
    # serial against vectorized, normalization off
    rows = values[:GYMNE_SERIAL_BATCH].clone()
    vectorized = _gymne_problem(device, env, "pipelined", normalization=False)
    batch = SolutionBatch(vectorized, GYMNE_SERIAL_BATCH, values=rows)
    vectorized.evaluate(batch)
    serial = _gymne_problem(device, env, "pipelined", normalization=False, num_envs=None)
    sbatch = SolutionBatch(serial, GYMNE_SERIAL, values=rows[:GYMNE_SERIAL].clone())
    serial.evaluate(sbatch)
    got, ref = sbatch.evals[:, 0].cpu().numpy(), batch.evals[:GYMNE_SERIAL, 0].cpu().numpy()
    serial_steps = int(serial.status["total_interaction_count"])
    check(np.allclose(got, ref, **GYMNE_SERIAL_TOL), f"[gymne] serial against vectorized: {got} vs {ref}")
    # a score is its episode's length plus terms under 0.11 a step: the
    # lengths are exact when the scores agree this closely
    print(
        f"[gymne] serial (num_envs=None) against vectorized on the first {GYMNE_SERIAL} of {GYMNE_SERIAL_BATCH} solutions,"
        f" normalization off: max abs difference {float(np.abs(got - ref).max()):.3g} (tolerance {GYMNE_SERIAL_TOL});"
        f" {serial_steps:,} serial env steps"
    )


def _structures_run(device, generator):
    """One fixed sequence of operations on a CList, a CMemory, a CBag (one
    of each per member of a ``STRUCTURES_POPSIZE`` population) and a
    ``STRUCTURES_POPSIZE``-row TensorFrame, from inputs made on the CPU by
    one seed before any of it runs; returns every result (on the CPU)."""
    import torch

    from evotorch_tpu_torch.tools import CBag, CList, CMemory, TensorFrame

    n = STRUCTURES_POPSIZE
    slots, width = STRUCTURES_LIST
    keys, bag_keys = STRUCTURES_MEMORY_KEYS, STRUCTURES_BAG_KEYS
    g = torch.Generator().manual_seed(0)

    def make(*shape, low=-4, high=5, dtype=torch.float32):
        return torch.randint(low, high, shape, generator=g).to(dtype).to(device)

    pushes = [(make(n, width), make(n, low=0, high=5) > 0) for _ in range(slots + 6)]  # past the capacity
    left, left_where = make(n, width), make(n, low=0, high=2) > 0
    pop_where = make(n, low=0, high=3) > 0
    list_index = make(n, low=-slots, high=slots, dtype=torch.int64)
    list_add = (make(n, low=0, high=slots, dtype=torch.int64), make(n, width))
    mem_adds = [(make(n, low=-4, high=keys + 4, dtype=torch.int64), make(n), make(n, low=0, high=4) > 0) for _ in range(8)]
    mem_set = (make(n, low=0, high=keys, dtype=torch.int64), make(n))
    mem_circular = make(n, low=0, high=keys, dtype=torch.int64)
    mem_read = make(3, n, low=-2, high=keys + 2, dtype=torch.int64)
    bag_pushes = [make(2, n, low=-1, high=bag_keys + 1, dtype=torch.int64) for _ in range(6)]
    bag_pop = make(n, low=0, high=bag_keys, dtype=torch.int64)
    columns = {f"f{i}": make(n) for i in range(STRUCTURES_FRAME_COLUMNS - 3)}
    columns |= {f"i{i}": make(n, low=0, high=50, dtype=torch.int32) for i in range(3)}
    frame_write = make(n)

    results = []
    lst = CList.create(slots, width, batch_shape=(n,), device=device)
    for value, where in pushes:
        lst = lst.append_(value, where=where)
    lst = lst.appendleft_(left, where=left_where)
    lst, popped = lst.pop_()
    lst, popped_left = lst.popleft_(where=pop_where)
    got = lst.get(list_index, default=-1.0)
    lst = lst.add_(*list_add)
    results += [lst.data, lst.begin, lst.length, popped, popped_left, got]

    mem = CMemory.create(keys, batch_shape=(n,), device=device)
    for k, v, where in mem_adds:
        mem = mem.add_(k, v, where=where)
    mem = mem.set_(*mem_set)
    mem = mem.add_circular_(mem_circular, 3.0, 5.0)
    read = mem.get(mem_read, default=-9.0)
    results += [mem.data, read]

    bag = CBag.create(bag_keys, batch_shape=(n,), device=device)
    for k in bag_pushes:
        bag = bag.push_(k)
    bag, key, ok = bag.pop_(bag_pop)
    results += [bag.counts, key, ok]
    total_before = bag.total
    popped_bag, picked, picked_ok = bag.pop_(generator)
    # held by the counts: a present key drawn wherever the bag is not empty
    check(torch.equal(picked_ok, total_before > 0), "[structures] a random pop missed a non-empty bag")
    check(bool((bag.counts.gather(1, picked[:, None])[:, 0][picked_ok] > 0).all()), "[structures] a random pop drew an absent key")
    check(torch.equal(popped_bag.total, total_before - picked_ok.to(torch.int32)), "[structures] a random pop left wrong counts")
    results += [popped_bag.total, picked_ok]

    frame = TensorFrame.create(columns)
    ordered = frame.sort("f0", descending=True)
    top = frame.nlargest(100, "i0")
    mask = frame.f1 > 0
    picked_rows = frame.pick[mask, ["f2", "i1"]]
    written = frame.pick_set(mask, frame_write, columns="f3")
    for f in (ordered, top, picked_rows, written):
        results += list(f.data)
    return [r.cpu() for r in results]


def structures_phase(device):
    """The structures of ``tools/structures.py`` and a TensorFrame on the
    card, one structure per member of a 10,000 population: a CList of 64
    slots of width 17, a CMemory of 256 keys, a CBag of 64 keys and a
    10,000-row frame of 8 columns sorted and picked; the same operations
    on the CPU, every result equal bit for bit (the random pop of the bag
    held by its counts, not its draws)."""
    import torch

    before = _launches()
    card = _structures_run(device, torch.Generator(device=device).manual_seed(7))
    launches = _launches(before)
    cpu = _structures_run(torch.device("cpu"), torch.Generator().manual_seed(7))
    check(len(card) == len(cpu), "[structures] result counts")
    for i, (a, b) in enumerate(zip(card, cpu)):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f"[structures] result {i} differs from the CPU's")
    check(launches == {"symmetric_gaussian": 0, "centered_rank": 0}, f"[structures] launches {launches}")
    print(f"[structures] popsize {STRUCTURES_POPSIZE}: {len(card)} results equal to the CPU's bit for bit")


def faults_phase(device):
    """One flagship ``VecNE`` + ``PGPE`` generation (Humanoid, popsize
    10,000, ``budget``, quarantine on) under ``FAULT_SPEC``: 2,500 scores
    made non-finite at the host boundary, at the indices numpy's
    ``default_rng(1234 + 1)`` chooses (the JAX package's), each replaced by
    the worst finite score, the others untouched; then the next generation,
    whose tell takes those scores, leaves a finite center. The spec is
    installed with ``resilience.faults.configure`` and removed at the end."""
    import numpy as np
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp
    from evotorch_tpu_torch.observability import counters
    from evotorch_tpu_torch.resilience import faults

    problem = VecNE("humanoid", tanh_mlp(109, 17, HIDDEN), episode_length=EPISODE_LENGTH, eval_mode="budget", nonfinite_quarantine=True, device=device, seed=0)
    searcher = PGPE(problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, optimizer="clipup", ranking_method="centered")
    seen = []
    inject = problem._maybe_inject_nonfinite

    def recording(scores):
        out = inject(scores)
        seen.append((scores.clone(), out.clone()))
        return out

    problem._maybe_inject_nonfinite = recording
    before = counters.get("faults.injected_nonfinite")
    faults.configure(FAULT_SPEC)
    try:
        launched = _launches()
        searcher.step()
        evals = searcher.population.evals[:, 0].clone()
        searcher.step()
        launches = _launches(launched)
    finally:
        faults.configure(None)
        problem._maybe_inject_nonfinite = inject
    injected = counters.get("faults.injected_nonfinite") - before
    k = int(round(FAULT_SHARE * POPSIZE))
    check(injected == k, f"[faults] injected {injected}, expected {k} (a quarter of popsize {POPSIZE})")
    check(len(seen) == 2, f"[faults] {len(seen)} evaluations")
    raw, quarantined = seen[0]
    expected_idx = torch.as_tensor(np.random.default_rng(1234 + 1).choice(POPSIZE, size=k, replace=False), device=device)
    mask = torch.zeros(POPSIZE, dtype=torch.bool, device=device)
    mask[expected_idx] = True
    worst = raw[~mask].min()
    check(torch.equal(quarantined[~mask], raw[~mask]), "[faults] a score outside the chosen indices changed")
    check(bool((quarantined[mask] == worst).all()), "[faults] the chosen indices are not the worst finite score")
    check(bool(torch.isfinite(evals).all()) and torch.equal(evals, quarantined), "[faults] a non-finite score reached the tell")
    check(torch.equal(seen[1][0], seen[1][1]), "[faults] the spec fired a second time")
    center = searcher.status["center"]
    check(bool(torch.isfinite(center).all()), "[faults] the center after the tell is not finite")
    check(launches == {"symmetric_gaussian": 2, "centered_rank": 1}, f"[faults] launches {launches}")
    print(
        f"[faults] {FAULT_SPEC}: VecNE + PGPE at popsize {POPSIZE} (budget, quarantine on), 2 generations:"
        f" counters['faults.injected_nonfinite'] +{injected}, the indices numpy's default_rng(1235) chooses, each set to the"
        f" worst finite score {float(worst):.3f}; every score reaching the tell finite, the center finite; launches {launches}"
    )


SERVE_SLAB = 10_000  # rows a dispatch packs (bench.py's BENCH_SERVE slab: the flagship popsize)
SERVE_TENANTS = 4
SERVE_ROWS = SERVE_SLAB // SERVE_TENANTS  # 2,500 a tenant
SERVE_STDEV = 0.1  # the rows are the flagship's first population: 0 + 0.1 * N(0, 1)
SERVE_VECNE_POPSIZE = 5_000
SERVE_VECNE_GENERATIONS = 2  # the first has no tell; launches are counted over the last (three before the autotune phase)
SERVE_SLO_ROWS = 1_000


def _serve_tenant_inputs(device, L, k):
    """Tenant ``k``'s matrix (``SERVE_ROWS`` x ``L``) and the seed of its
    generator, each from its own seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(1_000 + k)
    return SERVE_STDEV * torch.randn((SERVE_ROWS, L), generator=g, device=device), 2_000 + k


def _serve_leg(server, tenants, inputs):
    """One ``serve`` leg: every tenant submits its matrix with a generator
    from its seed, then the server drains. Returns the futures' results and
    the dispatches."""
    import torch

    before = server.dispatches
    futures = [server.submit(t, m, torch.Generator(device=server.device).manual_seed(seed)) for t, (m, seed) in zip(tenants, inputs)]
    server.drain()
    return [f.result() for f in futures], server.dispatches - before


def _sequential_leg(env, policy, inputs, width):
    """One ``sequential`` leg: each tenant's matrix evaluated alone by
    ``episodes_refill`` at the server's width, from a generator of the
    same seed, one after the other."""
    import torch

    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout

    return [
        run_vectorized_rollout(
            env, policy, m, torch.Generator(device=m.device).manual_seed(seed), None, eval_mode="episodes_refill",
            refill_width=width, episode_length=EPISODE_LENGTH,
        )
        for m, seed in inputs
    ]  # fmt: skip


def serving_phase(device):
    """One ``EvalServer`` at the flagship (slab 10,000, 4 tenants of 2,500
    rows, ``episodes_refill`` at the server's refill width, 200-step
    episodes, no normalization): the ``serve`` leg (4 submits, one
    ``drain``) in one dispatch, each tenant's packed scores equal to its
    standalone run at that width from the same generator state (the
    ``sequential`` leg), bit for bit. Then a slab of 3 tenants, whose
    padding is charged to group 0 and to no tenant; then churn: a tenant
    departs, another is admitted, the residency key stays, each step adds
    one dispatch, no kernel is rebuilt. Neither kernel runs here (the
    matrices come from ``torch.randn``)."""
    import torch

    from evotorch_tpu_torch.ops import _build
    from evotorch_tpu_torch.serving import EvalServer

    env, policy, _, _ = flagship(device)
    L = policy.parameter_count
    server = EvalServer(env, policy, slab_size=SERVE_SLAB, max_tenants=SERVE_TENANTS, episode_length=EPISODE_LENGTH, device=device)
    width = server.refill_width
    tenants = [server.admit(f"t{k}") for k in range(SERVE_TENANTS)]
    inputs = [_serve_tenant_inputs(device, L, k) for k in range(SERVE_TENANTS)]
    before_launches = _launches()

    packed, dispatches = _serve_leg(server, tenants, inputs)
    check(dispatches == 1, f"[serving] {SERVE_TENANTS} x {SERVE_ROWS} rows took {dispatches} dispatches of {SERVE_SLAB}")
    alone = _sequential_leg(env, policy, inputs, width)
    served_steps, alone_steps = sum(r.total_steps for r in packed), sum(int(r.total_steps) for r in alone)
    check(served_steps == alone_steps, f"[serving] env steps differ between the legs: {served_steps} and {alone_steps}")
    for k, (a, b) in enumerate(zip(packed, alone)):
        check(a.scores.shape == (SERVE_ROWS,) and bool(torch.isfinite(a.scores).all()), f"[serving] tenant {k} scores")
        diff = float((a.scores - b.scores).abs().max())
        check(torch.equal(a.scores, b.scores), f"[serving] tenant {k}: packed scores differ from its standalone run at width {width} (max {diff:.3g})")
        check(a.total_steps == int(b.total_steps) and a.total_episodes == SERVE_ROWS, f"[serving] tenant {k} counters")
    print(
        f"[serving] {SERVE_TENANTS} tenants x {SERVE_ROWS} rows packed into one slab of {SERVE_SLAB} (refill width"
        f" {width}): every tenant's scores equal its standalone episodes_refill run at width {width} bit for bit;"
        f" program key {server.program.key}"
    )

    # padding: a slab filled by 3 tenants charges its padding to group 0 only
    three = tenants[:3]
    before = server.dispatches
    futures = [server.submit(t, m, torch.Generator(device=device).manual_seed(seed)) for t, (m, seed) in zip(three, inputs[:3])]
    before_rows = {t.name: t.telemetry for t in server.tenants}
    server.drain()
    check(server.dispatches == before + 1, "[serving] 3 tenants took more than one dispatch")
    wire = server.last_telemetry
    padding = SERVE_SLAB - 3 * SERVE_ROWS
    check(wire.group(0).episodes == padding and wire.group(0).env_steps > 0, f"[serving] group 0 ran {wire.group(0).episodes} padding episodes, expected {padding}")
    check(wire.group(4).episodes == 0 and wire.group(4).env_steps == 0, "[serving] the idle tenant's row was charged")
    for k, f in enumerate(futures):
        r = f.result()
        check(r.total_episodes == SERVE_ROWS and torch.equal(r.scores, packed[k].scores), f"[serving] tenant {k} in the 3-tenant slab")
    check(tenants[3].telemetry.total().episodes == before_rows["t3"].total().episodes, "[serving] the idle tenant's telemetry moved")
    print(
        f"[serving] 3 tenants in a slab of {SERVE_SLAB}: {padding} padding rows ran as group 0 ({wire.group(0).env_steps} env"
        f" steps, {wire.group(0).episodes} episodes), no tenant charged for them, scores as before"
    )

    # churn: one departs, one is admitted; the residency key stays
    key, program, loaded = server.program.key, server.program, dict(_build._loaded)
    server.depart(tenants[3])
    fresh = server.admit("t4")
    check(fresh.group == tenants[3].group, "[serving] the freed group row was not reused")
    grew = []
    for t, (m, seed) in zip(tenants[:3] + [fresh], inputs):
        server.submit(t, m, torch.Generator(device=device).manual_seed(seed))
    while True:
        before = server.dispatches
        if not server.step():
            break
        grew.append(server.dispatches - before)
    check(server.program is program and server.program.key == key, "[serving] the residency key changed under churn")
    check(grew == [1], f"[serving] dispatches grew by {grew} over the steps")
    check(_build._loaded == loaded and all(_build._loaded[k] is v for k, v in loaded.items()), "[serving] a kernel was rebuilt")
    launches = _launches(before_launches)
    check(launches == {"symmetric_gaussian": 0, "centered_rank": 0}, f"[serving] launches {launches}")
    print(
        f"[serving] churn: t3 departed, t4 admitted on group {fresh.group}; program key unchanged {key},"
        f" dispatches +1 per step {grew}, no kernel rebuilt; {server.dispatches} dispatches; launches {launches}"
    )


def _vecne_search(device, seed, **problem_kw):
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp

    problem = VecNE(
        "humanoid", tanh_mlp(109, 17, HIDDEN), episode_length=EPISODE_LENGTH, eval_mode="episodes_refill", seed=seed,
        device=device, **problem_kw,
    )  # fmt: skip
    return PGPE(problem, popsize=SERVE_VECNE_POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, optimizer="clipup", ranking_method="centered")


def _stdio_round_trip(device):
    """The JSON-lines front on the card: a small CartPole server, ``admit``,
    ``submit``, ``step``, ``result``, a bad request, ``status``."""
    import io

    import torch

    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, Tanh, run_vectorized_rollout
    from evotorch_tpu_torch.serving import EvalServer, serve_stdio

    env = CartPole(continuous_actions=True, device=device)
    policy = FlatParamsPolicy(Linear(4, 1) >> Tanh())
    server = EvalServer(env, policy, slab_size=16, max_tenants=2, device=device)
    values = [[0.1 * ((i * 5 + j) % 7 - 3) for j in range(policy.parameter_count)] for i in range(6)]
    lines = [
        {"op": "admit", "tenant": "cli"},
        {"op": "submit", "tenant": "cli", "values": values, "seed": 5},
        {"op": "step"},
        {"op": "result", "request_id": 0},
        {"op": "submit", "tenant": "ghost", "values": values},
        {"op": "status"},
    ]
    out = io.StringIO()
    serve_stdio(server, io.StringIO("\n".join(json.dumps(x) for x in lines) + "\n"), out)
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    check([r["ok"] for r in replies] == [True, True, True, True, False, True], f"[serving_vecne] stdio replies {replies}")
    ref = run_vectorized_rollout(
        env, policy, torch.tensor(values, device=device), torch.Generator(device=device).manual_seed(5), None,
        eval_mode="episodes_refill", refill_width=server.refill_width,
    )  # fmt: skip
    check(replies[3]["scores"] == [float(x) for x in ref.scores.cpu()], "[serving_vecne] stdio scores differ from the standalone run")
    print(f"[serving_vecne] stdio on the card: admit, submit, step (served {replies[2]['served']}), result ({len(replies[3]['scores'])} scores equal to the standalone run), a bad request answered {replies[4]['error']!r} and the server went on")


def serving_vecne_phase(device):
    """Two ``VecNE`` + ``PGPE`` searches at the flagship (popsize 5,000 each,
    ``eval_backend=RemoteEvalBackend(server)``) on one server (slab 10,000),
    each stepping in its own thread, so that one thread serves the other's
    items while it waits: 2 generations, each a staged co-dispatch
    (``server.holding()`` until both searches have submitted, so that one
    dispatch carries both); each tenant's scores equal the same search run
    standalone (refill width the server's) with the same seed, generation
    by generation, bit for bit; each kernel launched once per tenant in
    each generation after the first, which has no tell (the sampler at
    5,000 x 12,305, the rank at n = 5,000). A third tenant with an
    ``occupancy_floor`` of 1.01 queues two requests first: it is suspended
    after its first dispatch, its next submit raises, its queued items
    drain, the others run on. A MetricsHub writes one row a dispatch with
    the per-tenant breakdown to ``build/serving_metrics.jsonl``. Then a
    small stdio round trip on the card."""
    import threading

    import torch

    from evotorch_tpu_torch.observability.metricshub import MetricsHub
    from evotorch_tpu_torch.serving import EvalServer, RemoteEvalBackend

    env, policy, _, _ = flagship(device)
    metrics_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serving_metrics.jsonl")
    hub = MetricsHub(metrics_path, manifest={"phase": "serving_vecne"})
    server = EvalServer(
        env, policy, slab_size=SERVE_SLAB, max_tenants=3, episode_length=EPISODE_LENGTH, metrics=hub, device=device
    )  # fmt: skip
    width = server.refill_width

    # the standalone searches, same seeds, refill width the server's
    alone = []
    for seed in (11, 12):
        searcher = _vecne_search(device, seed, refill_config={"width": width})
        scores = []
        for _ in range(SERVE_VECNE_GENERATIONS):
            searcher.step()
            scores.append(searcher.population.evals[:, 0].clone())
        alone.append(scores)

    hot = server.admit("slo", slo=[{"kind": "occupancy_floor", "threshold": 1.01}])
    g = torch.Generator(device=device).manual_seed(7)
    hot_futures = [server.submit(hot, SERVE_STDEV * torch.randn((SERVE_SLO_ROWS, policy.parameter_count), generator=g, device=device)) for _ in range(2)]
    searchers = [_vecne_search(device, seed, eval_backend=RemoteEvalBackend(server, name=f"search{seed}")) for seed in (11, 12)]
    served = [[] for _ in searchers]
    errors = []
    start, end = threading.Barrier(len(searchers) + 1), threading.Barrier(len(searchers) + 1)

    def run(k):
        try:
            for _ in range(SERVE_VECNE_GENERATIONS):
                start.wait()
                searchers[k].step()
                served[k].append(searchers[k].population.evals[:, 0].clone())
                end.wait()
        except BaseException as exc:  # graftlint: allow(swallow): re-raised below, on the main thread
            errors.append(exc)
            start.abort()
            end.abort()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(searchers))]
    for t in threads:
        t.start()
    tenants = [s.problem.eval_backend.tenant for s in searchers]
    before = None
    try:
        for gen in range(SERVE_VECNE_GENERATIONS):
            if gen == 1:
                before = _launches()  # launches of the generations with a tell
            # staged co-dispatch: hold the dispatches until both searches have
            # submitted, so the one dispatch carries both, run by whichever
            # thread gets there first
            with server.holding():
                start.wait()
                deadline = time.monotonic() + 120
                while not all(t.pending for t in tenants) and time.monotonic() < deadline and not errors:
                    time.sleep(0.001)
            end.wait()
    except threading.BrokenBarrierError:
        pass
    for t in threads:
        t.join()
    launches = _launches(before)
    if errors:
        raise errors[0]
    check(hot.suspended, "[serving_vecne] the tenant with the 1.01 occupancy floor was not suspended")
    try:
        server.submit(hot, torch.zeros((1, policy.parameter_count), device=device))
        check(False, "[serving_vecne] a suspended tenant's submit was taken")
    except RuntimeError as exc:
        check("suspended" in str(exc), f"[serving_vecne] {exc}")
    server.drain()
    check(all(f.done() and bool(torch.isfinite(f.result().scores).all()) for f in hot_futures), "[serving_vecne] the suspended tenant's queued items did not drain")
    for k in range(len(searchers)):
        for gen in range(SERVE_VECNE_GENERATIONS):
            a, b = served[k][gen], alone[k][gen]
            check(torch.equal(a, b), f"[serving_vecne] search {k} generation {gen}: scores differ from the standalone search (max {float((a - b).abs().max()):.3g})")
    expected = {"symmetric_gaussian": 2 * (SERVE_VECNE_GENERATIONS - 1), "centered_rank": 2 * (SERVE_VECNE_GENERATIONS - 1)}
    check(launches == expected, f"[serving_vecne] launches {launches}, expected {expected} (one of each per tenant per generation with a tell)")
    with open(metrics_path) as f:
        lines = [json.loads(x) for x in f]
    check(len(lines) == 1 + server.dispatches and lines[0]["manifest"]["runtime"] == "torch", "[serving_vecne] MetricsHub rows")
    check(all(len(x["groups"]) == 4 and "tenants" in x for x in lines[1:]), "[serving_vecne] a MetricsHub row lacks the per-tenant breakdown")
    status = server.status()
    print(
        f"[serving_vecne] 2 VecNE + PGPE searches (popsize {SERVE_VECNE_POPSIZE}, refill width {width}) in 2 threads on one"
        f" server of {SERVE_SLAB}, each generation one staged co-dispatch: scores equal the standalone searches bit for bit, {SERVE_VECNE_GENERATIONS} generations each; launches over the"
        f" last {SERVE_VECNE_GENERATIONS - 1} generations {launches}; {server.dispatches} dispatches; the 'slo' tenant suspended ({status['tenants']['slo'].get('slo_detail')}), its 2 queued"
        f" requests drained; {len(lines) - 1} MetricsHub rows in build/serving_metrics.jsonl"
    )
    _stdio_round_trip(device)


# ---------------------------------------------------------------------------
# the autotuner and the program ledger
# ---------------------------------------------------------------------------

# refill lane widths from the default 2,048 up (1,024 too before phase 24: the script's time limit)
AUTOTUNE_WIDTHS = (2_048, 4_096)
AUTOTUNE_TRIALS = 2
AUTOTUNE_FLOOR = 0.9  # the refill group's occupancy floor (RefillHarness.default_min_occupancy)
REPORT_STEPS = 2  # control steps of each rollout the report captures at the flagship
# the sampling and ranking kernels' launches inside each report capture
# (ask: 1 sample; tell: 1 rank; a generation: both; a span of 3: 3 of each;
# the trunk-delta ask draws its coefficients with torch, not the sampling
# kernel; the physics kernel's launches are not held here)
REPORT_LAUNCHES = {
    "gaussian.ask": {"symmetric_gaussian": 1, "centered_rank": 0},
    "gaussian.tell": {"symmetric_gaussian": 0, "centered_rank": 1},
    "generation_step": {"symmetric_gaussian": 1, "centered_rank": 1},
    "generation_step.trunk_delta": {"symmetric_gaussian": 0, "centered_rank": 1},
    "training_span": {"symmetric_gaussian": 3, "centered_rank": 3},
}


def _readback_cache(device, harness, winner, path):
    """The winner as ``tune_group`` would persist it (its group, the
    ``_cache_shape`` key and the card's ``machine_fingerprint``), written to
    ``path``: the read-back runs on every call, also when the winner misses
    the floor and ``tune_group`` rightly leaves the tuner's cache
    unwritten."""
    from evotorch_tpu_torch.observability import autotune
    from evotorch_tpu_torch.observability.timings import TunedEntry, machine_fingerprint, save_tuned_entry

    if os.path.exists(path):
        os.remove(path)
    entry = TunedEntry(
        group=harness.group, shape=autotune._cache_shape(harness), machine=machine_fingerprint(device),
        config=harness.tuned_config(winner.config),
        evidence={"steps_per_sec": round(winner.steps_per_sec, 1), "occupancy": round(winner.occupancy, 4), "read_back_only": True},
    )  # fmt: skip
    save_tuned_entry(entry, path)
    return path


def _autotune_cache_checks(device, harness, cache):
    """A cache holding the winner read back: its machine the card's, then a
    ``VecNE`` + ``PGPE`` generation and the one-rank sharded evaluator (C.7
    on the card), each reporting ``tuned_config_source == "cache"`` and
    running at the tuned width."""
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import tanh_mlp
    from evotorch_tpu_torch.observability import EvalTelemetry
    from evotorch_tpu_torch.parallel import default_mesh, make_sharded_rollout_evaluator

    with open(cache) as f:
        entries = json.load(f)["entries"]
    check(len(entries) == 1, f"[autotune] {len(entries)} cache entries, expected 1")
    machine, width = entries[0]["machine"], int(entries[0]["config"]["width"])
    check(
        machine["backend"] == "cuda" and machine["device_kind"] == torch.cuda.get_device_name(0) and machine["runtime"] == "torch",
        f"[autotune] the entry's machine is {machine}",
    )
    before = os.environ.get("EVOTORCH_TUNED_CACHE")
    os.environ["EVOTORCH_TUNED_CACHE"] = cache
    try:
        problem = VecNE(
            "humanoid", tanh_mlp(109, 17, HIDDEN), episode_length=EPISODE_LENGTH, eval_mode="episodes_refill", seed=0,
            device=device,
        )  # fmt: skip
        searcher = PGPE(
            problem, popsize=POPSIZE, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1,
            optimizer="clipup", ranking_method="centered",
        )  # fmt: skip
        launched = _launches()
        searcher.step()
        launches = _launches(launched)
        lane_width = EvalTelemetry.from_array(problem._pending_telemetry).lane_width
        check(searcher.status["tuned_config_source"] == "cache", f"[autotune] VecNE: {searcher.status['tuned_config_source']}")
        check(lane_width == width, f"[autotune] VecNE ran at {lane_width} lanes, the cache says {width}")
        check(launches == {"symmetric_gaussian": 1, "centered_rank": 0}, f"[autotune] VecNE launches {launches}")
        check(bool(torch.isfinite(searcher.population.evals).all()), "[autotune] VecNE: scores not finite")
        evaluator = make_sharded_rollout_evaluator(
            harness.env, harness.policy, mesh=default_mesh(), num_episodes=1, episode_length=EPISODE_LENGTH,
            eval_mode="episodes_refill",
        )  # fmt: skip
        result, _ = evaluator(harness.values, torch.Generator(device=device).manual_seed(3), harness.stats)
        sharded_width = EvalTelemetry.from_array(result.telemetry).lane_width
        check(evaluator.tuned_config_source == "cache", f"[autotune] sharded evaluator: {evaluator.tuned_config_source}")
        check(sharded_width == width, f"[autotune] the sharded evaluator ran at {sharded_width} lanes, the cache says {width}")
        check(bool(torch.isfinite(result.scores).all()), "[autotune] sharded evaluator: scores not finite")
    finally:
        if before is None:
            os.environ.pop("EVOTORCH_TUNED_CACHE", None)
        else:
            os.environ["EVOTORCH_TUNED_CACHE"] = before
    print(
        f"[autotune] {os.path.basename(cache)} read back: VecNE + PGPE generation at {lane_width} lanes from the cache,"
        f" launches {launches}; the one-rank sharded evaluator at {sharded_width} lanes from the cache"
    )


def _ledger_report(device):
    """``report --flagship`` in this process, over the one-rank group: each
    registered program captured once at the flagship with REPORT_STEPS
    control steps a rollout (ops, kernel launches, FLOPs, peak, the
    input-mutation check)."""
    from evotorch_tpu_torch.observability import report
    from evotorch_tpu_torch.observability.inventory import capture_inventory
    from evotorch_tpu_torch.observability.programs import ProgramLedger

    cfg = report.gate_config(flagship=True, episode_length=REPORT_STEPS)
    check(cfg.popsize == POPSIZE and cfg.hidden == tuple(HIDDEN), f"[report] the flagship config {cfg}")
    records, errors = capture_inventory(cfg, ProgramLedger(), device=device, strict=False)
    check(not errors, f"[report] captures failed: {errors}")
    check(any(r.name == "sharded_evaluator" for r in records), "[report] the sharded evaluator was not captured")
    for r in records:
        check(r.donation is not None and r.donation.verified, f"[report] {r.key}: inputs written {r.donation}")
        check(r.peak_bytes is not None and r.peak_bytes >= 0, f"[report] {r.key}: peak {r.peak_bytes}")
        check(r.ops > 0 and r.control_steps >= 1, f"[report] {r.key}: {r.ops} ops over {r.control_steps} steps")
        expected = REPORT_LAUNCHES.get(r.name, {"symmetric_gaussian": 0, "centered_rank": 0})
        launches = {k: r.kernel_launches.get(k, 0) for k in expected}
        check(launches == expected, f"[report] {r.key}: launches {r.kernel_launches}, expected {expected}")
    print(f"[report] {len(records)} programs at the flagship ({REPORT_STEPS} steps a rollout): launches as expected, inputs untouched")


def autotune_phase(device):
    """The autotuner at the flagship (Humanoid, popsize 10,000,
    ``tanh_mlp(109, 17, [64, 64])``, float32, one 200-step episode):
    ``tune_group(RefillHarness(widths=AUTOTUNE_WIDTHS), trials=2,
    max_rounds=1, refine=False)`` into ``build/autotune_cache.json``. Every
    candidate gives finite scores, occupancies in [0, 1], no first-use work
    in its timed trials and a peak from its capture; the cache is written
    exactly when the winner meets the 0.9 floor. The winner is then read
    back on every run (``_autotune_cache_checks``): from that cache when it
    was written, else from ``build/autotune_cache_readback.json``, which
    holds the entry ``tune_group`` would have written. Then ``report
    --flagship`` (``_ledger_report``) over a one-rank group. The sampling
    kernel launches once for the harness's population and once in the
    ``VecNE`` generation, the ranking kernel not at all."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from evotorch_tpu_torch.observability import autotune
    from evotorch_tpu_torch.parallel import init_distributed

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "autotune_cache.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    before = _launches()
    shape = autotune.TuneShape(env_name="humanoid", popsize=POPSIZE, episode_length=EPISODE_LENGTH, hidden=tuple(HIDDEN))
    harness = autotune.RefillHarness(shape, widths=AUTOTUNE_WIDTHS, periods=(1,), device=device)
    outcome = autotune.tune_group(harness, trials=AUTOTUNE_TRIALS, max_rounds=1, refine=False, cache_path=cache)
    harness.baseline(AUTOTUNE_TRIALS)
    launches = _launches(before)
    check(harness.policy.parameter_count == 12_305, f"[autotune] {harness.policy.parameter_count} parameters")
    check(len(outcome.results) == len(AUTOTUNE_WIDTHS) and not outcome.pruned, f"[autotune] {len(outcome.results)} candidates, pruned {outcome.pruned}")
    for stats in outcome.results:
        rows = [t for t in harness.trials if t["label"] == "refill" and t["config"] == stats.config]
        where = f"[autotune] width {stats.config['refill_width']}"
        check(len(rows) == AUTOTUNE_TRIALS and all(r["finite"] for r in rows), f"{where}: scores not finite")
        check(len(stats.occupancies) == AUTOTUNE_TRIALS and all(0.0 <= o <= 1.0 for o in stats.occupancies), f"{where}: occupancies {stats.occupancies}")
        check(stats.steady_compiles == 0, f"{where}: {stats.steady_compiles} first uses in its timed trials")
        check(stats.cost is not None and stats.cost.get("peak_bytes") is not None, f"{where}: no peak captured")
    base_rows = [t for t in harness.trials if t["label"] == "episodes"]
    check(all(r["finite"] and r["first_uses"] == 0 for r in base_rows), "[autotune] the episodes baseline")
    winner = outcome.winner
    floor_met = winner.occupancy is not None and winner.occupancy >= AUTOTUNE_FLOOR
    check(outcome.cache_written == floor_met, f"[autotune] cache_written {outcome.cache_written}, floor met {floor_met}")
    check(os.path.exists(cache) == floor_met, f"[autotune] the cache file exists: {os.path.exists(cache)}")
    check(launches == {"symmetric_gaussian": 1, "centered_rank": 0}, f"[autotune] launches {launches}")
    print(
        f"[autotune] {len(outcome.results)} widths tuned, each trial finite; winner width {winner.config['refill_width']}"
        f" ({'meets' if floor_met else 'below'} the {AUTOTUNE_FLOOR} occupancy floor: cache"
        f" {'written' if outcome.cache_written else 'left unwritten'}); launches {launches}"
    )
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", world_size=1, rank=0, timeout=datetime.timedelta(seconds=MULTIGPU_TIMEOUT))
        try:
            if not outcome.cache_written:
                cache = _readback_cache(device, harness, winner, cache.replace(".json", "_readback.json"))
            _autotune_cache_checks(device, harness, cache)
            _ledger_report(device)
        finally:
            dist.destroy_process_group()


OPTIM_LR = 0.01  # Adam's step on the flagship's center
OPTIM_GENERATIONS = 2
OPTIM_CHECK_STEPS = 5  # seeded gradients each optimizer pair is held over
# TorchOptimizer against the port's own Adam and SGD, and the card against
# the CPU: float32 steps of ~1e-2 in which torch's optimizers round in
# another order (tests/test_torch_optimizers.py's tolerance)
OPTIM_TOL = dict(rtol=1e-5, atol=2e-6)


def _optimizer_checks(device, length):
    """``TorchOptimizer(Adam)`` against the port's ``Adam`` and
    ``TorchOptimizer(SGD, momentum=0.9)`` against its ``SGD(momentum=0.9)``
    on the card, each over the same seeded gradients, with the host syncs of
    every ``ascent`` counted; then the same two on the CPU against the
    card's steps. Returns the largest difference of each comparison and
    the syncs."""
    import torch

    from evotorch_tpu_torch.optimizers import SGD, Adam, TorchOptimizer

    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(length, generator=g) for _ in range(OPTIM_CHECK_STEPS)]
    pairs = {
        "adam": (
            lambda dev: TorchOptimizer(torch.optim.Adam, solution_length=length, device=dev, lr=OPTIM_LR),
            lambda dev: Adam(solution_length=length, device=dev, stepsize=OPTIM_LR),
        ),
        "sgd_momentum": (
            lambda dev: TorchOptimizer(torch.optim.SGD, solution_length=length, device=dev, lr=OPTIM_LR, momentum=0.9),
            lambda dev: SGD(solution_length=length, device=dev, stepsize=OPTIM_LR, momentum=0.9),
        ),
    }
    out = {}
    for name, (make_torch, make_own) in pairs.items():
        on_card, own, on_cpu = make_torch(device), make_own(device), make_torch("cpu")
        card_grads = [grad.to(device) for grad in grads]  # copied before the syncs are counted
        card_steps, syncs = [], 0
        for grad in card_grads:
            step, n = _count_syncs(lambda: on_card.ascent(grad))
            syncs += n
            card_steps.append(step)
        own_steps = [own.ascent(grad) for grad in card_grads]
        cpu_steps = [on_cpu.ascent(grad) for grad in grads]
        err_own = max(float((a - b).abs().max()) for a, b in zip(card_steps, own_steps))
        err_cpu = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_steps, cpu_steps))
        for a, b, what in [(x, y, "the port's own") for x, y in zip(card_steps, own_steps)] + [
            (x.cpu(), y, "the CPU's") for x, y in zip(card_steps, cpu_steps)
        ]:
            check(torch.allclose(a.cpu(), b.cpu(), **OPTIM_TOL), f"[optim] TorchOptimizer {name} differs from {what}")
        check(syncs == 0, f"[optim] TorchOptimizer {name}: {syncs} host syncs in {len(grads)} ascents")
        out[name] = {"err_own": err_own, "err_cpu": err_cpu, "syncs": syncs}
    return out


def optim_phase(device):
    """The flagship through the OO API with a ``torch.optim`` optimizer (see
    the module note)."""
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.optimizers import TorchOptimizer

    problem = VecNE("humanoid", OO_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="budget", seed=0)
    length = problem.solution_length
    check(length == 12_305, f"[optim] {length} parameters")
    optimizer = TorchOptimizer(torch.optim.Adam, solution_length=length, device=device, lr=OPTIM_LR)
    searcher = PGPE(
        problem,
        popsize=POPSIZE,
        center_learning_rate=OPTIM_LR,
        stdev_learning_rate=0.1,
        radius_init=0.27,
        optimizer=optimizer,
        ranking_method="centered",
    )
    check(searcher.optimizer is optimizer, "[optim] PGPE did not keep the TorchOptimizer")
    center_before = searcher.distribution.parameters["mu"].clone()
    StdOutLogger(searcher, interval=1)
    rows = _oo_run("[optim]", searcher, OPTIM_GENERATIONS)
    interactions = int(searcher.status["total_interaction_count"])
    check(interactions == OPTIM_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[optim] total_interaction_count {interactions}")
    evals = searcher.population.evals
    check(evals.shape[0] == POPSIZE and bool(torch.isfinite(evals).all()), "[optim] scores not finite")
    center = searcher.distribution.parameters["mu"]
    check(bool(torch.isfinite(center).all()) and not torch.equal(center, center_before), "[optim] the center did not move")
    moved = float((center - center_before).abs().max())
    print(
        f"[optim] VecNE + PGPE + TorchOptimizer(torch.optim.Adam, lr={OPTIM_LR}), popsize {POPSIZE}, L {length}, budget"
        f" {EPISODE_LENGTH} steps: mean_eval {', '.join('%.3f' % r['mean_eval'] for r in rows)}; {interactions:,} env"
        f" steps; center moved by up to {moved:.3e}"
    )
    for name, r in _optimizer_checks(device, length).items():
        print(
            f"[optim] TorchOptimizer {name} at {length}: {OPTIM_CHECK_STEPS} ascents on the card, largest difference"
            f" {r['err_own']:.3e} from the port's own, {r['err_cpu']:.3e} from the CPU (tolerance {OPTIM_TOL});"
            f" {r['syncs']} host syncs"
        )


SHARDED_GROUPS = 4  # the flagship population as 4 groups (tenants, islands) of 2,500
# (c) against the one-rank server: each tenant's mean and median score within
# 1% (``multigpu``'s rule, at a tenant's 2,500 rows; a lane in a block of 512
# refill lanes may round otherwise than in one of 1,024, and the chaotic
# closed loop then parts it from its one-rank trajectory)
SHARDED_GROUPS_STATS_TOL = 0.01
SHARDED_SERVE_TENANTS = 2  # of SERVE_ROWS rows each, in a slab of 5,000


def _flagship_groups(device):
    """Each flagship solution's group: 4 contiguous groups of 2,500."""
    import torch

    return torch.arange(POPSIZE, device=device) // (POPSIZE // SHARDED_GROUPS)


def _grouped_generation(device, mesh):
    """One flagship ``budget`` generation with per-group telemetry from a
    fresh state and seed 0, sharded over ``mesh`` (None: unsharded), its
    kernel launches counted."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.parallel import make_generation_step

    env, policy, state, stats = flagship(device)
    groups = _flagship_groups(device)
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=POPSIZE), tell=pgpe_tell, popsize=POPSIZE, mesh=mesh,
        device=device, num_episodes=1, episode_length=EPISODE_LENGTH, eval_mode="budget", groups=groups,
        num_groups=SHARDED_GROUPS,
    )  # fmt: skip
    generator = torch.Generator(device=device).manual_seed(0)
    before = _launches()
    state, scores, stats, steps, wire = generation(state, generator, stats)
    return dict(
        scores=scores, wire=wire, center=state.optimizer_state.center, steps=int(steps), launches=_launches(before),
        groups=groups,
    )  # fmt: skip


def _health_bits(scores, groups):
    """The health block ``compute_health_block`` gives on these scores and
    ids, as the wire carries it (bit-cast to int32)."""
    import torch

    from evotorch_tpu_torch.observability.devicemetrics import compute_health_block

    return compute_health_block(scores, groups, SHARDED_GROUPS).contiguous().view(torch.int32)


def _serve_two_tenants(device, mesh):
    """(c): an ``EvalServer`` over ``mesh`` (None: one rank) with 2 flagship
    tenants of ``SERVE_ROWS`` rows in a slab of 5,000 (``episodes_refill``
    at the default width for 5,000 items, 200-step episodes): one ``serve``
    leg, its dispatches and launches; each tenant's scores and wire on the
    host."""
    import torch.distributed as dist

    from evotorch_tpu_torch.serving import EvalServer

    env, policy, _, _ = flagship(device)
    server = EvalServer(
        env, policy, slab_size=SHARDED_SERVE_TENANTS * SERVE_ROWS, max_tenants=SHARDED_SERVE_TENANTS,
        episode_length=EPISODE_LENGTH, mesh=mesh, device=device,
    )  # fmt: skip
    tenants = [server.admit(f"t{k}") for k in range(SHARDED_SERVE_TENANTS)]
    inputs = [_serve_tenant_inputs(device, policy.parameter_count, k) for k in range(SHARDED_SERVE_TENANTS)]
    before = _launches()
    if mesh is not None:
        dist.barrier()  # graftlint: allow(process-group): the world is phase 14's two ranks
    results, dispatches = _serve_leg(server, tenants, inputs)
    return dict(
        scores=[r.scores.cpu() for r in results], wires=[r.telemetry for r in results], dispatches=dispatches,
        width=server.refill_width, key=server.program.key, launches=_launches(before),
    )  # fmt: skip


def _two_rank_groups(device):
    """Phase 24's (b) and (c) on one of ``multigpu``'s two spawned ranks (its
    process group formed): one grouped flagship ``budget`` generation over
    both ranks, with this rank's health block recomputed on its gathered
    scores and ids; then the 2-tenant ``EvalServer(mesh=default_mesh())``."""
    import torch

    from evotorch_tpu_torch.parallel import default_mesh

    b = _grouped_generation(device, default_mesh())
    b["health_equal"] = bool(torch.equal(b["wire"][:, 15:], _health_bits(b["scores"], b["groups"])))
    b = {k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in b.items()}
    return {"b": b, "c": _serve_two_tenants(device, default_mesh())}


def _check_grouped_wire(tag, wire, total_steps):
    """Every group's env steps and capacity 2,500 x 200 = 500,000 exactly."""
    from evotorch_tpu_torch.observability import GroupTelemetry

    decoded = GroupTelemetry.from_array(wire)
    check(tuple(wire.shape) == (SHARDED_GROUPS, 20), f"{tag}: wire {tuple(wire.shape)}")
    per = POPSIZE // SHARDED_GROUPS * EPISODE_LENGTH
    for g in range(SHARDED_GROUPS):
        row = decoded.group(g)
        check(row.env_steps == per and row.capacity == per, f"{tag}: group {g} env steps {row.env_steps}, capacity {row.capacity}")
    check(decoded.total().env_steps == total_steps, f"{tag}: env steps {decoded.total().env_steps} against {total_steps}")
    return decoded


def sharded_groups_phase(device, spawned):
    """Phase 24 (see the module note): (a) here over one NCCL rank, the
    grouped flagship generation sharded against unsharded, bit for bit;
    (b) and (c) from ``multigpu``'s two-rank spawn (``spawned``: each rank's
    saved results), checked here, (c) against the one-rank server run
    here."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from evotorch_tpu_torch.observability import GroupTelemetry
    from evotorch_tpu_torch.parallel import default_mesh, init_distributed

    # (a) one NCCL rank, set up as multigpu's (a) is
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", world_size=1, rank=0, timeout=datetime.timedelta(seconds=MULTIGPU_TIMEOUT))
        try:
            backend = "nccl" if device.type == "cuda" else "gloo"
            check(dist.get_backend() == backend, f"[sharded_groups] (a) backend {dist.get_backend()}")
            unsharded = _grouped_generation(device, None)
            sharded = _grouped_generation(device, default_mesh())
        finally:
            dist.destroy_process_group()
    for name, run in (("unsharded", unsharded), ("sharded", sharded)):
        tag = f"[sharded_groups] (a) {name}"
        check(run["launches"] == ONE_EACH, f"{tag}: launches {run['launches']}")
        check(bool(torch.isfinite(run["scores"]).all()), f"{tag}: scores not finite")
        _check_grouped_wire(tag, run["wire"], run["steps"])
        check(torch.equal(run["wire"][:, 15:], _health_bits(run["scores"], run["groups"])), f"{tag}: health block")
    check(torch.equal(sharded["scores"], unsharded["scores"]), "[sharded_groups] (a) scores differ from the unsharded grouped generation")
    check(torch.equal(sharded["wire"], unsharded["wire"]), "[sharded_groups] (a) the (4, 20) wire differs from the unsharded one")
    check(torch.equal(sharded["center"], unsharded["center"]), "[sharded_groups] (a) the centers differ")
    decoded = GroupTelemetry.from_array(sharded["wire"])
    print(
        f"[sharded_groups] (a) world size 1 over NCCL, the flagship budget generation with {SHARDED_GROUPS} groups of"
        f" {POPSIZE // SHARDED_GROUPS:,}: sharded equal to unsharded bit for bit (scores, center and the (4, 20) wire);"
        f" per-group env steps {[decoded.group(g).env_steps for g in range(SHARDED_GROUPS)]}, episodes"
        f" {[decoded.group(g).episodes for g in range(SHARDED_GROUPS)]}; launches {sharded['launches']} each"
    )
    del unsharded

    # (b) the grouped generation over the two spawned ranks
    for r, got in enumerate(spawned):
        b, tag = got["b"], f"[sharded_groups] (b) rank {r}"
        check(b["launches"] == ONE_EACH, f"{tag}: launches {b['launches']}")
        decoded = _check_grouped_wire(tag, b["wire"], b["steps"])
        ungrouped_scores, ungrouped_wire = got["ungrouped"]
        total = GroupTelemetry.from_array(ungrouped_wire).total()
        check(decoded.total().episodes == total.episodes, f"{tag}: episodes {decoded.total().episodes} against {total.episodes}")
        check(torch.equal(b["scores"], ungrouped_scores), f"{tag}: scores differ from the ungrouped generation's")
        check(b["health_equal"], f"{tag}: the health block differs from compute_health_block of the gathered scores and ids")
        check(torch.equal(b["wire"], spawned[0]["b"]["wire"]) and torch.equal(b["scores"], spawned[0]["b"]["scores"]), f"{tag}: ranks differ")
    b0 = spawned[0]["b"]
    print(
        f"[sharded_groups] (b) two ranks sharing one card over gloo, the grouped flagship budget generation: each"
        f" group's env steps and capacity {POPSIZE // SHARDED_GROUPS * EPISODE_LENGTH:,}, episodes per group"
        f" {[GroupTelemetry.from_array(b0['wire']).group(g).episodes for g in range(SHARDED_GROUPS)]} summing to the"
        f" ungrouped generation's, scores equal to it bit for bit, each rank's health block that of the gathered"
        f" scores and ids bit for bit; launches {b0['launches']} on each rank"
    )

    # (c) the two-rank server against the one-rank server, run here
    alone = _serve_two_tenants(device, None)
    c0 = spawned[0]["c"]
    gaps = []
    for r, got in enumerate(spawned):
        c, tag = got["c"], f"[sharded_groups] (c) rank {r}"
        check(c["dispatches"] == 1 and c["launches"] == {"symmetric_gaussian": 0, "centered_rank": 0}, f"{tag}: {c['dispatches']} dispatches, launches {c['launches']}")
        check(c["key"][5] == "pop2" and alone["key"][5] == "none", f"{tag}: program keys {c['key']} and {alone['key']}")
        for k in range(SHARDED_SERVE_TENANTS):
            a, b = c["scores"][k], alone["scores"][k]
            check(a.shape == (SERVE_ROWS,) and bool(torch.isfinite(a).all()), f"{tag} tenant {k}: scores")
            check(torch.equal(a, c0["scores"][k]) and torch.equal(c["wires"][k], c0["wires"][k]), f"{tag} tenant {k}: the ranks differ")
            ours, theirs = GroupTelemetry.from_array(c["wires"][k]).total(), GroupTelemetry.from_array(alone["wires"][k]).total()
            check(ours.episodes == theirs.episodes == SERVE_ROWS, f"{tag} tenant {k}: episodes {ours.episodes}, {theirs.episodes}")
            check((ours.lane_width, ours.refill_events, ours.nonfinite) == (theirs.lane_width, theirs.refill_events, theirs.nonfinite), f"{tag} tenant {k}: lane width, refill events or quarantine counts differ: {ours} against {theirs}")
            tenant_gaps = [abs(float(f(a)) - float(f(b))) / abs(float(f(b))) for f in (torch.mean, torch.median)]
            check(max(tenant_gaps) <= SHARDED_GROUPS_STATS_TOL, f"{tag} tenant {k}: mean and median score {tenant_gaps} from the one-rank server's")
            gaps.append(max(tenant_gaps))
    bitwise = all(torch.equal(a, b) for a, b in zip(c0["scores"], alone["scores"]))
    print(
        f"[sharded_groups] (c) EvalServer(mesh=default_mesh()) on the two ranks, {SHARDED_SERVE_TENANTS} tenants x"
        f" {SERVE_ROWS:,} rows in a slab of {SHARDED_SERVE_TENANTS * SERVE_ROWS:,} (refill width {c0['width']}, split"
        f" {c0['width'] // 2} + {c0['width'] // 2}): both ranks hold the same scores and wires; against the one-rank"
        f" server {'bit for bit' if bitwise else f'mean and median within {max(gaps):.4f} relative'}, episodes, lane"
        f" width, refill events and quarantine counts exact"
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import evotorch_tpu_torch

    device = evotorch_tpu_torch.resolve_device()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__} (CUDA {torch.version.cuda}); {name}")
    started = time.perf_counter()

    def run(tag, phase, *args, **kwargs):
        gc.collect()  # what the last phase left to the collector (a searcher and its logger hold each other)
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        print(f"[{tag}] phase in {time.perf_counter() - t0:.1f} s")
        return out

    run("build", build_phase)
    run("kernels", sampling_phase, device)
    run("kernels", ranking_phase, device)
    run("reference", reference_phase, device)
    run("contracts", contracts_phase, device)
    unsharded_budget = run("main", main_path_phase, device)
    unsharded_episodes = []
    run(
        "flagship", flagship_contracts_phase, device,
        episodes_labels=tuple(f"generation {i}" for i in range(MULTIGPU_GENERATIONS)), episodes_out=unsharded_episodes,
    )  # fmt: skip
    run("oo", oo_phase, device)
    run("ant", ant_phase, device)
    run("locomotion", locomotion_phase, device)
    run("supervised", supervised_checkpoint_phase, device)
    run("recurrent", recurrent_phase, device)
    run("searchers", searchers_phase, device)
    run("factored", factored_phase, device)
    unsharded = {"budget": unsharded_budget, "episodes": tuple(unsharded_episodes)}
    # (a) holds its sharded generations to the first MULTIGPU_GENERATIONS of each
    unsharded = {k: tuple(x[:MULTIGPU_GENERATIONS] for x in v) for k, v in unsharded.items()}
    spawned_groups = run("multigpu", multigpu_phase, device, unsharded)
    run("span", span_phase, device)
    run("object_ga", object_ga_phase, device)
    run("gymne", gymne_phase, device)
    run("structures", structures_phase, device)
    run("faults", faults_phase, device)
    run("serving", serving_phase, device)
    run("serving_vecne", serving_vecne_phase, device)
    run("autotune", autotune_phase, device)
    run("optim", optim_phase, device)
    run("sharded_groups", sharded_groups_phase, device, spawned_groups)
    print(f"[done] all phases in {time.perf_counter() - started:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
