#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``evotorch_tpu_torch``) on one card.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit.
2. Build: compiles every kernel of ``evotorch_tpu_torch/csrc`` with ``nvcc``
   (one process per source, started together) and prints ``-Xptxas -v``.
3. Kernels: each kernel against its plain PyTorch version at the flagship
   shapes (ranking n = 10,000; sampling popsize 10,000 x L 12,305), timed
   with CUDA events around calls launched eagerly (``ms``, what the main
   path pays per call) and around replays of calls captured in a CUDA graph
   (``graph_ms``, the device time), beside its bound, its plain version, a
   PyTorch yardstick and the plain PyTorch route a user would compose; then
   a small generation on the card against the same generation on the CPU
   (plain versions), with observation normalization off and on, as a
   reference.
4. Contracts reference: CartPole (continuous actions, a ``Linear(4, 1)``
   policy, popsize 1,000, 200 steps, reset noise from one seeded table)
   under ``episodes``, ``episodes_refill`` (128 lanes and the default
   width) and ``episodes_compact`` (widths 64/128/256, chunks of 10), at
   one and two episodes per solution, on the card and on the CPU: the
   counters and the telemetry wire must hold exactly on each device, the
   contracts agree within each, and the card agrees with the CPU.
5. Main path: the flagship PGPE generation (Humanoid, popsize 10,000,
   64-64 tanh MLP, ``budget`` contract with 200 steps, the JAX benchmark's
   ``fresh_pgpe_state`` constants): one warm-up and three timed generations.
   Each must count 2,000,000 env steps, give finite scores, move the center
   and launch both kernels (launch counts are zeroed just before it).
6. The flagship under each episodes contract (200-step episodes, one each):
   ``episodes``, ``episodes_refill`` at its default width (2,048 lanes) and
   ``episodes_compact`` (ask, ``run_vectorized_rollout_compacting`` with
   chunks of 25 and the default width menu, tell); one warm-up and one
   timed generation each, with the telemetry's env-steps/s, occupancy,
   control steps, refill and compaction figures, launches and peak memory.
   Launch counts are zeroed before and read after each generation.

7. ``oo``: the repo's flagship example (``examples/humanoid_pgpe.py``) through
   the object API at full width: ``VecNE("humanoid", <the example's
   network string>, observation_normalization=True, episode_length=200,
   eval_mode="budget", compute_dtype=torch.bfloat16, seed=0)``, ``PGPE``
   at popsize 10,000 with ClipUp and centered ranking, ``StdOutLogger``,
   ``run(3)``: 6,000,000 interactions, the sampling kernel launched 3
   times and the ranking kernel 2 times (no tell in the first generation),
   every logged ``mean_eval`` finite, the observation count 3 x 10,000 x
   201, ``save_solution`` read back; generation times and peak memory.
   Then one more generation under ``eval_mode="episodes"`` in float32
   without normalization: its population, evaluated by ``VecNE.evaluate``
   and by the functional ``run_vectorized_rollout`` with one reset table,
   must score the same bit for bit.

It prints the kernel table as one JSON line, the card's name and power
limit on the line before the last, and ``{"ok": true, "device": ...}`` last.
Without a CUDA device it exits 1 and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

POPSIZE = 10_000
EPISODE_LENGTH = 200
HIDDEN = [64, 64]
TIMED_GENERATIONS = 3

# published H100 SXM peaks (NVIDIA data sheet): HBM rate and the float32
# rate outside the tensor cores, the only non-tensor peak the sheet gives
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per (i, j) pair that centered ranking needs: one compare and one
# add to the count. Mapped once per element (O(n) work) to an
# order-preserving integer key (NaN above +inf, -0 equal to +0), the (isnan,
# value) order is one integer compare, and the index tie-break is fixed by
# the side of i on which j lies (key_j <= key_i for j < i, key_j < key_i for
# j > i)
RANK_OPS_PER_PAIR = 2
# operations per (direction, group of 4 columns) in csrc/symmetric_gaussian.cu:
# Philox4x32-10 = 10 rounds x (2 mul-hi, 2 mul-lo, 4 xor) + 9 x 2 key adds
# = 98; each of the two Box-Muller pairs = 2 shifts, 2 ors, 2 subs, log, mul,
# sqrt, mul (the angle), sin, cos, 2 muls = 14; scale and +/- = 3 per column
SAMPLING_OPS_PER_GROUP = 98 + 2 * 14 + 4 * 3
# the kernels' first versions, as this script timed them at the same shapes
# (NVIDIA H100 80GB HBM3, 700 W, eager): printed beside this run's times for
# the reader, not measured in this run and not in the JSON line
FIRST_VERSION_MS = {"centered_rank": 0.2448, "symmetric_gaussian": 0.3504}


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

    t0 = time.perf_counter()
    reports = _build.build(verbose=True)
    print(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.2f} s with {' '.join(_build.NVCC_FLAGS)}")
    for name, report in reports.items():
        print(f"[build] {name}.cu -Xptxas -v:\n{report.strip()}")


def ranking_phase(device):
    """Centered-rank kernel against its plain version at n = 10,000."""
    import torch

    from evotorch_tpu_torch.ops import ranking
    from evotorch_tpu_torch.ops.kernel_times import graph_ms, time_ms

    g = torch.Generator(device=device).manual_seed(1)
    n = POPSIZE
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
    cases = {
        "random": torch.randn(n, generator=g, device=device),
        "ties": torch.randint(0, 50, (n,), generator=g, device=device).float(),
        "signed_zero_ties": signed_zero,
        "batch": torch.randn((4, n), generator=g, device=device),
        "nan_inf": special,
        "float64": torch.randn(n, generator=g, device=device, dtype=torch.float64),
        "float64_nan_inf_zero": special64,
    }
    max_err = 0.0
    for name, x in cases.items():
        for higher_is_better in (True, False):
            got = ranking.centered_rank(x, higher_is_better=higher_is_better)
            ref = ranking.centered_rank_plain(x, higher_is_better=higher_is_better)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"centered_rank differs from its plain version on {name} ({higher_is_better=})")
            max_err = max(max_err, float((got - ref).abs().nan_to_num().max()))
    x = cases["random"]

    def composed():
        order = torch.argsort(x, stable=True)
        return torch.argsort(order, stable=True).float() / (n - 1) - 0.5

    # the same ranks; the values within one float32 ulp of 0.5, since
    # division by a Python number multiplies by its reciprocal on the card
    composed_err = float((composed() - ranking.centered_rank(x)).abs().max())
    check(composed_err <= 2.0**-24, f"centered_rank differs from the double argsort by {composed_err}")
    # eagerly, the few-microsecond kernels time the host's issue rate; in a
    # CUDA graph, the card's time
    ms = time_ms(lambda: ranking.centered_rank(x), warmup=5, iters=50)
    kernel_graph_ms = graph_ms(lambda: ranking.centered_rank(x), calls=20, replays=10)
    plain_ms = time_ms(lambda: ranking.centered_rank_plain(x), warmup=2, iters=10)
    library_ms = time_ms(lambda: torch.argsort(x, stable=True), warmup=5, iters=50)
    library_graph_ms = graph_ms(lambda: torch.argsort(x, stable=True), calls=20, replays=10)
    composed_ms = time_ms(composed, warmup=5, iters=50)
    composed_graph_ms = graph_ms(composed, calls=20, replays=10)
    ops = RANK_OPS_PER_PAIR * n * n
    bytes_moved = 2 * 4 * n
    bound_ms = 1e3 * max(ops / FP32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S)
    print(
        f"[kernel] centered_rank n={n}: equal to plain on {len(cases)} inputs x 2 senses;"
        f" {ms:.4f} ms launched eagerly, {kernel_graph_ms:.4f} ms in a CUDA graph"
        f" (bound {bound_ms:.4f} ms by operations: {ops:.3g} ops at 67 TFLOP/s;"
        f" {100 * bound_ms / ms:.1f}% of it eagerly, {100 * bound_ms / kernel_graph_ms:.1f}% in a graph),"
        f" plain {plain_ms:.4f} ms, torch.argsort(stable=True) {library_ms:.4f} ms eagerly and"
        f" {library_graph_ms:.4f} ms in a graph (a partial yardstick: it sorts, it does not rank or center),"
        f" double argsort and division {composed_ms:.4f} ms eagerly and {composed_graph_ms:.4f} ms in a graph;"
        f" the first version took {FIRST_VERSION_MS['centered_rank']:.4f} ms eagerly (its own run, not this one)"
    )
    return {
        "name": "centered_rank",
        "route": "cuda",
        "source": "evotorch_tpu_torch/csrc/centered_rank.cu",
        "replaces": "evotorch_tpu/ops/ranking.py:23",
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": kernel_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "library_ms": library_ms,
        "composed_ms": composed_ms,
    }


def sampling_phase(device):
    """Sampling kernel against its plain Philox version at 10,000 x 12,305."""
    import torch

    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
    from evotorch_tpu_torch.ops import sampling
    from evotorch_tpu_torch.ops.kernel_times import graph_ms, time_ms

    L = FlatParamsPolicy(tanh_mlp(109, 17, HIDDEN)).parameter_count
    half = POPSIZE // 2
    g = torch.Generator(device=device).manual_seed(2)
    mu = torch.randn(L, generator=g, device=device)
    sigma = torch.full((L,), 0.1, device=device)
    seed = sampling.draw_seed(g, device)
    got = sampling.sample_symmetric_gaussian(mu, sigma, POPSIZE, seed=seed)
    ref = sampling.sample_symmetric_gaussian_plain(mu, sigma, POPSIZE, seed=seed)
    torch.cuda.synchronize()
    check(got.shape == (POPSIZE, L), f"sampling shape {tuple(got.shape)}")
    max_err = float((got - ref).abs().max())
    # tolerance: bit-equal. The kernel and the plain version evaluate the same
    # float32 functions without fast math (logf, sqrtf, and sincosf, which
    # gives the values of sinf and cosf that torch.sin and torch.cos call), and
    # the scale and +/- cannot be contracted into an FMA
    check(torch.equal(got, ref), f"sampling kernel differs from its plain version by {max_err}")
    del ref
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
    eps = ((got[0::2] - mu) / sigma).double()
    count = eps.numel()
    mean, std = float(eps.mean()), float(eps.std())
    check(abs(mean) < 5 / math.sqrt(count), f"sample mean {mean}")
    check(abs(std - 1) < 5 / math.sqrt(2 * count), f"sample std {std}")
    # the cosine and sine normals of one Box-Muller pair (columns 4q, 4q+1)
    width = 4 * (L // 4)
    corr = float(torch.corrcoef(torch.stack([eps[:, 0:width:4].reshape(-1), eps[:, 1:width:4].reshape(-1)]))[0, 1])
    check(abs(corr) < 5 / math.sqrt(half * (L // 4)), f"cosine and sine normals correlate: {corr}")
    del eps, at_zero, got

    def composed():
        scaled = torch.randn((half, L), generator=g, device=device) * sigma
        return torch.stack((mu + scaled, mu - scaled), dim=1).reshape(POPSIZE, L)

    ms = time_ms(lambda: sampling.sample_symmetric_gaussian(mu, sigma, POPSIZE, seed=seed), warmup=3, iters=20)
    kernel_graph_ms = graph_ms(lambda: sampling.sample_symmetric_gaussian(mu, sigma, POPSIZE, seed=seed), calls=5, replays=4)
    plain_ms = time_ms(lambda: sampling.sample_symmetric_gaussian_plain(mu, sigma, POPSIZE, seed=seed), warmup=1, iters=3)
    library_ms = time_ms(lambda: torch.randn((half, L), generator=g, device=device), warmup=3, iters=20)
    composed_ms = time_ms(composed, warmup=2, iters=10)
    bytes_moved = 4 * (POPSIZE * L + 2 * L) + 16
    ops = SAMPLING_OPS_PER_GROUP * half * ((L + 3) // 4)
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    print(
        f"[kernel] symmetric_gaussian {POPSIZE}x{L}: equal to plain (max abs err {max_err:.3g}), injected noise equal,"
        f" pairs exact at mu=0, noise mean {mean:.3g} std {std:.6f}, cos/sin corr {corr:.3g};"
        f" {ms:.4f} ms launched eagerly, {kernel_graph_ms:.4f} ms in a CUDA graph"
        f" (bound {bound_ms:.4f} ms by bytes: {bytes_moved / 1e6:.1f} MB at 3.35 TB/s;"
        f" {100 * bound_ms / ms:.1f}% of it eagerly, {100 * bound_ms / kernel_graph_ms:.1f}% in a graph;"
        f" {ops:.3g} ops), plain {plain_ms:.3f} ms,"
        f" torch.randn(({half}, {L})) {library_ms:.4f} ms (a partial yardstick: the noise alone, half the bytes),"
        f" randn then mu +/- sigma*e interleaved {composed_ms:.4f} ms (both launched eagerly);"
        f" the first version took {FIRST_VERSION_MS['symmetric_gaussian']:.4f} ms eagerly (its own run, not this one)"
    )
    return {
        "name": "symmetric_gaussian",
        "route": "cuda",
        "source": "evotorch_tpu_torch/csrc/symmetric_gaussian.cu",
        "replaces": "evotorch_tpu/ops/sampling.py:57",
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": kernel_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "composed_ms": composed_ms,
    }


def flagship(device, *, center=None, stdev_init=0.1, reset_noise_scale=0.01):
    """The flagship env and policy, a fresh PGPE state (the JAX benchmark's
    ``fresh_pgpe_state`` constants, center zero unless given) and empty
    observation statistics."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, tanh_mlp

    env = Humanoid(device=device, reset_noise_scale=reset_noise_scale)
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, HIDDEN))
    state = pgpe(
        center_init=torch.zeros(policy.parameter_count, device=device) if center is None else center.to(device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=stdev_init,
    )
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


def main_path_phase(device, episode_length):
    """The flagship generation: one warm-up, then TIMED_GENERATIONS timed."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.observability import GroupTelemetry
    from evotorch_tpu_torch.ops import centered_rank, sample_symmetric_gaussian
    from evotorch_tpu_torch.parallel import make_generation_step

    env, policy, state, stats = flagship(device)
    events = {}

    def ask(generator, s):
        events["ask0"].record()
        values = pgpe_ask(generator, s, popsize=POPSIZE)
        events["ask1"].record()
        return values

    def tell(s, values, scores):
        events["tell0"].record()
        out = pgpe_tell(s, values, scores)
        events["tell1"].record()
        return out

    generation = make_generation_step(
        env,
        policy,
        ask=ask,
        tell=tell,
        popsize=POPSIZE,
        device=device,
        num_episodes=1,
        episode_length=episode_length,
        eval_mode="budget",
    )
    generator = torch.Generator(device=device).manual_seed(0)
    launches = {}
    timings = []
    torch.cuda.reset_peak_memory_stats()
    for index in range(1 + TIMED_GENERATIONS):
        events = {k: torch.cuda.Event(enable_timing=True) for k in ("ask0", "ask1", "tell0", "tell1")}
        center_before = state.optimizer_state.center.clone()
        sample_symmetric_gaussian.launches = 0
        centered_rank.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scores, stats, total_steps, telemetry = generation(state, generator, stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"symmetric_gaussian": sample_symmetric_gaussian.launches, "centered_rank": centered_rank.launches}
        label = "warm-up" if index == 0 else f"timed {index}"
        check(total_steps == POPSIZE * episode_length, f"{label}: total_steps {total_steps}")
        decoded = GroupTelemetry.from_array(telemetry)
        check(decoded.total().env_steps == total_steps and decoded.total().capacity == total_steps, f"{label}: telemetry {decoded.summary()}")
        check(scores.shape == (POPSIZE,) and bool(torch.isfinite(scores).all()), f"{label}: scores not finite")
        check(not torch.equal(center_before, state.optimizer_state.center), f"{label}: the center did not move")
        check(all(v >= 1 for v in launches.values()), f"{label}: a kernel was not launched: {launches}")
        ask_ms = events["ask0"].elapsed_time(events["ask1"])
        eval_ms = events["ask1"].elapsed_time(events["tell0"])
        tell_ms = events["tell0"].elapsed_time(events["tell1"])
        print(
            f"[main] generation {label}: {seconds:.3f} s, {total_steps / seconds:,.0f} env-steps/s;"
            f" ask {ask_ms:.3f} ms, eval {eval_ms:.1f} ms, tell {tell_ms:.3f} ms (CUDA events);"
            f" launches {launches}; mean score {float(scores.mean()):.3f}, best {float(scores.max()):.3f}"
        )
        if index > 0:
            timings.append(seconds)
    peak = torch.cuda.max_memory_allocated()
    print(
        f"[main] Humanoid popsize {POPSIZE}, L {policy.parameter_count}, budget {episode_length} steps:"
        f" median timed generation {sorted(timings)[len(timings) // 2]:.3f} s,"
        f" max_memory_allocated {peak / 1e9:.3f} GB"
    )
    return launches


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
            t0 = time.perf_counter()
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
            print(f"[contracts] {dev.type} E={num_episodes}: 4 runs in {time.perf_counter() - t0:.2f} s")
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


def flagship_contracts_phase(device):
    """The flagship generation under each episodes contract: one warm-up and
    one timed generation each, the launch counts zeroed before and read
    after each generation; returns the timed generations' counts."""
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout_compacting
    from evotorch_tpu_torch.observability import GroupTelemetry
    from evotorch_tpu_torch.ops import centered_rank, sample_symmetric_gaussian
    from evotorch_tpu_torch.parallel import make_generation_step

    launches_by_contract = {}
    for contract in ("episodes", "episodes_refill", "episodes_compact"):
        env, policy, state, stats = flagship(device)
        loop_stats = {}
        kw = dict(num_episodes=1, episode_length=EPISODE_LENGTH, loop_stats=loop_stats)
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
        generator = torch.Generator(device=device).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        for label in ("warm-up", "timed"):
            center_before = state.optimizer_state.center.clone()
            sample_symmetric_gaussian.launches = 0
            centered_rank.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, scores, stats, total_steps, telemetry = generation(state, generator, stats)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {"symmetric_gaussian": sample_symmetric_gaussian.launches, "centered_rank": centered_rank.launches}
            decoded = GroupTelemetry.from_array(telemetry)
            tot = decoded.total()
            where = f"[flagship] {contract} {label}"
            check(scores.shape == (POPSIZE,) and bool(torch.isfinite(scores).all()), f"{where}: scores not finite")
            check(not torch.equal(center_before, state.optimizer_state.center), f"{where}: the center did not move")
            check(tot.episodes == POPSIZE, f"{where}: episodes {tot.episodes}")
            check(tot.env_steps == total_steps, f"{where}: env_steps {tot.env_steps} vs total_steps {total_steps}")
            check(decoded.score_stats()["count"] == POPSIZE, f"{where}: health count {decoded.score_stats()['count']}")
            check(all(v >= 1 for v in launches.values()), f"{where}: a kernel was not launched: {launches}")
            extra = ""
            if contract == "episodes_refill":
                extra = (
                    f"; lanes {tot.lane_width}, refill events {tot.refill_events},"
                    f" queue wait p50 {decoded.queue_wait_quantile(0.5):g} p99 {decoded.queue_wait_quantile(0.99):g} steps"
                )
            elif contract == "episodes_compact":
                widths = loop_stats["widths"]
                visited = [w for i, w in enumerate(widths) if i == 0 or widths[i - 1] != w]
                extra = f"; widths visited {visited} over {len(widths)} chunks"
            print(
                f"[flagship] {contract} {label}: {seconds:.3f} s, {tot.env_steps / seconds:,.0f} env-steps/s"
                f" ({tot.env_steps} env steps), occupancy {tot.occupancy:.4f} ({tot.env_steps}/{tot.capacity}),"
                f" {loop_stats['steps']} control steps ({loop_stats['steps_issued']} launched){extra};"
                f" launches {launches}; mean score {float(scores.mean()):.3f}, best {float(scores.max()):.3f}"
            )
        launches_by_contract[contract] = launches
        print(f"[flagship] {contract}: max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del env, policy, state, stats, generation
    return launches_by_contract


OO_NETWORK = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
OO_GENERATIONS = 3


def oo_phase(device):
    """The flagship example through the object API (see the module note);
    returns the kernels' launch counts over its ``run``."""
    import pickle
    import tempfile

    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.logging import StdOutLogger
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout
    from evotorch_tpu_torch.ops import centered_rank, sample_symmetric_gaussian

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
    rows = []
    searcher.log_hook.append(rows.append)
    # generation boundaries: the card is drained at each one, so a
    # generation's time is its ask, eval, tell and logging, all finished
    marks = []

    def mark(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    searcher.before_step_hook.append(mark)
    searcher.end_of_run_hook.append(mark)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sample_symmetric_gaussian.launches = 0
    centered_rank.launches = 0
    searcher.run(OO_GENERATIONS)
    launches = {"symmetric_gaussian": sample_symmetric_gaussian.launches, "centered_rank": centered_rank.launches}
    peak = torch.cuda.max_memory_allocated()
    times = [b - a for a, b in zip(marks, marks[1:])]

    interactions = int(searcher.status["total_interaction_count"])
    check(interactions == OO_GENERATIONS * POPSIZE * EPISODE_LENGTH, f"[oo] total_interaction_count {interactions}")
    check(launches == {"symmetric_gaussian": OO_GENERATIONS, "centered_rank": OO_GENERATIONS - 1}, f"[oo] launches {launches}")
    check(len(rows) == OO_GENERATIONS and all(math.isfinite(r["mean_eval"]) for r in rows), "[oo] a logged mean_eval is not finite")
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
    generation_s = ", ".join("%.3f" % t for t in times)
    step_s = ", ".join("%.3f" % r["step_seconds"] for r in rows)
    mean_evals = ", ".join("%.3f" % r["mean_eval"] for r in rows)
    print(
        f"[oo] flagship example, popsize {POPSIZE}, L {problem.solution_length}, budget {EPISODE_LENGTH} steps, bf16,"
        f" observation normalization: generations {generation_s} s (host step_seconds {step_s}); mean_eval"
        f" {mean_evals}; {interactions:,} interactions; launches {launches}; observation count {obs_count:,.0f};"
        f" max_memory_allocated {peak / 1e9:.3f} GB"
    )

    # one more generation: episodes, float32, no normalization; VecNE and
    # the functional engine on one population and one reset table
    plain = VecNE("humanoid", OO_NETWORK, episode_length=EPISODE_LENGTH, eval_mode="episodes", seed=1)
    generator = torch.Generator(device=device).manual_seed(3)
    values = searcher.distribution.sample(POPSIZE, generator=generator)
    table = plain.env.reset_noise(POPSIZE, generator)
    batch = SolutionBatch(plain, POPSIZE, values=values)
    t0 = time.perf_counter()
    plain.evaluate(batch, reset_noise=table)
    oo_scores = batch.evals[:, 0].clone()
    torch.cuda.synchronize()
    oo_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    functional_seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(oo_scores).all()), "[oo] episodes scores not finite")
    check(torch.equal(oo_scores, result.scores), f"[oo] VecNE and the functional engine differ by {float((oo_scores - result.scores).abs().max())}")
    check(int(plain.status["total_interaction_count"]) == result.total_steps, "[oo] episodes interaction counts differ")
    print(
        f"[oo] episodes, float32, no normalization: VecNE.evaluate and run_vectorized_rollout on one population and"
        f" one reset table score the same bit for bit ({result.total_steps:,} env steps;"
        f" {oo_seconds:.3f} s and {functional_seconds:.3f} s)"
    )
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import evotorch_tpu_torch

    device = evotorch_tpu_torch.resolve_device()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); {name}")

    started = time.perf_counter()
    build_phase()
    kernels = [sampling_phase(device), ranking_phase(device)]
    reference_phase(device)
    t0 = time.perf_counter()
    contracts_phase(device)
    print(f"[contracts] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = main_path_phase(device, EPISODE_LENGTH)
    print(f"[main] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_contract = flagship_contracts_phase(device)
    print(f"[flagship] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oo_launches = oo_phase(device)
    print(f"[oo] phase in {time.perf_counter() - t0:.1f} s")
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = (
            {"budget": launches[row["name"]]}
            | {k: v[row["name"]] for k, v in by_contract.items()}
            | {"oo": oo_launches[row["name"]]}
        )
    print(f"[done] all phases in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
