#!/usr/bin/env python3
"""Where the time of the port's flagship rollout goes, on one CUDA card.

    python3 scripts/profile_torch_eval.py [--popsize 10000] [--steps 10]
        [--contract budget|episodes|episodes_refill] [--env humanoid]
        [--network "LSTM(obs_length, 64) >> Linear(64, act_length)"]
        [--action-noise-stdev 0.05] [--policy-form dense|lowrank|trunk_delta]
        [--rank 32] [--compute-dtype bfloat16]

Builds the flagship (Humanoid, 64-64 tanh MLP, a population drawn around a
zero center with stdev 0.1), or the same policy and population on another
env of the registry (``--env ant``, ...), or another network string of the
``str_to_net`` language (``--network``, e.g. the recurrent flagship's
LSTM), optionally with action noise, and reports, for one control step of the
rollout under ``--contract`` (``budget`` by default; ``episodes_refill``
at its default width, an eighth of the popsize rounded up to a power of
two). ``--policy-form lowrank`` or ``trunk_delta`` draws the population in
that factored form at ``--rank`` (``pgpe_ask_lowrank`` /
``pgpe_ask_trunk_delta`` around the same center and stdev) and runs the
rollout's factored forward; ``--compute-dtype bfloat16`` casts the
population and the policy input as the rollout does. It reports:

- the ops it dispatches (``TorchDispatchMode``), split into kernels and
  views (a view launches nothing);
- the host time of each part (policy forward, ``batch_step``,
  ``batch_reset`` of the step's width, the whole step), each timed alone
  over ``--steps`` calls ending in ``torch.cuda.synchronize()``;
- a ``torch.profiler`` trace of ``--steps`` whole steps: device busy time
  (the sum of kernel times) over wall time, kernel launches per step, and
  the kernels that take the most device time; and one of ``--steps``
  policy forwards alone: their device time and launches per forward.

The last line is one JSON object with these numbers and the card's name and
power limit. ``--device cpu`` runs the same accounting on the CPU (then no
device time is reported).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import functools  # noqa: E402

from evotorch_tpu_torch import resolve_device  # noqa: E402
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask_lowrank, pgpe_ask_trunk_delta  # noqa: E402
from evotorch_tpu_torch.envs import make_env  # noqa: E402
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, str_to_net  # noqa: E402
from evotorch_tpu_torch.neuroevolution.net import vecrl  # noqa: E402
from evotorch_tpu_torch.ops import sample_symmetric_gaussian  # noqa: E402
from evotorch_tpu_torch.tools.misc import to_torch_dtype  # noqa: E402

MLP = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
VIEW_OPS = (
    "select", "slice", "view", "unsqueeze", "expand", "transpose", "aten.t.", "unflatten", "squeeze", "alias",
    "as_strided", "permute", "unbind", "split",
)  # fmt: skip


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, device, iters):
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / iters


def profile_device(fn, iters):
    """``fn`` run ``iters`` times under ``torch.profiler``: (device ms, the
    kernels' events, launches) over the calls."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    return wall_ms, device_ms, kernels, launches


def population(args, policy, device, generator):
    """The population of ``--policy-form`` around a zero center, stdev 0.1."""
    L = policy.parameter_count
    if args.policy_form == "dense":
        return sample_symmetric_gaussian(
            torch.zeros(L, device=device), torch.full((L,), 0.1, device=device), args.popsize, generator=generator
        )
    state = pgpe(center_init=torch.zeros(L, device=device), center_learning_rate=0.1, stdev_learning_rate=0.1,
                 objective_sense="max", stdev_init=0.1)  # fmt: skip
    if args.policy_form == "lowrank":
        return pgpe_ask_lowrank(generator, state, popsize=args.popsize, rank=args.rank)
    return pgpe_ask_trunk_delta(generator, state, popsize=args.popsize, rank=args.rank, policy=policy)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--popsize", type=int, default=10_000)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default=None)
    parser.add_argument("--contract", default="budget", choices=("budget", "episodes", "episodes_refill"))
    parser.add_argument("--env", default="humanoid", help="an env name of the registry (default: humanoid)")
    parser.add_argument("--network", default=MLP, help=f"a str_to_net string (default: {MLP})")
    parser.add_argument("--action-noise-stdev", type=float, default=None)
    parser.add_argument("--policy-form", default="dense", choices=("dense", "lowrank", "trunk_delta"))
    parser.add_argument("--rank", type=int, default=32, help="the factored forms' rank (default: 32)")
    parser.add_argument("--compute-dtype", default=None, help="the policy forward's dtype, e.g. bfloat16")
    args = parser.parse_args()
    device = resolve_device(args.device)

    env = make_env(args.env, device=device)
    policy = FlatParamsPolicy(str_to_net(args.network, obs_length=env.observation_size, act_length=env.action_size))
    generator = torch.Generator(device=device).manual_seed(0)
    compute_dtype = None if args.compute_dtype is None else to_torch_dtype(args.compute_dtype)
    options = vecrl._Options(action_noise_stdev=args.action_noise_stdev, compute_dtype=compute_dtype)
    # the rollout's set-up: the cast, then the factored context built once
    ctx, params = vecrl._forward_ctx(policy, vecrl._params_cast(population(args, policy, device, generator), options))
    forward = functools.partial(vecrl._batched_forward, policy, ctx)
    stats = stats_init(env.observation_size, device=device)
    if args.contract == "budget":
        width = args.popsize
        carry = vecrl._budget_init(env, policy, params, generator, stats, options)
        step = vecrl._make_budget_step(env, policy, params, generator, max_t=200, options=options, forward=forward)
    else:
        table = env.reset_noise(args.popsize, generator)
        noise = vecrl._noise_table(env, None, args.popsize, 200, generator, options)
        if args.contract == "episodes":
            width = args.popsize
            carry = vecrl._episodes_init(env, policy, params, table, stats, options)
            step = vecrl._make_episodes_step(
                env, policy, table, noise, popsize=args.popsize, num_episodes=1, max_t=200, options=options,
                forward=forward,
            )  # fmt: skip
        else:
            width = vecrl._default_refill_width(args.popsize)
            carry = vecrl._refill_init(env, policy, params, table, stats, options, width=width)
            step = vecrl._make_refill_step(
                env, policy, params, table, noise, num_episodes=1, period=1, max_t=200, options=options,
                forward=forward,
            )  # fmt: skip
    for _ in range(3):  # leave the reset state, warm up
        carry = step(carry)

    with OpCounter() as counter:
        step(carry)
    ops = sum(counter.counts.values())
    views = sum(n for name, n in counter.counts.items() if any(v in name for v in VIEW_OPS))

    lane_params = params[:width]
    policy_in = carry.obs if compute_dtype is None else carry.obs.to(compute_dtype)
    actions, _ = forward(lane_params, policy_in, carry.policy_states)
    actions = actions.float()

    def policy_forward():
        return forward(lane_params, policy_in, carry.policy_states)

    parts = {
        "policy_forward": policy_forward,
        "batch_step": lambda: env.batch_step(carry.env_states, actions),
        "batch_reset": lambda: env.batch_reset(width, generator),
        "whole_step": lambda: step(carry),
    }
    part_ms = {name: host_ms(fn, device, args.steps) for name, fn in parts.items()}

    summary = {
        "device": str(device),
        "env": args.env,
        "network": args.network,
        "action_noise_stdev": args.action_noise_stdev,
        "policy_form": args.policy_form,
        "rank": None if args.policy_form == "dense" else args.rank,
        "compute_dtype": args.compute_dtype,
        "parameters": policy.parameter_count,
        "contract": args.contract,
        "popsize": args.popsize,
        "width": width,
        "ops_per_step": ops,
        "kernel_ops_per_step": ops - views,
        "view_ops_per_step": views,
        "host_ms_per_call": part_ms,
    }
    if device.type == "cuda":
        holder = [carry]

        def one_step():
            holder[0] = step(holder[0])

        wall_ms, device_ms, kernels, launches = profile_device(one_step, args.steps)
        _, forward_ms, _, forward_launches = profile_device(policy_forward, args.steps)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        summary.update(
            {
                "profiled_steps": args.steps,
                "profiled_wall_ms": wall_ms,
                "device_busy_ms": device_ms,
                "device_busy_share": device_ms / wall_ms,
                "launches_per_step": launches / args.steps,
                "policy_forward_device_ms": forward_ms / args.steps,
                "policy_forward_launches": forward_launches / args.steps,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3 for e in top},
            }
        )
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        )
        summary["card"] = smi.stdout.strip()
    for key, value in summary.items():
        print(f"{key}: {value}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
