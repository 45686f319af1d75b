"""Times of the port's kernels alone, at the flagship shapes: the port's one
timer of a kernel outside a rollout (a kernel's time inside a benchmark cell
is the benchmark's trace metrics, ``perfbench/``).

Run on a machine with a CUDA device, from the root of a checkout:

    python3 -m evotorch_tpu_torch.ops.kernel_times

or, to time another checkout's kernels with this same code, from the root of
that checkout:

    python3 /path/to/evotorch_tpu_torch/ops/kernel_times.py

It times the wrappers of the package in the current directory (centered
ranks of 10,000 float32 fitnesses; an antithetic population of 10,000 x
12,305; one Humanoid control step of the rigid-body kernel at 10,000 and
2,048 lanes, beside the plain loop of substeps it replaced, and the whole
env step, observation, reward and done included, in one launch of the
same kernel), so that two commits can be compared in one call, in turns. Prints one JSON line: the
card and, per kernel, the mean time of one call launched eagerly (CUDA
events around back-to-back calls; where the wrapper's host work outlasts
the kernel, this is the rate at which the host issues calls) and the mean
device time of one call captured in a CUDA graph, and the device
microseconds per call of each kernel the call launches
(``torch.profiler``).
"""

from __future__ import annotations

import json
import os
import sys

POPSIZE = 10_000
LENGTH = 12_305  # parameters of the flagship 64-64 tanh MLP on Humanoid
PHYSICS_LANES = (10_000, 2_048)  # the lanes of the benchmark's budget and refill cells
PHYSICS_WARM_STEPS = 30  # random-policy control steps before the timed one: the Humanoid is down, in contact
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def physics_flops(sys, substeps: int) -> int:
    """Float32 operations a lane of ``csrc/rigid_body_step.cu`` computes in
    one control step, counted from its source (an add, multiply, divide,
    square root, min or max is one; ``atan2f`` 15): a body's rotation
    matrix 30 and update 160, a joint 336, a sphere 62 a substep."""
    nb, nj, ns = sys.num_bodies, sys.num_joints, int(sys.sph_radius.shape[0])
    return substeps * (190 * nb + 336 * nj + 62 * ns)


def physics_bytes(sys) -> int:
    """Bytes a lane of the kernel moves in one control step: the state (13
    floats a body) read and written once, the action read once."""
    return 4 * (2 * 13 * sys.num_bodies + sys.num_act)


def epilogue_bytes(obs_dim: int) -> int:
    """Bytes a lane of the kernel's env-step epilogue moves besides the
    physics: the observation row (``obs_dim`` float32), the reward (4) and
    done (1) written, the episode clock read and written (4 + 4)."""
    return 4 * obs_dim + 4 + 1 + 4 + 4


def physics_bound_ms(sys, substeps: int, lanes: int, obs_dim: int = 0) -> float:
    """The least time of one control step at ``lanes`` lanes: the larger of
    the bytes at 3.35 TB/s and the operations at 67 TFLOP/s. With
    ``obs_dim`` the whole env step: the epilogue's bytes added (its
    arithmetic, a few joint rotations a lane, is left out: the bound stays
    a lower one)."""
    moved = physics_bytes(sys) + (epilogue_bytes(obs_dim) if obs_dim else 0)
    return 1e3 * lanes * max(moved / HBM_BYTES_PER_S, physics_flops(sys, substeps) / FP32_FLOPS_PER_S)


def humanoid_states(lanes: int, device, *, seed: int = 0):
    """The Humanoid on ``device``, the body states of ``lanes`` lanes after
    ``PHYSICS_WARM_STEPS`` control steps of uniform random actions from its
    resets, and one more such action ``(num_act, lanes)`` as ``batch_step``
    hands it to the physics (a transposed view)."""
    import torch

    from evotorch_tpu_torch.envs import make_env

    env = make_env("humanoid", device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state, _ = env.batch_reset_from(env.reset_noise(lanes, g))
    for _ in range(PHYSICS_WARM_STEPS):
        state, _, _, _ = env.batch_step(state, 2.0 * torch.rand((lanes, env.action_size), generator=g, device=device) - 1.0)
    actions = (2.0 * torch.rand((lanes, env.action_size), generator=g, device=device) - 1.0).t()
    return env, state.obs_state, actions


def time_ms(fn, *, warmup: int, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, *, calls: int, replays: int) -> float:
    """Mean device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the host's
    cost of each launch (Python, ctypes) does not hide the device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def kernel_split_us(fn, *, iters: int = 20) -> dict:
    """Device microseconds per ``fn()`` of each kernel it launches, by
    ``torch.profiler`` over eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0)
        if device_us and getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA:
            split[event.key] = device_us / iters
    return split


def physics_times(lanes: int, device) -> dict:
    """One Humanoid control step at ``lanes`` lanes: the kernel eagerly and
    in a CUDA graph, and the plain loop of substeps it replaced: its host ms
    (issuing the launches) and its device ms (in a CUDA graph); and under
    ``fused`` the env's whole step (``rigidbody.env_step_batched``: the
    physics, the observation row, reward, done and clock) timed alike."""
    import time

    import torch

    from evotorch_tpu_torch.envs import rigidbody as rb

    env, st, actions = humanoid_states(lanes, device)
    task = env._task()
    clocks = torch.zeros(lanes, dtype=torch.int32, device=device)
    rows = actions.t()  # (lanes, num_act), as batch_step takes them

    def kernel():
        return rb.physics_step_batched(env.sys, st, actions, env.dt, env.substeps)

    def fused():
        return rb.env_step_batched(env.sys, task, st, clocks, rows, env.dt, env.substeps)

    def plain():
        return rb.physics_step_batched_plain(env.sys, st, actions, env.dt, env.substeps)

    plain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        plain()
    # graftlint: allow(timing): the host's time to issue the plain loop's launches (the card keeps up with it)
    plain_host_ms = 1e3 * (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    return {
        "lanes": lanes,
        "eager_ms": time_ms(kernel, warmup=3, iters=20),
        "graph_ms": graph_ms(kernel, calls=5, replays=4),
        "bound_ms": physics_bound_ms(env.sys, env.substeps, lanes),
        "plain_host_ms": plain_host_ms,
        "plain_graph_ms": graph_ms(plain, calls=1, replays=3),
        "split_us": kernel_split_us(kernel, iters=5),
        "fused": {
            "eager_ms": time_ms(fused, warmup=3, iters=20),
            "graph_ms": graph_ms(fused, calls=5, replays=4),
            "bound_ms": physics_bound_ms(env.sys, env.substeps, lanes, env.observation_size),
            "split_us": kernel_split_us(fused, iters=5),
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from evotorch_tpu_torch.ops import ranking, sampling

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(POPSIZE, generator=g, device=device)
    mu = torch.randn(LENGTH, generator=g, device=device)
    sigma = torch.full((LENGTH,), 0.1, device=device)
    seed = sampling.draw_seed(g, device)

    def rank():
        return ranking.centered_rank(x)

    def sample():
        return sampling.sample_symmetric_gaussian(mu, sigma, POPSIZE, seed=seed)

    result = {
        "device": torch.cuda.get_device_name(0),
        "root": os.getcwd(),
        "centered_rank": {
            "graph_ms": graph_ms(rank, calls=20, replays=10),
            "eager_ms": time_ms(rank, warmup=5, iters=50),
            "split_us": kernel_split_us(rank),
        },
        "symmetric_gaussian": {
            "graph_ms": graph_ms(sample, calls=5, replays=4),
            "eager_ms": time_ms(sample, warmup=3, iters=20),
            "split_us": kernel_split_us(sample),
        },
        "rigid_body_step": [physics_times(lanes, device) for lanes in PHYSICS_LANES],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
