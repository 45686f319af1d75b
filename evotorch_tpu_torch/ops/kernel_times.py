"""Times of the port's two kernels at the flagship shapes, and the
CUDA-event timers that ``chip_smoke.py`` uses.

Run on a machine with a CUDA device, from the root of a checkout:

    python3 -m evotorch_tpu_torch.ops.kernel_times

or, to time another checkout's kernels with this same code, from the root of
that checkout:

    python3 /path/to/evotorch_tpu_torch/ops/kernel_times.py

It times the wrappers of the package in the current directory (centered
ranks of 10,000 float32 fitnesses; an antithetic population of 10,000 x
12,305), so that two commits can be compared in one call, in turns. Prints
one JSON line: the card and, per kernel, the mean time of one call launched
eagerly (CUDA events around back-to-back calls; where the wrapper's host
work outlasts the kernel, this is the rate at which the host issues calls)
and the mean device time of one call captured in a CUDA graph, and the
device microseconds per call of each kernel the call launches
(``torch.profiler``).
"""

from __future__ import annotations

import json
import os
import sys

POPSIZE = 10_000
LENGTH = 12_305  # parameters of the flagship 64-64 tanh MLP on Humanoid


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
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
