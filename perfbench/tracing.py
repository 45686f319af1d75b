"""The traced segment of a ``--trace 1`` run, reduced to numbers.

``torch.profiler`` records the device's kernels, copies and fills and the
CUDA runtime's calls of a short segment; the harness stamps each control
step (each call of the env's ``batch_step``) on the host's clock, which is
the profiler's. This module reads the profiler's raw events (no event tree
is built) and keeps:

- the device seconds and count of each operation by name, over the whole
  segment (the round boundary's tell and ask included);
- over the traced window, the whole control steps from the first stamp to
  the last: ``busy_s``, the union of the device's intervals, ``window_s``,
  the window's length, the kernel launches, and the device's idle gaps,
  each named by what the host was doing when it began (inside the env's
  step, or between two, where the policy forward and the contract's
  bookkeeping run).

The profiler's own start (seconds, the first time in a process) and the
round boundary stay out of the window. The profiler slows the host about
twofold on these cells, so the idle share it reads is higher than an
untraced run's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

__all__ = ["breakdown", "summarize"]

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_RANGES = ("evotorch_tpu_torch.", "perfbench.")
_ENV_STEP = "env step (physics, observation, reward)"
_BETWEEN = "between env steps (policy forward, contract bookkeeping)"


def _raw_events(prof):
    return prof.profiler.kineto_results.events()


def _is_annotation(e) -> bool:
    probe = getattr(e, "is_user_annotation", None)
    return bool(probe()) if callable(probe) else False


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _host_activity(t: int, steps: Sequence[Tuple[int, int]], starts: List[int]) -> str:
    i = max(bisect.bisect_right(starts, t) - 1, 0)
    return _ENV_STEP if t < steps[i][1] else _BETWEEN


def summarize(prof, steps: Sequence[Tuple[int, int]]) -> Dict:
    """The segment with its control steps' ``(start, end)`` stamps (host
    clock, ns); every time in seconds."""
    device, launches = [], []
    for e in _raw_events(prof):
        name = e.name()
        if _is_annotation(e) or name.startswith(_RANGES):
            continue  # a host range, which the profiler also draws on the device's timeline
        start = int(e.start_ns())
        end = start + max(int(e.duration_ns()), 0)
        if str(e.device_type()).endswith("CUDA"):
            device.append((name, start, end))
        elif name in _LAUNCH_CALLS:
            launches.append(start)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, start, end in device:
        by_name[name][0] += (end - start) / 1e9
        by_name[name][1] += 1
    out = {
        "device_ops": {name: {"seconds": v[0], "count": v[1]} for name, v in by_name.items()},
        "busy_s": 0.0,
        "window_s": 0.0,
        "ctrl_steps": 0,
        "ctrl_step_launches": 0,
        "idle_gaps": {},
    }
    if len(steps) < 2:
        return out
    lo, hi = steps[0][0], steps[-1][0]
    busy = _union([(max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi])
    starts = [s for s, _ in steps]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, prev_end), (next_start, _) in zip(edges, edges[1:]):
        if next_start > prev_end:
            gaps[_host_activity(prev_end, steps, starts)] += (next_start - prev_end) / 1e9
    out.update(
        busy_s=sum(e - s for s, e in busy) / 1e9,
        window_s=(hi - lo) / 1e9,
        ctrl_steps=len(steps) - 1,
        ctrl_step_launches=sum(1 for t in launches if lo <= t < hi),
        idle_gaps=dict(gaps),
    )
    return out


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The ``breakdown`` of a result line: the device operations that took
    the most time and the idle time by host range, at most ``top`` each."""
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1]["seconds"])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, v["seconds"]] for name, v in ops], "idle_gaps": [[name, s] for name, s in gaps]}
