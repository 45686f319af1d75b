"""The result line of a run, and the lines before it."""

from __future__ import annotations

import json
import math
import sys
from typing import Optional

from . import harness
from .check import judge

__all__ = ["emit", "result_line"]


def _metrics(spec, summary: dict, names) -> dict:
    out = {}
    for m in names:
        value: Optional[float] = harness.reader(m["name"], spec["root"])(summary)
        if value is None:
            continue  # nothing to read in this run: the metric is left out
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(spec, result: dict, *, trace: bool) -> dict:
    summary = result["summary"]
    device = dict(result["device"])
    if trace:
        t = summary["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
    line = {
        "correct": judge(result["checks"]) and bool(result["checks"]),
        "attempted": int(result["attempted"]),
        "failed": int(result["failed"]),
        "metrics": _metrics(spec, summary, spec["per_layer"] if trace else spec["end_to_end"]),
        "device": device,
    }
    if trace:
        from .tracing import breakdown

        line["breakdown"] = breakdown(summary["trace"])
    line["checks"] = result["checks"]
    return line


def emit(spec, result: dict, *, trace: bool, stdout=None, stderr=None) -> int:
    """Print the run's lines; returns the exit code."""
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded in this process: {', '.join(bad)}; no result", file=stderr)
        return 3
    line = result_line(spec, result, trace=trace)
    power = harness.power_limit()
    if power is not None:
        line["device"]["nvidia_smi"] = power
    for key, item in result["checks"].items():
        print(f"check {key} {item['value']!r} limit {item['limit']!r}", file=stderr)
    stderr.flush()
    print(json.dumps(line), file=stdout)
    stdout.flush()
    return 0
