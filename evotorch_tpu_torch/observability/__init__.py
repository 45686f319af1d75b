"""Observability (counterpart of ``evotorch_tpu/observability``): the
on-device eval telemetry wire and its host decoders, the process-wide
counter registry, the host span tracer, the kernel-build cache's counts,
and, loaded at first access, the program ledger (``programs``), the
measured-timing ledger with the tuned-config cache (``timings``), the SLO
watchdog (``slo``), the health trends (``health``) and the metrics export
(``metricshub``).

The names the JAX package re-exports here resolve under the same names.
The lazy ones go through the module ``__getattr__`` below, so that
``import evotorch_tpu_torch.observability`` stays as cheap as before and
``python -m evotorch_tpu_torch.observability.slo`` does not import its own
module twice. One name differs in kind: the JAX package's ``timings`` is
the ledger singleton, which shadows its submodule; here ``timings`` stays
the submodule (the port's code and tests import it as one), and the
singleton is ``timings.timings``.
"""

import importlib

from . import devicemetrics, registry, tracer
from .compilecache import cache_stats
from .devicemetrics import (
    GROUP_TELEMETRY_WIDTH,
    HEALTH_TELEMETRY_WIDTH,
    HEALTH_WIDTH,
    QUEUE_WAIT_BUCKET_EDGES,
    QUEUE_WAIT_BUCKETS,
    TELEMETRY_SCHEMA_VERSION,
    TELEMETRY_WIDTH,
    EvalTelemetry,
    GroupTelemetry,
    append_health_block,
    compute_health_block,
    pack_eval_telemetry,
    pack_group_telemetry,
    queue_wait_bucket_index,
)
from .registry import CounterRegistry, counters, ensure_compile_counter, ensure_compile_timer
from .tracer import SpanTracer, get_tracer, instant, span, start_tracing, stop_tracing, tracing_enabled

#: name -> the submodule that defines it, imported at the name's first access
_LAZY_EXPORTS = {
    "MetricsHub": "metricshub",
    "Rule": "slo",
    "SLOReport": "slo",
    "SLOWatchdog": "slo",
    "EWMATrend": "health",
    "HealthMonitor": "health",
    "DonationReport": "programs",
    "ProgramLedger": "programs",
    "ProgramRecord": "programs",
    "compare_to_baseline": "programs",
    "default_ledger_baseline_path": "programs",
    "ledger": "programs",
    "load_ledger_baseline": "programs",
    "save_ledger_baseline": "programs",
    "SOURCE_CACHE": "timings",
    "SOURCE_FALLBACK": "timings",
    "SOURCE_OVERRIDE": "timings",
    "TimingLedger": "timings",
    "TimingRecord": "timings",
    "TunedEntry": "timings",
    "canonical_env_label": "timings",
    "default_tuned_cache_path": "timings",
    "load_tuned_cache": "timings",
    "lookup_tuned": "timings",
    "machine_fingerprint": "timings",
    "resolve_knobs": "timings",
    "save_tuned_entry": "timings",
    "timing_key": "timings",
}


def __getattr__(name):
    if name == "timings":
        return importlib.import_module(f"{__name__}.timings")
    submodule = _LAZY_EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = [
    "cache_stats",
    "EvalTelemetry",
    "GroupTelemetry",
    "GROUP_TELEMETRY_WIDTH",
    "HEALTH_TELEMETRY_WIDTH",
    "HEALTH_WIDTH",
    "QUEUE_WAIT_BUCKETS",
    "QUEUE_WAIT_BUCKET_EDGES",
    "TELEMETRY_SCHEMA_VERSION",
    "TELEMETRY_WIDTH",
    "append_health_block",
    "compute_health_block",
    "pack_eval_telemetry",
    "pack_group_telemetry",
    "queue_wait_bucket_index",
    "MetricsHub",
    "Rule",
    "SLOReport",
    "SLOWatchdog",
    "EWMATrend",
    "HealthMonitor",
    "CounterRegistry",
    "counters",
    "devicemetrics",
    "ensure_compile_counter",
    "ensure_compile_timer",
    "DonationReport",
    "ProgramLedger",
    "ProgramRecord",
    "compare_to_baseline",
    "default_ledger_baseline_path",
    "ledger",
    "load_ledger_baseline",
    "save_ledger_baseline",
    "SpanTracer",
    "get_tracer",
    "instant",
    "registry",
    "span",
    "start_tracing",
    "stop_tracing",
    "tracer",
    "tracing_enabled",
    "SOURCE_CACHE",
    "SOURCE_FALLBACK",
    "SOURCE_OVERRIDE",
    "TimingLedger",
    "TimingRecord",
    "TunedEntry",
    "canonical_env_label",
    "default_tuned_cache_path",
    "load_tuned_cache",
    "lookup_tuned",
    "machine_fingerprint",
    "resolve_knobs",
    "save_tuned_entry",
    "timing_key",
    "timings",
]
