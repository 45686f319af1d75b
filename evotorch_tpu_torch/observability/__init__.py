"""Observability (counterpart of ``evotorch_tpu/observability``): the
on-device eval telemetry wire and its host decoders, the process-wide
counter registry, the host span tracer, and the measured-timing ledger with
the tuned-config cache (``timings``, imported on its own)."""

from . import devicemetrics, registry, tracer
from .devicemetrics import EvalTelemetry, GroupTelemetry
from .registry import CounterRegistry, counters
from .tracer import SpanTracer, instant, span, start_tracing, stop_tracing, tracing_enabled

__all__ = [
    "CounterRegistry",
    "EvalTelemetry",
    "GroupTelemetry",
    "SpanTracer",
    "counters",
    "devicemetrics",
    "instant",
    "registry",
    "span",
    "start_tracing",
    "stop_tracing",
    "tracer",
    "tracing_enabled",
]
