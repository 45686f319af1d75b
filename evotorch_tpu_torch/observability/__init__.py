"""Observability (counterpart of ``evotorch_tpu/observability``): the
on-device eval telemetry wire and its host decoders so far."""

from . import devicemetrics
from .devicemetrics import EvalTelemetry, GroupTelemetry

__all__ = ["EvalTelemetry", "GroupTelemetry", "devicemetrics"]
