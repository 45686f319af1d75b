"""Process-wide counter registry (counterpart of
``evotorch_tpu/observability/registry.py``).

A :class:`CounterRegistry` is a thread-safe map of named meters; the
module-level :data:`counters` is the one the port feeds:

- ``trace_spans``: spans recorded by the host tracer
  (:mod:`~evotorch_tpu_torch.observability.tracer`), 0 while tracing is off;
- ``span.<name>.count``, ``span.<name>.seconds`` and
  ``span.<name>.self_seconds`` (floats): each span's calls, host seconds
  (child spans included) and seconds less its direct child spans, while a
  torch profiler records or the host tracer is on (``tracer.span``); the
  rollout's are ``rollout.ctrl_step``, ``rollout.policy``,
  ``rollout.env_step``, ``rollout.host_wait`` and ``env.physics``;
- ``span.<name>.device_seconds`` (a float): a span's time on the card,
  for the spans given a CUDA device (``policy.lstm_cell``), read in by
  ``tracer.resolve_device_seconds``; and beside that span
  ``lstm.cell.lanes`` (the rows the cell computed) and the gauges
  ``lstm.cell.input_size`` and ``lstm.cell.hidden_size``;
- ``faults.fired.<site>.<kind>`` and ``faults.injected_nonfinite``: the
  fault-injection harness (:mod:`~evotorch_tpu_torch.resilience.faults`);
- ``hostpool.worker_deaths``, ``hostpool.respawns``,
  ``hostpool.redispatched_pieces``: the host worker pool's recoveries;
- ``telemetry_fetches``: host decodes of a telemetry wire
  (:mod:`~evotorch_tpu_torch.observability.devicemetrics`);
- ``retry.<site>.attempts`` / ``.retries`` / ``.giveups``: the retries of
  :mod:`~evotorch_tpu_torch.resilience.retry`;
- ``checkpoint.bundles_written``, ``checkpoint.corrupt_skipped``: the run
  bundles of :mod:`~evotorch_tpu_torch.resilience.runstate`;
- ``watchdog.device_probe.timeouts``: first device uses that hung;
- ``compiles`` and ``compile_seconds`` (a float): kernel libraries built by
  ``nvcc`` or loaded from the build directory, and their seconds, where the
  JAX package counts XLA compiles; ``compilecache.misses`` and
  ``compilecache.hits`` split ``compiles`` into the two
  (:mod:`~evotorch_tpu_torch.observability.compilecache`). Both are fed by
  two permanent sinks of the first-use sentinel, which
  :func:`ensure_compile_counter` and :func:`ensure_compile_timer` register
  (``compilecache`` calls both before it reports its first library).

Pair two :meth:`CounterRegistry.snapshot` calls with :meth:`~CounterRegistry.delta`
to meter a region; ``SearchAlgorithm.step`` publishes the per-step deltas
of ``compiles``, ``compile_seconds``, ``trace_spans`` and
``telemetry_fetches``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

__all__ = ["CounterRegistry", "counters", "ensure_compile_counter", "ensure_compile_timer"]


class CounterRegistry:
    """Thread-safe named meters: monotonically-increasing counters
    (:meth:`increment` int, :meth:`accumulate` float) and high-water-mark
    gauges (:meth:`observe_max`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = {}

    def increment(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def accumulate(self, name: str, value: float) -> None:
        """Float-valued increment (e.g. seconds)."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + float(value)

    def observe_max(self, name: str, value: float) -> None:
        """High-water-mark gauge: the stored value only ever rises."""
        with self._lock:
            if value > self._counts.get(name, 0):
                self._counts[name] = value

    def get(self, name: str):
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self, names: Optional[Iterable[str]] = None) -> Dict[str, int]:
        """A point-in-time copy (of ``names`` only, when given)."""
        with self._lock:
            if names is None:
                return dict(self._counts)
            return {n: self._counts.get(n, 0) for n in names}

    def delta(self, since: Dict[str, int]) -> Dict[str, int]:
        """Increases since a prior :meth:`snapshot`, over its keys."""
        with self._lock:
            return {n: self._counts.get(n, 0) - v for n, v in since.items()}


#: the process-wide registry every subsystem feeds
counters = CounterRegistry()


_compile_sinks: Dict[str, object] = {}
_compile_lock = threading.Lock()


class _CompileCounterSink:
    """A permanent first-use sink counting kernel libraries into
    ``counters['compiles']``."""

    def record(self, name: str, seconds: float) -> None:
        counters.increment("compiles")


class _CompileTimerSink:
    """A permanent first-use sink accumulating their seconds into
    ``counters['compile_seconds']``."""

    def record(self, name: str, seconds: float) -> None:
        counters.accumulate("compile_seconds", seconds)


def _ensure_sink(key: str, make) -> None:
    with _compile_lock:
        if key in _compile_sinks:
            return
        from ..analysis import retrace_sentinel

        _compile_sinks[key] = make()
        retrace_sentinel.register_sink(_compile_sinks[key])


def ensure_compile_counter() -> None:
    """From now on, every kernel library built or loaded (the first-use
    sentinel's builds) adds one to ``counters['compiles']``. Idempotent;
    composes with :func:`~evotorch_tpu_torch.analysis.retrace_sentinel.track_first_use`
    blocks, which read the counter."""
    _ensure_sink("compiles", _CompileCounterSink)


def ensure_compile_timer() -> None:
    """The duration twin of :func:`ensure_compile_counter`: every kernel
    library's build or load seconds accumulate into
    ``counters['compile_seconds']``. Idempotent."""
    _ensure_sink("compile_seconds", _CompileTimerSink)
