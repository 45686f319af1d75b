"""Host-side span tracer emitting Chrome trace-event JSON (counterpart of
``evotorch_tpu/observability/tracer.py``; the same events, names and
categories).

It covers the HOST side of a run: the search loop's ask/eval/tell phases,
the rollout's control step (policy, env step, physics, host waits), the
host pipeline's S1/S2/S3 stages, the physics worker thread, the host
pool's dispatch and sync. Every span is one complete ("ph": "X") event;
threads appear as separate tracks, so pipeline overlap is visible as
parallel spans. A span around a CUDA launch times the host's dispatch, not
the card's work: the tracer never synchronizes the device.

:func:`span` is the one span call of the package, and feeds up to three
recorders:

- **a torch profiler**, whenever one records (``torch.profiler.profile``,
  ``SearchAlgorithm.run(profile_dir=...)``): the span opens a
  ``torch.profiler.record_function`` range named
  ``evotorch_tpu_torch.<name>``, on the device trace's own clock;
- **the installed** :class:`SpanTracer` (``EVOTORCH_TRACE``,
  :func:`start_tracing`): a Chrome event whose ``ts`` is the epoch clock in
  µs (``time.time_ns() / 1000``), the profiler's, so the two traces line
  up in Perfetto;
- **the counter registry**, while either records: ``span.<name>.count``,
  ``span.<name>.seconds`` (host seconds, child spans included) and
  ``span.<name>.self_seconds`` (less its direct child spans' seconds).

A span decides at entry whether it records, and then records at exit even
if an exception passes through it. A span in which a profiler stopped
(and no tracer records) closes its range and is left out of the counters:
its seconds would hold the profiler's own stop, seconds long.

- **~0 overhead when nothing records** (the default): :func:`span` returns a
  shared no-op context manager after a ``None`` check and a read of the
  profiler's flag; no range is ever entered then.
- **Ring-buffered**: events live in a bounded ``deque``.
- **Thread-safe**: events append from any thread under one lock;
  per-thread track names are emitted as metadata events on first use; the
  self-time stack is per thread.

Enable the Chrome trace with ``EVOTORCH_TRACE=/path/to/trace.json`` in the
environment (written at process exit) or programmatically::

    from evotorch_tpu_torch.observability import tracer
    tracer.start_tracing("pipeline.json")
    ...
    tracer.stop_tracing()          # writes the file

Open the file at https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from .registry import counters

__all__ = [
    "SpanTracer",
    "span",
    "instant",
    "start_tracing",
    "stop_tracing",
    "get_tracer",
    "tracing_enabled",
]

#: default ring-buffer capacity (events); ~150 bytes/event => tens of MB max
DEFAULT_CAPACITY = 400_000

#: the prefix of every profiler range a span opens
RANGE_PREFIX = "evotorch_tpu_torch."


def _epoch_us() -> float:
    """The trace clock: the epoch in µs, the clock of the profiler's events."""
    return time.time_ns() / 1000


_keys: Dict[str, tuple] = {}
_local = threading.local()


def _span_keys(name: str) -> tuple:
    """The span's range name and its three counter names (made once a name)."""
    keys = _keys.get(name)
    if keys is None:
        keys = _keys[name] = (
            RANGE_PREFIX + name,
            f"span.{name}.count",
            f"span.{name}.seconds",
            f"span.{name}.self_seconds",
        )
    return keys


def _open_spans() -> list:
    """This thread's open recording spans, each as its children's ns."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One in-flight recording span: a profiler range while one records, a
    complete event on ``tracer`` (when not None), and the span's counters."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_range", "_stack", "_t0")

    def __init__(self, tracer: Optional["SpanTracer"], name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(_span_keys(self._name)[0])
            self._range.__enter__()
        self._stack = _open_spans()
        self._stack.append(0)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.time_ns() - self._t0
        children = self._stack.pop()
        if self._stack:
            self._stack[-1] += dur
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        t = self._tracer
        if t is None and not _autograd_profiler._is_profiler_enabled:
            # the profiler stopped inside the span: its seconds hold the
            # profiler's own stop (its sync and its trace's collection)
            return False
        _, count, seconds, self_seconds = _span_keys(self._name)
        counters.increment(count)
        counters.accumulate(seconds, dur / 1e9)
        counters.accumulate(self_seconds, (dur - children) / 1e9)
        if t is not None:
            t._complete(self._name, self._t0 / 1000, dur / 1000, self._cat, self._args)
        return False


class _NoopSpan:
    """The shared disabled-path context manager: no state, no work."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


class SpanTracer:
    """Ring-buffered Chrome trace-event recorder (see the module docstring)."""

    def __init__(
        self,
        *,
        capacity: int = DEFAULT_CAPACITY,
        flush_path: Optional[str] = None,
        flush_secs: Optional[float] = None,
    ):
        self._events: deque = deque(maxlen=int(capacity))
        self._meta: List[dict] = []  # thread-name metadata; never evicted
        self._pid = os.getpid()
        # one lock for appends AND snapshots: a worker thread finishing a
        # span while stop_tracing()/the atexit writer iterates the deque
        # would otherwise raise "deque mutated during iteration" and lose
        # the trace (the acquire is ~100ns against spans that are µs+)
        self._lock = threading.Lock()
        self._named: set = set()
        # periodic ring-buffer flush (off unless both are set): a SIGKILLed
        # long run keeps the last flushed window instead of losing the whole
        # trace at the missed atexit hook
        self._flush_path = flush_path
        self._flush_secs = float(flush_secs) if flush_secs else None
        self._last_flush = time.monotonic()
        self._flush_gate = threading.Lock()

    # ------------------------------------------------------------- recording
    def _now_us(self) -> float:
        return _epoch_us()

    def now_us(self) -> float:
        """The trace clock (the epoch in µs, the profiler's clock) — pair with
        :meth:`complete` for manually-timed spans that cannot be expressed
        as one ``with`` block (e.g. an async dispatch whose wait happens in
        a later call)."""
        return self._now_us()

    def complete(self, name: str, ts: float, dur: float, cat: str = "", **args):
        """Append a complete event with caller-supplied timestamps."""
        self._complete(name, ts, dur, cat, args)

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._named:
            with self._lock:
                if tid not in self._named:
                    self._named.add(tid)
                    self._meta.append(
                        {
                            "name": "thread_name",
                            "ph": "M",
                            "pid": self._pid,
                            "tid": tid,
                            "args": {"name": t.name},
                        }
                    )
        return tid

    def _complete(self, name: str, ts: float, dur: float, cat: str, args: dict):
        event = {
            "name": name,
            "ph": "X",
            "ts": ts,
            "dur": dur,
            "pid": self._pid,
            "tid": self._tid(),
        }
        if cat:
            event["cat"] = cat
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)
        counters.increment("trace_spans")
        self._maybe_flush()

    def span(self, name: str, cat: str = "", **args) -> _Span:
        """A span recorded on this tracer (and as a profiler range, and in
        the counters, as :func:`span`'s)."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """A point event ("ph": "i", thread-scoped)."""
        event = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": self._tid(),
        }
        if cat:
            event["cat"] = cat
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def counter(self, name: str, value, cat: str = "") -> None:
        """A counter-track sample ("ph": "C")."""
        event = {
            "name": name,
            "ph": "C",
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": self._tid(),
            "args": {name: value},
        }
        if cat:
            event["cat"] = cat
        with self._lock:
            self._events.append(event)

    def _maybe_flush(self) -> None:
        """Write the ring buffer to ``flush_path`` when the flush interval
        has elapsed. Serialization happens OUTSIDE the event lock (events
        keep appending while the snapshot serializes); a second thread
        arriving mid-flush skips (non-blocking gate). Never raises — a
        flush failure must not take down the run being traced."""
        if self._flush_secs is None or self._flush_path is None:
            return
        now = time.monotonic()
        if now - self._last_flush < self._flush_secs:
            return
        if not self._flush_gate.acquire(blocking=False):
            return
        try:
            self._last_flush = now
            tmp = self._flush_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.to_chrome_trace(), f)
            os.replace(tmp, self._flush_path)  # readers never see a torn file
        except Exception:  # graftlint: allow(swallow): tracing must never take down the run it traces
            pass
        finally:
            self._flush_gate.release()

    # --------------------------------------------------------------- readout
    def events(self) -> List[dict]:
        with self._lock:
            return self._meta + list(self._events)

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# ---------------------------------------------------------------------------
# the module-level tracer (the one `span()` feeds)
# ---------------------------------------------------------------------------

_TRACER: Optional[SpanTracer] = None
_TRACE_PATH: Optional[str] = None
_STATE_LOCK = threading.Lock()


def get_tracer() -> Optional[SpanTracer]:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER is not None


def start_tracing(
    path: Optional[str] = None,
    *,
    capacity: int = DEFAULT_CAPACITY,
    flush_secs: Optional[float] = None,
) -> SpanTracer:
    """Install a fresh process tracer. ``path`` (optional) is where
    :func:`stop_tracing` — or process exit — writes the trace.
    ``flush_secs`` (or ``EVOTORCH_TRACE_FLUSH_SECS`` in the environment;
    default off) additionally rewrites ``path`` every that-many seconds,
    so a killed run keeps a partial trace."""
    global _TRACER, _TRACE_PATH
    with _STATE_LOCK:
        _TRACER = SpanTracer(
            capacity=capacity,
            flush_path=path if flush_secs else None,
            flush_secs=flush_secs,
        )
        _TRACE_PATH = path
        return _TRACER


def stop_tracing(*, write: bool = True) -> Optional[str]:
    """Uninstall the tracer; write the trace to its configured path (if any).
    Returns the written path, or None."""
    global _TRACER, _TRACE_PATH
    with _STATE_LOCK:
        tracer, path = _TRACER, _TRACE_PATH
        _TRACER, _TRACE_PATH = None, None
    if tracer is not None and path is not None and write:
        return tracer.write(path)
    return None


def span(name: str, cat: str = "", **args):
    """A context manager recording one span: a profiler range while a torch
    profiler records, a complete event on the installed tracer, and the
    span's counters while either does — or the shared no-op when nothing
    records (the fast path: a ``None`` check and the profiler's flag)."""
    t = _TRACER
    if t is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(t, name, cat, args)


def instant(name: str, cat: str = "", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def _write_at_exit() -> None:
    # EVOTORCH_TRACE runs write the ring buffer out even on an unclean stop;
    # nothing here may raise (an atexit traceback would mask the real error
    # of the run being traced)
    if _TRACER is not None and _TRACE_PATH is not None:
        try:
            _TRACER.write(_TRACE_PATH)
        except Exception:  # graftlint: allow(swallow): tracing must never take down the run it traces
            pass


def _env_flush_secs() -> Optional[float]:
    raw = os.environ.get("EVOTORCH_TRACE_FLUSH_SECS")
    if not raw:
        return None
    try:
        secs = float(raw)
    except ValueError:
        return None
    return secs if secs > 0 else None


_env_path = os.environ.get("EVOTORCH_TRACE")
if _env_path:
    start_tracing(_env_path, flush_secs=_env_flush_secs())
atexit.register(_write_at_exit)
