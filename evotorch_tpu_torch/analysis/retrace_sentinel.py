"""First-use sentinel: count the first-use work done inside a code region
(counterpart of ``evotorch_tpu/analysis/retrace_sentinel.py``).

The JAX sentinel counts XLA compiles, since a program that compiles inside
a timed region times its compiler. Eager PyTorch has no trace to redo;
what contaminates a timed region instead is first-use work:

- a kernel library built with ``nvcc`` or loaded from the build directory:
  the ``compiles`` counter of the registry, which ``ops/_build.py`` feeds
  through :mod:`~evotorch_tpu_torch.observability.compilecache`;
- on the card, a new segment of the caching allocator: ``cudaMalloc`` of
  memory the region's tensors did not find in the cache
  (``torch.cuda.memory_stats()["segment.all.allocated"]`` growing inside
  the region).

:func:`track_first_use` yields a :class:`FirstUseLog` whose ``count`` is
the sum of both, and whose ``names`` are the libraries' names;
:func:`assert_first_use` raises :class:`RetraceError` when it exceeds a
budget, counting only the libraries whose names contain ``match`` when it
is given, and names what it counted. Both nest and are thread-safe: each
block reads the two process-wide counts at its own entry and exit, and is
a sink while it is open, so every active block sees every first use made
while it is open, from any thread.

:func:`register_sink` adds a permanent sink, an object with
``record(name: str, seconds: float)``, that sees every kernel library built
or loaded from then on, by name and with its seconds (the counterpart of
the JAX sentinel's sinks, which see every XLA compile). The registry's
``compiles`` and ``compile_seconds`` counters are two such sinks
(``observability.registry.ensure_compile_counter`` and
``ensure_compile_timer``). Allocator segments are read, not reported, so
no sink sees them.

Usage::

    with track_first_use() as log:
        generation(state, generator, stats)
    assert log.count == 0            # warm: nothing built, nothing allocated

    with assert_first_use(0):        # raises RetraceError otherwise
        generation(state, generator, stats)

    with assert_first_use(1, match="centered_rank"):  # one load of that library
        ranking.centered_rank(scores)
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from ..observability.registry import counters

__all__ = [
    "FirstUseLog",
    "RetraceError",
    "assert_first_use",
    "record_first_use",
    "register_sink",
    "track_first_use",
    "unregister_sink",
]

_LOCK = threading.Lock()
_SINKS: List = []  # objects with .record(name, seconds); mutated under _LOCK


class RetraceError(AssertionError):
    """Raised by :func:`assert_first_use` when a region did more first-use
    work than its budget."""


@dataclass(eq=False)
class FirstUseLog:
    """The first-use work seen inside one tracking block, known when the
    block exits: the kernel libraries built or loaded (``builds``, and their
    ``names`` in the order they were reported) and the allocator segments
    allocated on the card (``segments``, which have no names). ``eq=False``:
    a log is a sink, registered and removed by identity."""

    builds: int = 0
    segments: int = 0
    names: List[str] = field(default_factory=list)

    def record(self, name: str, seconds: float) -> None:
        """Sink protocol: one library built or loaded (any thread;
        ``list.append`` is atomic under the interpreter lock)."""
        self.names.append(str(name))

    @property
    def count(self) -> int:
        return self.builds + self.segments

    def count_matching(self, substring: str) -> int:
        """The libraries whose names contain ``substring``."""
        return sum(1 for name in self.names if substring in name)


def _segments_allocated() -> int:
    """Allocator segments allocated so far on every card this process has
    used (0 before CUDA is initialized, and on a CPU-only build): reading
    it never initializes CUDA."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return sum(
        int(torch.cuda.memory_stats(d).get("segment.all.allocated", 0)) for d in range(torch.cuda.device_count())
    )


def register_sink(sink) -> None:
    """Add a permanent sink (an object with ``record(name: str, seconds:
    float)``) that sees every kernel library built or loaded from now on.
    Thread-safe."""
    with _LOCK:
        _SINKS.append(sink)


def unregister_sink(sink) -> None:
    """Remove a sink by identity, never equality: two equal sinks must not
    unregister each other."""
    with _LOCK:
        for i, registered in enumerate(_SINKS):
            if registered is sink:
                del _SINKS[i]
                return


def record_first_use(name: str, seconds: float) -> None:
    """Report one kernel library built or loaded (``name``, taking
    ``seconds``) to every registered sink; ``observability.compilecache``
    calls it for each library."""
    with _LOCK:
        sinks = list(_SINKS)
    for sink in sinks:
        sink.record(name, seconds)


@contextlib.contextmanager
def track_first_use():
    """Context manager yielding a :class:`FirstUseLog` of the first-use work
    done inside the block (see the module note). Nestable and
    thread-safe."""
    log = FirstUseLog()
    builds, segments = counters.get("compiles"), _segments_allocated()
    register_sink(log)
    try:
        yield log
    finally:
        unregister_sink(log)
        log.builds = counters.get("compiles") - builds
        log.segments = _segments_allocated() - segments


@contextlib.contextmanager
def assert_first_use(at_most: int = 0, *, match: Optional[str] = None):
    """Assert that the block does at most ``at_most`` pieces of first-use
    work (with ``match``: at most ``at_most`` kernel libraries whose names
    contain it; allocator segments have no name and are not counted then);
    raises :class:`RetraceError` naming them otherwise.
    ``assert_first_use(0)`` around a warmed-up loop is the steady-state
    contract."""
    with track_first_use() as log:
        yield log
    if match is not None:
        names = [name for name in log.names if match in name]
        if len(names) > at_most:
            raise RetraceError(
                f"expected at most {at_most} first use(s) matching {match!r}, observed {len(names)}: {names}"
            )
    elif log.count > at_most:
        raise RetraceError(
            f"expected at most {at_most} first use(s), observed {log.count}: {log.builds} kernel"
            f" librar{'y' if log.builds == 1 else 'ies'} built or loaded {log.names} and {log.segments} allocator"
            " segment(s)"
        )
