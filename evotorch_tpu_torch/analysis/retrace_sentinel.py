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
the sum of both; :func:`assert_first_use` raises :class:`RetraceError`
when it exceeds a budget. Both nest and are thread-safe: each block reads
the two process-wide counts at its own entry and exit, so every active
block sees every first use made while it is open, from any thread.

Usage::

    with track_first_use() as log:
        generation(state, generator, stats)
    assert log.count == 0            # warm: nothing built, nothing allocated

    with assert_first_use(0):        # raises RetraceError otherwise
        generation(state, generator, stats)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

from ..observability.registry import counters

__all__ = ["FirstUseLog", "RetraceError", "assert_first_use", "track_first_use"]


class RetraceError(AssertionError):
    """Raised by :func:`assert_first_use` when a region did more first-use
    work than its budget."""


@dataclass
class FirstUseLog:
    """The first-use work seen inside one tracking block, known when the
    block exits: the kernel libraries built or loaded (``builds``) and the
    allocator segments allocated on the card (``segments``)."""

    builds: int = 0
    segments: int = 0

    @property
    def count(self) -> int:
        return self.builds + self.segments


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


@contextlib.contextmanager
def track_first_use():
    """Context manager yielding a :class:`FirstUseLog` of the first-use work
    done inside the block (see the module note). Nestable and
    thread-safe."""
    log = FirstUseLog()
    builds, segments = counters.get("compiles"), _segments_allocated()
    try:
        yield log
    finally:
        log.builds = counters.get("compiles") - builds
        log.segments = _segments_allocated() - segments


@contextlib.contextmanager
def assert_first_use(at_most: int = 0):
    """Assert that the block does at most ``at_most`` pieces of first-use
    work; raises :class:`RetraceError` naming them otherwise.
    ``assert_first_use(0)`` around a warmed-up loop is the steady-state
    contract."""
    with track_first_use() as log:
        yield log
    if log.count > at_most:
        raise RetraceError(
            f"expected at most {at_most} first use(s), observed {log.count}: {log.builds} kernel"
            f" librar{'y' if log.builds == 1 else 'ies'} built or loaded and {log.segments} allocator segment(s)"
        )
