"""The kernel-build cache and its hit and miss counts (counterpart of
``evotorch_tpu/observability/compilecache.py``).

The JAX module wires XLA's persistent compilation cache and counts its
hits and misses. The port compiles no programs; its nearest thing is the
build directory of ``ops/_build.py``: each CUDA source is built once by
``nvcc`` into ``build/kernels/``, under a name hashed from its source and
flags, and reused from there by every later process. That cache is always
on, so the JAX ``enable_persistent_cache()`` has no counterpart.

``_build`` reports every library here: a **miss** is an ``nvcc`` run, a
**hit** a library loaded from the build directory that this process did
not build. Each is counted on the counter registry, as
``compilecache.misses`` or ``compilecache.hits``, and reported to the
first-use sentinel of :mod:`~evotorch_tpu_torch.analysis.retrace_sentinel`,
whose permanent sinks count it as one of ``compiles`` with its seconds in
``compile_seconds`` (the per-step deltas ``SearchAlgorithm.step``
publishes, and the builds the sentinel's tracking blocks count).
"""

from __future__ import annotations

from typing import Dict

from .registry import counters

__all__ = ["cache_stats", "record_load", "reset_stats"]

_KEYS = ("compilecache.hits", "compilecache.misses", "compile_seconds")
_since: Dict[str, float] = counters.snapshot(_KEYS)


def record_load(*, built: bool, seconds: float, name: str = "kernel") -> None:
    """Count one kernel library ``name``: built by ``nvcc`` (a miss) or
    loaded from the build directory (a hit), taking ``seconds``."""
    from ..analysis.retrace_sentinel import record_first_use
    from .registry import ensure_compile_counter, ensure_compile_timer

    ensure_compile_counter()
    ensure_compile_timer()
    counters.increment("compilecache.misses" if built else "compilecache.hits")
    record_first_use(name, float(seconds))


def cache_stats() -> Dict[str, object]:
    """Hits, misses and their seconds in this process since the last
    :func:`reset_stats`."""
    delta = counters.delta(_since)
    return {
        "hits": int(delta["compilecache.hits"]),
        "misses": int(delta["compilecache.misses"]),
        "seconds": delta["compile_seconds"],
    }


def reset_stats() -> None:
    global _since
    _since = counters.snapshot(_KEYS)
