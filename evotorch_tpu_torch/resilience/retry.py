"""Bounded exponential-backoff retry for fragile host-side operations
(counterpart of ``evotorch_tpu/resilience/retry.py``).

The device programs are deterministic; the host edges around them (the
process-group rendezvous, the tuned-config cache and timing ledger writes,
MetricsHub writes) fail for transient reasons: a store still binding its
port, a filesystem blip. :func:`retry_call` wraps them alike:

- bounded attempts with exponential backoff (deterministic delays, no
  jitter; host sleeps, never on the device path);
- counters in :mod:`~evotorch_tpu_torch.observability.registry`:
  ``retry.<site>.attempts`` / ``.retries`` / ``.giveups``;
- a ``retry:<site>`` span on the host tracer around each backoff sleep;
- a :func:`~evotorch_tpu_torch.resilience.faults.fault_point` at every
  attempt, so ``EVOTORCH_FAULTS="<site>:raise@1"`` drives the retry path
  and ``...@1+`` past ``retries`` the give-up path.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Tuple, Type

from ..observability import tracer
from ..observability.registry import counters
from .faults import fault_point

__all__ = ["retry_call", "retryable"]


def retry_call(
    fn: Callable,
    *args,
    site: str,
    retries: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """``fn(*args, **kwargs)`` with up to ``retries`` retries.

    ``exceptions`` is the retryable set (default ``OSError``, which covers
    :class:`~evotorch_tpu_torch.resilience.faults.InjectedFault`); any other
    exception propagates at once. ``on_retry(attempt, exc)`` runs before
    each backoff sleep. The delay starts at ``base_delay`` and doubles up
    to ``max_delay``. The last failure is raised unchanged."""
    attempts = int(retries) + 1
    delay = float(base_delay)
    for attempt in range(1, attempts + 1):
        counters.increment(f"retry.{site}.attempts")
        try:
            fault_point(site)
            return fn(*args, **kwargs)
        except exceptions as exc:
            if attempt >= attempts:
                counters.increment(f"retry.{site}.giveups")
                raise
            counters.increment(f"retry.{site}.retries")
            if on_retry is not None:
                on_retry(attempt, exc)
            with tracer.span(f"retry:{site}", cat="resilience", attempt=attempt, error=type(exc).__name__):
                time.sleep(delay)
            delay = min(delay * 2.0, float(max_delay))
    raise AssertionError("unreachable")


def retryable(
    *,
    site: str,
    retries: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
):
    """Decorator form of :func:`retry_call` for fixed call sites."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(
                fn, *args, site=site, retries=retries, base_delay=base_delay, max_delay=max_delay,
                exceptions=exceptions, **kwargs,
            )  # fmt: skip

        return wrapped

    return deco
