"""Request and future plumbing of the evaluation service (counterpart of
``evotorch_tpu/serving/requests.py``).

One :class:`EvalRequest` is one tenant's "evaluate these ``n`` solutions"
call. The server slices it into per-solution items, packs items of many
requests into fixed-width ``episodes_refill`` slabs, and assembles each
request's scores as its items finish, over as many dispatches as packing
needs. The client holds the :class:`EvalFuture`, whose ``result()`` drives
the owning server until the request is complete: the in-process server has
no thread of its own, so waiting is serving.

The port keeps a request's parameter matrix on the server's device from
``submit`` on, with the random table rows the request drew there from its
own generator (``vecrl.SolutionTables``, one row per solution); packing
copies slices of both into the slab.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = ["EvalFuture", "EvalRequest"]


class EvalRequest:
    """One tenant's pending evaluation: an ``(n, P)`` parameter matrix on
    the device, its per-solution random tables and the assembly buffers
    the packer fills as items complete. Internal to the server; clients
    hold ``request.future``."""

    def __init__(self, request_id: int, tenant, values, tables, server):
        self.request_id = int(request_id)
        self.tenant = tenant
        self.values = values  # (n, P) on the server's device
        self.tables = tables  # vecrl.SolutionTables, row i for solution i
        self.num_solutions = int(values.shape[0])
        self.next_item = 0  # first solution not yet packed
        self.pending_items = self.num_solutions  # packed but unfinished, or unpacked
        self.scores = values.new_full((self.num_solutions,), float("nan"))  # on the device, filled by slice copies
        self.telemetry = None  # the tenant rows accumulated over this request's dispatches
        self.submit_dispatch = None  # the server's dispatch count at submit
        self.future = EvalFuture(self, server)

    @property
    def done(self) -> bool:
        return self.pending_items == 0

    def take_items(self, k: int) -> range:
        """Claim the next ``k`` (at most) unpacked solutions."""
        start = self.next_item
        stop = min(start + int(k), self.num_solutions)
        self.next_item = stop
        return range(start, stop)


class EvalFuture:
    """Handle on a submitted evaluation. ``done()`` is a cheap poll;
    ``result()`` drives the owning server's dispatches until this request
    completes and returns a ``RolloutResult`` (scores, the tenant's
    statistics, counters, its telemetry wire), what ``RemoteEvalBackend``
    hands an unmodified ``VecNE``. ``result()`` may run other tenants'
    items too: they share the slabs."""

    def __init__(self, request: EvalRequest, server):
        self._request = request
        self._server = server
        self._lock = threading.Lock()
        self._result: Optional[Any] = None
        self._error: Optional[BaseException] = None

    @property
    def request_id(self) -> int:
        return self._request.request_id

    @property
    def tenant(self):
        return self._request.tenant

    def done(self) -> bool:
        with self._lock:
            return self._result is not None or self._error is not None

    def set_result(self, result) -> None:
        with self._lock:
            self._result = result

    def set_error(self, error: BaseException) -> None:
        with self._lock:
            self._error = error

    def result(self, *, max_dispatches: Optional[int] = None):
        """Drive the server until this request is complete and return its
        record; ``max_dispatches`` bounds the dispatches this call runs
        (None: until done)."""
        dispatched = 0
        while not self.done():
            served = self._server.step()
            dispatched += 1
            if served == 0 and not self.done():
                raise RuntimeError(
                    f"request {self.request_id} cannot complete: the server has no pending work for it (was its tenant departed?)"
                )
            if max_dispatches is not None and dispatched >= max_dispatches:
                break
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._result is None:
                raise TimeoutError(f"request {self.request_id} still pending after {dispatched} dispatches")
            return self._result
