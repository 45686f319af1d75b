"""Fairness policies of the evaluation service's slab packer (counterpart
of ``evotorch_tpu/serving/admission.py``, host-side and ported whole).

An :class:`AdmissionPolicy` answers one question per dispatch: in what
order do the tenants with pending work get lanes? The packer walks that
order, taking each tenant's queued items first in, first out, until the
slab is full: the policy sets the fairness between tenants, and a tenant's
own requests keep their submission order.

The starvation-aware policy reads the per-group queue-wait histograms the
refill engine accumulates on the device (``GroupTelemetry.hist``), which
the server reads with each dispatch's scores at no extra sync.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = [
    "AdmissionPolicy",
    "FIFOAdmission",
    "StarvationAwareAdmission",
]


class AdmissionPolicy:
    """Base interface: order tenants for one packing round."""

    def order(self, tenants: Sequence, server) -> List:
        """Return ``tenants`` (those with pending items, pre-filtered by the
        server: admitted, not suspended) in service order — first gets
        lanes first."""
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__ + "()"


class FIFOAdmission(AdmissionPolicy):
    """Serve the tenant whose OLDEST pending request was submitted first.

    Ties (same submit dispatch) break by admission order. With a single
    tenant this degenerates to plain FIFO over its requests, which is the
    standalone-equivalent schedule the bit-identity tests rely on."""

    def order(self, tenants: Sequence, server) -> List:
        return sorted(
            tenants,
            key=lambda t: (t.oldest_pending_dispatch(), t.group),
        )


class StarvationAwareAdmission(AdmissionPolicy):
    """Weighted fairness off the on-device queue-wait histograms.

    Each tenant's priority is its cumulative *starvation share* — the
    fraction of its refilled items that waited in the histogram's overflow
    bucket (>= 64 loop steps; the same figure the ``starvation_share`` SLO
    rule gates on) — tie-broken by tail wait (p99) and then FIFO order. A
    tenant that has been repeatedly out-packed accumulates overflow-bucket
    mass and floats to the front of the next rounds until its tail
    recovers; tenants with no histogrammed waits yet rank by FIFO.

    ``bias`` (default 0) adds a constant to every NEW tenant's priority so
    fresh admissions are not starved by incumbents' clean histories.
    """

    def __init__(self, *, bias: float = 0.0):
        self.bias = float(bias)

    def order(self, tenants: Sequence, server) -> List:
        def priority(t):
            gt = t.telemetry
            if gt is None:
                starvation, tail = self.bias, 0.0
            else:
                starvation = gt.starvation_share()
                tail = gt.queue_wait_quantile(0.99)
            # descending starvation/tail, ascending FIFO key
            return (-starvation, -tail, t.oldest_pending_dispatch(), t.group)

        return sorted(tenants, key=priority)

    def __repr__(self):
        return f"StarvationAwareAdmission(bias={self.bias})"


def resolve_policy(policy) -> AdmissionPolicy:
    """Coerce a policy spec: an instance passes through; None = FIFO; the
    strings "fifo" / "starvation" name the built-ins."""
    if policy is None:
        return FIFOAdmission()
    if isinstance(policy, AdmissionPolicy):
        return policy
    if isinstance(policy, str):
        name = policy.lower()
        if name == "fifo":
            return FIFOAdmission()
        if name in ("starvation", "starvation_aware"):
            return StarvationAwareAdmission()
        raise ValueError(f"unknown admission policy {policy!r}")
    raise TypeError(
        f"admission policy must be an AdmissionPolicy, a name or None,"
        f" got {type(policy).__name__}"
    )
