"""Fault tolerance (counterpart of ``evotorch_tpu/resilience``):

- :mod:`~evotorch_tpu_torch.resilience.runstate`: durable, self-verifying
  run checkpoint bundles (atomic writes, keep-last-K retention, fallback
  past a corrupt bundle); a resumed run replays the uninterrupted one bit
  for bit, since a searcher's pickle holds its generators' states;
- :mod:`~evotorch_tpu_torch.resilience.retry`: bounded-backoff retries
  around the fragile host edges (the rendezvous, cache and metrics writes);
- :mod:`~evotorch_tpu_torch.resilience.watchdog`: the first-device-use
  watchdog, which turns a hanging card into an error and a missing one,
  where a card is required, too;
- :mod:`~evotorch_tpu_torch.resilience.faults`: the deterministic
  ``EVOTORCH_FAULTS`` injection harness that keeps every recovery path
  exercised by tests.

The non-finite score quarantine lives in the eval engines
(``net/vecrl.py:_quarantine_nonfinite``)."""

from .faults import FaultRule, InjectedFault, active_spec, configure, fault_point, parse_spec
from .retry import retry_call, retryable
from .runstate import BUNDLE_SCHEMA_VERSION, CorruptBundleError, RunCheckpointer
from .watchdog import DeviceProbeTimeout, probe_devices

__all__ = [
    "BUNDLE_SCHEMA_VERSION",
    "CorruptBundleError",
    "DeviceProbeTimeout",
    "FaultRule",
    "InjectedFault",
    "RunCheckpointer",
    "active_spec",
    "configure",
    "fault_point",
    "parse_spec",
    "probe_devices",
    "retry_call",
    "retryable",
]
