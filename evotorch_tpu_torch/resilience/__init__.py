"""Fault tolerance (counterpart of ``evotorch_tpu/resilience``): so far the
deterministic ``EVOTORCH_FAULTS`` injection harness
(:mod:`~evotorch_tpu_torch.resilience.faults`), which keeps the recovery
paths exercised by tests. The non-finite score quarantine lives in the eval
engines (``net/vecrl.py:_quarantine_nonfinite``). The durable run
checkpoints, retries and the device watchdog belong to ``ROADMAP.md`` item
A.12."""

from .faults import FaultRule, InjectedFault, active_spec, configure, fault_point, parse_spec

__all__ = ["FaultRule", "InjectedFault", "active_spec", "configure", "fault_point", "parse_spec"]
