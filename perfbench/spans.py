"""The program's own span counters, read per control step.

``evotorch_tpu_torch.observability.tracer.span`` adds to
``span.<name>.count``, ``.seconds`` (host seconds, child spans included)
and ``.self_seconds`` (less its direct child spans) of the process's
counter registry while a torch profiler records. In a ``--trace 1`` run
the harness's profiler is the only one, over the traced segment, so the
totals read after the run are that segment's. The span in which the
harness stops its profiler (the segment's last control step and env
step) is left out by the program, so each span's seconds are divided by
its own count. A program without these spans leaves the keys at 0, and
every reading is then None.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["per_step_ms"]

CTRL_STEPS = "span.rollout.ctrl_step.count"


def per_step_ms(key: str, per: str = CTRL_STEPS) -> Optional[float]:
    """The counter ``key`` (seconds) in ms per count of ``per`` (a span
    that runs once a control step), in this process; None where no
    control step, or no such span, was counted."""
    from evotorch_tpu_torch.observability import counters

    values = counters.snapshot((CTRL_STEPS, per, key))
    if not values[CTRL_STEPS] or not values[per]:
        return None
    return 1000.0 * values[key] / values[per]
