"""Host ms per control step in the contract's bookkeeping: the
``rollout.ctrl_step`` span's self time (less its policy, env step and host
waits): the refill's gate and gathers, the telemetry, the statistics'
update and the end poll's copy, over the traced segment's control
steps."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.rollout.ctrl_step.self_seconds")
