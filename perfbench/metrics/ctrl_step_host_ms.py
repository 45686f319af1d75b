"""Host ms per control step from inside the program: the
``rollout.ctrl_step`` span (one step as the host issues it, its end poll
included) over the traced segment. Traced runs only: the profiler slows
the host, so it compares with no untraced ``ctrl_step_ms``."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.rollout.ctrl_step.seconds")
