"""Host ms per control step in the env's step: the ``rollout.env_step``
span (the call of ``env.batch_step``: physics, observation, reward), per
span counted in the traced segment (one a control step)."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.rollout.env_step.seconds", "span.rollout.env_step.count")
