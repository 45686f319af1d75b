"""Host ms per control step in the policy: the ``rollout.policy`` span
(normalization, the dtype casts, the forward, the action clip), per span
counted in the traced segment (one a control step)."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.rollout.policy.seconds", "span.rollout.policy.count")
