"""Host ms per control step in the rigid-body substeps: the
``env.physics`` span (all of one control step's substeps), per span
counted in the traced segment (one a control step). ``env_host_ms`` less
this is the observation, the reward and the clamp."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.env.physics.seconds", "span.env.physics.count")
