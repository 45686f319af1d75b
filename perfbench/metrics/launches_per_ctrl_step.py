"""Kernel launches per control step in the traced segment: the CUDA runtime
launch calls between the first and the last control-step stamp, over the
whole steps between them."""


def read(summary):
    trace = summary.get("trace")
    if not trace or trace["ctrl_steps"] <= 0 or trace["ctrl_step_launches"] <= 0:
        return None
    return trace["ctrl_step_launches"] / trace["ctrl_steps"]
