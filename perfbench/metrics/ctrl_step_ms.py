"""Milliseconds of evaluation wall time per control step: the time inside
``problem.evaluate`` over the control steps the telemetry counts, summed
over the window's rounds."""


def read(summary):
    steps = summary.get("ctrl_steps")
    if not steps:
        return None
    return 1000.0 * summary["eval_s"] / steps
