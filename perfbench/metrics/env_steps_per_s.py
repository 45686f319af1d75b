"""Env steps per second: the interactions counted over every round of the
window, over the window's wall time."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return summary["env_steps"] / summary["window_s"]
