"""Counted env steps over the lane-step slots paid for (the program's
telemetry counters, summed over the window's rounds)."""


def read(summary):
    if summary["telemetry_capacity"] <= 0:
        return None
    return summary["telemetry_env_steps"] / summary["telemetry_capacity"]
