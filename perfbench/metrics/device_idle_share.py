"""Percent of the traced segment in which no operation ran on the device:
1 - the union of the device's intervals over the segment."""


def read(summary):
    trace = summary.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
