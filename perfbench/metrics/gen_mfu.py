"""The whole step's share of the card's float32 peak (67 TFLOP/s): the
policy's operations per env step (two per multiply-add of the plain
policy's ``macs()``; for a factored population the low-rank path's,
``factored.py``, or None where that yardstick has no count) times the
window's env steps, over the window's wall time."""

from perfbench import roofline


def read(summary):
    if summary["window_s"] <= 0 or summary["env_steps"] <= 0 or summary["policy_flops_per_step"] is None:
        return None
    flops = summary["policy_flops_per_step"] * summary["env_steps"]
    return 100.0 * flops / summary["window_s"] / roofline.H100_SXM["float32_flops"]
