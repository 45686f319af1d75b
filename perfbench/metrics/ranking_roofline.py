"""The ranking kernel's share of its roofline in the traced segment: the
scores read and the ranks written at 3.35 TB/s over the device time of its
two kernels (count and finish)."""

from perfbench import roofline

KERNELS = ("centered_rank_count_kernel", "centered_rank_finish_kernel")


def read(summary):
    trace = summary.get("trace")
    if not trace:
        return None
    sizes = trace.get("ranking_sizes", [])
    count_calls = sum(v["count"] for name, v in trace["device_ops"].items() if KERNELS[0] in name)
    if not sizes or count_calls != len(sizes):
        return None
    seconds = sum(v["seconds"] for name, v in trace["device_ops"].items() if any(k in name for k in KERNELS))
    return roofline.roofline_share(seconds, nbytes=sum(roofline.ranking_bytes(n) for n in sizes))
