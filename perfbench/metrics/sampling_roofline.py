"""The sampling kernel's share of its roofline in the traced segment: the
bytes of the populations it wrote at 3.35 TB/s over its device time."""

from perfbench import roofline

KERNEL = "symmetric_gaussian_philox_kernel"


def read(summary):
    trace = summary.get("trace")
    if not trace:
        return None
    ops = [v for name, v in trace["device_ops"].items() if KERNEL in name]
    shapes = trace.get("sampling_shapes", [])
    count = sum(v["count"] for v in ops)
    if not shapes or count != len(shapes):
        return None
    seconds = sum(v["seconds"] for v in ops)
    nbytes = sum(roofline.sampling_bytes(n, length) for n, length in shapes)
    return roofline.roofline_share(seconds, nbytes=nbytes)
