"""The yardstick's counts: published peaks of the card and the bytes each
kernel has to move (a policy's operations per env step are its plain
policy's ``macs()``, ``reference/policies.py``).

A roofline share is the least time the card could take for a kernel's work,
the larger of its operations at the peak rate and its bytes at the peak
bandwidth, over the time the kernel took. Each input byte is counted once as
read and each output byte once as written, whatever a kernel reads again or
counts on the side: that is the work any implementation of the operation
needs, so a share above 100% means the counts or the time are wrong.
"""

from __future__ import annotations

__all__ = [
    "H100_SXM",
    "ranking_bytes",
    "roofline_share",
    "sampling_bytes",
]

#: NVIDIA H100 SXM5 data sheet: dense rates, no sparsity, at the 700 W limit
H100_SXM = {
    "float32_flops": 67e12,
    "tf32_flops": 495e12,
    "bfloat16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}

_F32 = 4


def sampling_bytes(num_solutions: int, length: int) -> int:
    """The antithetic sampler: writes the ``(N, L)`` float32 population and
    reads ``mu``, ``sigma`` (``L`` float32 each) and the 16-byte seed."""
    return num_solutions * length * _F32 + 2 * length * _F32 + 16


def ranking_bytes(n: int) -> int:
    """Centered ranks of ``n`` float32 scores: reads ``n`` values and writes
    ``n`` float32 ranks. The kernel's n^2 comparisons are its own choice of
    algorithm, not the operation's work, and are not counted."""
    return 2 * n * _F32


def roofline_share(seconds: float, *, nbytes: float = 0.0, flops: float = 0.0, peak=H100_SXM) -> float:
    """Percent of the roofline: the least time for ``nbytes`` and ``flops``
    (float32) over the measured ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a measured time must be positive, got {seconds}")
    least = max(nbytes / peak["hbm_bytes_per_s"], flops / peak["float32_flops"])
    return 100.0 * least / seconds

