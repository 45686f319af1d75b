"""Tensor tools (counterpart of ``evotorch_tpu/tools``)."""

from .misc import modify_tensor, modify_vector, stdev_from_radius
from .ranking import centered, linear, nes, normalized, rank, rankers, raw

__all__ = [
    "centered",
    "linear",
    "modify_tensor",
    "modify_vector",
    "nes",
    "normalized",
    "rank",
    "rankers",
    "raw",
    "stdev_from_radius",
]
