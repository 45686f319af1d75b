"""Tensor tools (counterpart of ``evotorch_tpu/tools``)."""

from .cloning import Serializable, deep_clone
from .hook import Hook
from .lazyreporter import LazyReporter, LazyStatusDict
from .lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch, is_factored
from .misc import ensure_tensor_length_and_dtype, modify_tensor, modify_vector, stdev_from_radius, to_stdev_init
from .ranking import centered, linear, nes, normalized, rank, rankers, raw
from .recursiveprintable import RecursivePrintable
from .tensormaker import TensorMakerMixin

__all__ = [
    "Hook",
    "LazyReporter",
    "LazyStatusDict",
    "LowRankParamsBatch",
    "RecursivePrintable",
    "Serializable",
    "TensorMakerMixin",
    "TrunkDeltaParamsBatch",
    "centered",
    "deep_clone",
    "ensure_tensor_length_and_dtype",
    "is_factored",
    "linear",
    "modify_tensor",
    "modify_vector",
    "nes",
    "normalized",
    "rank",
    "rankers",
    "raw",
    "stdev_from_radius",
    "to_stdev_init",
]
