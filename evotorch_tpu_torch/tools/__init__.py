"""Tensor tools (counterpart of ``evotorch_tpu/tools``)."""

from .cloning import Clonable, ReadOnlyClonable, Serializable, deep_clone
from .constraints import log_barrier, penalty, violation
from .hook import Hook
from .immutable import (
    ImmutableContainer,
    ImmutableDict,
    ImmutableList,
    ImmutableSet,
    as_immutable,
    is_immutable,
    mutable_copy,
)
from .lazyreporter import LazyReporter, LazyStatusDict
from .lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch, is_factored
from .misc import (
    ErroneousResult,
    cast_arrays_in_container,
    clip_tensor,
    dtype_of_container,
    ensure_tensor_length_and_dtype,
    is_dtype_bool,
    is_dtype_float,
    is_dtype_integer,
    is_dtype_object,
    is_dtype_real,
    modify_tensor,
    modify_vector,
    split_workload,
    stdev_from_radius,
    to_numpy_dtype,
    to_stdev_init,
    to_torch_dtype,
)
from .objectarray import ObjectArray
from .ranking import centered, linear, nes, normalized, rank, rankers, raw
from .readonlytensor import ReadOnlyTensor, as_read_only_tensor, read_only_tensor
from .recursiveprintable import RecursivePrintable
from .tensormaker import TensorMakerMixin

__all__ = [
    "Clonable",
    "ErroneousResult",
    "Hook",
    "ImmutableContainer",
    "ImmutableDict",
    "ImmutableList",
    "ImmutableSet",
    "LazyReporter",
    "LazyStatusDict",
    "LowRankParamsBatch",
    "ObjectArray",
    "ReadOnlyClonable",
    "ReadOnlyTensor",
    "RecursivePrintable",
    "Serializable",
    "TensorMakerMixin",
    "TrunkDeltaParamsBatch",
    "as_immutable",
    "as_read_only_tensor",
    "cast_arrays_in_container",
    "centered",
    "clip_tensor",
    "deep_clone",
    "dtype_of_container",
    "ensure_tensor_length_and_dtype",
    "is_dtype_bool",
    "is_dtype_float",
    "is_dtype_integer",
    "is_dtype_object",
    "is_dtype_real",
    "is_factored",
    "is_immutable",
    "linear",
    "log_barrier",
    "modify_tensor",
    "modify_vector",
    "mutable_copy",
    "nes",
    "normalized",
    "penalty",
    "rank",
    "rankers",
    "raw",
    "read_only_tensor",
    "split_workload",
    "stdev_from_radius",
    "to_numpy_dtype",
    "to_stdev_init",
    "to_torch_dtype",
    "violation",
]
