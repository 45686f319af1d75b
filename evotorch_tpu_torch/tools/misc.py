"""Small tensor helpers, the counterparts of ``evotorch_tpu/tools/misc.py``.

``object`` passes through the dtype helpers as it is: object-typed problems
hold their values on the host (``tools/objectarray.py``).
"""

from __future__ import annotations

import logging
import math
import os
from numbers import Number
from typing import Any, List, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "DType",
    "Device",
    "ErroneousResult",
    "cast_arrays_in_container",
    "clip_tensor",
    "clone",
    "dtype_of_container",
    "ensure_tensor_length_and_dtype",
    "expect_none",
    "is_dtype_bool",
    "is_dtype_float",
    "is_dtype_integer",
    "is_dtype_object",
    "is_dtype_real",
    "message_from",
    "modify_tensor",
    "modify_vector",
    "pass_through",
    "set_default_logger_config",
    "split_workload",
    "stack_trees",
    "stdev_from_radius",
    "to_numpy_dtype",
    "to_stdev_init",
    "to_torch_dtype",
]

_DTYPE_ALIASES = {
    "float": torch.float32,
    "float32": torch.float32,
    "float64": torch.float64,
    "double": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "half": torch.float16,
    "int": torch.int64,
    "int32": torch.int32,
    "int64": torch.int64,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

#: what the helpers below accept as a device: a ``torch.device`` or its name
Device = Union[str, torch.device]
#: what they accept as a dtype: a ``torch.dtype``, its name, a numpy dtype or
#: a Python type (``object`` for object-typed problems)
DType = Union[str, torch.dtype, np.dtype, type]


def is_dtype_object(dtype: Any) -> bool:
    if isinstance(dtype, torch.dtype):
        return False
    return dtype is object or dtype == "object" or (isinstance(dtype, np.dtype) and dtype == np.dtype(object))


def to_torch_dtype(dtype: Any) -> Union[torch.dtype, type]:
    """A ``torch.dtype`` from a torch dtype, its name (``"float32"``,
    ``"torch.bfloat16"``), a numpy dtype or a Python type. ``object`` has no
    torch dtype and is returned as it is."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if is_dtype_object(dtype):
        return object
    if isinstance(dtype, str):
        key = dtype.replace("torch.", "").replace("jnp.", "").replace("np.", "")
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"Unknown dtype {dtype!r}")
    if dtype is float:
        return torch.float32
    if dtype is int:
        return torch.int64
    if dtype is bool:
        return torch.bool
    return _DTYPE_ALIASES[np.dtype(dtype).name]


def to_numpy_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype of a dtype-like (``object`` included). bfloat16 has
    no numpy dtype."""
    d = to_torch_dtype(dtype)
    if d is object:
        return np.dtype(object)
    try:
        return np.dtype(str(d).replace("torch.", ""))
    except TypeError:
        raise ValueError(f"{d} has no numpy dtype") from None


def is_dtype_bool(dtype: Any) -> bool:
    return to_torch_dtype(dtype) is torch.bool


def is_dtype_integer(dtype: Any) -> bool:
    d = to_torch_dtype(dtype)
    return d is not object and d is not torch.bool and not d.is_floating_point and not d.is_complex


def is_dtype_float(dtype: Any) -> bool:
    d = to_torch_dtype(dtype)
    return d is not object and d.is_floating_point


def is_dtype_real(dtype: Any) -> bool:
    return is_dtype_float(dtype) or is_dtype_integer(dtype)


def cast_arrays_in_container(container: Any, *, dtype: Any = None, device: Any = None) -> Any:
    """Every tensor and numpy array of a container (dicts, lists, tuples,
    named tuples) as a tensor of ``dtype`` on ``device`` (each kept where
    None); other leaves stay as they are."""
    d = None if dtype is None else to_torch_dtype(dtype)

    def cast(leaf):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(leaf, dtype=d, device=device)
        return leaf

    return tree_map(cast, container)


def dtype_of_container(container: Any):
    """The one dtype of a container's array leaves (None without any); more
    than one raises."""
    leaves = [leaf for leaf in tree_leaves(container) if hasattr(leaf, "dtype")]
    if not leaves:
        return None
    dtypes = {leaf.dtype for leaf in leaves}
    if len(dtypes) > 1:
        raise ValueError(f"Container has multiple dtypes: {dtypes}")
    return leaves[0].dtype


def clone(x: Any, *, memo: Optional[dict] = None) -> Any:
    """A deep copy of ``x`` that shares no storage with it: tensors are
    copied (torch tensors are mutable, unlike the JAX arrays the JAX
    package's ``clone`` returns as they are), numpy arrays too, generators
    get a twin in the same state, ``Clonable`` objects (``SolutionBatch``,
    ``ObjectArray``) clone themselves, and containers recurse."""
    from .cloning import deep_clone

    return deep_clone(x, memo=memo)


def ensure_tensor_length_and_dtype(
    x: Any, length: int, dtype: torch.dtype, *, device, about: Optional[str] = None, allow_scalar: bool = True
) -> torch.Tensor:
    """``x`` as a 1-D tensor of ``length`` with ``dtype`` on ``device``;
    a scalar is broadcast unless ``allow_scalar`` is False. For
    ``dtype=object``, an ``ObjectArray`` on the host (a string, a mapping or
    a non-iterable counts as one object)."""
    dtype = to_torch_dtype(dtype)
    if dtype is object:
        return _object_array_of_length(x, length, about=about, allow_scalar=allow_scalar)
    if isinstance(x, Number):
        if not allow_scalar:
            raise ValueError(f"{about or 'value'}: expected a sequence, got scalar {x}")
        return torch.full((length,), x, dtype=dtype, device=device)
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, dtype=dtype, device=device)
    if t.ndim == 0:
        if not allow_scalar:
            raise ValueError(f"{about or 'value'}: expected a sequence, got a scalar")
        return t.expand(length).clone()
    if t.ndim != 1 or t.shape[0] != length:
        raise ValueError(f"{about or 'value'}: expected shape ({length},), got {tuple(t.shape)}")
    return t

Bound = Optional[Union[float, torch.Tensor]]


def _like(x: Bound, ref: torch.Tensor) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def modify_tensor(
    original: torch.Tensor,
    target: torch.Tensor,
    lb: Bound = None,
    ub: Bound = None,
    max_change: Bound = None,
    *,
    in_place: bool = False,
) -> torch.Tensor:
    """Move ``original`` towards ``target``: ``max_change`` limits each
    element's change relative to ``|original|`` (0.2 allows 20%), and
    ``lb``/``ub`` are absolute clamps. Returns a new tensor, or, with
    ``in_place``, ``original`` holding the result."""
    target = target.to(original.dtype)
    result = target
    if max_change is not None:
        allowed = torch.abs(original) * _like(max_change, original)
        result = original + torch.clamp(target - original, -allowed, allowed)
    if lb is not None:
        result = torch.maximum(result, _like(lb, original))
    if ub is not None:
        result = torch.minimum(result, _like(ub, original))
    return original.copy_(result) if in_place else result


def modify_vector(original, target, lb: Bound = None, ub: Bound = None, max_change: Bound = None) -> torch.Tensor:
    """1-D counterpart of :func:`modify_tensor`."""
    return modify_tensor(original, target, lb=lb, ub=ub, max_change=max_change)


def stdev_from_radius(radius: float, solution_length: int) -> float:
    """Initial stdev from a hypersphere radius: ``radius / sqrt(n)``."""
    return float(radius) / math.sqrt(solution_length)


def to_stdev_init(*, solution_length: int, stdev_init=None, radius_init=None):
    """Resolve the ``stdev_init`` / ``radius_init`` constructor pair:
    exactly one must be given."""
    if (stdev_init is None) == (radius_init is None):
        raise ValueError("Exactly one of stdev_init / radius_init must be provided")
    if stdev_init is not None:
        return stdev_init
    return stdev_from_radius(float(radius_init), solution_length)


def _object_array_of_length(x: Any, length: int, *, about: Optional[str], allow_scalar: bool):
    from collections.abc import Mapping

    from .objectarray import ObjectArray

    what = about or "value"
    if isinstance(x, ObjectArray):
        if len(x) != length:
            raise ValueError(f"{what}: expected length {length}, got {len(x)}")
        return x
    if isinstance(x, (str, bytes, Mapping)) or not hasattr(x, "__iter__"):
        if not allow_scalar and length != 1:
            raise ValueError(f"{what}: expected a sequence, got {x!r}")
        values = [x] * length
    else:
        values = list(x)
        if len(values) == 1 and length != 1 and allow_scalar:
            values = values * length
    if len(values) != length:
        raise ValueError(f"{what}: expected length {length}, got {len(values)}")
    return ObjectArray.from_values(values)


def clip_tensor(x: torch.Tensor, lb: Bound = None, ub: Bound = None) -> torch.Tensor:
    """``x`` clamped into ``[lb, ub]`` (either may be None)."""
    x = torch.as_tensor(x)
    if lb is not None:
        x = torch.maximum(x, _like(lb, x))
    if ub is not None:
        x = torch.minimum(x, _like(ub, x))
    return x


def stack_trees(items: list):
    """Equal pytrees of tensors (dicts, lists, tuples, named tuples) as one
    pytree of their leaves stacked along a new first axis."""
    flats = [tree_flatten(item) for item in items]
    stacked = [torch.stack(list(column)) for column in zip(*(flat for flat, _ in flats))]
    return tree_unflatten(stacked, flats[0][1])


def split_workload(workload: int, num_pieces: int) -> List[int]:
    """``workload`` items split into ``num_pieces`` near-equal pieces, the
    larger ones first."""
    base, rem = divmod(int(workload), int(num_pieces))
    return [base + (1 if i < rem else 0) for i in range(int(num_pieces))]


class ErroneousResult:
    """A value that stands for a failure: false in a boolean context."""

    def __init__(self, error: Exception):
        self.error = error

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"<ErroneousResult: {self.error!r}>"

    @staticmethod
    def call(f, *args, **kwargs):
        """``f(*args, **kwargs)``, or an ``ErroneousResult`` of what it raised."""
        try:
            return f(*args, **kwargs)
        except Exception as e:  # noqa: BLE001  # graftlint: allow(swallow): the failure is the value, an ErroneousResult
            return ErroneousResult(e)


def pass_through(x):
    return x


def expect_none(msg_prefix: str, **kwargs):
    """Raise if any of the keyword arguments is not None."""
    for k, v in kwargs.items():
        if v is not None:
            raise ValueError(f"{msg_prefix}: unexpected argument {k}={v!r}")


def message_from(sender: Any, message: str) -> str:
    return f"[{type(sender).__name__}] {message}"


def set_default_logger_config(level: Optional[Union[int, str]] = None) -> logging.Logger:
    """Configure the ``evotorch_tpu_torch`` logging channel: ``level``, else
    ``EVOTORCH_TPU_VERBOSE_LEVEL`` (default ``INFO``), and one stream
    handler unless it has one."""
    logger = logging.getLogger("evotorch_tpu_torch")
    if level is None:
        level = os.environ.get("EVOTORCH_TPU_VERBOSE_LEVEL", "INFO")
    if isinstance(level, str) and level.isdigit():
        level = int(level)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(levelname)s <%(name)s> %(message)s"))
        logger.addHandler(handler)
    return logger
