"""Small tensor helpers, the counterparts of ``evotorch_tpu/tools/misc.py``."""

from __future__ import annotations

import math
from numbers import Number
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = [
    "ensure_tensor_length_and_dtype",
    "is_dtype_object",
    "modify_tensor",
    "modify_vector",
    "stdev_from_radius",
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


def is_dtype_object(dtype: Any) -> bool:
    return dtype is object or dtype == "object"


def to_torch_dtype(dtype: Any) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, its name (``"float32"``,
    ``"torch.bfloat16"``), a numpy dtype or a Python type. ``object`` has no
    torch dtype: object-typed problems are not ported yet."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if is_dtype_object(dtype):
        raise NotImplementedError(
            "object-typed problems are not ported to evotorch_tpu_torch yet (ROADMAP.md, item A.13, ObjectArray)"
        )
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


def ensure_tensor_length_and_dtype(
    x: Any, length: int, dtype: torch.dtype, *, device, about: Optional[str] = None, allow_scalar: bool = True
) -> torch.Tensor:
    """``x`` as a 1-D tensor of ``length`` with ``dtype`` on ``device``;
    a scalar is broadcast unless ``allow_scalar`` is False."""
    dtype = to_torch_dtype(dtype)
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
