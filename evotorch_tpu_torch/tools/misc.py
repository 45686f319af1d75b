"""Small tensor helpers, the counterparts of ``evotorch_tpu/tools/misc.py``."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

__all__ = ["modify_tensor", "modify_vector", "stdev_from_radius"]

Bound = Optional[Union[float, torch.Tensor]]


def _like(x: Bound, ref: torch.Tensor) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def modify_tensor(
    original: torch.Tensor,
    target: torch.Tensor,
    lb: Bound = None,
    ub: Bound = None,
    max_change: Bound = None,
) -> torch.Tensor:
    """Move ``original`` towards ``target``: ``max_change`` limits each
    element's change relative to ``|original|`` (0.2 allows 20%), and
    ``lb``/``ub`` are absolute clamps. Returns a new tensor."""
    target = target.to(original.dtype)
    result = target
    if max_change is not None:
        allowed = torch.abs(original) * _like(max_change, original)
        result = original + torch.clamp(target - original, -allowed, allowed)
    if lb is not None:
        result = torch.maximum(result, _like(lb, original))
    if ub is not None:
        result = torch.minimum(result, _like(ub, original))
    return result


def modify_vector(original, target, lb: Bound = None, ub: Bound = None, max_change: Bound = None) -> torch.Tensor:
    """1-D counterpart of :func:`modify_tensor`."""
    return modify_tensor(original, target, lb=lb, ub=ub, max_change=max_change)


def stdev_from_radius(radius: float, solution_length: int) -> float:
    """Initial stdev from a hypersphere radius: ``radius / sqrt(n)``."""
    return float(radius) / math.sqrt(solution_length)
