"""Constraint penalties (counterpart of ``evotorch_tpu/tools/constraints.py``):
``violation``, ``log_barrier`` and ``penalty``. Every argument may be a
number or a tensor; they broadcast elementwise, so extra leading dimensions
are batch dimensions (where the JAX package vmaps its row functions)."""

from __future__ import annotations

import torch

__all__ = ["violation", "log_barrier", "penalty"]

_COMPARISONS = ("<=", ">=", "==")


def _check_comparison(comparison: str):
    if comparison not in _COMPARISONS:
        raise ValueError(f"comparison must be one of {_COMPARISONS}, got {comparison!r}")


def _as_tensors(*xs):
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dtype = like.dtype if like is not None and like.is_floating_point() else torch.float32
    device = like.device if like is not None else None
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in xs]


def _violation(lhs, comparison, rhs):
    if comparison == "<=":
        return torch.clamp(lhs - rhs, min=0.0)
    if comparison == ">=":
        return torch.clamp(rhs - lhs, min=0.0)
    return torch.abs(lhs - rhs)


def violation(lhs, comparison: str, rhs) -> torch.Tensor:
    """How far ``lhs <comparison> rhs`` is violated; 0 where it holds."""
    _check_comparison(comparison)
    lhs, rhs = _as_tensors(lhs, rhs)
    return _violation(lhs, comparison, rhs)


def log_barrier(lhs, comparison: str, rhs, *, sharpness=1.0) -> torch.Tensor:
    """A logarithmic barrier: near 0 well inside the feasible region, down
    to -inf at and beyond its boundary, never above 0. Add it to a fitness
    that is maximized (negate it for minimization)."""
    if comparison not in ("<=", ">="):
        raise ValueError(f"log_barrier requires an inequality comparison, got {comparison!r}")
    lhs, rhs, sharpness = _as_tensors(lhs, rhs, sharpness)
    gap = rhs - lhs if comparison == "<=" else lhs - rhs
    inside = torch.log(torch.clamp(gap, min=1e-30)) / sharpness
    return torch.clamp(torch.where(gap > 0, inside, torch.full_like(inside, -torch.inf)), max=0.0)


def penalty(lhs, comparison: str, rhs, *, penalty_sign: str = "-", linear=1.0, step=0.0) -> torch.Tensor:
    """A linear and a step penalty of a violated constraint: ``-(linear *
    violation) - step`` where violated. ``penalty_sign="-"`` gives values
    <= 0 (for maximization), ``"+"`` values >= 0 (for minimization)."""
    _check_comparison(comparison)
    if penalty_sign not in ("+", "-"):
        raise ValueError(f"penalty_sign must be '+' or '-', got {penalty_sign!r}")
    lhs, rhs, linear, step = _as_tensors(lhs, rhs, linear, step)
    v = _violation(lhs, comparison, rhs)
    result = -(linear * v) - torch.where(v > 0, step, torch.zeros_like(step))
    return -result if penalty_sign == "+" else result
