"""Fitness shaping (ranking), the counterpart of ``evotorch_tpu/tools/ranking.py``.

All methods work along the last axis and return utilities where higher is
better, whatever the objective sense of the raw fitnesses.

``centered`` is ``ops.ranking.centered_rank``: on a CUDA tensor the
hand-written kernel at any population size, on a CPU tensor its plain
version. Both give the ranks of a stable argsort: ties break by index and
NaN orders last. The plain version counts pairs as the kernel does, so on
the CPU a row of n costs O(n^2) compares (10^8 at popsize 10,000) where a
double argsort would cost two sorts.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..ops.ranking import centered_rank

__all__ = ["centered", "linear", "nes", "normalized", "raw", "rank", "rankers"]


def _ascending_ranks(fitnesses: torch.Tensor) -> torch.Tensor:
    """Integer ranks along the last axis, 0 for the lowest fitness: the
    argsort of a stable argsort, so ties get distinct ranks by index."""
    order = torch.argsort(fitnesses, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _float_dtype_like(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype.is_floating_point else torch.float32


def centered(fitnesses: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """Centered ranks in ``[-0.5, +0.5]``."""
    return centered_rank(fitnesses, higher_is_better=higher_is_better)


def linear(fitnesses: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """Linearly spaced ranks in ``[0, 1]``."""
    return centered(fitnesses, higher_is_better=higher_is_better) + 0.5


def nes(fitnesses: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """NES utility weights: for the k-th best of n, ``max(0, ln(n/2+1) - ln(k))``,
    normalized to sum 1, then shifted by ``-1/n`` so that they sum to 0."""
    x = fitnesses if higher_is_better else -fitnesses
    n = x.shape[-1]
    k = (n - _ascending_ranks(x)).to(_float_dtype_like(fitnesses))
    u = torch.clamp(torch.log(torch.full_like(k, n / 2.0 + 1.0)) - torch.log(k), min=0.0)
    u = u / torch.sum(u, dim=-1, keepdim=True)
    return u - 1.0 / n


def normalized(fitnesses: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """Z-scores with the unbiased stdev (ddof=1)."""
    x = fitnesses if higher_is_better else -fitnesses
    mean = torch.mean(x, dim=-1, keepdim=True)
    std = torch.std(x, dim=-1, keepdim=True, correction=1) if x.shape[-1] > 1 else torch.ones_like(mean)
    return (x - mean) / torch.where(std == 0, torch.ones_like(std), std)


def raw(fitnesses: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """Raw fitnesses, sign-adjusted so that higher is better."""
    x = fitnesses if higher_is_better else -fitnesses
    return x.to(_float_dtype_like(x))


rankers: Dict[str, Callable] = {
    "centered": centered,
    "linear": linear,
    "nes": nes,
    "normalized": normalized,
    "raw": raw,
}


def _nonfinite_to_worst(x: torch.Tensor, *, higher_is_better: bool) -> torch.Tensor:
    """Non-finite fitnesses replaced by the worst finite one of their row
    (0 for a row with no finite value); the identity on all-finite input."""
    finite = torch.isfinite(x)
    big = torch.finfo(x.dtype).max
    if higher_is_better:
        worst = torch.amin(torch.where(finite, x, big), dim=-1, keepdim=True)
        worst = torch.where(worst >= big, torch.zeros_like(worst), worst)
    else:
        worst = torch.amax(torch.where(finite, x, -big), dim=-1, keepdim=True)
        worst = torch.where(worst <= -big, torch.zeros_like(worst), worst)
    return torch.where(finite, x, worst)


def rank(
    fitnesses: torch.Tensor,
    ranking_method: str = "raw",
    *,
    higher_is_better: bool,
    guard_nonfinite: bool = True,
) -> torch.Tensor:
    """Shape ``fitnesses`` with ``ranking_method``; ``guard_nonfinite`` (on by
    default) first replaces NaN/inf by the worst finite value of the row."""
    try:
        fn = rankers[ranking_method]
    except KeyError:
        raise ValueError(f"Unknown ranking method {ranking_method!r}; expected one of {sorted(rankers)}") from None
    if guard_nonfinite and fitnesses.dtype.is_floating_point:
        fitnesses = _nonfinite_to_worst(fitnesses, higher_is_better=higher_is_better)
    return fn(fitnesses, higher_is_better=higher_is_better)
