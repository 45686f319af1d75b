"""Functional SNES: ``snes`` / ``snes_ask`` / ``snes_tell`` (counterpart of
``evotorch_tpu/algorithms/functional/funcsnes.py``), over the
``ExpSeparableGaussian`` math of ``distributions.py``. ``snes_ask`` takes
a ``torch.Generator`` where the JAX version takes a PRNG key; extra
leading dimensions on the center are independent searches."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ...distributions import ExpSeparableGaussian, make_functional_grad_estimator
from .misc import as_center, as_vector_like

__all__ = ["SNESState", "default_popsize", "snes", "snes_ask", "snes_tell"]


@dataclasses.dataclass(frozen=True)
class SNESState:
    center: torch.Tensor
    stdev: torch.Tensor
    center_learning_rate: torch.Tensor
    stdev_learning_rate: torch.Tensor
    ranking_method: str
    maximize: bool


def _lane_stdev(stdev_init, center: torch.Tensor) -> torch.Tensor:
    """A stdev per lane (``(*batch)``), per dimension, or one number, as a
    tensor of the center's shape."""
    stdev = torch.as_tensor(stdev_init, dtype=center.dtype, device=center.device)
    if stdev.ndim > 0 and stdev.ndim == center.ndim - 1:
        stdev = stdev[..., None]
    else:
        stdev = as_vector_like(stdev, center, 0.0)
    return stdev.expand(center.shape).clone()


def snes(
    *,
    center_init,
    objective_sense: str,
    stdev_init=None,
    radius_init=None,
    center_learning_rate: Optional[float] = None,
    stdev_learning_rate: Optional[float] = None,
    ranking_method: str = "nes",
) -> SNESState:
    """Initial SNES state; the stdev learning rate defaults to ``0.2 * (3 +
    log n) / sqrt(n)``."""
    center_init = as_center(center_init)
    n = center_init.shape[-1]
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
    if (stdev_init is None) == (radius_init is None):
        raise ValueError("Exactly one of stdev_init / radius_init must be provided")
    if radius_init is not None:
        radius = torch.as_tensor(radius_init, dtype=center_init.dtype, device=center_init.device)
        stdev_init = radius / torch.sqrt(torch.tensor(n, dtype=center_init.dtype, device=center_init.device))
    if center_learning_rate is None:
        center_learning_rate = 1.0
    if stdev_learning_rate is None:
        stdev_learning_rate = 0.2 * (3 + math.log(n)) / math.sqrt(n)
    scalar = lambda x: torch.as_tensor(x, dtype=center_init.dtype, device=center_init.device)  # noqa: E731
    return SNESState(
        center=center_init,
        stdev=_lane_stdev(stdev_init, center_init),
        center_learning_rate=scalar(center_learning_rate),
        stdev_learning_rate=scalar(stdev_learning_rate),
        ranking_method=str(ranking_method),
        maximize=(objective_sense == "max"),
    )


def default_popsize(solution_length: int) -> int:
    """``4 + floor(3 log n)`` (the reference's ``gaussian.py:948``)."""
    return int(4 + math.floor(3 * math.log(solution_length)))


def snes_ask(generator: torch.Generator, state: SNESState, *, popsize: int) -> torch.Tensor:
    return ExpSeparableGaussian.functional_sample(
        int(popsize), {"mu": state.center, "sigma": state.stdev}, generator=generator
    )


def snes_tell(state: SNESState, values, evals) -> SNESState:
    grad_fn = make_functional_grad_estimator(
        ExpSeparableGaussian, objective_sense=("max" if state.maximize else "min"), ranking_method=state.ranking_method
    )
    grads = grad_fn(values, evals, {"mu": state.center, "sigma": state.stdev})
    center = state.center + state.center_learning_rate[..., None] * grads["mu"]
    stdev = state.stdev * torch.exp(0.5 * state.stdev_learning_rate[..., None] * grads["sigma"])
    return dataclasses.replace(state, center=center, stdev=stdev)
