"""Functional ClipUp: ``clipup`` / ``clipup_ask`` / ``clipup_tell``.

Counterpart of ``evotorch_tpu/algorithms/functional/funcclipup.py``:
normalize the gradient to ``center_learning_rate``, accumulate it into the
velocity with momentum, clip the velocity's norm to ``max_speed`` (default
``2 * center_learning_rate``). Every step stays on the device (no host sync).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ClipUpState", "clipup", "clipup_ask", "clipup_tell"]


@dataclasses.dataclass(frozen=True)
class ClipUpState:
    center: torch.Tensor
    velocity: torch.Tensor
    center_learning_rate: torch.Tensor
    momentum: torch.Tensor
    max_speed: torch.Tensor


def clipup(
    *,
    center_init: torch.Tensor,
    momentum=0.9,
    center_learning_rate: Optional[float] = None,
    max_speed: Optional[float] = None,
) -> ClipUpState:
    """Initial ClipUp state. At least one of ``center_learning_rate`` and
    ``max_speed`` is required; the missing one follows the factor-of-2 rule."""

    def as_tensor(x):
        return torch.as_tensor(x, dtype=center_init.dtype, device=center_init.device)

    if center_learning_rate is None and max_speed is None:
        raise ValueError("Both `center_learning_rate` and `max_speed` are missing. At least one of them is needed.")
    if max_speed is None:
        center_learning_rate = as_tensor(center_learning_rate)
        max_speed = center_learning_rate * 2.0
    elif center_learning_rate is None:
        max_speed = as_tensor(max_speed)
        center_learning_rate = max_speed / 2.0
    else:
        center_learning_rate = as_tensor(center_learning_rate)
        max_speed = as_tensor(max_speed)
    return ClipUpState(
        center=center_init,
        velocity=torch.zeros_like(center_init),
        center_learning_rate=center_learning_rate,
        momentum=as_tensor(momentum),
        max_speed=max_speed,
    )


def clipup_ask(state: ClipUpState) -> torch.Tensor:
    return state.center


def _clipup_step(g, center, velocity, center_learning_rate, momentum, max_speed):
    """One ClipUp step: ``(velocity, center)`` after following ``g``."""
    velocity = momentum * velocity + center_learning_rate * (g / torch.linalg.vector_norm(g))
    vnorm = torch.linalg.vector_norm(velocity)
    velocity = torch.where(vnorm > max_speed, max_speed * (velocity / vnorm), velocity)
    return velocity, center + velocity


def clipup_tell(state: ClipUpState, *, follow_grad: torch.Tensor) -> ClipUpState:
    """Apply an ascent gradient."""
    velocity, center = _clipup_step(
        follow_grad, state.center, state.velocity, state.center_learning_rate, state.momentum, state.max_speed
    )
    return dataclasses.replace(state, center=center, velocity=velocity)
