"""Functional SGD with optional momentum: ``sgd`` / ``sgd_ask`` /
``sgd_tell`` (counterpart of ``evotorch_tpu/algorithms/functional/funcsgd.py``).
The step ascends the gradient it is given."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SGDState", "sgd", "sgd_ask", "sgd_tell"]


@dataclasses.dataclass(frozen=True)
class SGDState:
    center: torch.Tensor
    velocity: torch.Tensor
    center_learning_rate: torch.Tensor
    momentum: torch.Tensor


def sgd(*, center_init: torch.Tensor, center_learning_rate, momentum: Optional[float] = None) -> SGDState:
    """Initial SGD state; ``momentum=None`` is plain gradient ascent."""

    def as_tensor(x):
        return torch.as_tensor(x, dtype=center_init.dtype, device=center_init.device)

    return SGDState(
        center=center_init,
        velocity=torch.zeros_like(center_init),
        center_learning_rate=as_tensor(center_learning_rate),
        momentum=as_tensor(0.0 if momentum is None else momentum),
    )


def _sgd_step(g, center, velocity, center_learning_rate, momentum):
    """One SGD step: ``(velocity, center)`` after following ``g``."""
    velocity = momentum * velocity + center_learning_rate * g
    return velocity, center + velocity


def sgd_ask(state: SGDState) -> torch.Tensor:
    return state.center


def sgd_tell(state: SGDState, *, follow_grad: torch.Tensor) -> SGDState:
    velocity, center = _sgd_step(follow_grad, state.center, state.velocity, state.center_learning_rate, state.momentum)
    return dataclasses.replace(state, center=center, velocity=velocity)
