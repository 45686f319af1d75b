"""Functional Adam: ``adam`` / ``adam_ask`` / ``adam_tell`` (counterpart of
``evotorch_tpu/algorithms/functional/funcadam.py``). The step ascends: the
gradient given to ``adam_tell`` is followed, not descended. Every step stays
on the device."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamState", "adam", "adam_ask", "adam_tell"]


@dataclasses.dataclass(frozen=True)
class AdamState:
    center: torch.Tensor
    center_learning_rate: torch.Tensor
    beta1: torch.Tensor
    beta2: torch.Tensor
    epsilon: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


def adam(*, center_init: torch.Tensor, center_learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8) -> AdamState:
    """Initial Adam state on the device and in the dtype of ``center_init``."""

    def as_tensor(x):
        return torch.as_tensor(x, dtype=center_init.dtype, device=center_init.device)

    return AdamState(
        center=center_init,
        center_learning_rate=as_tensor(center_learning_rate),
        beta1=as_tensor(beta1),
        beta2=as_tensor(beta2),
        epsilon=as_tensor(epsilon),
        m=torch.zeros_like(center_init),
        v=torch.zeros_like(center_init),
        t=torch.zeros(center_init.shape[:-1], dtype=center_init.dtype, device=center_init.device),
    )


def _adam_step(g, center, center_learning_rate, beta1, beta2, epsilon, m, v, t):
    """One Adam step: ``(center, m, v, t)`` after following ``g``."""
    t = t + 1
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g**2
    mhat = m / (1 - beta1**t)
    vhat = v / (1 - beta2**t)
    center = center + center_learning_rate * mhat / (torch.sqrt(vhat) + epsilon)
    return center, m, v, t


def adam_ask(state: AdamState) -> torch.Tensor:
    return state.center


def adam_tell(state: AdamState, *, follow_grad: torch.Tensor) -> AdamState:
    """Apply an ascent gradient."""
    center, m, v, t = _adam_step(
        follow_grad, state.center, state.center_learning_rate, state.beta1, state.beta2, state.epsilon, state.m, state.v, state.t
    )
    return dataclasses.replace(state, center=center, m=m, v=v, t=t)
