"""Functional PGPE: ``pgpe`` / ``pgpe_ask`` / ``pgpe_tell`` / ``pgpe_health``.

Counterpart of ``evotorch_tpu/algorithms/functional/funcpgpe.py`` (dense
populations): symmetric (antithetic) sampling by default, 0-centered
ranking, a functional optimizer (ClipUp) for the center, and a controlled
stdev update (``stdev_max_change``). ``pgpe_ask`` takes an explicit
``torch.Generator`` where the JAX version takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ...distributions import SeparableGaussian, SymmetricSeparableGaussian, make_functional_grad_estimator
from ...tools.misc import modify_vector, stdev_from_radius
from .misc import as_vector_like, get_functional_optimizer

__all__ = ["PGPEState", "pgpe", "pgpe_ask", "pgpe_health", "pgpe_tell"]


@dataclasses.dataclass(frozen=True)
class PGPEState:
    optimizer_state: object
    stdev: torch.Tensor
    stdev_learning_rate: torch.Tensor
    stdev_min: torch.Tensor
    stdev_max: torch.Tensor
    stdev_max_change: torch.Tensor
    optimizer: Union[str, tuple]
    ranking_method: str
    maximize: bool
    symmetric: bool


def _dist_class(symmetric: bool):
    return SymmetricSeparableGaussian if symmetric else SeparableGaussian


def _grad_divisors(symmetric: bool) -> dict:
    denominator = "num_directions" if symmetric else "num_solutions"
    return {"divide_mu_grad_by": denominator, "divide_sigma_grad_by": denominator}


def pgpe(
    *,
    center_init: torch.Tensor,
    center_learning_rate,
    stdev_learning_rate,
    objective_sense: str,
    ranking_method: str = "centered",
    optimizer: Union[str, tuple] = "clipup",
    optimizer_config: Optional[dict] = None,
    stdev_init=None,
    radius_init=None,
    stdev_min=None,
    stdev_max=None,
    stdev_max_change=0.2,
    symmetric: bool = True,
) -> PGPEState:
    """Initial PGPE state on the device of ``center_init``."""
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
    if (stdev_init is None) == (radius_init is None):
        raise ValueError("Exactly one of stdev_init / radius_init must be provided")
    if radius_init is not None:
        stdev_init = stdev_from_radius(float(radius_init), center_init.shape[-1])
    stdev = as_vector_like(stdev_init, center_init, 0.0).expand(center_init.shape).clone()

    opt_init, _, _ = get_functional_optimizer(optimizer)
    optimizer_state = opt_init(
        center_init=center_init,
        center_learning_rate=center_learning_rate,
        **(optimizer_config or {}),
    )
    return PGPEState(
        optimizer_state=optimizer_state,
        stdev=stdev,
        stdev_learning_rate=torch.as_tensor(stdev_learning_rate, dtype=center_init.dtype, device=center_init.device),
        stdev_min=as_vector_like(stdev_min, center_init, 0.0),
        stdev_max=as_vector_like(stdev_max, center_init, float("inf")),
        stdev_max_change=as_vector_like(stdev_max_change, center_init, float("inf")),
        optimizer=optimizer,
        ranking_method=str(ranking_method),
        maximize=(objective_sense == "max"),
        symmetric=bool(symmetric),
    )


def pgpe_ask(generator: torch.Generator, state: PGPEState, *, popsize: int, eps=None) -> torch.Tensor:
    """Sample a population around the optimizer's current center. ``eps``
    injects the standard-normal noise (``(popsize // 2, L)`` when symmetric,
    ``(popsize, L)`` otherwise) instead of drawing it from ``generator``."""
    _, opt_ask, _ = get_functional_optimizer(state.optimizer)
    center = opt_ask(state.optimizer_state)
    return _dist_class(state.symmetric)._sample(
        generator, {"mu": center, "sigma": state.stdev}, int(popsize), eps=eps
    )


def pgpe_tell(state: PGPEState, values: torch.Tensor, evals: torch.Tensor) -> PGPEState:
    """Estimate gradients from the evaluated population and update both the
    optimizer (center) and the controlled stdev."""
    _, opt_ask, opt_tell = get_functional_optimizer(state.optimizer)
    grad_fn = make_functional_grad_estimator(
        _dist_class(state.symmetric),
        objective_sense=("max" if state.maximize else "min"),
        ranking_method=state.ranking_method,
    )
    grads = grad_fn(
        values,
        evals,
        {"mu": opt_ask(state.optimizer_state), "sigma": state.stdev, **_grad_divisors(state.symmetric)},
    )
    new_optimizer_state = opt_tell(state.optimizer_state, follow_grad=grads["mu"])
    target_stdev = state.stdev + state.stdev_learning_rate * grads["sigma"]
    new_stdev = modify_vector(
        state.stdev,
        target_stdev,
        lb=state.stdev_min,
        ub=state.stdev_max,
        max_change=state.stdev_max_change,
    )
    return dataclasses.replace(state, optimizer_state=new_optimizer_state, stdev=new_stdev)


def pgpe_health(state: PGPEState) -> dict:
    """Algorithm-health scalars as device tensors: ``stdev_norm`` always,
    ``velocity_norm`` when the optimizer state carries a velocity."""
    out = {"stdev_norm": torch.linalg.vector_norm(state.stdev)}
    velocity = getattr(state.optimizer_state, "velocity", None)
    if velocity is not None:
        out["velocity_norm"] = torch.linalg.vector_norm(velocity)
    return out
