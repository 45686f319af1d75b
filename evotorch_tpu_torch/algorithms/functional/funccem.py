"""Functional cross-entropy method: ``cem`` / ``cem_ask`` / ``cem_tell``
(counterpart of ``evotorch_tpu/algorithms/functional/funccem.py``).
``cem_ask`` takes a ``torch.Generator`` where the JAX version takes a PRNG
key. Extra leading dimensions on ``center_init`` (and the
hyperparameters) are independent searches, updated under
``expects_ndim``."""

from __future__ import annotations

import dataclasses

import torch

from ...decorators import expects_ndim
from ...distributions import SeparableGaussian
from ...tools.misc import modify_vector, stdev_from_radius
from ...tools.ranking import rank
from .misc import as_center, as_vector_like

__all__ = ["CEMState", "cem", "cem_ask", "cem_tell"]


@dataclasses.dataclass(frozen=True)
class CEMState:
    center: torch.Tensor
    stdev: torch.Tensor
    stdev_min: torch.Tensor
    stdev_max: torch.Tensor
    stdev_max_change: torch.Tensor
    parenthood_ratio: float
    maximize: bool


def cem(
    *,
    center_init,
    parenthood_ratio: float,
    objective_sense: str,
    stdev_init=None,
    radius_init=None,
    stdev_min=None,
    stdev_max=None,
    stdev_max_change=None,
) -> CEMState:
    """Initial CEM state."""
    center_init = as_center(center_init)
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
    if (stdev_init is None) == (radius_init is None):
        raise ValueError("Exactly one of stdev_init / radius_init must be provided")
    if radius_init is not None:
        stdev_init = stdev_from_radius(float(radius_init), center_init.shape[-1])
    stdev = as_vector_like(stdev_init, center_init, 0.0)
    return CEMState(
        center=center_init,
        stdev=stdev.expand(center_init.shape).clone(),
        stdev_min=as_vector_like(stdev_min, center_init, 0.0),
        stdev_max=as_vector_like(stdev_max, center_init, float("inf")),
        stdev_max_change=as_vector_like(stdev_max_change, center_init, float("inf")),
        parenthood_ratio=float(parenthood_ratio),
        maximize=(objective_sense == "max"),
    )


def cem_ask(generator: torch.Generator, state: CEMState, *, popsize: int) -> torch.Tensor:
    """A population per search lane."""
    return SeparableGaussian.functional_sample(int(popsize), {"mu": state.center, "sigma": state.stdev}, generator=generator)


@expects_ndim(1, 1, 1, 1, 1, 2, 1, None)
def _cem_tell_core(org_center, org_stdev, stdev_min, stdev_max, stdev_max_change, values, weights, parenthood_ratio):
    grads = SeparableGaussian._compute_gradients_via_parenthood_ratio(
        {"mu": org_center, "sigma": org_stdev, "parenthood_ratio": parenthood_ratio}, values, weights
    )
    center = org_center + grads["mu"]
    stdev = modify_vector(org_stdev, org_stdev + grads["sigma"], lb=stdev_min, ub=stdev_max, max_change=stdev_max_change)
    return center, stdev


def cem_tell(state: CEMState, values, evals) -> CEMState:
    """The elites' mean and stdev become the new center and stdev (the
    stdev within its bounds and its largest change)."""
    weights = rank(torch.as_tensor(evals), "raw", higher_is_better=state.maximize)
    center, stdev = _cem_tell_core(
        state.center, state.stdev, state.stdev_min, state.stdev_max, state.stdev_max_change,
        torch.as_tensor(values), weights, state.parenthood_ratio,
    )  # fmt: skip
    return dataclasses.replace(state, center=center, stdev=stdev)
