"""Functional PGPE: ``pgpe`` / ``pgpe_ask`` / ``pgpe_tell`` / ``pgpe_health``.

Counterpart of ``evotorch_tpu/algorithms/functional/funcpgpe.py``:
symmetric (antithetic) sampling by default, 0-centered ranking, a
functional optimizer (ClipUp) for the center, and a controlled stdev update
(``stdev_max_change``). The factored forms (``pgpe_ask_lowrank``,
``pgpe_ask_trunk_delta`` and their tells) sample and update a population
``center + basis @ coeffs[i]`` without building the dense ``(N, L)``
matrix. Every ask takes an explicit ``torch.Generator`` where the JAX
version takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ...distributions import SeparableGaussian, SymmetricSeparableGaussian, make_functional_grad_estimator
from ...tools.lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch
from ...tools.misc import modify_vector, stdev_from_radius
from ...tools.ranking import rank as rank_fitnesses
from .misc import as_vector_like, get_functional_optimizer

__all__ = [
    "PGPEState",
    "pgpe",
    "pgpe_ask",
    "pgpe_ask_lowrank",
    "pgpe_ask_trunk_delta",
    "pgpe_health",
    "pgpe_tell",
    "pgpe_tell_lowrank",
    "pgpe_tell_trunk_delta",
]


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
    _, opt_ask, _ = get_functional_optimizer(state.optimizer)
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
    return _apply_grads(state, grads)


def _apply_grads(state: PGPEState, grads: dict) -> PGPEState:
    """The optimizer's step on the center and the controlled stdev update."""
    _, _, opt_tell = get_functional_optimizer(state.optimizer)
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


# ----------------------------------------------------------- factored forms


def _require_symmetric(state: PGPEState, what: str) -> None:
    if not state.symmetric:
        raise ValueError(f"{what} requires symmetric=True (the PGPE default)")


def pgpe_ask_lowrank(generator: torch.Generator, state: PGPEState, *, popsize: int, rank: int) -> LowRankParamsBatch:
    """Sample a low-rank population around the current center: a
    ``LowRankParamsBatch`` the rollout engine takes in place of a dense
    ``(popsize, L)`` matrix. Symmetric mode and an even ``popsize`` only."""
    _require_symmetric(state, "pgpe_ask_lowrank")
    _, opt_ask, _ = get_functional_optimizer(state.optimizer)
    center = opt_ask(state.optimizer_state)
    return SymmetricSeparableGaussian._sample_lowrank(
        generator, {"mu": center, "sigma": state.stdev}, int(popsize), int(rank)
    )


def pgpe_ask_trunk_delta(generator: torch.Generator, state: PGPEState, *, popsize: int, rank: int, policy) -> TrunkDeltaParamsBatch:
    """Sample a shared-trunk population with per-lane rank-``rank`` deltas
    around the current center. ``policy`` is the ``FlatParamsPolicy`` being
    evolved: the factors follow its parameter leaves. The factors are drawn
    from ``generator`` first, then the coefficients."""
    _require_symmetric(state, "pgpe_ask_trunk_delta")
    # imported here: the algorithms do not import neuroevolution at load time
    from ...neuroevolution.net.lowrank import sample_trunk_delta_factors

    _, opt_ask, _ = get_functional_optimizer(state.optimizer)
    center = opt_ask(state.optimizer_state)
    factors, basis = sample_trunk_delta_factors(generator, policy, state.stdev, int(rank))
    return SymmetricSeparableGaussian._sample_trunk_delta(
        generator, {"mu": center, "sigma": state.stdev}, int(popsize), int(rank), factors, basis
    )


def pgpe_tell_lowrank(state: PGPEState, params, evals: torch.Tensor) -> PGPEState:
    """The PGPE update from a factored population (low-rank or
    trunk-delta: the gradients read the shared effective basis and the
    coefficients): ``pgpe_tell`` on the materialized population, computed in
    O(L * rank). A ``"centered"`` ranking of CUDA fitnesses launches the
    ranking kernel."""
    _require_symmetric(state, "pgpe_tell_lowrank")
    _, opt_ask, _ = get_functional_optimizer(state.optimizer)
    weights = rank_fitnesses(evals, state.ranking_method, higher_is_better=state.maximize)
    grads = SymmetricSeparableGaussian._compute_gradients_lowrank(
        {"mu": opt_ask(state.optimizer_state), "sigma": state.stdev, **_grad_divisors(True)},
        params,
        weights,
        state.ranking_method,
    )
    return _apply_grads(state, grads)


#: the trunk-delta batch carries its materialized basis: the same update
pgpe_tell_trunk_delta = pgpe_tell_lowrank
