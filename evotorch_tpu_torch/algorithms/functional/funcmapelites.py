"""Functional MAP-Elites: ``mapelites`` / ``mapelites_ask`` /
``mapelites_tell`` (counterpart of
``evotorch_tpu/algorithms/functional/funcmapelites.py``), with the per-cell
selection of ``algorithms/mapelites.py``. ``evals[:, 0]`` is the fitness,
``evals[:, 1:]`` the features."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..mapelites import _best_solutions_for_all_cells

__all__ = ["MAPElitesState", "mapelites", "mapelites_ask", "mapelites_tell"]


@dataclasses.dataclass(frozen=True)
class MAPElitesState:
    values: torch.Tensor  # (num_cells, L) archive decision values
    evals: torch.Tensor  # (num_cells, 1 + num_features)
    filled: torch.Tensor  # (num_cells,) bool
    feature_grid: torch.Tensor  # (num_cells, num_features, 2)
    objective_sense: str


def mapelites(*, values_init, evals_init, feature_grid, objective_sense: str) -> MAPElitesState:
    """The initial archive from an evaluated seed population, placed into
    the cells by one selection pass."""
    values_init = torch.as_tensor(values_init)
    evals_init = torch.as_tensor(evals_init, device=values_init.device)
    feature_grid = torch.as_tensor(feature_grid, device=values_init.device)
    if values_init.ndim != 2:
        raise ValueError(f"values_init must be (N, L); got {tuple(values_init.shape)}")
    if evals_init.shape[0] != values_init.shape[0]:
        raise ValueError(f"evals_init has {evals_init.shape[0]} rows for {values_init.shape[0]} solutions")
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
    if feature_grid.ndim != 3 or feature_grid.shape[-1] != 2:
        raise ValueError(f"feature_grid must be (num_cells, num_features, 2); got {tuple(feature_grid.shape)}")
    if evals_init.ndim != 2 or evals_init.shape[1] != 1 + feature_grid.shape[1]:
        raise ValueError(
            f"evals_init must be (N, 1 + num_features) = (N, {1 + feature_grid.shape[1]}); got {tuple(evals_init.shape)}"
        )
    values, evals, filled = _best_solutions_for_all_cells(objective_sense, values_init, evals_init, feature_grid)
    return MAPElitesState(values=values, evals=evals, filled=filled, feature_grid=feature_grid, objective_sense=objective_sense)


def mapelites_ask(generator: torch.Generator, state: MAPElitesState, *, mutate: Callable) -> torch.Tensor:
    """One child per cell: ``mutate(generator, values) -> values`` of the
    current occupants."""
    return mutate(generator, state.values)


def mapelites_tell(state: MAPElitesState, child_values, child_evals) -> MAPElitesState:
    """For every cell, the best candidate (occupant or child) whose features
    lie inside it; an empty cell's occupant competes with the losing
    fitness."""
    child_values = torch.as_tensor(child_values)
    child_evals = torch.as_tensor(child_evals, device=child_values.device)
    if child_evals.shape[0] != child_values.shape[0]:
        raise ValueError(f"child_evals has {child_evals.shape[0]} rows for {child_values.shape[0]} children")
    bad = math.inf if state.objective_sense == "min" else -math.inf
    arch_evals = state.evals.clone()
    arch_evals[:, 0] = torch.where(state.filled, state.evals[:, 0], torch.full_like(state.evals[:, 0], bad))
    values, evals, filled = _best_solutions_for_all_cells(
        state.objective_sense,
        torch.cat([state.values, child_values], dim=0),
        torch.cat([arch_evals, child_evals], dim=0),
        state.feature_grid,
    )
    return dataclasses.replace(state, values=values, evals=evals, filled=filled)
