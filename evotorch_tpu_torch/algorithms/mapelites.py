"""MAP-Elites, a quality-diversity archive over a feature grid (counterpart
of ``evotorch_tpu/algorithms/mapelites.py``).

The per-cell selection keeps, for each cell of a general box grid (cells
may overlap: a feature on a shared edge lies in both), the best solution
whose features fall inside the cell's bounds. The JAX package vmaps over
the cells, which makes a ``(cells, N)`` mask; here the mask is built for a
block of cells at a time (at most ``_MASK_ELEMENTS`` entries, one compare
pass per feature), so 10,000 cells over an extended population of 20,000
take two blocks, with no Python loop over cells.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..core import Problem, SolutionBatch
from ..tools.misc import to_torch_dtype
from .ga import ExtendedPopulationMixin
from .searchalgorithm import SearchAlgorithm, SinglePopulationAlgorithmMixin

__all__ = ["MAPElites"]

#: entries of the (cells, N) suitability mask built at once
_MASK_ELEMENTS = 1 << 27


def _best_solutions_for_all_cells(objective_sense: str, decision_values, evals, feature_grid):
    """-> ``(values, evals, suitable)`` per cell: the best solution whose
    features lie in the cell (``evals[:, 0]`` is the fitness, ``evals[:,
    1:]`` the features), and whether it does lie there (a cell that no
    solution reaches takes solution 0, marked unsuitable). Ties go to the
    lower index, as ``jnp.argmin``/``jnp.argmax`` break them."""
    fitnesses, features = evals[:, 0], evals[:, 1:]
    n = evals.shape[0]
    penalty = math.inf if objective_sense == "min" else -math.inf
    argbest = torch.argmin if objective_sense == "min" else torch.argmax
    block = max(1, _MASK_ELEMENTS // max(1, n))
    indices, suitables = [], []
    for start in range(0, feature_grid.shape[0], block):
        grid = feature_grid[start : start + block]
        suitable = None
        for f in range(features.shape[1]):
            col = features[:, f][None, :]
            inside = (col >= grid[:, f, 0:1]) & (col <= grid[:, f, 1:2])
            suitable = inside if suitable is None else suitable & inside
        processed = torch.where(suitable, fitnesses[None, :], torch.full_like(fitnesses, penalty)[None, :])
        index = argbest(processed, dim=1)
        indices.append(index)
        suitables.append(torch.gather(suitable, 1, index[:, None])[:, 0])
    index = torch.cat(indices)
    return decision_values.index_select(0, index), evals.index_select(0, index), torch.cat(suitables)


class MAPElites(SearchAlgorithm, SinglePopulationAlgorithmMixin, ExtendedPopulationMixin):
    """MAP-Elites: the population is the archive, one solution per cell of
    the feature grid. The problem is single-objective, and its
    ``eval_data_length`` is the number of features."""

    def __init__(
        self,
        problem: Problem,
        *,
        operators: Iterable,
        feature_grid: Iterable,
        re_evaluate: bool = True,
        re_evaluate_parents_first: Optional[bool] = None,
    ):
        problem.ensure_numeric()
        if problem.is_multi_objective:
            raise ValueError("MAPElites supports single-objective problems only")
        if problem.eval_data_length is None or problem.eval_data_length == 0:
            raise ValueError("MAPElites requires eval_data_length >= 1 (the features of each solution)")
        SearchAlgorithm.__init__(self, problem)
        self._sense = problem.senses[0]
        self._feature_grid = torch.as_tensor(feature_grid, dtype=problem.eval_dtype, device=problem.device)
        if self._feature_grid.ndim != 3 or self._feature_grid.shape[-1] != 2:
            raise ValueError(
                f"feature_grid must have shape (num_cells, num_features, 2); got {tuple(self._feature_grid.shape)}"
            )
        if self._feature_grid.shape[1] != problem.eval_data_length:
            raise ValueError(
                f"feature_grid declares {self._feature_grid.shape[1]} features but the "
                f"problem's eval_data_length is {problem.eval_data_length}"
            )
        num_cells = self._feature_grid.shape[0]
        self._population = problem.generate_batch(num_cells)
        self._filled = torch.zeros(num_cells, dtype=torch.bool, device=problem.device)
        ExtendedPopulationMixin.__init__(
            self, re_evaluate=re_evaluate, re_evaluate_parents_first=re_evaluate_parents_first, operators=operators
        )
        SinglePopulationAlgorithmMixin.__init__(self)

    @property
    def population(self) -> SolutionBatch:
        return self._population

    @property
    def filled(self) -> torch.Tensor:
        """``filled[i]``: the solution in cell i satisfies that cell's
        feature bounds."""
        return self._filled

    def _step(self):
        extended = self._make_extended_population(split=False)
        values, evals, suitable = _best_solutions_for_all_cells(
            self._sense, extended.values, extended.evals, self._feature_grid
        )
        self._population.set_values(values, keep_evals=True)
        self._population.set_evals(evals)
        self._filled = suitable

    @staticmethod
    def make_feature_grid(
        lower_bounds: Iterable,
        upper_bounds: Iterable,
        num_bins: Union[int, Iterable[int]],
        *,
        dtype=None,
        device=None,
    ) -> torch.Tensor:
        """A uniform hypergrid of ``(num_cells, num_features, 2)`` bounds
        whose outermost bins reach to -inf and +inf, on ``device`` (the card
        by default)."""
        dtype = to_torch_dtype(dtype) if dtype is not None else torch.float32
        lower_bounds = np.asarray(lower_bounds, dtype=np.float64)
        upper_bounds = np.asarray(upper_bounds, dtype=np.float64)
        if lower_bounds.ndim != 1 or lower_bounds.shape != upper_bounds.shape:
            raise ValueError("lower_bounds / upper_bounds must be 1-D and equal-length")
        n_features = lower_bounds.shape[0]
        if np.isscalar(num_bins) or np.asarray(num_bins).ndim == 0:
            num_bins = [int(num_bins)] * n_features
        per_feature = []
        for lb, ub, bins in zip(lower_bounds, upper_bounds, [int(b) for b in num_bins]):
            edges = np.concatenate([[-np.inf], np.linspace(lb, ub, bins - 1), [np.inf]])
            per_feature.append(np.stack([edges[:-1], edges[1:]], axis=1))
        cells = [np.stack(combo, axis=0) for combo in itertools.product(*per_feature)]
        return torch.as_tensor(np.stack(cells), dtype=dtype, device=resolve_device(device))
