"""Operator bases (counterpart of ``evotorch_tpu/operators/base.py``):
``Operator``, ``CopyingOperator``, ``SingleObjOperator`` and ``CrossOver``
with its tournament selection. The object operators are thin wrappers that
hand their problem's ``torch.Generator`` to ``operators.functional``, where
the math lives."""

from __future__ import annotations

from typing import Optional

import torch

from ..core import Problem, SolutionBatch
from . import functional as F

__all__ = ["CopyingOperator", "CrossOver", "Operator", "SingleObjOperator"]


class Operator:
    """A callable acting on a ``SolutionBatch``."""

    def __init__(self, problem: Problem):
        self._problem = problem

    @property
    def problem(self) -> Problem:
        return self._problem

    @property
    def dtype(self):
        return self._problem.dtype

    def _respect_bounds(self, values: torch.Tensor) -> torch.Tensor:
        """Clipped to the problem's strict bounds, if it has any."""
        lb, ub = self._problem.lower_bounds, self._problem.upper_bounds
        if lb is not None:
            values = torch.maximum(values, lb)
        if ub is not None:
            values = torch.minimum(values, ub)
        return values

    def __call__(self, batch: SolutionBatch):
        raise NotImplementedError


class CopyingOperator(Operator):
    """An operator that makes a new batch instead of changing its input."""

    def __call__(self, batch: SolutionBatch) -> SolutionBatch:
        return self._do(batch)

    def _do(self, batch: SolutionBatch) -> SolutionBatch:
        raise NotImplementedError


class SingleObjOperator(Operator):
    """Base of the operators that accept single-objective problems only."""

    def __init__(self, problem: Problem):
        if problem.is_multi_objective:
            raise ValueError(f"{type(self).__name__} supports single-objective problems only")
        super().__init__(problem)


class CrossOver(CopyingOperator):
    """Base of the crossovers, which pick their parents by tournament:
    centered ranks of one objective, or Pareto utilities when the problem
    has several and no ``obj_index`` is given."""

    def __init__(
        self,
        problem: Problem,
        *,
        tournament_size: int,
        obj_index: Optional[int] = None,
        num_children: Optional[int] = None,
        cross_over_rate: Optional[float] = None,
    ):
        super().__init__(problem)
        self._tournament_size = int(tournament_size)
        self._obj_index = None if obj_index is None else problem.normalize_obj_index(obj_index)
        if num_children is not None and cross_over_rate is not None:
            raise ValueError("Provide at most one of num_children / cross_over_rate")
        self._num_children = None if num_children is None else int(num_children)
        self._cross_over_rate = None if cross_over_rate is None else float(cross_over_rate)

    def _resolve_num_children(self, batch: SolutionBatch) -> int:
        if self._num_children is not None:
            n = self._num_children
        elif self._cross_over_rate is not None:
            n = int(len(batch) * self._cross_over_rate)
        else:
            n = len(batch)
        return n + 1 if n % 2 != 0 else n

    def _do_tournament(self, batch: SolutionBatch):
        """The two parent sets, picked by tournament."""
        problem = self._problem
        if problem.is_multi_objective and self._obj_index is None:
            objective_sense = problem.senses
            evals = batch.evals[:, : problem.num_objectives]
        else:
            i = 0 if self._obj_index is None else self._obj_index
            objective_sense = problem.senses[i]
            evals = batch.evals[:, i]
        return F.tournament(
            problem.generator,
            batch.values,
            evals,
            num_tournaments=self._resolve_num_children(batch),
            tournament_size=self._tournament_size,
            objective_sense=objective_sense,
            split_results=True,
        )

    def _do_cross_over(self, parents1, parents2) -> SolutionBatch:
        raise NotImplementedError

    def _do(self, batch: SolutionBatch) -> SolutionBatch:
        parents1, parents2 = self._do_tournament(batch)
        return self._do_cross_over(parents1, parents2)

    def _make_children_batch(self, child_values) -> SolutionBatch:
        child_values = self._respect_bounds(child_values)
        return SolutionBatch(self._problem, child_values.shape[0], values=child_values)
