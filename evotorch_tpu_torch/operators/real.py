"""Object operators on real-valued decision vectors (counterpart of
``evotorch_tpu/operators/real.py``): ``GaussianMutation``, the k-point
crossovers, ``SimulatedBinaryCrossOver``, ``PolynomialMutation`` and
``CosynePermutation``. Each draws from its problem's ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch

from ..core import Problem, SolutionBatch
from . import functional as F
from .base import CopyingOperator, CrossOver

__all__ = [
    "CosynePermutation",
    "GaussianMutation",
    "MultiPointCrossOver",
    "OnePointCrossOver",
    "PolynomialMutation",
    "SimulatedBinaryCrossOver",
    "TwoPointCrossOver",
]


class GaussianMutation(CopyingOperator):
    """Additive Gaussian noise, optionally gated element by element."""

    def __init__(self, problem: Problem, *, stdev: float, mutation_probability: Optional[float] = None):
        super().__init__(problem)
        self._stdev = float(stdev)
        self._mutation_probability = mutation_probability

    def _do(self, batch: SolutionBatch) -> SolutionBatch:
        mutated = F.gaussian_mutation(
            self._problem.generator, batch.values, stdev=self._stdev, mutation_probability=self._mutation_probability
        )
        return SolutionBatch(self._problem, mutated.shape[0], values=self._respect_bounds(mutated))


class MultiPointCrossOver(CrossOver):
    """k-point crossover."""

    def __init__(
        self,
        problem: Problem,
        *,
        tournament_size: int,
        num_points: int,
        obj_index: Optional[int] = None,
        num_children: Optional[int] = None,
        cross_over_rate: Optional[float] = None,
    ):
        super().__init__(
            problem,
            tournament_size=tournament_size,
            obj_index=obj_index,
            num_children=num_children,
            cross_over_rate=cross_over_rate,
        )
        self._num_points = int(num_points)
        if self._num_points < 1:
            raise ValueError(f"num_points must be >= 1, got {num_points}")

    def _do_cross_over(self, parents1, parents2) -> SolutionBatch:
        parents = torch.cat([parents1, parents2], dim=0)
        children = F.multi_point_cross_over(self._problem.generator, parents, num_points=self._num_points)
        return self._make_children_batch(children)


class OnePointCrossOver(MultiPointCrossOver):
    def __init__(self, problem: Problem, *, tournament_size: int, obj_index=None, num_children=None, cross_over_rate=None):
        super().__init__(
            problem, tournament_size=tournament_size, num_points=1,
            obj_index=obj_index, num_children=num_children, cross_over_rate=cross_over_rate,
        )  # fmt: skip


class TwoPointCrossOver(MultiPointCrossOver):
    def __init__(self, problem: Problem, *, tournament_size: int, obj_index=None, num_children=None, cross_over_rate=None):
        super().__init__(
            problem, tournament_size=tournament_size, num_points=2,
            obj_index=obj_index, num_children=num_children, cross_over_rate=cross_over_rate,
        )  # fmt: skip


class SimulatedBinaryCrossOver(CrossOver):
    """Simulated binary crossover."""

    def __init__(
        self,
        problem: Problem,
        *,
        tournament_size: int,
        eta: float,
        obj_index: Optional[int] = None,
        num_children: Optional[int] = None,
        cross_over_rate: Optional[float] = None,
    ):
        super().__init__(
            problem,
            tournament_size=tournament_size,
            obj_index=obj_index,
            num_children=num_children,
            cross_over_rate=cross_over_rate,
        )
        self._eta = float(eta)

    def _do_cross_over(self, parents1, parents2) -> SolutionBatch:
        parents = torch.cat([parents1, parents2], dim=0)
        children = F.simulated_binary_cross_over(self._problem.generator, parents, eta=self._eta)
        return self._make_children_batch(children)


class PolynomialMutation(CopyingOperator):
    """Bounded polynomial mutation (the problem must have strict bounds)."""

    def __init__(self, problem: Problem, *, eta: Optional[float] = None, mutation_probability: Optional[float] = None):
        super().__init__(problem)
        if problem.lower_bounds is None or problem.upper_bounds is None:
            raise ValueError("PolynomialMutation requires a bounded problem")
        self._eta = 20.0 if eta is None else float(eta)
        self._mutation_probability = mutation_probability

    def _do(self, batch: SolutionBatch) -> SolutionBatch:
        mutated = F.polynomial_mutation(
            self._problem.generator,
            batch.values,
            lb=self._problem.lower_bounds,
            ub=self._problem.upper_bounds,
            eta=self._eta,
            mutation_probability=self._mutation_probability,
        )
        return SolutionBatch(self._problem, mutated.shape[0], values=mutated)


class CosynePermutation(CopyingOperator):
    """CoSyNE's column-wise permutation, biased by rank unless
    ``permute_all``."""

    def __init__(self, problem: Problem, obj_index: Optional[int] = None, *, permute_all: bool = False):
        super().__init__(problem)
        self._permute_all = bool(permute_all)
        self._obj_index = problem.normalize_obj_index(obj_index) if not permute_all else None

    def _do(self, batch: SolutionBatch) -> SolutionBatch:
        if self._permute_all:
            permuted = F.cosyne_permutation(self._problem.generator, batch.values, permute_all=True)
        else:
            i = self._obj_index
            permuted = F.cosyne_permutation(
                self._problem.generator,
                batch.values,
                batch.evals[:, i],
                permute_all=False,
                objective_sense=self._problem.senses[i],
            )
        return SolutionBatch(self._problem, permuted.shape[0], values=permuted)
