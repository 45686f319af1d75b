"""Restarts on stagnation (counterpart of
``evotorch_tpu/algorithms/restarter.py``): ``Restart`` builds its inner
searcher anew whenever that one terminates, ``ModifyingRestart`` may change
the arguments first, and ``IPOP`` multiplies the popsize when the
population's fitness spread collapses."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Optional, Type

import numpy as np

from ..core import Problem
from .searchalgorithm import SearchAlgorithm

__all__ = ["IPOP", "ModifyingRestart", "Restart"]


class Restart(SearchAlgorithm):
    """Re-instantiate the inner algorithm whenever it terminates."""

    def __init__(
        self,
        problem: Problem,
        algorithm_class: Type[SearchAlgorithm],
        algorithm_args: Optional[dict] = None,
        **kwargs: Any,
    ):
        SearchAlgorithm.__init__(
            self,
            problem,
            search_algorithm=self._get_sa_status,
            num_restarts=self._get_num_restarts,
            algorithm_terminated=self._search_algorithm_terminated,
            **kwargs,
        )
        self._algorithm_class = algorithm_class
        self._algorithm_args = dict(algorithm_args or {})
        self.num_restarts = 0
        self._restart()

    def _get_sa_status(self) -> dict:
        return dict(self.search_algorithm.status.items())

    def _get_num_restarts(self) -> int:
        return self.num_restarts

    def _restart(self):
        self.search_algorithm = self._algorithm_class(self._problem, **self._algorithm_args)
        self.num_restarts += 1

    def _search_algorithm_terminated(self) -> bool:
        return self.search_algorithm.is_terminated

    def _step(self):
        self.search_algorithm.step()
        if self._search_algorithm_terminated():
            self._restart()


class ModifyingRestart(Restart):
    """A restart that may adjust the inner algorithm's arguments first."""

    def _modify_algorithm_args(self):
        pass

    def _restart(self):
        self._modify_algorithm_args()
        super()._restart()


class IPOP(ModifyingRestart):
    """Increasing-population restarts: when the stdev of the population's
    evals falls below ``min_fitness_stdev``, restart with the popsize
    multiplied by ``popsize_multiplier``. Reading the spread is one host
    read per generation."""

    def __init__(
        self,
        problem: Problem,
        algorithm_class: Type[SearchAlgorithm],
        algorithm_args: Optional[dict] = None,
        min_fitness_stdev: float = 1e-9,
        popsize_multiplier: float = 2,
    ):
        super().__init__(problem, algorithm_class, algorithm_args)
        self.min_fitness_stdev = float(min_fitness_stdev)
        self.popsize_multiplier = float(popsize_multiplier)

    def _search_algorithm_terminated(self) -> bool:
        evals = self.search_algorithm.population.evals.cpu().numpy()
        if np.nanstd(evals) < getattr(self, "min_fitness_stdev", 1e-9):
            return True
        return super()._search_algorithm_terminated()

    def _modify_algorithm_args(self):
        if self.num_restarts >= 1:
            new_args = deepcopy(self._algorithm_args)
            new_args["popsize"] = int(self.popsize_multiplier * len(self.search_algorithm.population))
            self._algorithm_args = new_args
