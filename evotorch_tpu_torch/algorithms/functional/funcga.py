"""Functional genetic algorithm: ``ga`` / ``ga_ask`` / ``ga_tell``
(counterpart of ``evotorch_tpu/algorithms/functional/funcga.py``): an
elitist or non-elitist GA, single- or multi-objective (NSGA-II selection),
with a pluggable variation pipeline.

Usage::

    state = ga(values_init=values, evals_init=f(values), objective_sense="min")
    for _ in range(n_generations):
        children = ga_ask(generator, state)          # children only
        state = ga_tell(state, children, f(children))

The initial population is evaluated once by the caller; each generation
then evaluates only its children. ``ga_ask`` takes a ``torch.Generator``
where the JAX version takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from ...operators import functional as F

__all__ = ["GAState", "default_variation", "ga", "ga_ask", "ga_tell"]


@dataclasses.dataclass(frozen=True)
class GAState:
    values: torch.Tensor  # (popsize, L) current evaluated population
    evals: torch.Tensor  # (popsize,) or (popsize, n_obj)
    popsize: int
    objective_sense: Union[str, tuple]
    elitist: bool


def default_variation(
    *,
    tournament_size: int = 4,
    num_points: Optional[int] = None,
    eta: Optional[float] = None,
    mutation_stdev: Optional[float] = 0.1,
    mutation_probability: Optional[float] = None,
) -> Callable:
    """Tournament selection, then k-point crossover (``num_points``,
    default 1) or SBX (``eta``), then optional Gaussian mutation.
    ``variation(generator, values, evals, objective_sense, num_children)``."""
    if num_points is not None and eta is not None:
        raise ValueError("Provide either num_points (k-point crossover) or eta (SBX), not both")
    if num_points is None and eta is None:
        num_points = 1

    def variation(generator, values, evals, objective_sense, num_children):
        common = dict(tournament_size=tournament_size, num_children=num_children, objective_sense=objective_sense)
        if eta is not None:
            children = F.simulated_binary_cross_over(generator, values, evals, eta=eta, **common)
        else:
            children = F.multi_point_cross_over(generator, values, evals, num_points=num_points, **common)
        if mutation_stdev is not None:
            children = F.gaussian_mutation(
                generator, children, stdev=mutation_stdev, mutation_probability=mutation_probability
            )
        return children

    return variation


def ga(*, values_init, evals_init, objective_sense: Union[str, Sequence[str]], elitist: bool = True) -> GAState:
    """The initial state from an evaluated initial population."""
    values_init = torch.as_tensor(values_init)
    evals_init = torch.as_tensor(evals_init, device=values_init.device)
    if values_init.ndim != 2:
        raise ValueError(f"values_init must be (popsize, L); got {tuple(values_init.shape)}")
    if evals_init.shape[0] != values_init.shape[0]:
        raise ValueError(f"evals_init has {evals_init.shape[0]} rows for {values_init.shape[0]} solutions")
    sense = objective_sense if isinstance(objective_sense, str) else tuple(objective_sense)
    n_obj = 1 if isinstance(sense, str) else len(sense)
    if n_obj > 1 and (evals_init.ndim != 2 or evals_init.shape[1] != n_obj):
        raise ValueError(f"evals_init must be (popsize, {n_obj}) for {n_obj} objectives; got {tuple(evals_init.shape)}")
    return GAState(
        values=values_init, evals=evals_init, popsize=int(values_init.shape[0]), objective_sense=sense, elitist=bool(elitist)
    )


def _sense_arg(sense):
    return sense if isinstance(sense, str) else list(sense)


def ga_ask(
    generator: torch.Generator, state: GAState, *, variation: Optional[Callable] = None, num_children: Optional[int] = None
) -> torch.Tensor:
    """Children of the current (evaluated) population; only they need an
    evaluation."""
    variation = variation if variation is not None else default_variation()
    n = int(num_children) if num_children is not None else state.popsize
    if n % 2 != 0:
        raise ValueError(f"num_children must be even, got {n}")
    return variation(generator, state.values, state.evals, _sense_arg(state.objective_sense), n)


def ga_tell(state: GAState, child_values, child_evals) -> GAState:
    """The next population. Elitist: the best of parents and children
    (NSGA-II with several objectives); non-elitist: the children, topped
    up with the best parents when there are fewer than ``popsize``."""
    child_values = torch.as_tensor(child_values)
    child_evals = torch.as_tensor(child_evals, device=child_values.device)
    sense = _sense_arg(state.objective_sense)
    if state.elitist:
        all_values, all_evals = F.combine((state.values, state.evals), (child_values, child_evals), objective_sense=sense)
        best_values, best_evals = F.take_best(all_values, all_evals, state.popsize, objective_sense=sense)
    elif child_values.shape[0] >= state.popsize:
        best_values, best_evals = F.take_best(child_values, child_evals, state.popsize, objective_sense=sense)
    else:
        deficit = state.popsize - child_values.shape[0]
        top_values, top_evals = F.take_best(state.values, state.evals, deficit, objective_sense=sense)
        best_values, best_evals = F.combine((top_values, top_evals), (child_values, child_evals), objective_sense=sense)
    return dataclasses.replace(state, values=best_values, evals=best_evals)
