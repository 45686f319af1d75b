"""``make_search_span``: K ask -> fitness -> tell generations of a
functional searcher as one call (counterpart of
``evotorch_tpu/algorithms/functional/span.py``).

The JAX package scans the generations into one jitted program; here they
run one after another in eager PyTorch, and the per-generation metrics are
stacked at the end. A span and a hand-written loop over the same calls give
the same bits.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ...tools.misc import stack_trees

__all__ = ["make_search_span"]


def make_search_span(
    fitness: Callable,
    *,
    ask: Callable,
    tell: Callable,
    metrics: Optional[Callable] = None,
    donate_state: bool = True,
):
    """``span_fn(state, generators) -> (state, ys)``: one generation per
    item of ``generators`` (``torch.Generator`` objects; pass the same one
    K times to draw every generation from one stream, as a key array split
    from one key does in the JAX package). ``ask(generator, state) ->
    population`` (bind popsize et al. with ``functools.partial``),
    ``fitness(population) -> evals``, ``tell(state, population, evals) ->
    state``; ``metrics(population, evals)`` (default: the evals) is stacked
    over the generations as ``ys``. ``donate_state`` is accepted for the
    JAX package's signature: eager PyTorch donates nothing, and the
    functional states are never changed in place."""

    def span_fn(state, generators: Iterable[torch.Generator]):
        outs = []
        for generator in generators:
            population = ask(generator, state)
            evals = fitness(population)
            state = tell(state, population, evals)
            outs.append(evals if metrics is None else metrics(population, evals))
        return state, stack_trees(outs) if outs else None

    return span_fn
