"""One whole generation, ``ask -> rollout -> tell`` (counterpart of
``evotorch_tpu/parallel/evaluate.py:make_generation_step``), on one device.

The JAX version compiles the generation into one donated program over a
mesh; here the three parts run eagerly, one after the other, on one card.
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..neuroevolution.net.vecrl import run_vectorized_rollout

__all__ = ["make_generation_step"]


def make_generation_step(env, policy, *, ask: Callable, tell: Callable, popsize: int, device=None, **rollout_kwargs):
    """``ask(generator, state) -> values`` samples the ``(popsize, L)``
    population, ``tell(state, values, scores) -> state`` applies the update.

    Returns ``generation(state, generator, stats) -> (state, scores, stats,
    total_steps)``. Runs on ``cuda`` unless ``device`` says otherwise; the
    env must live on that device."""
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"the env lives on {env.device}, the generation runs on {device}")
    popsize = int(popsize)

    def generation(state, generator: torch.Generator, stats):
        values = ask(generator, state)
        result = run_vectorized_rollout(env, policy, values, generator, stats, **rollout_kwargs)
        scores = result.scores[:popsize]
        new_state = tell(state, values, scores)
        return new_state, scores, result.stats, result.total_steps

    return generation
