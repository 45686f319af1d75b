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
from ..observability.devicemetrics import append_health_block, compute_health_block

__all__ = ["make_generation_step"]


def make_generation_step(env, policy, *, ask: Callable, tell: Callable, popsize: int, device=None, **rollout_kwargs):
    """``ask(generator, state) -> values`` samples the population (a dense
    ``(popsize, L)`` tensor, or a factored batch such as
    ``pgpe_ask_lowrank``'s or ``pgpe_ask_trunk_delta``'s), ``tell(state,
    values, scores) -> state`` applies the update (``pgpe_tell_lowrank`` for
    a factored one). ``rollout_kwargs`` go to ``run_vectorized_rollout``:
    ``eval_mode`` ``"episodes"`` (the default), ``"episodes_refill"`` or
    ``"budget"``, ``trunk_block`` for a trunk-delta population;
    ``"episodes_compact"`` is refused, as in the JAX package: call
    ``run_vectorized_rollout_compacting`` between ask and tell instead.

    Returns ``generation(state, generator, stats) -> (state, scores, stats,
    total_steps, telemetry)``. ``telemetry`` is the rollout's ``(1, 20)``
    int32 wire, its health block computed on the ``popsize`` scores (an
    empty int32 tensor with ``telemetry=False``). Runs on ``cuda`` unless
    ``device`` says otherwise; the env must live on that device."""
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"the env lives on {env.device}, the generation runs on {device}")
    eval_mode = rollout_kwargs.get("eval_mode", "episodes")
    if eval_mode not in ("budget", "episodes", "episodes_refill"):
        raise ValueError(
            f"make_generation_step runs eval_mode 'episodes', 'episodes_refill' or 'budget', got {eval_mode!r};"
            " for episodes_compact call run_vectorized_rollout_compacting between ask and tell"
        )
    popsize = int(popsize)
    health = bool(rollout_kwargs.pop("health", True))
    rollout_kwargs["health"] = False

    def generation(state, generator: torch.Generator, stats):
        values = ask(generator, state)
        result = run_vectorized_rollout(env, policy, values, generator, stats, **rollout_kwargs)
        scores = result.scores[:popsize]
        new_state = tell(state, values, scores)
        if result.telemetry is None:
            telemetry = torch.zeros((0,), dtype=torch.int32, device=device)
        else:
            telemetry = result.telemetry
            if health:
                telemetry = append_health_block(telemetry, compute_health_block(scores))
        return new_state, scores, result.stats, result.total_steps, telemetry

    return generation
