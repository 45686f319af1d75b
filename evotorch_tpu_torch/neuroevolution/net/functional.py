"""Flat-parameter policy interface (counterpart of
``evotorch_tpu/neuroevolution/net/functional.py``).

A population is a ``(popsize, L)`` matrix of flat parameter vectors in the
JAX package's layout (see ``layers.py``). The population forward reads each
leaf as a strided view of that matrix, so no parameter is copied: at the
flagship size (10,000 x 12,305) a copy would move 492 MB on every step.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .layers import Module

__all__ = ["FlatParamsPolicy"]


class FlatParamsPolicy:
    """A network evaluated from a population of flat parameter vectors:
    ``policy(params_batch, obs)`` with ``params_batch`` ``(popsize, L)`` and
    ``obs`` ``(popsize, in)`` gives ``(popsize, out)``, row ``k`` from
    solution ``k``."""

    def __init__(self, module: Module):
        self.module = module
        self.layout: List[Tuple[str, tuple, int]] = []
        offset = 0
        for name, shape in module.param_shapes():
            self.layout.append((name, tuple(shape), offset))
            offset += math.prod(shape)
        self.parameter_count = offset

    def unravel(self, params_batch: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf as a view ``(popsize, *shape)`` of ``params_batch``."""
        if params_batch.ndim != 2 or params_batch.shape[1] != self.parameter_count:
            raise ValueError(f"expected a (popsize, {self.parameter_count}) population, got {tuple(params_batch.shape)}")
        return [
            params_batch[:, offset : offset + math.prod(shape)].unflatten(1, shape)
            for _, shape, offset in self.layout
        ]

    def __call__(self, params_batch: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return self.module.apply(self.unravel(params_batch), obs)
