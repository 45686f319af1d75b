"""Flat-parameter policy interface (counterpart of
``evotorch_tpu/neuroevolution/net/functional.py``).

A population is a ``(popsize, L)`` matrix of flat parameter vectors in the
JAX package's layout (see ``layers.py``). The population forward reads each
leaf as a strided view of that matrix, so no parameter is copied: at the
flagship size (10,000 x 12,305) a copy would move 492 MB on every step.

One solution's parameters are also handled as a list of leaves (the JAX
package's parameter pytree, flattened in layout order):
``parameter_vector`` concatenates them and ``fill_parameters`` reads a
vector back into their shapes.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch

from .layers import Module

__all__ = ["FlatParamsPolicy", "count_parameters", "fill_parameters", "make_functional_module", "parameter_vector"]


class FlatParamsPolicy:
    """A network evaluated from a population of flat parameter vectors:
    ``policy(params_batch, obs, state=None) -> (out, state)`` with
    ``params_batch`` ``(popsize, L)`` and ``obs`` ``(popsize, in)`` gives
    ``out`` ``(popsize, out)``, row ``k`` from solution ``k``, and the new
    recurrent state (population axis first; None for a stateless
    network)."""

    def __init__(self, module: Module):
        self.module = module
        self.layout: List[Tuple[str, tuple, int]] = []
        offset = 0
        for name, shape in module.param_shapes():
            self.layout.append((name, tuple(shape), offset))
            offset += math.prod(shape)
        self.parameter_count = offset

    @property
    def num_parameters(self) -> int:
        return self.parameter_count

    def initial_state(self) -> Any:
        """One policy's initial state (no population axis), or None."""
        return self.module.initial_state()

    def init_parameters(self, generator: torch.Generator) -> torch.Tensor:
        """A freshly initialized ``(L,)`` vector on the generator's device,
        from the JAX ``init``'s distributions (uniform in +-1/sqrt(fan) per
        leaf, amplitudes normal x 0.1)."""
        leaves = self.module.init(generator)
        return parameter_vector(leaves) if leaves else torch.zeros(0, device=generator.device)

    def unravel(self, params_batch: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf as a view ``(popsize, *shape)`` of ``params_batch``."""
        if params_batch.ndim != 2 or params_batch.shape[1] != self.parameter_count:
            raise ValueError(f"expected a (popsize, {self.parameter_count}) population, got {tuple(params_batch.shape)}")
        return [
            params_batch[:, offset : offset + math.prod(shape)].unflatten(1, shape)
            for _, shape, offset in self.layout
        ]

    def __call__(self, params_batch: torch.Tensor, obs: torch.Tensor, state=None) -> Tuple[torch.Tensor, Any]:
        return self.module.apply(self.unravel(params_batch), obs, state)


def make_functional_module(module: Module) -> FlatParamsPolicy:
    """The module as a function of flat parameter vectors."""
    return FlatParamsPolicy(module)


def count_parameters(module: Module) -> int:
    return FlatParamsPolicy(module).parameter_count


def parameter_vector(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """One solution's parameter leaves as one flat vector, in layout order."""
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def fill_parameters(template: Sequence[torch.Tensor], vector: torch.Tensor) -> List[torch.Tensor]:
    """The inverse of :func:`parameter_vector`: ``vector`` read into the
    shapes of the leaves of ``template`` (views of ``vector``)."""
    sizes = [leaf.numel() for leaf in template]
    if vector.ndim != 1 or vector.shape[0] != sum(sizes):
        raise ValueError(f"expected a vector of {sum(sizes)} parameters, got shape {tuple(vector.shape)}")
    return [part.view(leaf.shape) for part, leaf in zip(torch.split(vector, sizes), template)]
