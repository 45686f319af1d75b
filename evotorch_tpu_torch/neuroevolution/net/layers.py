"""Population-batched layers for evolvable policies.

Counterpart of ``evotorch_tpu/neuroevolution/net/layers.py`` for the layers
of the flagship policy (``Linear``, ``Tanh``, ``Sequential``, ``tanh_mlp``).
A layer declares its parameter leaves (``param_shapes``) in the order of the
JAX package's flat layout and applies them population-batched: every leaf
carries a leading population axis, and row ``k`` of the input is evaluated
with solution ``k``'s parameters.

The flat layout is the one ``jax.flatten_util.ravel_pytree`` gives the JAX
parameter pytree: dict keys in sorted order, so each ``Linear`` is
``[bias (out), weight (out, in) row-major]``, layer by layer in
``Sequential`` order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["Linear", "Module", "Sequential", "Tanh", "tanh_mlp"]


class Module:
    """Base layer: no parameters, identity shapes."""

    def param_shapes(self) -> List[Tuple[str, tuple]]:
        """``(name, shape)`` of each parameter leaf, in flat-layout order."""
        return []

    def apply(self, params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``params``: one tensor per leaf, each with a leading population
        axis; ``x``: ``(popsize, in)``. Returns ``(popsize, out)``."""
        raise NotImplementedError

    def __rshift__(self, other: "Module") -> "Sequential":
        mine = list(self.modules) if isinstance(self, Sequential) else [self]
        theirs = list(other.modules) if isinstance(other, Sequential) else [other]
        return Sequential(mine + theirs)


class Sequential(Module):
    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)

    def param_shapes(self):
        return [(f"{i}.{name}", shape) for i, m in enumerate(self.modules) for name, shape in m.param_shapes()]

    def apply(self, params, x):
        at = 0
        for m in self.modules:
            count = len(m.param_shapes())
            x = m.apply(params[at : at + count], x)
            at += count
        return x

    def __repr__(self):
        return " >> ".join(repr(m) for m in self.modules)


class Linear(Module):
    """Dense layer ``y = x @ W.T + b``, one ``baddbmm`` over the population."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.bias = bool(bias)

    def param_shapes(self):
        weight = ("weight", (self.out_features, self.in_features))
        return [("bias", (self.out_features,)), weight] if self.bias else [weight]

    def apply(self, params, x):
        weight_t = params[-1].transpose(1, 2)  # (popsize, in, out), a view
        if self.bias:
            return torch.baddbmm(params[0].unsqueeze(1), x.unsqueeze(1), weight_t).squeeze(1)
        return torch.bmm(x.unsqueeze(1), weight_t).squeeze(1)

    def __repr__(self):
        return f"Linear({self.in_features}, {self.out_features}, bias={self.bias})"


class Tanh(Module):
    def apply(self, params, x):
        return torch.tanh(x)

    def __repr__(self):
        return "Tanh()"


def tanh_mlp(input_size: int, output_size: int, hidden: Sequence) -> Module:
    """``Linear >> Tanh >> ... >> Linear``: the benchmark policy stack."""
    sizes = [int(h) for h in hidden]
    if not sizes:
        return Linear(int(input_size), int(output_size))
    net = Linear(int(input_size), sizes[0])
    for a, b in zip(sizes, sizes[1:] + [None]):
        net = net >> Tanh()
        net = net >> Linear(a, b if b is not None else int(output_size))
    return net
