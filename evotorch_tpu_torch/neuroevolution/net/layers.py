"""Population-batched layers for evolvable policies.

Counterpart of ``evotorch_tpu/neuroevolution/net/layers.py``: ``Linear``,
``Bias``, the stateless layers (``Apply``, ``Tanh``, ``ReLU``, ``Sigmoid``,
``Softmax``, ``Clip``, ``Bin``, ``Slice``, ``Round``), ``Sequential``,
``FrozenModule`` and ``tanh_mlp``. A layer declares its parameter leaves
(``param_shapes``) in the order of the JAX package's flat layout and applies
them population-batched: every leaf carries a leading population axis, and
row ``k`` of the input is evaluated with solution ``k``'s parameters.
``module(params, x)`` is ``module.apply(params, x)``.

The recurrent cells (``RNN``, ``LSTM``) and the structured nets
(``FeedForwardNet``, ``StructuredControlNet``, ``LocomotorNet``) are not
ported yet (``ROADMAP.md``, item A.2).

The flat layout is the one ``jax.flatten_util.ravel_pytree`` gives the JAX
parameter pytree: dict keys in sorted order, so each ``Linear`` is
``[bias (out), weight (out, in) row-major]``, layer by layer in
``Sequential`` order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

__all__ = [
    "Apply",
    "Bias",
    "Bin",
    "Clip",
    "FrozenModule",
    "Linear",
    "Module",
    "ReLU",
    "Round",
    "Sequential",
    "Sigmoid",
    "Slice",
    "Softmax",
    "Tanh",
    "tanh_mlp",
]

#: layers of the JAX package not ported yet, with their ROADMAP.md item
UNPORTED_LAYERS = {
    name: "A.2, policy" for name in ("RNN", "LSTM", "FeedForwardNet", "StructuredControlNet", "LocomotorNet")
}


class Module:
    """Base layer: no parameters, identity shapes."""

    def param_shapes(self) -> List[Tuple[str, tuple]]:
        """``(name, shape)`` of each parameter leaf, in flat-layout order."""
        return []

    def apply(self, params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``params``: one tensor per leaf, each with a leading population
        axis; ``x``: ``(popsize, in)``, or ``(popsize, rows, in)`` for
        several inputs per solution. Returns ``(popsize, out)`` or
        ``(popsize, rows, out)``."""
        raise NotImplementedError

    def __call__(self, params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

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
    """Dense layer ``y = x @ W.T + b``, one ``baddbmm`` over the population
    (one row per solution, or ``rows`` of them)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.bias = bool(bias)

    def param_shapes(self):
        weight = ("weight", (self.out_features, self.in_features))
        return [("bias", (self.out_features,)), weight] if self.bias else [weight]

    def apply(self, params, x):
        weight_t = params[-1].transpose(1, 2)  # (popsize, in, out), a view
        rows = x if x.ndim == 3 else x.unsqueeze(1)
        if self.bias:
            y = torch.baddbmm(params[0].unsqueeze(1), rows, weight_t)
        else:
            y = torch.bmm(rows, weight_t)
        return y if x.ndim == 3 else y.squeeze(1)

    def __repr__(self):
        return f"Linear({self.in_features}, {self.out_features}, bias={self.bias})"


class FrozenModule(Module):
    """A module with one solution's parameters baked in: it declares no
    leaves and applies the module with its own parameters to every row of
    the input. ``to_policy`` exports are built from it, so a deployable
    policy carries its evolved weights."""

    def __init__(self, module: Module, params: Sequence[torch.Tensor]):
        self._module = module
        self._params = [torch.as_tensor(p) for p in params]

    def apply(self, params, x):
        batched = [p.unsqueeze(0).expand(x.shape[0], *p.shape) for p in self._params]
        return self._module.apply(batched, x)

    @property
    def wrapped_module(self) -> Module:
        return self._module

    @property
    def wrapped_params(self) -> List[torch.Tensor]:
        return self._params

    def __repr__(self):
        return f"FrozenModule({self._module!r})"


class Bias(Module):
    """A learnable additive bias vector."""

    def __init__(self, num_features: int):
        self.num_features = int(num_features)

    def param_shapes(self):
        return [("bias", (self.num_features,))]

    def apply(self, params, x):
        return x + (params[0] if x.ndim == 2 else params[0].unsqueeze(1))

    def __repr__(self):
        return f"Bias({self.num_features})"


class Apply(Module):
    """An elementwise function of the input, with optional keyword
    arguments."""

    def __init__(self, fn: Callable, **kwargs):
        self._fn = fn
        self._kwargs = kwargs

    def apply(self, params, x):
        return self._fn(x, **self._kwargs)

    def __repr__(self):
        return f"Apply({getattr(self._fn, '__name__', repr(self._fn))})"


class Tanh(Module):
    def apply(self, params, x):
        return torch.tanh(x)

    def __repr__(self):
        return "Tanh()"


class ReLU(Module):
    def apply(self, params, x):
        return torch.relu(x)

    def __repr__(self):
        return "ReLU()"


class Sigmoid(Module):
    def apply(self, params, x):
        return torch.sigmoid(x)

    def __repr__(self):
        return "Sigmoid()"


class Softmax(Module):
    """Softmax over the feature axis (``axis=-1``; a population row's axis
    0 is the population's, so only the last axis is taken)."""

    def __init__(self, axis: int = -1):
        if axis != -1:
            raise ValueError(f"Softmax takes axis=-1 (the feature axis), got {axis}")
        self.axis = axis

    def apply(self, params, x):
        return torch.softmax(x, dim=-1)

    def __repr__(self):
        return "Softmax()"


class Clip(Module):
    """Clip into ``[lb, ub]``."""

    def __init__(self, lb: float, ub: float):
        self.lb = float(lb)
        self.ub = float(ub)

    def apply(self, params, x):
        return torch.clamp(x, self.lb, self.ub)

    def __repr__(self):
        return f"Clip({self.lb}, {self.ub})"


class Bin(Module):
    """Binarize: a value maps to ``lb`` where it is <= 0, else to ``ub``."""

    def __init__(self, lb: float, ub: float):
        self.lb = float(lb)
        self.ub = float(ub)

    def apply(self, params, x):
        return torch.where(x <= 0, self.lb, self.ub).to(x.dtype)

    def __repr__(self):
        return f"Bin({self.lb}, {self.ub})"


class Slice(Module):
    """The features ``x[..., from_index:to_index]``."""

    def __init__(self, from_index: int, to_index: int):
        self.from_index = int(from_index)
        self.to_index = int(to_index)

    def apply(self, params, x):
        return x[..., self.from_index : self.to_index]

    def __repr__(self):
        return f"Slice({self.from_index}, {self.to_index})"


class Round(Module):
    """Round to ``ndigits`` decimal digits (half to even)."""

    def __init__(self, ndigits: int = 0):
        self.ndigits = int(ndigits)
        self._scale = 10.0**self.ndigits

    def apply(self, params, x):
        return torch.round(x * self._scale) / self._scale

    def __repr__(self):
        return f"Round({self.ndigits})"


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
