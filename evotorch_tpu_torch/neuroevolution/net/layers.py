"""Population-batched layers for evolvable policies.

Counterpart of ``evotorch_tpu/neuroevolution/net/layers.py``: ``Linear``,
``Bias``, the stateless layers (``Apply``, ``Tanh``, ``ReLU``, ``Sigmoid``,
``Softmax``, ``Clip``, ``Bin``, ``Slice``, ``Round``), the recurrent cells
(``RNN``, ``LSTM``), the structured nets (``FeedForwardNet``,
``StructuredControlNet``, ``LocomotorNet``), ``Sequential``,
``FrozenModule`` and ``tanh_mlp``. A layer declares its parameter leaves
(``param_shapes``) in the order of the JAX package's flat layout and applies
them population-batched: every leaf carries a leading population axis, and
row ``k`` of the input is evaluated with solution ``k``'s parameters.

Every layer follows the JAX package's state protocol::

    y, state = module.apply(params, x, state=None)

``module.initial_state()`` is the recurrent state of one policy without
the population axis (None for a stateless module, so ``is_stateful`` is
False), and a state passed to ``apply`` carries the population axis first:
``(popsize, hidden)`` for ``(popsize, in)`` inputs. ``state=None`` means the
initial state. ``Sequential`` threads a tuple of per-module states and
returns None when every one of them is None. ``module(params, x, state)`` is
``module.apply(params, x, state)``.

The flat layout is the one ``jax.flatten_util.ravel_pytree`` gives the JAX
parameter pytree: dict keys in sorted order (uppercase before lowercase), so
each ``Linear`` is ``[bias (out), weight (out, in) row-major]``, each
recurrent cell ``[W_hh, W_ih, b_hh, b_ih]``, layer by layer in
``Sequential`` order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch

__all__ = [
    "Apply",
    "Bias",
    "Bin",
    "Clip",
    "FeedForwardNet",
    "FrozenModule",
    "LSTM",
    "Linear",
    "LocomotorNet",
    "Module",
    "RNN",
    "ReLU",
    "Round",
    "Sequential",
    "Sigmoid",
    "Slice",
    "Softmax",
    "StructuredControlNet",
    "Tanh",
    "tanh_mlp",
]


def map_state(fn: Callable, *states):
    """``fn`` applied leaf by leaf to recurrent states of one structure:
    nested tuples of tensors, with None where a module has no state."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return tuple(map_state(fn, *parts) for parts in zip(*states))
    return fn(*states)


def state_leaves(states) -> List[torch.Tensor]:
    """The tensors of recurrent states, in order (none for None)."""
    if states is None:
        return []
    if isinstance(states, (tuple, list)):
        return [leaf for part in states for leaf in state_leaves(part)]
    return [states]


def _uniform(generator: torch.Generator, shape: tuple, bound: float) -> torch.Tensor:
    """Uniform on ``[-bound, bound)``, the JAX ``init``'s distribution."""
    return (2.0 * torch.rand(shape, generator=generator, device=generator.device) - 1.0) * bound


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``(popsize, in)`` as ``(popsize, 1, in)``; ``(popsize, rows, in)`` as
    it is: the batched products take three dimensions."""
    return x if x.ndim == 3 else x.unsqueeze(1)


class Module:
    """Base layer: no parameters, no state, identity shapes."""

    def param_shapes(self) -> List[Tuple[str, tuple]]:
        """``(name, shape)`` of each parameter leaf, in flat-layout order."""
        return []

    def init(self, generator: torch.Generator) -> List[torch.Tensor]:
        """One solution's parameter leaves, in flat-layout order, drawn from
        ``generator`` (on its device) with the JAX ``init``'s distributions."""
        return []

    def initial_state(self) -> Any:
        """One policy's initial recurrent state (no population axis), or
        None for a stateless module."""
        return None

    @property
    def is_stateful(self) -> bool:
        return self.initial_state() is not None

    def apply(self, params: Sequence[torch.Tensor], x: torch.Tensor, state=None) -> Tuple[torch.Tensor, Any]:
        """``params``: one tensor per leaf, each with a leading population
        axis; ``x``: ``(popsize, in)``, or ``(popsize, rows, in)`` for
        several inputs per solution. Returns ``(y, state)``: ``y`` is
        ``(popsize, out)`` or ``(popsize, rows, out)``, and ``state`` the new
        recurrent state (the given one for a stateless module)."""
        raise NotImplementedError

    def __call__(self, params: Sequence[torch.Tensor], x: torch.Tensor, state=None):
        return self.apply(params, x, state)

    def __rshift__(self, other: "Module") -> "Sequential":
        mine = list(self.modules) if isinstance(self, Sequential) else [self]
        theirs = list(other.modules) if isinstance(other, Sequential) else [other]
        return Sequential(mine + theirs)


class Sequential(Module):
    """Layers in order, threading a tuple of per-module states."""

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)

    def param_shapes(self):
        return [(f"{i}.{name}", shape) for i, m in enumerate(self.modules) for name, shape in m.param_shapes()]

    def init(self, generator):
        return [leaf for m in self.modules for leaf in m.init(generator)]

    def initial_state(self):
        states = tuple(m.initial_state() for m in self.modules)
        return None if all(s is None for s in states) else states

    def apply(self, params, x, state=None):
        states = (None,) * len(self.modules) if state is None else state
        new_states = []
        at = 0
        for m, s in zip(self.modules, states):
            count = len(m.param_shapes())
            x, s = m.apply(params[at : at + count], x, s)
            new_states.append(s)
            at += count
        return x, (None if all(s is None for s in new_states) else tuple(new_states))

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

    def init(self, generator):
        bound = 1.0 / math.sqrt(self.in_features)
        return [_uniform(generator, shape, bound) for _, shape in self.param_shapes()]

    def apply(self, params, x, state=None):
        weight_t = params[-1].transpose(1, 2)  # (popsize, in, out), a view
        rows = _rows(x)
        if self.bias:
            y = torch.baddbmm(params[0].unsqueeze(1), rows, weight_t)
        else:
            y = torch.bmm(rows, weight_t)
        return (y if x.ndim == 3 else y.squeeze(1)), state

    def __repr__(self):
        return f"Linear({self.in_features}, {self.out_features}, bias={self.bias})"


class FrozenModule(Module):
    """A module with one solution's parameters baked in: it declares no
    leaves and applies the module with its own parameters to every row of
    the input, threading the module's state. ``to_policy`` exports are
    built from it, so a deployable policy carries its evolved weights."""

    def __init__(self, module: Module, params: Sequence[torch.Tensor]):
        self._module = module
        self._params = [torch.as_tensor(p) for p in params]

    def initial_state(self):
        return self._module.initial_state()

    def apply(self, params, x, state=None):
        batched = [p.unsqueeze(0).expand(x.shape[0], *p.shape) for p in self._params]
        return self._module.apply(batched, x, state)

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

    def init(self, generator):
        return [torch.zeros(self.num_features, device=generator.device)]

    def apply(self, params, x, state=None):
        return x + (params[0] if x.ndim == 2 else params[0].unsqueeze(1)), state

    def __repr__(self):
        return f"Bias({self.num_features})"


class Apply(Module):
    """An elementwise function of the input, with optional keyword
    arguments."""

    def __init__(self, fn: Callable, **kwargs):
        self._fn = fn
        self._kwargs = kwargs

    def apply(self, params, x, state=None):
        return self._fn(x, **self._kwargs), state

    def __repr__(self):
        return f"Apply({getattr(self._fn, '__name__', repr(self._fn))})"


class Tanh(Module):
    def apply(self, params, x, state=None):
        return torch.tanh(x), state

    def __repr__(self):
        return "Tanh()"


class ReLU(Module):
    def apply(self, params, x, state=None):
        return torch.relu(x), state

    def __repr__(self):
        return "ReLU()"


class Sigmoid(Module):
    def apply(self, params, x, state=None):
        return torch.sigmoid(x), state

    def __repr__(self):
        return "Sigmoid()"


class Softmax(Module):
    """Softmax over the feature axis (``axis=-1``; a population row's axis
    0 is the population's, so only the last axis is taken)."""

    def __init__(self, axis: int = -1):
        if axis != -1:
            raise ValueError(f"Softmax takes axis=-1 (the feature axis), got {axis}")
        self.axis = axis

    def apply(self, params, x, state=None):
        return torch.softmax(x, dim=-1), state

    def __repr__(self):
        return "Softmax()"


class Clip(Module):
    """Clip into ``[lb, ub]``."""

    def __init__(self, lb: float, ub: float):
        self.lb = float(lb)
        self.ub = float(ub)

    def apply(self, params, x, state=None):
        return torch.clamp(x, self.lb, self.ub), state

    def __repr__(self):
        return f"Clip({self.lb}, {self.ub})"


class Bin(Module):
    """Binarize: a value maps to ``lb`` where it is <= 0, else to ``ub``."""

    def __init__(self, lb: float, ub: float):
        self.lb = float(lb)
        self.ub = float(ub)

    def apply(self, params, x, state=None):
        return torch.where(x <= 0, self.lb, self.ub).to(x.dtype), state

    def __repr__(self):
        return f"Bin({self.lb}, {self.ub})"


class Slice(Module):
    """The features ``x[..., from_index:to_index]``."""

    def __init__(self, from_index: int, to_index: int):
        self.from_index = int(from_index)
        self.to_index = int(to_index)

    def apply(self, params, x, state=None):
        return x[..., self.from_index : self.to_index], state

    def __repr__(self):
        return f"Slice({self.from_index}, {self.to_index})"


class Round(Module):
    """Round to ``ndigits`` decimal digits (half to even)."""

    def __init__(self, ndigits: int = 0):
        self.ndigits = int(ndigits)
        self._scale = 10.0**self.ndigits

    def apply(self, params, x, state=None):
        return torch.round(x * self._scale) / self._scale, state

    def __repr__(self):
        return f"Round({self.ndigits})"


class _Cell(Module):
    """A single-step recurrent cell with ``gates`` stacked pre-activations:
    ``pre = x @ W_ih.T + b_ih + h @ W_hh.T + b_hh`` as two ``baddbmm``s over
    strided views of the population and one add, summed in the JAX
    package's order."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int):
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)

    def param_shapes(self):
        n = self.gates * self.hidden_size
        return [("W_hh", (n, self.hidden_size)), ("W_ih", (n, self.input_size)), ("b_hh", (n,)), ("b_ih", (n,))]

    def init(self, generator):
        bound = 1.0 / math.sqrt(self.hidden_size)
        return [_uniform(generator, shape, bound) for _, shape in self.param_shapes()]

    def _zeros(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:-1] + (self.hidden_size,), dtype=x.dtype, device=x.device)

    def _pre(self, params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        w_hh, w_ih, b_hh, b_ih = params
        pre = torch.baddbmm(b_ih.unsqueeze(1), _rows(x), w_ih.transpose(1, 2))
        pre = torch.baddbmm(pre, _rows(h), w_hh.transpose(1, 2))
        pre = pre + b_hh.unsqueeze(1)
        return pre if x.ndim == 3 else pre.squeeze(1)

    def _hidden(self, state, x: torch.Tensor) -> torch.Tensor:
        """The hidden state the pre-activation reads (zeros for None)."""
        raise NotImplementedError

    def _from_pre(self, pre: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
        """``(y, new state)`` from the stacked pre-activation ``pre`` and the
        old state (None: the initial one); the factored forwards of
        ``lowrank.py`` share it."""
        raise NotImplementedError


class RNN(_Cell):
    """Single-step Elman cell ``h = act(x @ W_ih.T + b_ih + h @ W_hh.T +
    b_hh)``, ``act`` ``"tanh"`` or ``"relu"``; the output is the new
    hidden state."""

    def __init__(self, input_size: int, hidden_size: int, nonlinearity: str = "tanh"):
        super().__init__(input_size, hidden_size)
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"Unsupported nonlinearity: {nonlinearity}")
        self.nonlinearity = nonlinearity

    def initial_state(self):
        return torch.zeros(self.hidden_size)

    def _hidden(self, state, x):
        return self._zeros(x) if state is None else state

    def _from_pre(self, pre, state):
        h = torch.tanh(pre) if self.nonlinearity == "tanh" else torch.relu(pre)
        return h, h

    def apply(self, params, x, state=None):
        return self._from_pre(self._pre(params, x, self._hidden(state, x)), state)

    def __repr__(self):
        return f"RNN({self.input_size}, {self.hidden_size})"


class LSTM(_Cell):
    """Single-step LSTM cell with state ``(h, c)``; the gates split as
    ``i, f, g, o``. The three sigmoid gates take one sigmoid of the whole
    pre-activation (the g quarter of it unused)."""

    gates = 4

    def initial_state(self):
        return (torch.zeros(self.hidden_size), torch.zeros(self.hidden_size))

    def _hidden(self, state, x):
        return self._zeros(x) if state is None else state[0]

    def _from_pre(self, pre, state):
        c = self._zeros(pre) if state is None else state[1]
        i, f, _, o = torch.sigmoid(pre).chunk(4, dim=-1)
        g = torch.tanh(pre.narrow(-1, 2 * self.hidden_size, self.hidden_size))
        c = torch.addcmul(f * c, i, g)
        h = o * torch.tanh(c)
        return h, (h, c)

    def apply(self, params, x, state=None):
        return self._from_pre(self._pre(params, x, self._hidden(state, x)), state)

    def __repr__(self):
        return f"LSTM({self.input_size}, {self.hidden_size})"


def _activation(act) -> Module:
    return act if isinstance(act, Module) else Apply(act)


class FeedForwardNet(Module):
    """An MLP from ``(size, activation)`` layer specs (an activation is a
    layer such as ``Tanh()``, a callable, or None); stateless."""

    def __init__(self, input_size: int, layers: Sequence):
        self.input_size = int(input_size)
        modules = []
        in_size = self.input_size
        for layer in layers:
            if isinstance(layer, (tuple, list)):
                size, act = (layer[0], layer[1]) if len(layer) >= 2 else (layer[0], None)
            else:
                size, act = layer, None
            modules.append(Linear(in_size, int(size)))
            if act is not None:
                modules.append(_activation(act))
            in_size = int(size)
        self._seq = Sequential(modules)

    def param_shapes(self):
        return self._seq.param_shapes()

    def init(self, generator):
        return self._seq.init(generator)

    def apply(self, params, x, state=None):
        y, _ = self._seq.apply(params, x)
        return y, state

    def __repr__(self):
        return f"FeedForwardNet({self._seq!r})"


class StructuredControlNet(Module):
    """Structured Control Net (Srouji, Zhang, Salakhutdinov 2018): a linear
    module plus a nonlinear MLP module. Flat layout: ``linear`` then
    ``nonlinear``."""

    def __init__(
        self,
        *,
        in_features: int,
        out_features: int,
        num_layers: int,
        hidden_size: int,
        bias: bool = True,
        nonlinearity: Callable = torch.tanh,
    ):
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self._linear = Linear(self.in_features, self.out_features, bias=bias)
        modules = []
        in_size = self.in_features
        for _ in range(int(num_layers)):
            modules.append(Linear(in_size, int(hidden_size), bias=bias))
            modules.append(_activation(nonlinearity))
            in_size = int(hidden_size)
        modules.append(Linear(in_size, self.out_features, bias=bias))
        self._nonlinear = Sequential(modules)

    def param_shapes(self):
        return [(f"linear.{n}", s) for n, s in self._linear.param_shapes()] + [
            (f"nonlinear.{n}", s) for n, s in self._nonlinear.param_shapes()
        ]

    def init(self, generator):
        return self._linear.init(generator) + self._nonlinear.init(generator)

    def apply(self, params, x, state=None):
        count = len(self._linear.param_shapes())
        y1, _ = self._linear.apply(params[:count], x)
        y2, _ = self._nonlinear.apply(params[count:], x)
        return y1 + y2, state

    def __repr__(self):
        return f"StructuredControlNet(in={self.in_features}, out={self.out_features})"


class LocomotorNet(Module):
    """Locomotor Net (Liu, Ostrow, Srouji et al.): a linear module plus
    ``sum_i sin(W_i x + b_i) * amplitude_i``. Flat layout: ``amplitudes``
    first, then ``linear``, then the sinusoids in order."""

    def __init__(self, *, in_features: int, out_features: int, bias: bool = True, num_sinusoids: int = 16):
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.num_sinusoids = int(num_sinusoids)
        self._linear = Linear(self.in_features, self.out_features, bias=bias)
        self._sinusoids = [Linear(self.in_features, self.out_features, bias=bias) for _ in range(self.num_sinusoids)]

    def param_shapes(self):
        shapes = [("amplitudes", (self.num_sinusoids,))]
        shapes += [(f"linear.{n}", s) for n, s in self._linear.param_shapes()]
        for i, m in enumerate(self._sinusoids):
            shapes += [(f"sinusoids.{i}.{n}", s) for n, s in m.param_shapes()]
        return shapes

    def init(self, generator):
        amplitudes = 0.1 * torch.randn(self.num_sinusoids, generator=generator, device=generator.device)
        return [amplitudes] + self._linear.init(generator) + [leaf for m in self._sinusoids for leaf in m.init(generator)]

    def apply(self, params, x, state=None):
        amplitudes = params[0] if x.ndim == 2 else params[0].unsqueeze(1)
        count = len(self._linear.param_shapes())
        y, _ = self._linear.apply(params[1 : 1 + count], x)
        for i, m in enumerate(self._sinusoids):
            at = 1 + count * (i + 1)
            s, _ = m.apply(params[at : at + count], x)
            y = y + torch.sin(s) * amplitudes[..., i : i + 1]
        return y, state

    def __repr__(self):
        return f"LocomotorNet(in={self.in_features}, out={self.out_features}, S={self.num_sinusoids})"


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
