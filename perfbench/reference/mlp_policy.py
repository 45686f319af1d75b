"""The default plain policy: the tanh MLP of a configuration's ``hidden``.

A configuration that names no ``reference_policy`` is held to this one,
and one that names no ``network`` runs the port's network that
``network(config)`` writes from the same ``hidden``. The interface every
policy file gives (``policies.py`` loads the others by path):

- ``make(config, obs_size, act_size)`` returns the policy, which has
  ``parameter_count``; ``macs()``, the multiply-adds of one lane's forward;
  ``output_bias()``, the ``(offset, size)`` of the output layer's bias in a
  flat row; ``initial_state(n, device)``, a tuple of ``(n, k)`` float32
  tensors, or None for a stateless policy; and ``__call__(params, obs,
  state)``, which returns ``(raw, state)``.
- The flat layout is the port's: each ``Linear`` is ``[bias, weight]``,
  each recurrent cell ``[W_hh, W_ih, b_hh, b_ih]``, layer by layer.

Plain ``torch`` in float32; it imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

__all__ = ["MLP", "make", "network"]


def network(config: dict) -> str:
    """The port's network string of the MLP of ``config["hidden"]``."""
    sizes = ["obs_length", *[str(int(h)) for h in config["hidden"]], "act_length"]
    layers = [f"Linear({a}, {b})" for a, b in zip(sizes[:-1], sizes[1:])]
    return " >> Tanh() >> ".join(layers)


def make(config: dict, obs_size: int, act_size: int) -> "MLP":
    return MLP([obs_size, *config["hidden"], act_size])


class MLP:
    """``Linear(sizes[0], sizes[1]) >> Tanh() >> ... >> Linear(sizes[-2],
    sizes[-1])`` evaluated from a population of flat parameter rows: each
    layer's bias then its ``(out, in)`` weight, in layer order, and one
    ``baddbmm`` a layer over strided views of the rows. Stateless."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = [int(s) for s in sizes]
        self.layout: List[Tuple[tuple, int]] = []
        offset = 0
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            for shape in ((fan_out,), (fan_out, fan_in)):
                self.layout.append((shape, offset))
                offset += math.prod(shape)
        self.parameter_count = offset

    def macs(self) -> int:
        """Multiply-adds of one forward of one lane."""
        return sum(a * b for a, b in zip(self.sizes[:-1], self.sizes[1:]))

    def output_bias(self) -> Tuple[int, int]:
        (size,), offset = self.layout[-2]
        return offset, size

    def initial_state(self, n: int, device) -> None:
        return None

    def __call__(self, params: torch.Tensor, obs: torch.Tensor, state=None):
        leaves = [params[:, off : off + math.prod(shape)].unflatten(1, shape) for shape, off in self.layout]
        x = obs
        last = len(self.sizes) - 2
        for i in range(last + 1):
            bias, weight = leaves[2 * i], leaves[2 * i + 1]
            y = torch.baddbmm(bias.unsqueeze(1), x.unsqueeze(1), weight.transpose(1, 2)).squeeze(1)
            x = torch.tanh(y) if i < last else y
        return x, state
