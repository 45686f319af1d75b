"""A plain recurrent policy for the tests: ``RNN(obs_length, h) >> Linear(h,
act_length)``, an Elman cell with tanh, ``h`` from the configuration's
``rnn_hidden``, under the interface of ``reference/mlp_policy.py``.

Flat layout, the port's: the cell's ``[W_hh (h, h), W_ih (h, in), b_hh
(h), b_ih (h)]``, then the output layer's ``[bias (out), weight (out,
h)]``. The state is ``(h,)``, zeros at the start. The pre-activation sums
in the port's order: ``x W_ih^T + b_ih``, then ``+ h W_hh^T``, then ``+
b_hh``. Plain ``torch`` in float32; it imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def make(config: dict, obs_size: int, act_size: int) -> "RNNPolicy":
    return RNNPolicy(obs_size, int(config["rnn_hidden"]), act_size)


class RNNPolicy:
    def __init__(self, obs_size: int, hidden: int, act_size: int):
        self.obs_size, self.hidden, self.act_size = int(obs_size), int(hidden), int(act_size)
        shapes = [(hidden, hidden), (hidden, obs_size), (hidden,), (hidden,), (act_size,), (act_size, hidden)]
        self.layout = []
        offset = 0
        for shape in shapes:
            self.layout.append((shape, offset))
            offset += math.prod(shape)
        self.parameter_count = offset

    def macs(self) -> int:
        return self.hidden * (self.obs_size + self.hidden) + self.act_size * self.hidden

    def output_bias(self) -> Tuple[int, int]:
        (size,), offset = self.layout[4]
        return offset, size

    def initial_state(self, n: int, device):
        return (torch.zeros((n, self.hidden), dtype=torch.float32, device=device),)

    def __call__(self, params: torch.Tensor, obs: torch.Tensor, state=None):
        w_hh, w_ih, b_hh, b_ih, bias, weight = (
            params[:, off : off + math.prod(shape)].unflatten(1, shape) for shape, off in self.layout
        )
        (h,) = self.initial_state(obs.shape[0], obs.device) if state is None else state
        pre = torch.baddbmm(b_ih.unsqueeze(1), obs.unsqueeze(1), w_ih.transpose(1, 2))
        pre = torch.baddbmm(pre, h.unsqueeze(1), w_hh.transpose(1, 2))
        h = torch.tanh((pre + b_hh.unsqueeze(1)).squeeze(1))
        y = torch.baddbmm(bias.unsqueeze(1), h.unsqueeze(1), weight.transpose(1, 2)).squeeze(1)
        return y, (h,)
