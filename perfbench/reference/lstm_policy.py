"""The plain LSTM policy: ``LSTM(obs_length, H) >> Linear(H, act_length)``,
EvoTorch's single-step recurrent cell with a forget gate and a linear
output, ``H`` from the configuration's ``lstm_hidden``, under the interface
of ``reference/mlp_policy.py``.

The cell, with the gates in ``torch.nn.LSTMCell``'s order ``i, f, g, o``::

    pre = x W_ih^T + b_ih + h W_hh^T + b_hh
    i, f, o = sigmoid(.), g = tanh(.)
    c' = f * c + i * g
    h' = o * tanh(c')

and the output ``raw = h' weight^T + bias``. The pre-activation sums in
the port's order: ``x W_ih^T + b_ih``, then ``+ h W_hh^T``, then ``+
b_hh``. Each gate takes its own nonlinearity on its own quarter (the port
takes one sigmoid over all four quarters and reads three of them: the same
values).

Flat layout, the port's: the cell's ``[W_hh (4H, H), W_ih (4H, in), b_hh
(4H), b_ih (4H)]``, then the output layer's ``[bias (out), weight (out,
H)]``. The state is ``(h, c)``, each ``(n, H)``, zeros at the start. Plain
``torch`` in float32, TF32 switched off; it imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["LSTMPolicy", "make"]


def make(config: dict, obs_size: int, act_size: int) -> "LSTMPolicy":
    return LSTMPolicy(obs_size, int(config["lstm_hidden"]), act_size)


class LSTMPolicy:
    def __init__(self, obs_size: int, hidden: int, act_size: int):
        # a float32 product on the card may otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.obs_size, self.hidden, self.act_size = int(obs_size), int(hidden), int(act_size)
        n = 4 * self.hidden
        shapes = [(n, self.hidden), (n, self.obs_size), (n,), (n,), (self.act_size,), (self.act_size, self.hidden)]
        self.layout = []
        offset = 0
        for shape in shapes:
            self.layout.append((shape, offset))
            offset += math.prod(shape)
        self.parameter_count = offset

    def macs(self) -> int:
        """Multiply-adds of one lane's step: the gate products and the output."""
        return 4 * self.hidden * (self.obs_size + self.hidden) + self.act_size * self.hidden

    def output_bias(self) -> Tuple[int, int]:
        (size,), offset = self.layout[4]
        return offset, size

    def initial_state(self, n: int, device):
        zeros = torch.zeros((n, self.hidden), dtype=torch.float32, device=device)
        return zeros, zeros.clone()

    def __call__(self, params: torch.Tensor, obs: torch.Tensor, state=None):
        w_hh, w_ih, b_hh, b_ih, bias, weight = (
            params[:, off : off + math.prod(shape)].unflatten(1, shape) for shape, off in self.layout
        )
        h, c = self.initial_state(obs.shape[0], obs.device) if state is None else state
        pre = torch.baddbmm(b_ih.unsqueeze(1), obs.unsqueeze(1), w_ih.transpose(1, 2))
        pre = torch.baddbmm(pre, h.unsqueeze(1), w_hh.transpose(1, 2))
        pre = (pre + b_hh.unsqueeze(1)).squeeze(1)
        H = self.hidden
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H : 2 * H])
        g = torch.tanh(pre[:, 2 * H : 3 * H])
        o = torch.sigmoid(pre[:, 3 * H :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        y = torch.baddbmm(bias.unsqueeze(1), h.unsqueeze(1), weight.transpose(1, 2)).squeeze(1)
        return y, (h, c)
