"""Policy factories over the layers of ``neuroevolution/net/layers.py``
(counterpart of ``evotorch_tpu/models/policies.py``); each gives the JAX
factory's layer stack, so the flat parameter layouts agree."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..neuroevolution.net.layers import (
    LSTM,
    RNN,
    Apply,
    Linear,
    LocomotorNet,
    Module,
    Sequential,
    StructuredControlNet,
)

__all__ = [
    "LinearPolicy",
    "MLPPolicy",
    "RNNPolicy",
    "LSTMPolicy",
    "structured_control_policy",
    "locomotor_policy",
]


def LinearPolicy(obs_length: int, act_length: int, *, bias: bool = True) -> Module:
    """The classic ES linear controller."""
    return Linear(obs_length, act_length, bias=bias)


def MLPPolicy(
    obs_length: int,
    act_length: int,
    *,
    hidden: Sequence[int] = (64, 64),
    activation: Callable = torch.tanh,
    final_activation: Callable = None,
) -> Module:
    """Tanh MLP, the standard ES policy (e.g. Salimans et al. 2017)."""
    modules = []
    in_size = obs_length
    for h in hidden:
        modules.append(Linear(in_size, int(h)))
        modules.append(Apply(activation))
        in_size = int(h)
    modules.append(Linear(in_size, act_length))
    if final_activation is not None:
        modules.append(Apply(final_activation))
    return Sequential(modules)


def RNNPolicy(obs_length: int, act_length: int, *, hidden_size: int = 64) -> Module:
    """Single-step Elman RNN policy for partially observable tasks."""
    return RNN(obs_length, hidden_size) >> Linear(hidden_size, act_length)


def LSTMPolicy(obs_length: int, act_length: int, *, hidden_size: int = 64) -> Module:
    return LSTM(obs_length, hidden_size) >> Linear(hidden_size, act_length)


def structured_control_policy(obs_length: int, act_length: int, *, num_layers: int = 2, hidden_size: int = 32) -> Module:
    """Structured Control Net policy."""
    return StructuredControlNet(
        in_features=obs_length, out_features=act_length, num_layers=num_layers, hidden_size=hidden_size
    )


def locomotor_policy(obs_length: int, act_length: int, *, num_sinusoids: int = 16) -> Module:
    """Locomotor Net policy."""
    return LocomotorNet(in_features=obs_length, out_features=act_length, num_sinusoids=num_sinusoids)
