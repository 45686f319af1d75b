"""Functional-optimizer registry and shared helpers (counterpart of
``evotorch_tpu/algorithms/functional/misc.py``)."""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Union

import numpy as np
import torch

__all__ = ["OptimizerFunctions", "as_center", "as_vector_like", "get_functional_optimizer"]


def as_center(x) -> torch.Tensor:
    """A search's initial center as a tensor: a tensor keeps its device;
    anything else goes to the default device (the card), float64 becoming
    float32 as ``jnp.asarray`` makes it."""
    if isinstance(x, torch.Tensor):
        return x
    from ..._device import resolve_device

    x = torch.as_tensor(np.asarray(x))
    if x.dtype == torch.float64:
        x = x.float()
    return x.to(resolve_device())


def as_vector_like(x, center: torch.Tensor, default: float) -> torch.Tensor:
    """A scalar, ``None`` (``default``) or vector hyperparameter as a vector
    of the center's length, dtype and device."""
    if x is None:
        x = default
    x = torch.as_tensor(x, dtype=center.dtype, device=center.device)
    if x.ndim == 0:
        return x.expand(center.shape[-1:])
    return x


class OptimizerFunctions(NamedTuple):
    initialize: Callable
    ask: Callable
    tell: Callable


def get_functional_optimizer(optimizer: Union[str, tuple]) -> OptimizerFunctions:
    """``"adam"`` -> ``(adam, adam_ask, adam_tell)``, likewise ``"clipup"``
    and ``"sgd"`` (or ``"sga"``, ``"momentum"``); a 3-tuple of callables
    passes through as a custom optimizer."""
    from .funcadam import adam, adam_ask, adam_tell
    from .funcclipup import clipup, clipup_ask, clipup_tell
    from .funcsgd import sgd, sgd_ask, sgd_tell

    if optimizer == "adam":
        return OptimizerFunctions(adam, adam_ask, adam_tell)
    if optimizer == "clipup":
        return OptimizerFunctions(clipup, clipup_ask, clipup_tell)
    if optimizer in ("sgd", "sga", "momentum"):
        return OptimizerFunctions(sgd, sgd_ask, sgd_tell)
    if isinstance(optimizer, str):
        raise ValueError(f"Unrecognized functional optimizer name: {optimizer}")
    if isinstance(optimizer, Iterable):
        a, b, c = optimizer
        return OptimizerFunctions(a, b, c)
    raise TypeError(f"Unrecognized optimizer specification: {optimizer!r}")
