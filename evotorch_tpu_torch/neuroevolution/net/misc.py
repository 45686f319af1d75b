"""Network helpers (counterpart of ``evotorch_tpu/neuroevolution/net/misc.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .functional import count_parameters, fill_parameters, parameter_vector

__all__ = ["count_parameters", "device_of_module", "fill_parameters", "parameter_vector"]


def device_of_module(params) -> Optional[torch.device]:
    """The device of the first tensor among ``params`` (a tensor, or nested
    lists and tuples of them), or None when it holds none."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, (list, tuple)):
        for leaf in params:
            device = device_of_module(leaf)
            if device is not None:
                return device
    return None
