"""Device resolution shared by every entry point of the port.

The card is the default: ``resolve_device(None)`` returns ``cuda`` when a
CUDA device is present and raises otherwise, naming ``device="cpu"`` as the
way to ask for the CPU. It never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    Also pins float32 matrix products and convolutions to full float32 (no
    TF32), so the card computes in the precision the JAX reference uses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "evotorch_tpu_torch runs on a CUDA device by default, and none is"
                ' available; pass device="cpu" to run on the CPU'
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the index a tensor made on "cuda" reports, so devices compare equal
        device = torch.device("cuda", torch.cuda.current_device())
    return device
