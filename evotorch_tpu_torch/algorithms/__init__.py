"""Search algorithms (counterpart of ``evotorch_tpu/algorithms``): the
functional forms so far."""

from . import functional

__all__ = ["functional"]
