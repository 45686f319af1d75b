"""Alias module: ``evotorch_tpu_torch.utils`` is ``evotorch_tpu_torch.tools``
(counterpart of ``evotorch_tpu/utils.py``); the symbols and the submodules
resolve under either name."""

from . import tools as _tools
from .tools import *  # noqa: F401,F403
from .tools import (  # noqa: F401
    cloning,
    constraints,
    hook,
    immutable,
    lowrank,
    misc,
    objectarray,
    pytree,
    ranking,
    readonlytensor,
    structures,
    tensorframe,
)

__all__ = _tools.__all__
