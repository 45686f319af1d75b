"""Functional ask/tell algorithms and optimizers (counterpart of
``evotorch_tpu/algorithms/functional``): PGPE with ClipUp so far."""

from .funcclipup import ClipUpState, clipup, clipup_ask, clipup_tell
from .funcpgpe import PGPEState, pgpe, pgpe_ask, pgpe_health, pgpe_tell
from .misc import OptimizerFunctions, get_functional_optimizer

__all__ = [
    "ClipUpState",
    "OptimizerFunctions",
    "PGPEState",
    "clipup",
    "clipup_ask",
    "clipup_tell",
    "get_functional_optimizer",
    "pgpe",
    "pgpe_ask",
    "pgpe_health",
    "pgpe_tell",
]
