"""Functional ask/tell algorithms and optimizers (counterpart of
``evotorch_tpu/algorithms/functional``): PGPE, with ClipUp, Adam and SGD."""

from .funcadam import AdamState, adam, adam_ask, adam_tell
from .funcclipup import ClipUpState, clipup, clipup_ask, clipup_tell
from .funcpgpe import PGPEState, pgpe, pgpe_ask, pgpe_health, pgpe_tell
from .funcsgd import SGDState, sgd, sgd_ask, sgd_tell
from .misc import OptimizerFunctions, get_functional_optimizer

__all__ = [
    "AdamState",
    "ClipUpState",
    "OptimizerFunctions",
    "PGPEState",
    "SGDState",
    "adam",
    "adam_ask",
    "adam_tell",
    "clipup",
    "clipup_ask",
    "clipup_tell",
    "get_functional_optimizer",
    "pgpe",
    "pgpe_ask",
    "pgpe_health",
    "pgpe_tell",
    "sgd",
    "sgd_ask",
    "sgd_tell",
]
