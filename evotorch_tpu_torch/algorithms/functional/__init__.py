"""Functional ask/tell algorithms and optimizers (counterpart of
``evotorch_tpu/algorithms/functional``): PGPE, SNES, XNES, CEM, CMA-ES, the
GA and MAP-Elites (PGPE also in its factored forms), ``make_search_span``, and the ClipUp, Adam and SGD
optimizers. Extra leading dimensions on the states of CEM, SNES and XNES
are independent searches."""

from .funcadam import AdamState, adam, adam_ask, adam_tell
from .funccem import CEMState, cem, cem_ask, cem_tell
from .funcclipup import ClipUpState, clipup, clipup_ask, clipup_tell
from .funccmaes import CMAESState, cmaes, cmaes_ask, cmaes_tell
from .funcga import GAState, default_variation, ga, ga_ask, ga_tell
from .funcmapelites import MAPElitesState, mapelites, mapelites_ask, mapelites_tell
from .funcpgpe import (
    PGPEState,
    pgpe,
    pgpe_ask,
    pgpe_ask_lowrank,
    pgpe_ask_trunk_delta,
    pgpe_health,
    pgpe_tell,
    pgpe_tell_lowrank,
    pgpe_tell_trunk_delta,
)
from .funcsgd import SGDState, sgd, sgd_ask, sgd_tell
from .funcsnes import SNESState, snes, snes_ask, snes_tell
from .funcxnes import XNESState, xnes, xnes_ask, xnes_tell
from .misc import OptimizerFunctions, get_functional_optimizer
from .span import make_search_span

__all__ = [
    "AdamState",
    "CEMState",
    "CMAESState",
    "ClipUpState",
    "GAState",
    "MAPElitesState",
    "OptimizerFunctions",
    "PGPEState",
    "SGDState",
    "SNESState",
    "XNESState",
    "adam",
    "adam_ask",
    "adam_tell",
    "cem",
    "cem_ask",
    "cem_tell",
    "clipup",
    "clipup_ask",
    "clipup_tell",
    "cmaes",
    "cmaes_ask",
    "cmaes_tell",
    "default_variation",
    "ga",
    "ga_ask",
    "ga_tell",
    "get_functional_optimizer",
    "make_search_span",
    "mapelites",
    "mapelites_ask",
    "mapelites_tell",
    "pgpe",
    "pgpe_ask",
    "pgpe_ask_lowrank",
    "pgpe_ask_trunk_delta",
    "pgpe_health",
    "pgpe_tell",
    "pgpe_tell_lowrank",
    "pgpe_tell_trunk_delta",
    "sgd",
    "sgd_ask",
    "sgd_tell",
    "snes",
    "snes_ask",
    "snes_tell",
    "xnes",
    "xnes_ask",
    "xnes_tell",
]
