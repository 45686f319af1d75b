"""Search algorithms (counterpart of ``evotorch_tpu/algorithms``): the
distribution-based searchers (PGPE, SNES, CEM, XNES, CMAES, PyCMAES), the
population-based ones (GeneticAlgorithm, SteadyStateGA, Cosyne,
MAPElites), the restart meta-algorithms, and the functional forms."""

from . import functional
from .cmaes import CMAES, PyCMAES
from .ga import Cosyne, GeneticAlgorithm, SteadyStateGA
from .gaussian import CEM, PGPE, SNES, XNES, GaussianSearchAlgorithm
from .mapelites import MAPElites
from .restarter import IPOP, ModifyingRestart, Restart
from .searchalgorithm import SearchAlgorithm, SinglePopulationAlgorithmMixin

__all__ = [
    "CEM",
    "CMAES",
    "Cosyne",
    "GaussianSearchAlgorithm",
    "GeneticAlgorithm",
    "IPOP",
    "MAPElites",
    "ModifyingRestart",
    "PGPE",
    "PyCMAES",
    "Restart",
    "SNES",
    "SearchAlgorithm",
    "SinglePopulationAlgorithmMixin",
    "SteadyStateGA",
    "XNES",
    "functional",
]
