"""Search algorithms (counterpart of ``evotorch_tpu/algorithms``): the
Gaussian searchers PGPE, SNES, CEM and XNES over ``SearchAlgorithm``, and
the functional forms."""

from . import functional
from .gaussian import CEM, PGPE, SNES, XNES, GaussianSearchAlgorithm
from .searchalgorithm import SearchAlgorithm, SinglePopulationAlgorithmMixin

__all__ = [
    "CEM",
    "GaussianSearchAlgorithm",
    "PGPE",
    "SNES",
    "SearchAlgorithm",
    "SinglePopulationAlgorithmMixin",
    "XNES",
    "functional",
]
