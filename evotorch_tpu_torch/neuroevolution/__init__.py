"""Neuroevolution (counterpart of ``evotorch_tpu/neuroevolution``): the
``NEProblem``, ``VecNE`` and ``SupervisedNE`` problems over the vectorized
policy and rollout layer (``net``)."""

from . import net
from .neproblem import BaseNEProblem, NEProblem
from .supervisedne import SupervisedNE, cross_entropy_loss, mse_loss
from .vecneproblem import VecGymNE, VecNE

__all__ = [
    "BaseNEProblem",
    "NEProblem",
    "SupervisedNE",
    "VecGymNE",
    "VecNE",
    "cross_entropy_loss",
    "mse_loss",
    "net",
]
