"""Neuroevolution (counterpart of ``evotorch_tpu/neuroevolution``): the
``NEProblem``, ``VecNE`` and ``SupervisedNE`` problems over the vectorized
policy and rollout layer (``net``), and ``GymNE`` over gym-API envs stepped
on the host."""

from . import net
from .gymne import GymNE
from .neproblem import BaseNEProblem, NEProblem
from .supervisedne import SupervisedNE, cross_entropy_loss, mse_loss
from .vecneproblem import VecGymNE, VecNE

__all__ = [
    "BaseNEProblem",
    "GymNE",
    "NEProblem",
    "SupervisedNE",
    "VecGymNE",
    "VecNE",
    "cross_entropy_loss",
    "mse_loss",
    "net",
]
