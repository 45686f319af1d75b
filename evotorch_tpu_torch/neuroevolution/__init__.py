"""Neuroevolution (counterpart of ``evotorch_tpu/neuroevolution``): the
``NEProblem`` and ``VecNE`` problems over the vectorized policy and rollout
layer (``net``)."""

from . import net
from .neproblem import BaseNEProblem, NEProblem
from .vecneproblem import VecGymNE, VecNE

__all__ = ["BaseNEProblem", "NEProblem", "VecGymNE", "VecNE", "net"]
