"""Neuroevolution (counterpart of ``evotorch_tpu/neuroevolution``): the
vectorized policy/rollout layer so far."""

from . import net

__all__ = ["net"]
