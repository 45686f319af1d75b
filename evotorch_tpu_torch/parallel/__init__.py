"""Whole-generation steps (counterpart of ``evotorch_tpu/parallel``):
the single-device generation step so far."""

from .evaluate import make_generation_step

__all__ = ["make_generation_step"]
