"""Variation operators (counterpart of ``evotorch_tpu/operators``): the
functional forms in ``functional``, the object forms over ``SolutionBatch``
in ``base`` and ``real``."""

from . import functional

__all__ = ["functional"]
