"""Runtime guardrails of the hot paths (counterpart of
``evotorch_tpu/analysis``): the first-use sentinel
(:mod:`~evotorch_tpu_torch.analysis.retrace_sentinel`), which counts the
kernel builds and allocator segments inside a region, the torch
counterpart of the JAX package's compile counter. The JAX package's
``graftlint`` suite (``graftlint.py``, ``checkers.py``, ``__main__.py``) is
a lint of JAX idioms; its torch counterpart is still to come
(``ROADMAP.md``, item A.14)."""

from .retrace_sentinel import FirstUseLog, RetraceError, assert_first_use, track_first_use

__all__ = ["FirstUseLog", "RetraceError", "assert_first_use", "track_first_use"]
