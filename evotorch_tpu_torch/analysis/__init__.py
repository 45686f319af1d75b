"""Static and runtime guardrails of the port's hot paths (counterpart of
``evotorch_tpu/analysis``).

- :mod:`~evotorch_tpu_torch.analysis.graftlint` / ``checkers``: the
  ``graftlint`` AST lint, redesigned for eager PyTorch (explicit
  generators, first-use work, host syncs, writes to a functional program's
  inputs, process groups, dtypes, unsynced timing, swallowed exceptions,
  telemetry columns). Run it with ``python -m evotorch_tpu_torch.analysis``;
  findings not in ``analysis/baseline.json`` fail the fast tier through
  ``tests/test_torch_lint.py``.
- :mod:`~evotorch_tpu_torch.analysis.retrace_sentinel`: the first-use
  sentinel, which counts the kernel builds and allocator segments inside a
  region, the torch counterpart of the JAX package's compile counter.
"""

from .graftlint import (
    Finding,
    apply_baseline,
    default_baseline_path,
    default_targets,
    lint_sources,
    load_baseline,
    run_lint,
    save_baseline,
)
from .retrace_sentinel import FirstUseLog, RetraceError, assert_first_use, track_first_use

__all__ = [
    "Finding",
    "run_lint",
    "lint_sources",
    "load_baseline",
    "save_baseline",
    "apply_baseline",
    "default_targets",
    "default_baseline_path",
    "FirstUseLog",
    "RetraceError",
    "assert_first_use",
    "track_first_use",
]
