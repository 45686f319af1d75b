"""Hand-written CUDA kernels for Hopper, the counterparts of the JAX
package's Pallas TPU kernels (``evotorch_tpu/ops``):

- ``sample_symmetric_gaussian`` (``csrc/symmetric_gaussian.cu``): the
  antithetic PGPE population, noise from an in-kernel Philox generator.
- ``centered_rank`` (``csrc/centered_rank.cu``): centered ranks by an
  O(n^2) comparison under the (isnan, value, index) order.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version beside it for a CPU tensor; each counts its launches
in the counter registry, ``kernel.<stem>.launches`` after its ``csrc``
source (``observability.counters``; ``observability.programs.kernel_launches``
reads them all). The counter counts the wrapper's calls, the launches the
host issues: a launch captured in a CUDA graph counts once, at the capture,
and not at each replay (the device trace counts replays). ``_build`` compiles the sources at first use,
the third among them: ``csrc/rigid_body_step.cu``, the locomotion envs'
physics step (with their observation, reward and done on request), which
replaces no TPU kernel and whose wrappers are
``envs/rigidbody.py:physics_step_batched``, ``env_step_batched`` and
``observe_batched``.
"""

from .ranking import centered_rank, centered_rank_plain
from .sampling import draw_seed, sample_symmetric_gaussian, sample_symmetric_gaussian_plain

__all__ = [
    "centered_rank",
    "centered_rank_plain",
    "draw_seed",
    "sample_symmetric_gaussian",
    "sample_symmetric_gaussian_plain",
]
