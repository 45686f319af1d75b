"""Hand-written CUDA kernels for Hopper, the counterparts of the JAX
package's Pallas TPU kernels (``evotorch_tpu/ops``):

- ``sample_symmetric_gaussian`` (``csrc/symmetric_gaussian.cu``): the
  antithetic PGPE population, noise from an in-kernel Philox generator.
- ``centered_rank`` (``csrc/centered_rank.cu``): centered ranks by an
  O(n^2) comparison under the (isnan, value, index) order.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version beside it for a CPU tensor; each counts its launches
in a ``launches`` attribute. ``_build`` compiles the sources at first use,
the third among them: ``csrc/rigid_body_step.cu``, the locomotion envs'
physics step, which replaces no TPU kernel and whose wrapper is
``envs/rigidbody.py:physics_step_batched``.
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
