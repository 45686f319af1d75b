"""PyTorch/CUDA port of ``evotorch_tpu``.

Module paths mirror the JAX package (``evotorch_tpu``), which stays the
reference every piece here is tested against. The plain tensor code is
eager PyTorch; the two kernels the JAX package wrote in Pallas for the TPU
(``ops/sampling.py`` and ``ops/ranking.py``) are hand-written CUDA C++ for
Hopper (``csrc/``), built at first use by ``ops/_build.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``_device.resolve_device``); without a card and without an explicit
device they raise instead of carrying on quietly on the CPU.

Implemented so far: the flagship PGPE generation (Humanoid, tanh MLP
policy) under every eval contract (``episodes``, ``episodes_refill``,
``episodes_compact``, ``budget``) with the on-device telemetry wire and a
bf16 policy forward (``compute_dtype``), every env of the JAX package's
registry (the locomotion tasks Humanoid, Ant, Walker2D, HalfCheetah and
Hopper, and the classic-control suite), and the object API over them:
``core`` (``Problem``, ``SolutionBatch``), ``algorithms`` (``PGPE``,
``SNES``, ``CEM``, ``XNES``), ``optimizers``, ``neuroevolution``
(``NEProblem``, ``VecNE``, ``SupervisedNE``), ``logging`` and
``checkpoint``. Other parts of the JAX package are listed as open work in
``ROADMAP.md``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
