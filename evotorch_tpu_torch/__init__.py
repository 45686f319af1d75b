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
``checkpoint``; the other searchers (``CMAES``, ``GeneticAlgorithm``,
``SteadyStateGA``, ``Cosyne``, ``MAPElites``, the restarts, the functional
SNES, XNES, CEM, CMA-ES, GA and MAP-Elites, batched searches and
``make_search_span``), the variation operators and Pareto utilities
(``operators``) and the ``decorators``; and the parallel layer
(``parallel``: one rank per card over ``torch.distributed``, sharded
evaluation and generations, the distributed gradient path, host worker
pools), with ``make_training_span``; object-typed problems
(``dtype=object``: ``tools.ObjectArray``, ``operators.sequence.CutAndSplice``)
with the immutable containers and ``ReadOnlyTensor``, the constraint
penalties (``tools.constraints``) and ``testing``; the batched structures
and ``TensorFrame`` (``tools``, aliased as ``utils``) and the policy
factories (``models``); and the host backends: ``GymNE`` over gym-API
envs with its serial, chunked and pipelined lane engines
(``neuroevolution.net.hostvecenv``; the policy forward batched on the
card), real MuJoCo through ``envs.mujoco``, the host tracer, counters and
tuned-config cache (``observability``) and fault injection
(``resilience.faults``). Other parts of the JAX package are listed as open
work in ``ROADMAP.md``.

The decorators are imported here, as in the JAX package; ``Problem`` and
the other names of ``core`` load on first use, so that importing the
package does not yet bind ``_device.resolve_device`` into ``core``.
"""

from ._device import resolve_device
from .decorators import expects_ndim, on_aux_device, on_cuda, on_device, pass_info, rowwise, vectorized

_CORE_NAMES = ("Problem", "ProblemBoundEvaluator", "Solution", "SolutionBatch", "SolutionBatchPieces")

__all__ = [
    "Problem",
    "ProblemBoundEvaluator",
    "Solution",
    "SolutionBatch",
    "SolutionBatchPieces",
    "expects_ndim",
    "on_aux_device",
    "on_cuda",
    "on_device",
    "pass_info",
    "resolve_device",
    "rowwise",
    "vectorized",
]


def __getattr__(name):
    if name in _CORE_NAMES:
        from . import core

        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
