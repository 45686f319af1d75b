"""The parallel layer (counterpart of ``evotorch_tpu/parallel``): one rank
per card over ``torch.distributed`` in place of the JAX package's device
mesh.

- ``mesh``: the ``Mesh`` (a process group and its named axes) and its
  helpers; the world size stands where the JAX package reads the device
  count.
- ``evaluate``: the sharded evaluators, the generation step and the
  training span of K generations, whose results equal the one-rank run's
  at any world size.
- ``grad``: the sharded ES-gradient estimator, with global ranking by
  default and the reference's per-rank ranking under ``use_shard_map``.
- ``distributed``: joining the group (``init_distributed``) and the
  multi-process dry run.
- ``hostpool``: worker processes for per-solution Python objectives.
"""

from .distributed import dryrun_multihost, init_distributed
from .evaluate import (
    make_generation_step,
    make_sharded_evaluator,
    make_sharded_rollout_evaluator,
    make_training_span,
    population_spec,
    shard_population,
)
from .grad import make_sharded_grad_estimator
from .hostpool import HostEvaluatorPool
from .mesh import MESH_AXES, Mesh, default_mesh, device_count, make_mesh, mesh_label, model_axis_size, parse_mesh_shape

__all__ = [
    "MESH_AXES",
    "Mesh",
    "default_mesh",
    "device_count",
    "make_mesh",
    "mesh_label",
    "model_axis_size",
    "parse_mesh_shape",
    "make_generation_step",
    "make_sharded_evaluator",
    "make_sharded_rollout_evaluator",
    "make_training_span",
    "population_spec",
    "shard_population",
    "make_sharded_grad_estimator",
    "HostEvaluatorPool",
    "init_distributed",
    "dryrun_multihost",
]
