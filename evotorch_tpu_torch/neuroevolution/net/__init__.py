"""Network utilities for neuroevolution (counterpart of
``evotorch_tpu/neuroevolution/net``)."""

from . import functional, layers, rl, runningnorm, vecrl
from .functional import FlatParamsPolicy
from .layers import Linear, Module, Sequential, Tanh, tanh_mlp
from .runningnorm import CollectedStats, stats_init, stats_normalize, stats_update
from .vecrl import RolloutResult, run_vectorized_rollout, run_vectorized_rollout_compacting

__all__ = [
    "CollectedStats",
    "FlatParamsPolicy",
    "Linear",
    "Module",
    "RolloutResult",
    "Sequential",
    "Tanh",
    "run_vectorized_rollout",
    "run_vectorized_rollout_compacting",
    "stats_init",
    "stats_normalize",
    "stats_update",
    "tanh_mlp",
]
