"""Network utilities for neuroevolution (counterpart of
``evotorch_tpu/neuroevolution/net``)."""

from . import functional, layers, parser, rl, runningnorm, vecrl
from .functional import FlatParamsPolicy
from .layers import (
    Apply,
    Bias,
    Bin,
    Clip,
    FrozenModule,
    Linear,
    Module,
    ReLU,
    Round,
    Sequential,
    Sigmoid,
    Slice,
    Softmax,
    Tanh,
    tanh_mlp,
)
from .parser import NetParsingError, str_to_net
from .rl import ActClipLayer, ObsNormLayer
from .runningnorm import CollectedStats, RunningNorm, stats_init, stats_merge, stats_normalize, stats_update
from .vecrl import RolloutResult, run_vectorized_rollout, run_vectorized_rollout_compacting

__all__ = [
    "ActClipLayer",
    "Apply",
    "Bias",
    "Bin",
    "Clip",
    "CollectedStats",
    "FlatParamsPolicy",
    "FrozenModule",
    "Linear",
    "Module",
    "NetParsingError",
    "ObsNormLayer",
    "ReLU",
    "RolloutResult",
    "Round",
    "RunningNorm",
    "Sequential",
    "Sigmoid",
    "Slice",
    "Softmax",
    "Tanh",
    "run_vectorized_rollout",
    "run_vectorized_rollout_compacting",
    "stats_init",
    "stats_merge",
    "stats_normalize",
    "stats_update",
    "str_to_net",
    "tanh_mlp",
]
