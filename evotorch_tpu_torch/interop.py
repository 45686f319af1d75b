"""Carry weights and state between the JAX package and this port.

Everything crosses as numpy arrays (the caller flattens the JAX pytrees;
this module never imports JAX):

- the PGPE state with a ClipUp optimizer, as a flat dict
  (``center``, ``velocity``, ``center_learning_rate``, ``momentum``,
  ``max_speed``, ``stdev``, ``stdev_learning_rate``, ``stdev_min``,
  ``stdev_max``, ``stdev_max_change`` plus the static ``optimizer``,
  ``ranking_method``, ``maximize``, ``symmetric``);
- flat policy parameters, after checking that the JAX leaf shapes (in
  ``ravel_pytree`` order) are the port's layout;
- observation-normalization statistics (``count``, ``sum``,
  ``sum_of_squares``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .algorithms.functional.funcclipup import ClipUpState
from .algorithms.functional.funcpgpe import PGPEState
from .neuroevolution.net.functional import FlatParamsPolicy
from .neuroevolution.net.runningnorm import CollectedStats

__all__ = [
    "pgpe_state_from_numpy",
    "pgpe_state_to_numpy",
    "policy_params_from_numpy",
    "policy_params_to_numpy",
    "stats_from_numpy",
    "stats_to_numpy",
]

_CLIPUP_FIELDS = ("center", "velocity", "center_learning_rate", "momentum", "max_speed")
_PGPE_FIELDS = ("stdev", "stdev_learning_rate", "stdev_min", "stdev_max", "stdev_max_change")
_PGPE_STATIC = ("optimizer", "ranking_method", "maximize", "symmetric")


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def pgpe_state_from_numpy(arrays: Mapping, *, device=None) -> PGPEState:
    """A :class:`PGPEState` (ClipUp optimizer) from the flat dict above."""
    device = resolve_device(device)
    if arrays.get("optimizer", "clipup") != "clipup":
        raise NotImplementedError("only a ClipUp optimizer state is carried across so far")
    missing = [k for k in _CLIPUP_FIELDS + _PGPE_FIELDS + _PGPE_STATIC if k not in arrays]
    if missing:
        raise KeyError(f"PGPE state is missing {missing}")
    opt = ClipUpState(**{k: _tensor(arrays[k], device) for k in _CLIPUP_FIELDS})
    return PGPEState(
        optimizer_state=opt,
        **{k: _tensor(arrays[k], device) for k in _PGPE_FIELDS},
        optimizer=arrays["optimizer"],
        ranking_method=str(arrays["ranking_method"]),
        maximize=bool(arrays["maximize"]),
        symmetric=bool(arrays["symmetric"]),
    )


def pgpe_state_to_numpy(state: PGPEState) -> dict:
    """The inverse of :func:`pgpe_state_from_numpy`."""
    out = {k: getattr(state.optimizer_state, k).detach().cpu().numpy() for k in _CLIPUP_FIELDS}
    out.update({k: getattr(state, k).detach().cpu().numpy() for k in _PGPE_FIELDS})
    out.update({k: getattr(state, k) for k in _PGPE_STATIC})
    return out


def _check_layout(policy: FlatParamsPolicy, leaf_shapes: Sequence[Sequence[int]], length: int) -> None:
    ours = [shape for _, shape, _ in policy.layout]
    theirs = [tuple(int(d) for d in s) for s in leaf_shapes]
    if theirs != ours:
        raise ValueError(f"parameter layouts differ: the JAX leaves are {theirs}, the port expects {ours}")
    if length != policy.parameter_count:
        raise ValueError(f"expected {policy.parameter_count} parameters per solution, got {length}")


def policy_params_from_numpy(
    policy: FlatParamsPolicy, flat: np.ndarray, leaf_shapes: Sequence[Sequence[int]], *, device=None
) -> torch.Tensor:
    """Flat parameters ``(L,)`` or a population ``(N, L)``; ``leaf_shapes``
    are the JAX parameter leaves' shapes in ``ravel_pytree`` order."""
    flat = np.asarray(flat, dtype=np.float32)
    _check_layout(policy, leaf_shapes, flat.shape[-1])
    return torch.as_tensor(flat, device=resolve_device(device))


def policy_params_to_numpy(policy: FlatParamsPolicy, params: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`policy_params_from_numpy`."""
    if params.shape[-1] != policy.parameter_count:
        raise ValueError(f"expected {policy.parameter_count} parameters per solution, got {params.shape[-1]}")
    return params.detach().cpu().numpy()


def stats_from_numpy(arrays: Mapping, *, device=None) -> CollectedStats:
    """:class:`CollectedStats` from ``count``, ``sum`` and ``sum_of_squares``."""
    device = resolve_device(device)
    return CollectedStats(**{k: _tensor(arrays[k], device) for k in ("count", "sum", "sum_of_squares")})


def stats_to_numpy(stats: CollectedStats) -> dict:
    """The inverse of :func:`stats_from_numpy`."""
    return {
        "count": stats.count.detach().cpu().numpy(),
        "sum": stats.sum.detach().cpu().numpy(),
        "sum_of_squares": stats.sum_of_squares.detach().cpu().numpy(),
    }
