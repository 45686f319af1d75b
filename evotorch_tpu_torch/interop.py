"""Carry weights and state between the JAX package and this port.

Everything crosses as numpy arrays (the caller flattens the JAX objects;
this module never imports JAX):

- the functional PGPE state with a ClipUp, Adam or SGD optimizer, as a
  flat dict: the optimizer state's fields (ClipUp: ``center``,
  ``velocity``, ``center_learning_rate``, ``momentum``, ``max_speed``;
  Adam: ``center``, ``center_learning_rate``, ``beta1``, ``beta2``,
  ``epsilon``, ``m``, ``v``, ``t``; SGD: ``center``, ``velocity``,
  ``center_learning_rate``, ``momentum``), then ``stdev``,
  ``stdev_learning_rate``, ``stdev_min``, ``stdev_max``,
  ``stdev_max_change`` and the static ``optimizer``, ``ranking_method``,
  ``maximize``, ``symmetric``;
- an OO searcher's state, as a flat dict: ``distribution.<name>`` for each
  tensor parameter of its distribution (``mu``, ``sigma``, and XNES's
  ``sigma_inv``), ``optimizer.<name>`` for its optimizer's state (ClipUp
  and SGD: ``velocity``; Adam: ``m``, ``v``, ``t``), and, for a ``VecNE``
  problem, ``obs_norm.count``, ``obs_norm.sum`` and
  ``obs_norm.sum_of_squares``;
- flat policy parameters, after checking that the JAX leaf shapes (in
  ``ravel_pytree`` order) are the port's layout;
- observation-normalization statistics (``count``, ``sum``,
  ``sum_of_squares``);
- the functional states of CMA-ES, SNES, XNES, CEM, the GA and
  MAP-Elites, as a flat dict of their fields by name (the JAX state's
  fields are the port's): tensor fields as numpy arrays, the others as
  Python values (CMA-ES's ``iteration`` as an int, which the port keeps on
  the host);
- factored populations, as a dict of ``center``, ``basis`` and ``coeffs``
  and, for a trunk-delta one, ``factors``: one ``(a, b)`` pair per
  parameter leaf, in layout order (the JAX factor tree's leaves in
  ``tree_leaves`` order, which is the ``ravel_pytree`` order);
- the host ``RunningStat`` of ``GymNE``, as ``count``, ``sum`` and
  ``sum_of_squares``;
- the structures of ``tools/structures.py`` (``CMemory``, ``CDict``,
  ``CList``, ``CBag``), as a flat dict with ``kind`` (the class name) and
  each dataclass field by name, a nested structure's fields prefixed with
  its name (``memory.data``): tensors as numpy arrays, static fields as
  Python values;
- a ``TensorFrame``, as ``{column name: array}`` in column order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .algorithms.functional.funcadam import AdamState
from .algorithms.functional.funccem import CEMState
from .algorithms.functional.funccmaes import CMAESState
from .algorithms.functional.funcga import GAState
from .algorithms.functional.funcmapelites import MAPElitesState
from .algorithms.functional.funcclipup import ClipUpState
from .algorithms.functional.funcpgpe import PGPEState
from .algorithms.functional.funcsgd import SGDState
from .algorithms.functional.funcsnes import SNESState
from .algorithms.functional.funcxnes import XNESState
from .neuroevolution.net.functional import FlatParamsPolicy
from .neuroevolution.net.lowrank import _Factor
from .neuroevolution.net.runningnorm import CollectedStats, RunningStat
from .tools.lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch
from .tools.structures import CBag, CDict, CList, CMemory
from .tools.tensorframe import TensorFrame

__all__ = [
    "cem_state_from_numpy",
    "cem_state_to_numpy",
    "cmaes_state_from_numpy",
    "cmaes_state_to_numpy",
    "ga_state_from_numpy",
    "ga_state_to_numpy",
    "load_searcher_state",
    "lowrank_batch_from_numpy",
    "lowrank_batch_to_numpy",
    "mapelites_state_from_numpy",
    "mapelites_state_to_numpy",
    "pgpe_state_from_numpy",
    "pgpe_state_to_numpy",
    "policy_params_from_numpy",
    "policy_params_to_numpy",
    "running_stat_from_numpy",
    "running_stat_to_numpy",
    "searcher_state_to_numpy",
    "snes_state_from_numpy",
    "snes_state_to_numpy",
    "group_stats_from_numpy",
    "stats_from_numpy",
    "stats_to_numpy",
    "structure_from_numpy",
    "structure_to_numpy",
    "tensorframe_from_numpy",
    "tensorframe_to_numpy",
    "trunk_delta_batch_from_numpy",
    "trunk_delta_batch_to_numpy",
    "xnes_state_from_numpy",
    "xnes_state_to_numpy",
]

#: the functional optimizer states, by the name PGPE knows each one under
_OPTIMIZER_STATES = {"clipup": ClipUpState, "adam": AdamState, "sgd": SGDState}
_PGPE_FIELDS = ("stdev", "stdev_learning_rate", "stdev_min", "stdev_max", "stdev_max_change")
_PGPE_STATIC = ("optimizer", "ranking_method", "maximize", "symmetric")
#: the state of each stateful optimizer (``optimizers.py``), by attribute
_OO_OPTIMIZER_FIELDS = {"ClipUp": ("velocity",), "SGD": ("velocity",), "Adam": ("m", "v", "t")}
_STATS_FIELDS = ("count", "sum", "sum_of_squares")


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _optimizer_state_class(name: str):
    key = {"sga": "sgd", "momentum": "sgd"}.get(name, name)
    if key not in _OPTIMIZER_STATES:
        raise ValueError(f"no functional optimizer state is known as {name!r}")
    return _OPTIMIZER_STATES[key]


def pgpe_state_from_numpy(arrays: Mapping, *, device=None) -> PGPEState:
    """A :class:`PGPEState` from the flat dict above (ClipUp when it names
    no optimizer)."""
    device = resolve_device(device)
    optimizer = arrays.get("optimizer", "clipup")
    state_cls = _optimizer_state_class(optimizer)
    fields = tuple(f.name for f in dataclasses.fields(state_cls))
    missing = [k for k in fields + _PGPE_FIELDS + _PGPE_STATIC if k not in arrays]
    if missing:
        raise KeyError(f"PGPE state is missing {missing}")
    opt = state_cls(**{k: _tensor(arrays[k], device) for k in fields})
    return PGPEState(
        optimizer_state=opt,
        **{k: _tensor(arrays[k], device) for k in _PGPE_FIELDS},
        optimizer=optimizer,
        ranking_method=str(arrays["ranking_method"]),
        maximize=bool(arrays["maximize"]),
        symmetric=bool(arrays["symmetric"]),
    )


def pgpe_state_to_numpy(state: PGPEState) -> dict:
    """The inverse of :func:`pgpe_state_from_numpy`."""
    out = {f.name: _numpy(getattr(state.optimizer_state, f.name)) for f in dataclasses.fields(state.optimizer_state)}
    out.update({k: _numpy(getattr(state, k)) for k in _PGPE_FIELDS})
    out.update({k: getattr(state, k) for k in _PGPE_STATIC})
    return out


def searcher_state_to_numpy(searcher) -> dict:
    """An OO searcher's state as the flat dict described above."""
    out = {
        f"distribution.{k}": _numpy(v)
        for k, v in searcher.distribution.parameters.items()
        if isinstance(v, torch.Tensor)
    }
    optimizer = searcher.optimizer
    if optimizer is not None:
        for name in _OO_OPTIMIZER_FIELDS[type(optimizer).__name__]:
            out[f"optimizer.{name}"] = _numpy(getattr(optimizer, f"_{name}"))
    obs_norm = getattr(searcher.problem, "obs_norm", None)
    if obs_norm is not None:
        out.update({f"obs_norm.{k}": _numpy(getattr(obs_norm.stats, k)) for k in _STATS_FIELDS})
    return out


def load_searcher_state(searcher, arrays: Mapping) -> None:
    """Set an OO searcher's distribution parameters, optimizer state and (on
    a ``VecNE`` problem) observation statistics from the flat dict above;
    keys it does not give are left as they are."""
    device = searcher.problem.device
    dist = searcher.distribution
    overrides = {
        k.split(".", 1)[1]: _tensor(v, device) for k, v in arrays.items() if k.startswith("distribution.")
    }
    unknown = set(overrides) - set(dist.parameters)
    if unknown:
        raise KeyError(f"{type(dist).__name__} has no parameters {sorted(unknown)}")
    searcher._distribution = dist.modified_copy(**overrides)
    optimizer = searcher.optimizer
    if optimizer is not None:
        for name in _OO_OPTIMIZER_FIELDS[type(optimizer).__name__]:
            if f"optimizer.{name}" in arrays:
                setattr(optimizer, f"_{name}", _tensor(arrays[f"optimizer.{name}"], device))
    if any(k.startswith("obs_norm.") for k in arrays):
        searcher.problem.obs_norm.stats = stats_from_numpy(
            {k: arrays[f"obs_norm.{k}"] for k in _STATS_FIELDS}, device=device
        )


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


def group_stats_from_numpy(arrays: Mapping, *, device=None) -> CollectedStats:
    """Stacked (per-group) :class:`CollectedStats` from ``count (G,)``,
    ``sum (G, n)`` and ``sum_of_squares (G, n)``: the JAX package's
    ``runningnorm.group_stats_*`` slots, one per group."""
    stats = stats_from_numpy(arrays, device=device)
    if stats.count.ndim != 1 or stats.sum.ndim != 2 or stats.sum.shape != stats.sum_of_squares.shape:
        raise ValueError(
            "stacked statistics hold count (G,), sum (G, n) and sum_of_squares (G, n); got"
            f" {tuple(stats.count.shape)}, {tuple(stats.sum.shape)}, {tuple(stats.sum_of_squares.shape)}"
        )
    return stats


_STATIC_CASTS = {"int": int, "bool": bool, "float": float, "str": str}


def _static_value(annotation: str, value):
    if annotation in _STATIC_CASTS:
        return _STATIC_CASTS[annotation](np.asarray(value).item() if isinstance(value, np.ndarray) else value)
    if isinstance(value, str):
        return value
    return tuple(str(v) for v in value)  # a GA's objective senses


def _state_from_numpy(state_cls, arrays: Mapping, device):
    device = resolve_device(device)
    fields = dataclasses.fields(state_cls)
    missing = [f.name for f in fields if f.name not in arrays]
    if missing:
        raise KeyError(f"{state_cls.__name__} is missing {missing}")
    return state_cls(
        **{
            f.name: torch.as_tensor(np.array(arrays[f.name]), device=device)
            if f.type == "torch.Tensor"
            else _static_value(f.type, arrays[f.name])
            for f in fields
        }
    )


def _state_to_numpy(state) -> dict:
    return {
        f.name: _numpy(getattr(state, f.name)) if isinstance(getattr(state, f.name), torch.Tensor) else getattr(state, f.name)
        for f in dataclasses.fields(state)
    }


def cmaes_state_from_numpy(arrays: Mapping, *, device=None) -> CMAESState:
    """A :class:`CMAESState` from its fields as numpy arrays and values."""
    return _state_from_numpy(CMAESState, arrays, device)


def cmaes_state_to_numpy(state: CMAESState) -> dict:
    return _state_to_numpy(state)


def snes_state_from_numpy(arrays: Mapping, *, device=None) -> SNESState:
    return _state_from_numpy(SNESState, arrays, device)


def snes_state_to_numpy(state: SNESState) -> dict:
    return _state_to_numpy(state)


def xnes_state_from_numpy(arrays: Mapping, *, device=None) -> XNESState:
    return _state_from_numpy(XNESState, arrays, device)


def xnes_state_to_numpy(state: XNESState) -> dict:
    return _state_to_numpy(state)


def cem_state_from_numpy(arrays: Mapping, *, device=None) -> CEMState:
    return _state_from_numpy(CEMState, arrays, device)


def cem_state_to_numpy(state: CEMState) -> dict:
    return _state_to_numpy(state)


def ga_state_from_numpy(arrays: Mapping, *, device=None) -> GAState:
    return _state_from_numpy(GAState, arrays, device)


def ga_state_to_numpy(state: GAState) -> dict:
    return _state_to_numpy(state)


def mapelites_state_from_numpy(arrays: Mapping, *, device=None) -> MAPElitesState:
    return _state_from_numpy(MAPElitesState, arrays, device)


def mapelites_state_to_numpy(state: MAPElitesState) -> dict:
    return _state_to_numpy(state)


_FACTORED_FIELDS = ("center", "basis", "coeffs")


def lowrank_batch_from_numpy(arrays: Mapping, *, device=None) -> LowRankParamsBatch:
    """A :class:`LowRankParamsBatch` from ``center`` ``(L,)``, ``basis``
    ``(L, k)`` and ``coeffs`` ``(N, k)``."""
    device = resolve_device(device)
    return LowRankParamsBatch(*(_tensor(arrays[k], device) for k in _FACTORED_FIELDS))


def lowrank_batch_to_numpy(batch) -> dict:
    """The inverse of :func:`lowrank_batch_from_numpy` (also the shared
    algebra of a trunk-delta batch)."""
    return {k: _numpy(getattr(batch, k)) for k in _FACTORED_FIELDS}


def trunk_delta_batch_from_numpy(arrays: Mapping, *, device=None) -> TrunkDeltaParamsBatch:
    """A :class:`TrunkDeltaParamsBatch` from ``center``, ``basis``,
    ``coeffs`` and ``factors``, a sequence of ``(a, b)`` pairs in layout
    order."""
    device = resolve_device(device)
    factors = [_Factor(_tensor(a, device), _tensor(b, device)) for a, b in arrays["factors"]]
    return TrunkDeltaParamsBatch(*(_tensor(arrays[k], device) for k in _FACTORED_FIELDS), factors)


def trunk_delta_batch_to_numpy(batch: TrunkDeltaParamsBatch) -> dict:
    """The inverse of :func:`trunk_delta_batch_from_numpy`."""
    out = lowrank_batch_to_numpy(batch)
    out["factors"] = [(_numpy(f.a), _numpy(f.b)) for f in batch.factors]
    return out


def running_stat_from_numpy(arrays: Mapping) -> RunningStat:
    """A host ``RunningStat`` from ``count``, ``sum`` and
    ``sum_of_squares`` (an empty one for a count of 0)."""
    stat = RunningStat()
    count = int(arrays["count"])
    if count:
        stat._count = count
        stat._sum = np.array(arrays["sum"], dtype=np.float64)
        stat._sum_of_squares = np.array(arrays["sum_of_squares"], dtype=np.float64)
    return stat


def running_stat_to_numpy(stat: RunningStat) -> dict:
    return {"count": stat.count, "sum": stat.sum, "sum_of_squares": stat.sum_of_squares}


_STRUCTURES = {cls.__name__: cls for cls in (CMemory, CDict, CList, CBag)}


def _structure_fields(cls, arrays: Mapping, prefix: str, device) -> Any:
    values = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.name == "memory":
            values[f.name] = _structure_fields(CMemory, arrays, key + ".", device)
        elif f.metadata.get("static", False):
            value = arrays[key]
            values[f.name] = tuple(value) if isinstance(value, (list, tuple)) else value
        else:
            values[f.name] = torch.as_tensor(np.array(arrays[key]), device=device)
    return cls(**values)


def structure_from_numpy(arrays: Mapping, *, device=None):
    """A ``CMemory``, ``CDict``, ``CList`` or ``CBag`` (by ``kind``) from its
    fields, on ``device`` (the card unless given)."""
    return _structure_fields(_STRUCTURES[arrays["kind"]], arrays, "", resolve_device(device))


def structure_to_numpy(structure) -> dict:
    out = {"kind": type(structure).__name__}

    def put(obj, prefix):
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.name == "memory":
                put(value, prefix + "memory.")
            elif isinstance(value, torch.Tensor):
                out[prefix + f.name] = value.detach().cpu().numpy()
            else:
                out[prefix + f.name] = value

    put(structure, "")
    return out


def tensorframe_from_numpy(columns: Mapping, *, device=None) -> TensorFrame:
    """A ``TensorFrame`` from ``{column name: array}``, in that order."""
    device = resolve_device(device)
    return TensorFrame(
        columns=tuple(columns), data=tuple(torch.as_tensor(np.array(v), device=device) for v in columns.values())
    )


def tensorframe_to_numpy(frame: TensorFrame) -> dict:
    return {name: col.detach().cpu().numpy() for name, col in zip(frame.columns, frame.data)}
