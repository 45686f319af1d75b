"""``TensorFrame``: a pandas-like columnar table of tensors (counterpart of
``evotorch_tpu/tools/tensorframe.py``).

A pytree dataclass of named, equal-length columns, so whole frames pass
through ``torch.func.vmap``. Rows are read with the ``Picker``
(``frame.pick[rows]`` or ``frame.pick[rows, columns]``); as in the JAX
package, frames are immutable and row assignment is the functional
``frame.pick_set(rows, values)``, which returns a new frame (a boolean mask
lowers to ``torch.where``). Sorts are stable (``torch.argsort(stable=True)``,
as ``jnp.argsort`` is).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from .._device import resolve_device
from .pytree import pytree_dataclass, static_field

__all__ = ["TensorFrame", "Picker"]


def _as_column(v, length: Optional[int], device=None) -> torch.Tensor:
    arr = torch.as_tensor(v, device=device)
    if arr.ndim == 0 and length is not None:
        arr = arr.broadcast_to((length,))
    return arr


def _device_of(values, device=None) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``values``; else the default device (the card, raising without one)."""
    if device is None:
        for v in values:
            if isinstance(v, torch.Tensor):
                return v.device
    return resolve_device(device)


@pytree_dataclass
class TensorFrame:
    columns: tuple = static_field()
    data: tuple = ()  # tensors aligned with `columns`

    # ------------------------------------------------------------- factories
    @staticmethod
    def create(data: Optional[Dict[str, Any]] = None, *, device=None, **kwargs) -> "TensorFrame":
        """A frame from ``{name: column}``; scalars are broadcast to the
        length of the first non-scalar column. Every column lands on
        ``device`` when it is given, else on the device of the first tensor
        column, else on the card (``device="cpu"`` asks for the CPU)."""
        items = dict(data or {}, **kwargs)
        device = _device_of(items.values(), device)
        length = None
        for v in items.values():
            arr = torch.as_tensor(v)
            if arr.ndim > 0:
                length = arr.shape[0]
                break
        arrays = tuple(_as_column(v, length, device) for v in items.values())
        lengths = {a.shape[0] for a in arrays if a.ndim > 0}
        if len(lengths) > 1:
            raise ValueError(f"Columns have differing lengths: {lengths}")
        return TensorFrame(columns=tuple(items.keys()), data=arrays)

    # ------------------------------------------------------------ properties
    def __len__(self) -> int:
        for a in self.data:
            if a.ndim > 0:
                return int(a.shape[0])
        return 0

    @property
    def column_names(self) -> tuple:
        return self.columns

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.columns, self.data))

    # --------------------------------------------------------------- columns
    def __getitem__(self, key):
        if isinstance(key, str):
            try:
                return self.data[self.columns.index(key)]
            except ValueError:
                raise KeyError(f"No column named {key!r} (have {self.columns})") from None
        return self.pick[key]

    def __getattr__(self, name):
        if name.startswith("_") or name in ("columns", "data"):
            raise AttributeError(name)
        if name in self.columns:
            return self.data[self.columns.index(name)]
        raise AttributeError(name)

    def with_columns(self, **new_columns) -> "TensorFrame":
        """The frame with columns added or replaced, on the device of the
        frame's columns (an empty frame takes ``create``'s rule)."""
        length = len(self) if self.data else None
        device = _device_of(self.data or new_columns.values())
        items = self.as_dict()
        for k, v in new_columns.items():
            items[k] = _as_column(v, length, device)
        return TensorFrame(columns=tuple(items.keys()), data=tuple(items.values()))

    def without_columns(self, *names) -> "TensorFrame":
        items = {k: v for k, v in self.as_dict().items() if k not in names}
        return TensorFrame(columns=tuple(items.keys()), data=tuple(items.values()))

    # ----------------------------------------------------------------- rows
    @property
    def pick(self) -> "Picker":
        """Row indexer: ``frame.pick[mask_or_indices]``."""
        return Picker(self)

    def take(self, indices) -> "TensorFrame":
        return TensorFrame(columns=self.columns, data=tuple(a[torch.as_tensor(indices, device=a.device)] for a in self.data))

    def argsort(self, by: str, *, descending: bool = False) -> torch.Tensor:
        """Indices that sort the frame by column ``by`` (stable; descending
        sorts the negated column, as the JAX package does)."""
        key = self[by]
        return torch.argsort(-key if descending else key, stable=True)

    def sort_values(self, by: str, *, descending: bool = False) -> "TensorFrame":
        return self.take(self.argsort(by, descending=descending))

    def sort(self, by: str, *, descending: bool = False) -> "TensorFrame":
        return self.sort_values(by, descending=descending)

    def nlargest(self, n: int, by: str) -> "TensorFrame":
        """The ``n`` rows with the largest values in column ``by``."""
        return self.take(self.argsort(by, descending=True)[: int(n)])

    def nsmallest(self, n: int, by: str) -> "TensorFrame":
        return self.take(self.argsort(by)[: int(n)])

    def concat(self, other: "TensorFrame") -> "TensorFrame":
        if self.columns != other.columns:
            raise ValueError("Cannot concat frames with different columns")
        return TensorFrame(columns=self.columns, data=tuple(torch.cat([a, b]) for a, b in zip(self.data, other.data)))

    def vstack(self, other: "TensorFrame") -> "TensorFrame":
        return self.concat(other)

    def hstack(self, other: "TensorFrame", *, override: bool = False) -> "TensorFrame":
        """Column-wise join; overlapping names raise unless ``override=True``
        (then ``other``'s values win)."""
        overlap = set(self.columns) & set(other.columns)
        if overlap and not override:
            raise ValueError(
                f"Overlapping columns {sorted(overlap)}; pass override=True to let the right-hand frame's values"
                " take precedence"
            )
        return self.with_columns(**other.as_dict())

    def join(self, other: "TensorFrame") -> "TensorFrame":
        return self.hstack(other)

    def drop(self, *, columns) -> "TensorFrame":
        """The frame without the given column(s)."""
        if isinstance(columns, str):
            columns = [columns]
        missing = set(columns) - set(self.columns)
        if missing:
            raise ValueError(f"Cannot drop unknown columns: {sorted(missing)}")
        return self.without_columns(*columns)

    # ------------------------------------------------------------- row write
    def pick_set(self, rows, new_values, columns=None) -> "TensorFrame":
        """Functional row assignment: a new frame with ``rows`` (a slice, an
        index tensor or a boolean mask) set to ``new_values`` (a tensor for
        one target column, a mapping of name -> values, or a frame)."""
        if isinstance(new_values, TensorFrame):
            updates = new_values.as_dict()
        elif isinstance(new_values, Mapping):
            updates = dict(new_values)
        else:
            if columns is None:
                raise ValueError("When new_values is a plain array, pass the target column via `columns=`")
            if isinstance(columns, str):
                columns = [columns]
            if len(columns) != 1:
                raise ValueError("A plain-array right-hand side updates exactly one column")
            updates = {columns[0]: new_values}
        if columns is not None:
            target = [columns] if isinstance(columns, str) else list(columns)
            if set(target) != set(updates):
                raise ValueError(f"Target columns {sorted(target)} do not match the right-hand side columns {sorted(updates)}")
        unknown = set(updates) - set(self.columns)
        if unknown:
            raise KeyError(f"No such column(s): {sorted(unknown)}")

        def write(current, new):
            new = torch.as_tensor(new, dtype=current.dtype, device=current.device)
            if isinstance(rows, slice):
                out = current.clone()
                out[rows] = new
                return out
            sel = torch.as_tensor(rows, device=current.device)
            if sel.dtype == torch.bool:
                m = sel.reshape(sel.shape + (1,) * (current.ndim - 1))
                return torch.where(m, new.broadcast_to(current.shape), current)
            return current.index_put((sel,), new.broadcast_to(current[sel].shape))

        out = {name: (write(col, updates[name]) if name in updates else col) for name, col in self.as_dict().items()}
        return TensorFrame(columns=self.columns, data=tuple(out.values()))

    # ----------------------------------------------------------- row compute
    def each(self, fn: Callable[[dict], dict], *, join: bool = False, override: bool = False) -> "TensorFrame":
        """``fn`` (dict of one row's values -> dict) applied to every row
        with ``torch.func.vmap``; ``join=True`` keeps the input columns
        beside the outputs (``override=True`` lets outputs shadow them)."""
        if (not join) and override:
            raise ValueError("override=True requires join=True")
        result = TensorFrame.create(torch.func.vmap(fn)(self.as_dict()))
        if join:
            return self.hstack(result, override=override)
        return result

    # ---------------------------------------------------------------- output
    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: v.detach().cpu().numpy() for k, v in self.as_dict().items()})

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}: {tuple(v.shape)}" for k, v in self.as_dict().items())
        return f"<TensorFrame len={len(self)} {{{parts}}}>"


class Picker:
    """Row indexer over a TensorFrame: ``frame.pick[rows]`` or
    ``frame.pick[rows, columns]`` with ``columns`` a name, a list of names or
    ``:``. Assignment is :meth:`TensorFrame.pick_set`; ``pick[...] = ...``
    raises with that pointer."""

    def __init__(self, frame: TensorFrame):
        self._frame = frame

    @staticmethod
    def _unpack(frame: TensorFrame, location):
        if isinstance(location, tuple):
            rows, columns = location
            if isinstance(columns, str):
                columns = [columns]
            elif isinstance(columns, slice):
                if columns != slice(None):
                    raise ValueError("For columns, only ':' is supported")
                columns = list(frame.columns)
            else:
                columns = [str(c) for c in columns]
        else:
            rows, columns = location, list(frame.columns)
        return rows, columns

    def __getitem__(self, location) -> TensorFrame:
        frame = self._frame
        rows, columns = self._unpack(frame, location)
        sub = {name: frame[name] for name in columns}
        if isinstance(rows, slice):
            data = {k: v[rows] for k, v in sub.items()}
        else:
            data = {}
            for k, v in sub.items():
                sel = torch.as_tensor(rows, device=v.device)
                if sel.dtype == torch.bool:
                    sel = torch.nonzero(sel).reshape(-1)
                data[k] = v[sel]
        return TensorFrame(columns=tuple(data.keys()), data=tuple(data.values()))

    def __setitem__(self, location, new_values):
        raise TypeError(
            "TensorFrames are immutable; use frame.pick_set(rows, values, columns=...), which returns the updated frame"
        )
