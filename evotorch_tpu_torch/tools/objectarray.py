"""``ObjectArray``: a 1-D container of arbitrary objects with array-like
indexing (counterpart of ``evotorch_tpu/tools/objectarray.py``).

Object-typed solutions (variable-length genomes, trees, ...) cannot live
in device memory: the container is on the host (a numpy object array
underneath), and its elements are stored as immutable copies
(``as_immutable``), so that views can share them safely.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Iterable, Optional

import numpy as np
import torch

from .immutable import as_immutable, mutable_copy

__all__ = ["ObjectArray"]


def _as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _elements_equal(a, b) -> bool:
    """Scalar equality that tolerates array- and tensor-valued elements."""
    try:
        if isinstance(a, (np.ndarray, torch.Tensor)) or isinstance(b, (np.ndarray, torch.Tensor)):
            return bool(np.array_equal(_as_numpy(a), _as_numpy(b)))
        result = a == b
        if isinstance(result, np.ndarray):
            return bool(result.all())
        return bool(result)
    except (TypeError, ValueError):
        return False


class ObjectArray(Sequence):
    dtype = object

    def __init__(self, size: Optional[int] = None, *, slice_of=None):
        if slice_of is not None:
            source, sl = slice_of
            if size is not None:
                raise ValueError("Cannot give both size and slice_of")
            if not isinstance(source, ObjectArray):
                raise TypeError("slice_of must reference an ObjectArray")
            self._data = source._data[sl]  # numpy view: shares storage
            self._read_only = source._read_only
        else:
            if size is None:
                size = 0
            self._data = np.empty(int(size), dtype=object)
            self._read_only = False

    # -- factory ------------------------------------------------------------
    @classmethod
    def from_values(cls, values: Iterable) -> "ObjectArray":
        values = list(values)
        result = cls(len(values))
        for i, v in enumerate(values):
            result[i] = v
        return result

    @staticmethod
    def from_numpy(ndarray: np.ndarray) -> "ObjectArray":
        """A new ObjectArray from a 1-D numpy object array."""
        if ndarray.ndim != 1:
            raise ValueError(f"Expected a 1-D array, got ndim={ndarray.ndim}")
        return ObjectArray.from_values(ndarray)

    # -- tensor-like introspection -------------------------------------------
    @property
    def shape(self) -> tuple:
        return (len(self._data),)

    def size(self, dim: Optional[int] = None):
        """The shape tuple, or the size along ``dim`` (torch-style)."""
        if dim is None:
            return self.shape
        if dim not in (0, -1):
            raise IndexError(f"ObjectArray is 1-D; no dimension {dim}")
        return len(self._data)

    @property
    def ndim(self) -> int:
        return 1

    def dim(self) -> int:
        return 1

    def numel(self) -> int:
        return len(self._data)

    @property
    def device(self) -> torch.device:
        """Always the host: objects never live in device memory."""
        return torch.device("cpu")

    def repeat(self, *sizes: int) -> "ObjectArray":
        """Tile the array (torch ``repeat`` of a 1-D tensor: exactly one
        repeat count)."""
        if len(sizes) != 1:
            raise ValueError(
                "ObjectArray is 1-D: repeat expects exactly one repeat count"
            )
        (n,) = sizes
        result = ObjectArray(len(self._data) * int(n))
        for rep in range(int(n)):
            base = rep * len(self._data)
            for i, v in enumerate(self._data):
                result._data[base + i] = v  # elements are immutable: share
        return result

    # -- element access ------------------------------------------------------
    def __getitem__(self, i):
        if isinstance(i, slice):
            return ObjectArray(slice_of=(self, i))
        if isinstance(i, torch.Tensor):
            i = i.cpu().numpy() if i.ndim > 0 else int(i)
        if isinstance(i, (list, np.ndarray)) and not np.isscalar(i):
            idx = np.asarray(i, dtype=bool if np.asarray(i).dtype == bool else np.int64)
            if idx.dtype == bool:
                idx = np.nonzero(idx)[0]
            picked = ObjectArray(len(idx))
            picked._data[:] = self._data[idx]
            picked._read_only = self._read_only
            return picked
        return self._data[int(i)]

    def __setitem__(self, i, value):
        if self._read_only:
            raise ValueError("Cannot modify a read-only ObjectArray")
        if isinstance(i, slice):
            values = [as_immutable(v) for v in value]
            indices = list(range(*i.indices(len(self._data))))
            if len(indices) != len(values):
                raise ValueError("Slice assignment length mismatch")
            # assign one-by-one to avoid numpy flattening sequence values
            for j, v in zip(indices, values):
                self._data[j] = v
        else:
            self._data[int(i)] = as_immutable(value)

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        for i in range(len(self)):
            yield self._data[i]

    def set_item(self, i, value, *, memo: Optional[dict] = None):
        """``self[i] = value`` by name."""
        del memo  # immutable storage: no cycles to track
        self[i] = value

    # -- semantics -----------------------------------------------------------
    def clone(
        self, *, preserve_read_only: bool = False, memo: Optional[dict] = None
    ) -> "ObjectArray":
        if memo is None:
            memo = {}
        existing = memo.get(id(self))
        if existing is not None:
            return existing
        result = ObjectArray(len(self))
        memo[id(self)] = result
        for i in range(len(self)):
            result._data[i] = mutable_copy(self._data[i])
        if preserve_read_only and self._read_only:
            result = result.get_read_only_view()
        return result

    def __copy__(self) -> "ObjectArray":
        return self.clone(preserve_read_only=True)

    def __deepcopy__(self, memo: Optional[dict]) -> "ObjectArray":
        return self.clone(preserve_read_only=True, memo=memo)

    def get_read_only_view(self) -> "ObjectArray":
        view = ObjectArray(slice_of=(self, slice(None)))
        view._read_only = True
        return view

    @property
    def is_read_only(self) -> bool:
        return self._read_only

    def numpy(self) -> np.ndarray:
        return self._data.copy()

    def storage_ptr(self) -> int:
        """The address of the underlying buffer: the same for views that
        share storage."""
        base = self._data
        while base.base is not None:
            base = base.base
        return base.__array_interface__["data"][0]

    def __eq__(self, other):
        if isinstance(other, ObjectArray):
            other = list(other)
        if isinstance(other, (list, tuple)):
            if len(self) != len(other):
                return np.zeros(len(self), dtype=bool)
            return np.array(
                [_elements_equal(a, b) for a, b in zip(list(self), other)], dtype=bool
            )
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"ObjectArray({list(self._data)!r})"
