"""Immutable containers, the storage discipline of object-typed solutions
(counterpart of ``evotorch_tpu/tools/immutable.py``).

Object-typed problems live on the host in both packages: their values are
plain Python, frozen on entry. Where the JAX package lets a ``jax.Array``
pass as it is (it is immutable), the port stores a tensor as a
``ReadOnlyTensor`` copy (a torch tensor can be changed in place), and
``mutable_copy`` gives back a plain tensor.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence, Set as AbstractSet
from typing import Any, Iterable

import numpy as np
import torch

from .readonlytensor import ReadOnlyTensor, read_only_tensor

__all__ = [
    "ImmutableContainer",
    "ImmutableList",
    "ImmutableSet",
    "ImmutableDict",
    "as_immutable",
    "mutable_copy",
    "is_immutable",
]


class ImmutableContainer:
    """Marker base class."""


class ImmutableList(ImmutableContainer, Sequence):
    def __init__(self, iterable: Iterable = ()):
        self._data = tuple(as_immutable(x) for x in iterable)

    def __getitem__(self, i):
        if isinstance(i, slice):
            result = ImmutableList.__new__(ImmutableList)
            result._data = self._data[i]
            return result
        return self._data[i]

    def __len__(self):
        return len(self._data)

    def __eq__(self, other):
        if isinstance(other, ImmutableList):
            return self._data == other._data
        if isinstance(other, (list, tuple)):
            return list(self._data) == list(other)
        return NotImplemented

    def __hash__(self):
        return hash(self._data)

    def __repr__(self):
        return f"ImmutableList({list(self._data)!r})"


class ImmutableSet(ImmutableContainer, AbstractSet):
    def __init__(self, iterable: Iterable = ()):
        self._data = frozenset(as_immutable(x) for x in iterable)

    def __contains__(self, x):
        return x in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return f"ImmutableSet({set(self._data)!r})"


class ImmutableDict(ImmutableContainer, Mapping):
    def __init__(self, mapping: Any = (), **kwargs):
        items = dict(mapping, **kwargs)
        self._data = {as_immutable(k): as_immutable(v) for k, v in items.items()}

    def __getitem__(self, k):
        return self._data[k]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return f"ImmutableDict({self._data!r})"


def _frozen_numpy(arr: np.ndarray) -> np.ndarray:
    result = arr.copy()
    result.setflags(write=False)
    return result


def as_immutable(x: Any) -> Any:
    """An immutable counterpart of ``x``: a tensor becomes a
    ``ReadOnlyTensor`` copy, a numpy array a frozen copy (an object array
    an ``ImmutableList``), containers ``Immutable*`` containers, an
    ``ObjectArray`` a read-only view; scalars and strings stay as they are."""
    from .objectarray import ObjectArray

    if isinstance(x, ObjectArray):
        return x.get_read_only_view()
    if isinstance(x, torch.Tensor):
        return read_only_tensor(x)
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ImmutableList(x.tolist())
        return _frozen_numpy(x)
    if isinstance(x, ImmutableContainer):
        return x
    if isinstance(x, Mapping):
        return ImmutableDict(x)
    if isinstance(x, (set, frozenset)):
        return ImmutableSet(x)
    if isinstance(x, (list, tuple)):
        return ImmutableList(x)
    if isinstance(x, (int, float, complex, bool, str, bytes, type(None), np.generic)):
        return x
    raise TypeError(f"Cannot make object of type {type(x)} immutable")


def mutable_copy(x: Any) -> Any:
    """The inverse of :func:`as_immutable`: mutable copies (a tensor as a
    plain tensor)."""
    from .objectarray import ObjectArray

    if isinstance(x, ObjectArray):
        return x.clone()
    if isinstance(x, torch.Tensor):
        return x.detach().as_subclass(torch.Tensor).clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, ImmutableList):
        return [mutable_copy(v) for v in x]
    if isinstance(x, ImmutableSet):
        return {mutable_copy(v) for v in x}
    if isinstance(x, ImmutableDict):
        return {mutable_copy(k): mutable_copy(v) for k, v in x.items()}
    return x


def is_immutable(x: Any) -> bool:
    from .objectarray import ObjectArray

    if isinstance(x, ObjectArray):
        return x.is_read_only
    if isinstance(x, (ImmutableContainer, ReadOnlyTensor)):
        return True
    if isinstance(x, np.ndarray):
        return not x.flags.writeable
    return isinstance(x, (int, float, complex, bool, str, bytes, type(None)))
