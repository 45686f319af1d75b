"""Read-only tensors (counterpart of ``evotorch_tpu/tools/readonlytensor.py``).

The JAX package's arrays are immutable, so its ``ReadOnlyTensor`` is
``jax.Array`` itself. A torch tensor can be changed in place, so here
``ReadOnlyTensor`` is a ``torch.Tensor`` subclass that refuses every
in-place operation (a method ending in ``_``, an augmented assignment, item
assignment, ``out=`` into it). A view of it is read-only as well; a result
that owns new memory (``clone()``, arithmetic) is a plain tensor. numpy
arrays are handled as in the JAX package: as write-protected views.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

__all__ = ["ReadOnlyTensor", "as_read_only_tensor", "is_read_only", "read_only_tensor"]

_INPLACE_DUNDERS = {
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__", "__imod__", "__ipow__",
    "__iand__", "__ior__", "__ixor__", "__ilshift__", "__irshift__", "__imatmul__",
}  # fmt: skip


def _write_targets(func, args, kwargs) -> list:
    """The tensors an operation writes into: ``out=``, and ``self`` of an
    in-place method or an augmented or item assignment."""
    targets = list(tree_flatten((kwargs or {}).get("out"))[0])
    name = getattr(func, "__name__", "") or ""
    if args and (name in _INPLACE_DUNDERS or (name.endswith("_") and not name.startswith("_"))):
        targets.append(args[0])
    return targets


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class ReadOnlyTensor(torch.Tensor):
    """A tensor that cannot be changed in place. Make one with
    ``read_only_tensor`` (a copy) or ``as_read_only_tensor`` (a view)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if any(isinstance(t, ReadOnlyTensor) for t in _write_targets(func, args, kwargs)):
            raise TypeError(f"a ReadOnlyTensor cannot be changed in place ({getattr(func, '__name__', func)})")
        with torch._C.DisableTorchFunctionSubclass():
            result = func(*args, **(kwargs or {}))
            read_only = [t for t in tree_flatten((args, kwargs or {}))[0] if isinstance(t, ReadOnlyTensor)]
            pointers = {_storage_ptr(t) for t in read_only}

            def wrap(x):
                # a view of read-only memory stays read-only; new memory is free
                if isinstance(x, torch.Tensor):
                    return x.as_subclass(ReadOnlyTensor if _storage_ptr(x) in pointers else torch.Tensor)
                return x

            return tree_map(wrap, result)

    def numpy(self, *args, **kwargs) -> np.ndarray:
        arr = self.as_subclass(torch.Tensor).numpy(*args, **kwargs)
        arr.setflags(write=False)
        return arr

    def clone(self, *args, **kwargs) -> torch.Tensor:
        """A mutable copy (a plain tensor)."""
        return self.as_subclass(torch.Tensor).clone(*args, **kwargs)

    def __deepcopy__(self, memo) -> "ReadOnlyTensor":
        copied = self.as_subclass(torch.Tensor).clone().as_subclass(ReadOnlyTensor)
        memo[id(self)] = copied
        return copied

    def __repr__(self, *args, **kwargs) -> str:
        return "ReadOnlyTensor(" + repr(self.as_subclass(torch.Tensor))[len("tensor(") :]


def read_only_tensor(x: Any, *, dtype=None, device=None) -> ReadOnlyTensor:
    """A read-only tensor holding a copy of ``x``."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(dtype=dtype, device=device, copy=True).as_subclass(ReadOnlyTensor)


def as_read_only_tensor(x: Any, *, dtype=None, device=None) -> Any:
    """``x`` as read-only without a copy where it can be: a read-only
    tensor as it is, a tensor as a read-only view of it, a numpy array as
    a write-protected view (as in the JAX package); anything else, or a
    dtype or device change, as a read-only copy."""
    if isinstance(x, torch.Tensor):
        same = (dtype is None or x.dtype == dtype) and (device is None or x.device == torch.device(device))
        if same:
            return x if isinstance(x, ReadOnlyTensor) else x.detach().as_subclass(ReadOnlyTensor)
        return read_only_tensor(x, dtype=dtype, device=device)
    if isinstance(x, np.ndarray) and (dtype is None or x.dtype == np.dtype(dtype)) and device is None:
        view = x.view()
        view.setflags(write=False)
        return view
    return read_only_tensor(x, dtype=dtype, device=device)


def is_read_only(x: Any) -> bool:
    if isinstance(x, ReadOnlyTensor):
        return True
    if isinstance(x, np.ndarray):
        return not x.flags.writeable
    return False
