"""Cloning and pickling discipline (counterpart of
``evotorch_tpu/tools/cloning.py``).

Tensors are mutable in PyTorch, so ``deep_clone`` copies them (the JAX
package returns its immutable arrays as they are). A ``torch.Generator``
does not pickle: ``Serializable`` stores each generator of an object's state
as its device and ``get_state()``, and rebuilds it on unpickling.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["deep_clone", "Clonable", "ReadOnlyClonable", "Serializable"]

#: memo key marking a clone made for pickling
_PICKLING = "pickling"


def _clone_generator(g: torch.Generator) -> torch.Generator:
    new = torch.Generator(device=g.device)
    new.set_state(g.get_state())
    return new


def deep_clone(
    x: Any,
    *,
    otherwise_deepcopy: bool = True,
    memo: Optional[dict] = None,
) -> Any:
    """Deep-clone ``x``: tensors and numpy arrays are copied, generators get
    a twin with the same state, ``Clonable`` objects delegate to their
    ``clone``, containers recurse with memoization."""
    if memo is None:
        memo = {}
    key = id(x)
    if key in memo:
        return memo[key]

    if isinstance(x, torch.Tensor):
        # pickling reads the state and never writes it: no copy needed
        result = x if memo.get(_PICKLING) else x.clone()
    elif isinstance(x, torch.Generator):
        result = _clone_generator(x)
    elif isinstance(x, np.ndarray):
        result = x.copy()
    elif isinstance(x, Clonable):
        result = x.clone(memo=memo)
    elif isinstance(x, dict):
        result = type(x)()
        memo[key] = result
        for k, v in x.items():
            result[deep_clone(k, memo=memo)] = deep_clone(v, memo=memo)
        return result
    elif isinstance(x, list):
        result = type(x)()
        memo[key] = result
        for v in x:
            result.append(deep_clone(v, memo=memo))
        return result
    elif isinstance(x, tuple):
        cloned = [deep_clone(v, memo=memo) for v in x]
        result = tuple(cloned) if type(x) is tuple else type(x)(*cloned)
    elif isinstance(x, set):
        result = {deep_clone(v, memo=memo) for v in x}
    elif isinstance(x, (int, float, complex, str, bytes, bool, type(None), torch.dtype, torch.device)):
        result = x
    elif otherwise_deepcopy:
        result = copy.deepcopy(x, memo)
    else:
        result = x
    memo[key] = result
    return result


class Clonable:
    """Objects that know how to clone themselves."""

    def _get_cloned_state(self, *, memo: dict) -> dict:
        return {k: deep_clone(v, memo=memo) for k, v in self.__dict__.items()}

    def clone(self, *, memo: Optional[dict] = None) -> "Clonable":
        if memo is None:
            memo = {}
        if id(self) in memo:
            return memo[id(self)]
        new = object.__new__(type(self))
        memo[id(self)] = new
        new.__dict__.update(self._get_cloned_state(memo=memo))
        return new

    def __copy__(self):
        return self.clone()

    def __deepcopy__(self, memo):
        return self.clone(memo=memo)


class _PickledGenerator:
    """A generator's device and state, the picklable stand-in that
    ``Serializable`` writes for a ``torch.Generator``."""

    def __init__(self, g: torch.Generator):
        self.device = str(g.device)
        self.state = g.get_state()

    def restore(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.set_state(self.state)
        return g


def _restore(x):
    return x.restore() if isinstance(x, _PickledGenerator) else x


class Serializable(Clonable):
    """Clonable, and picklable through its cloned state; a generator held
    as an attribute is stored as its device and state and rebuilt on
    unpickling."""

    def __getstate__(self) -> dict:
        state = self._get_cloned_state(memo={id(self): self, _PICKLING: True})
        return {k: _PickledGenerator(v) if isinstance(v, torch.Generator) else v for k, v in state.items()}

    def __setstate__(self, state: dict):
        self.__dict__.update({k: _restore(v) for k, v in state.items()})


class ReadOnlyClonable(Clonable):
    """Clonable whose default clone is a mutable copy of read-only data;
    subclasses implement ``_get_mutable_clone``."""

    def clone(self, *, memo: Optional[dict] = None, preserve_read_only: bool = False):
        if preserve_read_only:
            return super().clone(memo=memo)
        return self._get_mutable_clone(memo=memo if memo is not None else {})

    def _get_mutable_clone(self, *, memo: dict):
        raise NotImplementedError
