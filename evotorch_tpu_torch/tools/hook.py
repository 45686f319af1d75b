"""``Hook``: a list of callbacks whose dict/list returns are accumulated
(counterpart of ``evotorch_tpu/tools/hook.py``; the basis of the status
merging of ``SearchAlgorithm`` and ``Problem``)."""

from __future__ import annotations

from collections.abc import MutableSequence
from typing import Callable, Iterable, Optional

__all__ = ["Hook"]


class Hook(MutableSequence):
    def __init__(
        self,
        callbacks: Optional[Iterable[Callable]] = None,
        *,
        args: Optional[Iterable] = None,
        kwargs: Optional[dict] = None,
    ):
        self._funcs = list(callbacks) if callbacks is not None else []
        self._args = list(args) if args is not None else []
        self._kwargs = dict(kwargs) if kwargs is not None else {}

    # -- invocation ---------------------------------------------------------
    def __call__(self, *args, **kwargs) -> Optional[dict]:
        """Call every callback. dict returns are merged into an accumulated
        dict (later callbacks win on key conflict); list returns extend an
        accumulated list; a mix of the two is an error. Returns None when no
        callback returned anything."""
        all_args = list(self._args) + list(args)
        all_kwargs = {**self._kwargs, **kwargs}
        acc_dict: Optional[dict] = None
        acc_list: Optional[list] = None
        for f in self._funcs:
            result = f(*all_args, **all_kwargs)
            if result is None:
                continue
            if isinstance(result, dict):
                if acc_list is not None:
                    raise TypeError(
                        "Hook callbacks returned a mix of dict and list results"
                    )
                acc_dict = {} if acc_dict is None else acc_dict
                acc_dict.update(result)
            elif isinstance(result, (list, tuple)):
                if acc_dict is not None:
                    raise TypeError(
                        "Hook callbacks returned a mix of dict and list results"
                    )
                acc_list = [] if acc_list is None else acc_list
                acc_list.extend(result)
            else:
                raise TypeError(
                    f"Hook callback {f} returned unsupported type {type(result)}"
                )
        return acc_dict if acc_dict is not None else acc_list

    def accumulate_dict(self, *args, **kwargs) -> dict:
        result = self(*args, **kwargs)
        if result is None:
            return {}
        if not isinstance(result, dict):
            raise TypeError(f"Expected dict accumulation, got {type(result)}")
        return result

    def accumulate_sequence(self, *args, **kwargs) -> list:
        result = self(*args, **kwargs)
        if result is None:
            return []
        if isinstance(result, dict):
            raise TypeError("Expected sequence accumulation, got dict")
        return list(result)

    # -- MutableSequence protocol ------------------------------------------
    def __getitem__(self, i):
        return self._funcs[i]

    def __setitem__(self, i, value):
        self._funcs[i] = value

    def __delitem__(self, i):
        del self._funcs[i]

    def __len__(self):
        return len(self._funcs)

    def insert(self, i, value):
        self._funcs.insert(i, value)

    def append(self, value):
        self._funcs.append(value)

    @property
    def args(self) -> list:
        return self._args

    @property
    def kwargs(self) -> dict:
        return self._kwargs

    def __repr__(self) -> str:
        return f"Hook({self._funcs!r})"
