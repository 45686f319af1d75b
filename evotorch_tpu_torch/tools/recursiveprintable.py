"""Pretty-printing mixin (counterpart of
``evotorch_tpu/tools/recursiveprintable.py``)."""

from __future__ import annotations

from collections.abc import Mapping, Sequence

__all__ = ["RecursivePrintable"]


class RecursivePrintable:
    def to_string(self, *, max_depth: int = 10) -> str:
        return _to_string(self, max_depth)

    def __repr__(self) -> str:
        return self.to_string()

    def __str__(self) -> str:
        return self.to_string()


def _to_string(x, depth: int) -> str:
    if depth <= 0:
        return "<...>"
    if isinstance(x, RecursivePrintable):
        items = getattr(x, "_printable_items", None)
        if callable(items):
            body = items()
        else:
            body = x.__dict__
        if isinstance(body, Mapping):
            inner = ", ".join(f"{k}={_to_string(v, depth - 1)}" for k, v in body.items())
        elif isinstance(body, Sequence) and not isinstance(body, (str, bytes)):
            inner = ", ".join(_to_string(v, depth - 1) for v in body)
        else:
            inner = _to_string(body, depth - 1)
        return f"<{type(x).__name__} {inner}>"
    if isinstance(x, Mapping):
        inner = ", ".join(f"{_to_string(k, depth - 1)}: {_to_string(v, depth - 1)}" for k, v in x.items())
        return "{" + inner + "}"
    if isinstance(x, (list, tuple)):
        inner = ", ".join(_to_string(v, depth - 1) for v in x)
        return ("[" + inner + "]") if isinstance(x, list) else ("(" + inner + ")")
    return repr(x)
