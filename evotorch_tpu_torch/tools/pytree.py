"""Pytree-dataclass helpers (counterpart of ``evotorch_tpu/tools/pytree.py``).

A structure is a frozen dataclass registered as a pytree node
(``torch.utils._pytree.register_pytree_node``): its tensor fields are the
leaves and its *static* fields (shapes, names, flags) ride in the context,
so ``torch.func.vmap`` maps over a whole structure and hands back one of
the same type. (``register_dataclass`` can only drop a field, not carry it
as context.)
"""

from __future__ import annotations

import dataclasses

import torch.utils._pytree as _pytree

__all__ = ["pytree_dataclass", "static_field", "field", "replace"]


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (a constant)."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs):
    return dataclasses.field(**kwargs)


def pytree_dataclass(cls):
    """Decorator: a frozen dataclass registered as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = tuple(f.name for f in fields if not f.metadata.get("static", False))
    static = tuple(f.name for f in fields if f.metadata.get("static", False))

    def flatten(obj):
        return [getattr(obj, n) for n in data], tuple(getattr(obj, n) for n in static)

    def unflatten(values, context):
        return cls(**dict(zip(data, values)), **dict(zip(static, context)))

    def flatten_with_keys(obj):
        children, context = flatten(obj)
        return [(_pytree.GetAttrKey(n), c) for n, c in zip(data, children)], context

    _pytree.register_pytree_node(
        cls,
        flatten,
        unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
        flatten_with_keys_fn=flatten_with_keys,
    )
    return cls


replace = dataclasses.replace
