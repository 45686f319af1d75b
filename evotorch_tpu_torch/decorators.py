"""Decorators: fitness-function markers and the batching engine
(counterpart of ``evotorch_tpu/decorators.py``).

``expects_ndim`` declares the core number of dimensions of each positional
argument; extra leading dimensions are batch dimensions. Their shapes
broadcast together, the batch is flattened into one leading dimension and
the function runs once under ``torch.func.vmap`` over it, as the JAX
package runs it under ``jax.vmap``. The function must therefore be a pure
tensor function: no random draws (a ``torch.Generator`` cannot be used
under ``vmap``; draw one ``(*batch, ...)`` tensor before the call), no
host reads of tensor values and no hand-written kernel (they take
contiguous storage, which a batched view under ``vmap`` has not).

The device markers (``on_device``, ``on_aux_device``, ``on_cuda``) only
record the requested device, as in the JAX package: a problem's device
decides where its evaluation runs.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

__all__ = [
    "expects_ndim",
    "on_aux_device",
    "on_cuda",
    "on_device",
    "pass_info",
    "rowwise",
    "vectorized",
]


def vectorized(fn: Callable) -> Callable:
    """Mark a fitness function as taking the whole ``(N, L)`` population."""
    fn.__evotorch_vectorized__ = True
    return fn


def pass_info(fn: Callable) -> Callable:
    """Mark a network factory as wanting the problem's info keywords
    (``obs_length``, ``act_length``, ...)."""
    fn.__evotorch_pass_info__ = True
    return fn


def on_device(device: Any) -> Callable:
    """A decorator that records ``device`` on the function (a marker: the
    problem's device decides where its evaluation runs)."""

    def decorator(fn: Callable) -> Callable:
        fn.__evotorch_on_device__ = device
        return fn

    return decorator


def on_aux_device(fn: Optional[Callable] = None):
    if fn is None:
        return on_device("aux")
    return on_device("aux")(fn)


def on_cuda(fn: Optional[Callable] = None):
    """The marker of :func:`on_device` with the accelerator."""
    if fn is None:
        return on_device("accelerator")
    return on_device("accelerator")(fn)


def _bind_to_positions(sig, fn, expected_ndims, args, kwargs):
    """Keyword arguments bound to their declared positional slots -> (the
    positional arguments covering those slots, the other keywords)."""
    if sig is None or not kwargs:
        return list(args), dict(kwargs)
    positional = [p for p in sig.parameters.values() if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    out_args = []
    for p in positional[: len(expected_ndims)]:
        if p.name not in bound.arguments:
            break
        out_args.append(bound.arguments.pop(p.name))
    static = {}
    for name, value in bound.arguments.items():
        param = sig.parameters[name]
        if param.kind == param.VAR_KEYWORD:
            static.update(value)
        elif param.kind == param.VAR_POSITIONAL:
            if value:
                raise TypeError(f"{fn.__name__}: expects_ndim does not support *args functions called past the declared slots")
        else:
            static[name] = value
    return out_args, static


def expects_ndim(*expected_ndims: Optional[int], allow_smaller_ndim: bool = False):
    """Declare each positional argument's core ndim (``None``: passed
    through untouched). Leading dimensions beyond it are batch dimensions,
    broadcast together and mapped over with ``torch.func.vmap``.

    As in the JAX package: arguments passed by keyword bind to their
    declared slots; Python scalars, lists and numpy arrays in a declared
    slot become tensors, and a floating one takes the dtype of the first
    floating tensor among the declared arguments (its device too)."""

    def decorator(fn: Callable) -> Callable:
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            args, kwargs = _bind_to_positions(sig, fn, expected_ndims, args, kwargs)
            if len(args) > len(expected_ndims):
                raise TypeError(
                    f"{fn.__name__}: got {len(args)} positional args, but expects_ndim declares only {len(expected_ndims)}"
                )
            float_dtype, device = None, None
            for arg, nd in zip(args, expected_ndims):
                if nd is not None and isinstance(arg, torch.Tensor):
                    device = arg.device if device is None else device
                    if float_dtype is None and arg.dtype.is_floating_point:
                        float_dtype = arg.dtype
            arrs, batch_shape = [], ()
            for arg, nd in zip(args, expected_ndims):
                if nd is None:
                    arrs.append(arg)
                    continue
                if isinstance(arg, torch.Tensor):
                    arr = arg
                elif isinstance(arg, (int, float, bool, list, tuple, np.ndarray, np.generic)):
                    arr = torch.as_tensor(arg, device=device)
                    if float_dtype is not None and arr.dtype.is_floating_point:
                        arr = torch.as_tensor(arg, dtype=float_dtype, device=device)
                else:
                    arr = torch.as_tensor(arg)
                extra = arr.ndim - nd
                if extra < 0:
                    if allow_smaller_ndim:
                        arrs.append(arr)
                        continue
                    raise ValueError(
                        f"{fn.__name__}: argument with shape {tuple(arr.shape)} has fewer than the expected {nd} dimensions"
                    )
                batch_shape = torch.broadcast_shapes(batch_shape, arr.shape[:extra])
                arrs.append(arr)
            batch_shape = tuple(batch_shape)
            if batch_shape == ():
                return fn(*arrs, **kwargs)

            batch_size = math.prod(batch_shape)
            flat_args, in_dims = [], []
            for arg, nd in zip(arrs, expected_ndims):
                if nd is None or not isinstance(arg, torch.Tensor) or arg.ndim < nd:
                    flat_args.append(arg)
                    in_dims.append(None)
                    continue
                core = arg.shape[arg.ndim - nd :]
                flat_args.append(arg.expand(batch_shape + tuple(core)).reshape((batch_size,) + tuple(core)))
                in_dims.append(0)
            call = functools.partial(fn, **kwargs) if kwargs else fn
            out = torch.func.vmap(call, in_dims=tuple(in_dims))(*flat_args)
            return tree_map(lambda leaf: leaf.reshape(batch_shape + tuple(leaf.shape[1:])), out)

        wrapped.__expects_ndim__ = expected_ndims
        return wrapped

    return decorator


def rowwise(fn: Callable) -> Callable:
    """Wrap a function written for one 1-D row so that it takes any number
    of leading batch dimensions; it is also marked ``vectorized``."""
    wrapped = expects_ndim(1)(fn)
    wrapped.__evotorch_rowwise__ = True
    wrapped.__evotorch_vectorized__ = True
    return wrapped
