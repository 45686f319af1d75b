"""``TensorMakerMixin``: per-object tensor factories (counterpart of
``evotorch_tpu/tools/tensormaker.py``).

Dtype, device and shape defaults come from the owning object (a
``Problem`` or a ``Distribution``). Random factories draw from the
``torch.Generator`` they are given, or from the owner's ``generator``
where the JAX package takes a PRNG key or the owner's ``next_rng_key()``.
"""

from __future__ import annotations

from numbers import Number
from typing import Iterable, Optional, Union

import torch

from .misc import is_dtype_object, to_torch_dtype
from .readonlytensor import as_read_only_tensor

__all__ = ["TensorMakerMixin"]

Size = Union[int, Iterable[int]]


class TensorMakerMixin:
    """Owners provide ``dtype`` (and optionally ``eval_dtype``), ``device``,
    ``solution_length`` and ``generator``."""

    def _make_dtype(self, dtype=None, use_eval_dtype=False) -> torch.dtype:
        if dtype is not None:
            return to_torch_dtype(dtype)
        if use_eval_dtype:
            return to_torch_dtype(getattr(self, "eval_dtype", torch.float32))
        return to_torch_dtype(getattr(self, "dtype", torch.float32))

    def _make_shape(self, *size: Size, num_solutions=None) -> tuple:
        if len(size) == 1 and not isinstance(size[0], Number):
            size = tuple(size[0])
        if len(size) > 0:
            shape = tuple(int(s) for s in size)
            if num_solutions is not None:
                shape = (int(num_solutions),) + shape
            return shape
        shape = () if num_solutions is None else (int(num_solutions),)
        length = getattr(self, "solution_length", None)
        return shape if length is None else shape + (int(length),)

    def _make_generator(self, generator=None) -> torch.Generator:
        return self.generator if generator is None else generator

    def _draw(self, fn, shape, dtype, generator):
        """``fn`` (``torch.randn``/``torch.rand``) drawn on the generator's
        device and moved to the owner's."""
        out = fn(shape, generator=generator, dtype=dtype, device=generator.device)
        return out.to(self.device)

    # -- deterministic fills -------------------------------------------------
    def make_empty(self, *size: Size, num_solutions=None, dtype=None, use_eval_dtype=False):
        return self.make_zeros(*size, num_solutions=num_solutions, dtype=dtype, use_eval_dtype=use_eval_dtype)

    def make_zeros(self, *size: Size, num_solutions=None, dtype=None, use_eval_dtype=False):
        shape = self._make_shape(*size, num_solutions=num_solutions)
        return torch.zeros(shape, dtype=self._make_dtype(dtype, use_eval_dtype), device=self.device)

    def make_ones(self, *size: Size, num_solutions=None, dtype=None, use_eval_dtype=False):
        shape = self._make_shape(*size, num_solutions=num_solutions)
        return torch.ones(shape, dtype=self._make_dtype(dtype, use_eval_dtype), device=self.device)

    def make_nan(self, *size: Size, num_solutions=None, dtype=None, use_eval_dtype=False):
        shape = self._make_shape(*size, num_solutions=num_solutions)
        return torch.full(shape, float("nan"), dtype=self._make_dtype(dtype, use_eval_dtype), device=self.device)

    def make_I(self, size: Optional[int] = None, dtype=None, use_eval_dtype=False):
        if size is None:
            size = getattr(self, "solution_length", None)
            if size is None:
                raise ValueError("make_I needs a size when the owner has no solution_length")
        return torch.eye(int(size), dtype=self._make_dtype(dtype, use_eval_dtype), device=self.device)

    def make_tensor(self, data, *, dtype=None, use_eval_dtype=False, read_only: bool = False):
        """``data`` as a tensor in the owner's dtype, on its device; with
        ``dtype=object``, an ``ObjectArray`` on the host. ``read_only`` gives
        a ``ReadOnlyTensor`` (or a read-only ``ObjectArray`` view)."""
        if dtype is not None and is_dtype_object(dtype):
            from .objectarray import ObjectArray

            out = ObjectArray.from_values(data)
            return out.get_read_only_view() if read_only else out
        out = torch.as_tensor(data, dtype=self._make_dtype(dtype, use_eval_dtype), device=self.device)
        return as_read_only_tensor(out) if read_only else out

    def make_uniform_shaped_like(self, t, *, lb=None, ub=None, generator=None):
        """A uniform random tensor with ``t``'s shape and dtype."""
        t = torch.as_tensor(t)
        # a 0-d input gives a 0-d output (an empty size would take the
        # owner's solution_length)
        shape = tuple(t.shape) if t.ndim else (1,)
        out = self.make_uniform(*shape, lb=lb, ub=ub, dtype=t.dtype, generator=generator)
        return out.reshape(t.shape)

    def make_gaussian_shaped_like(self, t, *, center=None, stdev=None, generator=None):
        """A Gaussian random tensor with ``t``'s shape and dtype."""
        t = torch.as_tensor(t)
        shape = tuple(t.shape) if t.ndim else (1,)
        out = self.make_gaussian(*shape, center=center, stdev=stdev, dtype=t.dtype, generator=generator)
        return out.reshape(t.shape)

    # -- random fills --------------------------------------------------------
    def make_uniform(
        self, *size: Size, num_solutions=None, lb=None, ub=None, dtype=None, use_eval_dtype=False, generator=None
    ):
        dtype = self._make_dtype(dtype, use_eval_dtype)
        shape = self._make_shape(*size, num_solutions=num_solutions)
        generator = self._make_generator(generator)
        lb = torch.as_tensor(0.0 if lb is None else lb, dtype=dtype, device=self.device)
        ub = torch.as_tensor(1.0 if ub is None else ub, dtype=dtype, device=self.device)
        if not dtype.is_floating_point:
            u = self._draw(torch.rand, shape, torch.float64, generator)
            return (lb + torch.floor(u * (ub - lb + 1).to(torch.float64))).to(dtype)
        return self._draw(torch.rand, shape, dtype, generator) * (ub - lb) + lb

    def make_gaussian(
        self,
        *size: Size,
        num_solutions=None,
        center=None,
        stdev=None,
        symmetric=False,
        dtype=None,
        use_eval_dtype=False,
        generator=None,
    ):
        dtype = self._make_dtype(dtype, use_eval_dtype)
        shape = self._make_shape(*size, num_solutions=num_solutions)
        generator = self._make_generator(generator)
        if symmetric:
            if len(shape) == 0 or shape[0] % 2 != 0:
                raise ValueError(f"symmetric gaussian requires an even leading dimension, got shape {shape}")
            eps = self._draw(torch.randn, (shape[0] // 2,) + shape[1:], dtype, generator)
            # antithetic pairs interleaved: [+e0, -e0, +e1, -e1, ...]
            noise = torch.stack([eps, -eps], dim=1).reshape(shape)
        else:
            noise = self._draw(torch.randn, shape, dtype, generator)
        if stdev is not None:
            noise = noise * torch.as_tensor(stdev, dtype=dtype, device=self.device)
        if center is not None:
            noise = noise + torch.as_tensor(center, dtype=dtype, device=self.device)
        return noise

    def make_randint(self, *size: Size, n: int, num_solutions=None, dtype=None, generator=None):
        dtype = torch.int64 if dtype is None else to_torch_dtype(dtype)
        if dtype.is_floating_point:
            dtype = torch.int64
        shape = self._make_shape(*size, num_solutions=num_solutions)
        generator = self._make_generator(generator)
        out = torch.randint(0, int(n), shape, generator=generator, dtype=dtype, device=generator.device)
        return out.to(self.device)
