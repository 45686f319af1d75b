"""Test assertions (counterpart of ``evotorch_tpu/testing.py``):
``assert_allclose``, ``assert_almost_between``, ``assert_dtype_matches``,
``assert_shape_matches`` and ``assert_eachclose``. Each takes tensors (on
any device), numpy arrays, ``Solution``s and ``SolutionBatch``es (compared
by their decision values)."""

from __future__ import annotations

from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

__all__ = [
    "TestingError",
    "assert_allclose",
    "assert_almost_between",
    "assert_dtype_matches",
    "assert_shape_matches",
    "assert_eachclose",
]


class TestingError(AssertionError):
    """Raised when a testing assertion fails."""


def _to_numpy(x: Any) -> np.ndarray:
    if hasattr(x, "evals") and hasattr(x, "values"):
        # Solution / SolutionBatch: compare by decision values
        x = x.values
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_allclose(
    actual: Any,
    desired: Any,
    *,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    equal_nan: bool = True,
):
    """Elementwise closeness; at least one of ``rtol``/``atol`` is
    required."""
    if rtol is None and atol is None:
        raise ValueError("Provide at least one of `rtol` / `atol`")
    a = _to_numpy(actual)
    d = _to_numpy(desired)
    kwargs = {}
    if rtol is not None:
        kwargs["rtol"] = rtol
        if atol is None:
            kwargs["atol"] = 0.0
    if atol is not None:
        kwargs["atol"] = atol
        if rtol is None:
            kwargs["rtol"] = 0.0
    try:
        np.testing.assert_allclose(a, d, equal_nan=equal_nan, **kwargs)
    except AssertionError as e:
        raise TestingError(str(e)) from None


def assert_almost_between(
    x: Any,
    lb: Union[float, Any],
    ub: Union[float, Any],
    *,
    atol: Optional[float] = None,
):
    """Assert that every element is (almost) within ``[lb, ub]``."""
    arr = _to_numpy(x)
    lb = np.asarray(lb)
    ub = np.asarray(ub)
    tolerance = 0.0 if atol is None else float(atol)
    below = arr < (lb - tolerance)
    above = arr > (ub + tolerance)
    if bool(np.any(below)) or bool(np.any(above)):
        raise TestingError(
            f"Some elements are outside [{lb}, {ub}] (atol={atol}): "
            f"min={arr.min()}, max={arr.max()}"
        )


def assert_dtype_matches(x: Any, dtype: Any):
    """Assert the dtype: a dtype-like, or the kind ``"float"``, ``"int"`` or
    ``"bool"``."""
    arr = _to_numpy(x)
    if isinstance(dtype, str) and dtype in ("float", "int", "bool"):
        kinds = {"float": "f", "int": "iu", "bool": "b"}[dtype]
        if arr.dtype.kind not in kinds:
            raise TestingError(f"dtype kind mismatch: {arr.dtype} is not of kind {dtype}")
        return
    from .tools.misc import to_numpy_dtype

    expected = to_numpy_dtype(dtype)
    if np.dtype(arr.dtype) != expected:
        raise TestingError(f"dtype mismatch: {arr.dtype} != {expected}")


def assert_shape_matches(x: Any, shape: Union[int, Iterable]):
    """Assert the shape; a ``"*"`` (or -1, None) entry matches any size."""
    arr = _to_numpy(x)
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape)
    if arr.ndim != len(shape):
        raise TestingError(f"shape mismatch: {arr.shape} vs {shape}")
    for actual_dim, expected_dim in zip(arr.shape, shape):
        if expected_dim in ("*", -1, None):
            continue
        if actual_dim != int(expected_dim):
            raise TestingError(f"shape mismatch: {arr.shape} vs {shape}")


def assert_eachclose(x: Any, value: Any, *, rtol: Optional[float] = None, atol: Optional[float] = None):
    """Assert that every element is close to the scalar ``value``; the
    comparison is made in floating point, so an integer array is not close
    to a fractional target."""
    arr = _to_numpy(x)
    expected = np.full(arr.shape, value, dtype=np.result_type(arr.dtype, np.asarray(value).dtype, np.float32))
    assert_allclose(arr.astype(expected.dtype), expected, rtol=rtol, atol=atol)
