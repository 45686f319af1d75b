"""Centered ranks ``rank / (n - 1) - 0.5`` along the last axis.

Counterpart of ``evotorch_tpu/ops/ranking.py:fused_centered_rank``. The rank
of an element is its position in the total order (isnan, value, index): ties
break stably by index and NaN orders last, exactly as a stable argsort
ranks. Minimisation (``higher_is_better=False``) ranks the negated values,
and ``n == 1`` gives zeros.

On a CUDA tensor :func:`centered_rank` launches the hand-written kernel
``csrc/centered_rank.cu`` (see the note there for what bounds it and how it
is laid out) or raises; on a CPU tensor it runs the plain version in this
module, which maps the values to the same integer keys and counts the same
comparisons. It is the port's only plain centered rank: ``tools.ranking``
calls :func:`centered_rank` on every device. The kernel compares in float32
for the dtypes the JAX kernel admits (their values embed in float32 exactly)
and in float64 for float64; any other dtype raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..observability.registry import counters
from . import _build

__all__ = ["centered_rank", "centered_rank_plain"]

_F32_EXACT = tuple(
    getattr(torch, name)
    for name in ("float32", "bfloat16", "float16", "int16", "int8", "uint16", "uint8")
    if hasattr(torch, name)
)
_SIGNATURE = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_PLAIN_BLOCK = 1 << 24  # comparisons per chunk of the plain version


def _compare_dtype(dtype: torch.dtype) -> torch.dtype:
    # graftlint: allow(dtype): float64 scores are ranked as float64, as the JAX package's f64 path ranks them
    if dtype == torch.float64:
        return torch.float64  # graftlint: allow(dtype): float64 scores are ranked as float64
    if dtype in _F32_EXACT:
        return torch.float32
    raise TypeError(f"centered_rank compares in float32 or float64 and does not take {dtype}")


def _signed(x: torch.Tensor, higher_is_better: bool) -> torch.Tensor:
    """The values to rank ascending, in the compare dtype. The sign flips in
    the input dtype, as in the JAX kernel (integer negation wraps)."""
    return (x if higher_is_better else -x).to(_compare_dtype(x.dtype))


def _finish(ranks: torch.Tensor, n: int, like: torch.Tensor) -> torch.Tensor:
    """``rank / (n - 1) - 0.5`` with a true division (a tensor divisor, so
    no reciprocal multiply), cast back to a floating input dtype."""
    out = ranks / torch.full((), n - 1, dtype=ranks.dtype, device=ranks.device) - 0.5
    return out.to(like.dtype) if like.dtype.is_floating_point else out


def _zeros(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=x.dtype if x.dtype.is_floating_point else torch.float32, device=x.device)


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving keys, as signed int64: the kernel's
    unsigned key with its top bit flipped, so the same order. -0 becomes +0
    and every NaN the largest key, above +inf; ``values`` are float32 or
    float64, already sign-flipped for minimisation."""
    if values.dtype == torch.float64:  # graftlint: allow(dtype): the keys of float64 scores
        bits, top = values.view(torch.int64), torch.iinfo(torch.int64).max
    else:
        bits, top = values.view(torch.int32).to(torch.int64), torch.iinfo(torch.int32).max
    bits = torch.where(values == 0, torch.zeros_like(bits), bits)
    keys = torch.where(bits < 0, bits ^ top, bits)  # negatives: larger magnitude, smaller key
    return torch.where(torch.isnan(values), torch.full_like(keys, top), keys)


def centered_rank_plain(x: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same keys and the same
    count (``key_j < key_i``, or equal keys with ``j < i``), taken over row
    chunks so that memory stays bounded."""
    n = x.shape[-1]
    if n == 1:
        return _zeros(x)
    flat = _signed(x, higher_is_better).reshape(-1, n)
    keys = _order_keys(flat)
    index = torch.arange(n, device=x.device)
    ranks = torch.empty(flat.shape, dtype=flat.dtype, device=x.device)
    chunk = max(1, _PLAIN_BLOCK // (n * flat.shape[0]))
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        ki, kj = keys[:, start:stop, None], keys[:, None, :]
        earlier = index[None, None, :] < index[start:stop, None]
        ranks[:, start:stop] = ((kj < ki) | ((kj == ki) & earlier)).sum(-1).to(flat.dtype)
    return _finish(ranks, n, x).reshape(x.shape)


def _launch(x: torch.Tensor, higher_is_better: bool) -> torch.Tensor:
    cdt = _compare_dtype(x.dtype)
    n = x.shape[-1]
    if n == 1:
        return _zeros(x)
    if n >= 2**31:
        raise ValueError(f"centered_rank counts in int32 and takes n < 2**31, got {n}")
    if x.dtype.is_floating_point:
        values, negate = x.to(cdt), not higher_is_better
    else:
        values, negate = _signed(x, higher_is_better), False
    values = values.contiguous()
    batch = values.numel() // n
    counts = torch.zeros(values.shape, dtype=torch.int32, device=x.device)
    out = torch.empty(values.shape, dtype=cdt, device=x.device)
    lib = _build.library("centered_rank", {"evt_centered_rank_f32": _SIGNATURE, "evt_centered_rank_f64": _SIGNATURE})
    fn = lib.evt_centered_rank_f64 if cdt == torch.float64 else lib.evt_centered_rank_f32  # graftlint: allow(dtype): the kernel's float64 entry ranks float64 scores
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(values.data_ptr(), counts.data_ptr(), out.data_ptr(), batch, n, int(negate), x.device.index, stream)
    _build.check(status, "centered_rank")
    counters.increment("kernel.centered_rank.launches")
    return out.to(x.dtype) if x.dtype.is_floating_point else out


def centered_rank(x: torch.Tensor, *, higher_is_better: bool = True) -> torch.Tensor:
    """Centered ranks in ``[-0.5, 0.5]`` along the last axis. NaN is not
    guarded here (it ranks last, i.e. best when maximising): callers that
    need the guard go through ``tools.ranking.rank``."""
    if x.device.type == "cuda":
        return _launch(x, higher_is_better)
    if x.device.type != "cpu":
        raise RuntimeError(f"no centered-rank kernel for device {x.device}")
    return centered_rank_plain(x, higher_is_better=higher_is_better)
