"""Antithetic-Gaussian sampling: the PGPE ``ask`` population.

Computes ``[mu + sigma*e0, mu - sigma*e0, mu + sigma*e1, ...]``. Counterpart
of ``evotorch_tpu/ops/sampling.py``; on a CUDA tensor it launches the
hand-written kernel ``csrc/symmetric_gaussian.cu`` (see the note there for
what bounds it and how it is laid out), on a CPU tensor it runs the plain
PyTorch version in this module, which computes the same Philox4x32-10
counters and Box-Muller transform value by value.

The noise comes from a ``(seed, offset)`` pair drawn from the caller's
``torch.Generator``, so the port matches the JAX reference in distribution,
not in bits. ``eps=`` injects the standard-normal noise instead (the
counterpart of the JAX package's ``_pallas_kernel_with_noise``), which is how
the parity tests feed both packages the same population.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["sample_symmetric_gaussian", "sample_symmetric_gaussian_plain", "draw_seed"]

_TWO_PI = 2.0 * math.pi
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_SIGNATURE = (ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def draw_seed(generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Two int64 from ``generator`` (Philox key, counter offset), on
    ``device``: the kernel reads them there, so drawing costs no host sync."""
    seed = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device, dtype=torch.int64)
    return seed.to(device, non_blocking=True)


def _check_inputs(mu: torch.Tensor, sigma: torch.Tensor, num_solutions: int) -> int:
    if num_solutions % 2 != 0:
        raise ValueError(f"num_solutions must be even, got {num_solutions}")
    if mu.ndim != 1 or sigma.shape != mu.shape:
        raise ValueError(f"mu and sigma must be equal-length vectors, got {tuple(mu.shape)} and {tuple(sigma.shape)}")
    if mu.device != sigma.device:
        raise ValueError(f"mu and sigma lie on different devices: {mu.device} and {sigma.device}")
    return num_solutions // 2


# -- plain PyTorch version ------------------------------------------------------


def _mulhilo(multiplier: int, b: torch.Tensor):
    """High and low 32 bits of ``multiplier * b`` for uint32 values held in
    int64, split in 16-bit halves so that no product leaves int64."""
    p_lo = b * (multiplier & 0xFFFF)
    p_hi = b * (multiplier >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: torch.Tensor, k1: torch.Tensor):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    values; returns the four output words."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [1, 2) by the mantissa trick."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def _box_muller(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """The two normals of one Box-Muller pair: the radius from ``bits_a``,
    the cosine and the sine of one angle from ``bits_b``."""
    u1 = 2.0 - _unit_float(bits_a)  # in (0, 1]: log never sees 0
    u2 = _unit_float(bits_b) - 1.0  # in [0, 1)
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = _TWO_PI * u2
    return radius * torch.cos(angle), radius * torch.sin(angle)


def philox_normal(seed: torch.Tensor, num_directions: int, length: int) -> torch.Tensor:
    """The kernel's standard-normal noise ``(num_directions, length)``:
    direction ``i``, columns ``4q .. 4q+3`` come from one Philox call on the
    counter ``(q, i, offset)`` under the key ``seed[0]``, as two Box-Muller
    pairs (words 0-1 and 2-3), cosine then sine."""
    device = seed.device
    s = seed.to(torch.int64)
    k0, k1 = s[0] & _MASK32, (s[0] >> 32) & _MASK32
    off_lo, off_hi = s[1] & _MASK32, (s[1] >> 32) & _MASK32
    groups = (length + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=device).expand(num_directions, groups)
    c1 = torch.arange(num_directions, dtype=torch.int64, device=device)[:, None].expand(num_directions, groups)
    x0, x1, x2, x3 = philox4x32_10(c0, c1, off_lo.expand_as(c0), off_hi.expand_as(c0), k0, k1)
    noise = torch.stack((*_box_muller(x0, x1), *_box_muller(x2, x3)), dim=-1)
    return noise.reshape(num_directions, 4 * groups)[:, :length]


def _interleave_plain(mu: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    scaled = eps * sigma
    return torch.stack((mu + scaled, mu - scaled), dim=1).reshape(2 * eps.shape[0], mu.shape[-1])


def sample_symmetric_gaussian_plain(
    mu: torch.Tensor,
    sigma: torch.Tensor,
    num_solutions: int,
    *,
    seed: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: Philox noise from ``seed``
    (see :func:`draw_seed`), or the injected ``eps``."""
    half = _check_inputs(mu, sigma, num_solutions)
    if eps is None:
        eps = philox_normal(seed.to(mu.device), half, mu.shape[-1])
    return _interleave_plain(mu, sigma, eps)


# -- the CUDA kernel --------------------------------------------------------------


def _launch(mu, sigma, num_solutions, *, seed, eps) -> torch.Tensor:
    if mu.dtype != torch.float32 or sigma.dtype != torch.float32:
        raise TypeError(f"the sampling kernel takes float32, got {mu.dtype} and {sigma.dtype}")
    half = num_solutions // 2
    length = mu.shape[-1]
    mu = mu.contiguous()
    sigma = sigma.contiguous()
    out = torch.empty((num_solutions, length), dtype=torch.float32, device=mu.device)
    lib = _build.library(
        "symmetric_gaussian",
        {"evt_symmetric_gaussian_philox": _SIGNATURE, "evt_symmetric_gaussian_noise": _SIGNATURE},
    )
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    if eps is None:
        if seed.shape != (2,) or seed.dtype != torch.int64 or seed.device != mu.device:
            raise ValueError("seed must be an int64 tensor of 2 on the device of mu (see draw_seed)")
        fn, name, third = lib.evt_symmetric_gaussian_philox, "symmetric_gaussian_philox", seed
    else:
        if eps.shape != (half, length) or eps.dtype != torch.float32 or eps.device != mu.device:
            raise ValueError(f"eps must be float32 of shape {(half, length)} on {mu.device}")
        fn, name, third = lib.evt_symmetric_gaussian_noise, "symmetric_gaussian_noise", eps.contiguous()
    status = fn(mu.data_ptr(), sigma.data_ptr(), third.data_ptr(), out.data_ptr(), half, length, mu.device.index, stream)
    _build.check(status, name)
    sample_symmetric_gaussian.launches += 1
    return out


def sample_symmetric_gaussian(
    mu: torch.Tensor,
    sigma: torch.Tensor,
    num_solutions: int,
    *,
    generator: Optional[torch.Generator] = None,
    seed: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample an antithetic population of ``num_solutions`` (even) rows around
    ``mu`` with per-coordinate stdev ``sigma``.

    The noise is Philox noise keyed by a seed drawn from ``generator`` (or
    the given ``seed``, see :func:`draw_seed`), or else the injected
    standard-normal ``eps`` of shape ``(num_solutions // 2, L)``: pass
    exactly one of the three. A CUDA ``mu`` launches the kernel (or raises);
    a CPU ``mu`` runs the plain version."""
    _check_inputs(mu, sigma, num_solutions)
    if sum(x is not None for x in (generator, seed, eps)) != 1:
        raise ValueError("pass exactly one of generator, seed and eps")
    if generator is not None:
        seed = draw_seed(generator, mu.device)
    if mu.device.type == "cuda":
        return _launch(mu, sigma, num_solutions, seed=seed, eps=eps)
    if mu.device.type != "cpu":
        raise RuntimeError(f"no sampling kernel for device {mu.device}")
    return sample_symmetric_gaussian_plain(mu, sigma, num_solutions, seed=seed, eps=eps)


#: kernel launches (both entries), read by chip_smoke.py to show that the
#: main path went through the kernel
sample_symmetric_gaussian.launches = 0
