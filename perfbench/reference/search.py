"""Plain reference of PGPE's ask (numpy) and tell (PyTorch), in float64.

The ask: the program draws a Philox key and counter offset from its
generator (one ``randint`` of two int64) and the sampling kernel turns each
counter ``(column group q, direction i, offset)`` into four standard normals
by Philox4x32-10 and two Box-Muller pairs, direction ``i`` giving rows
``2i`` (``mu + sigma * e``) and ``2i + 1`` (``mu - sigma * e``). Here the same
counters go through Philox in exact integer arithmetic and Box-Muller in
float64, from the generator state the program's generator had before the
ask, so the population can be held to it row by row.

A factored (low-rank) ask ``theta_i = mu + B z_i`` draws with
``torch.randn`` from the same generator, in the program's float32: on a
generation's first round the basis ``g`` ``(L, k)``, then the coefficients
``(N/2, k)``, interleaved ``[+z0, -z0, +z1, -z1, ...]``; later rounds of the
generation draw coefficients only and reuse the first round's basis.
``B = sigma * g / sqrt(k)``, with ``sqrt(k)`` rounded to float32.
``ask_lowrank`` replays those draws and returns them in float64.

The tell: centered ranks of the scores, the symmetric PGPE gradient of the
center and the stdev over the population's directions, ClipUp on the
center, a plain learning-rate step on the stdev and its clamp to a 20%
change, in float64 (in another dtype for the control).
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["LowRankAsk", "TellState", "ask_lowrank", "ask_rows", "centered_ranks", "draw_seed", "normals", "tell"]

_MASK32 = np.uint64(0xFFFFFFFF)
_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)


def draw_seed(generator: torch.Generator) -> tuple:
    """The sampler's ``(key, offset)`` pair as the program draws it from its
    generator, which advances as the program's did."""
    seed = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device, dtype=torch.int64)
    key, offset = (int(v) for v in seed.cpu())
    return key, offset


def _philox(c0, c1, c2, c3, k0: np.uint64, k1: np.uint64):
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        p0 = _M0 * c0  # exact: both factors are below 2**32
        p1 = _M1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK32
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(bits: np.ndarray) -> np.ndarray:
    """uint32 bits -> [1, 2) by the mantissa trick, as float64 (exact)."""
    return ((bits >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32).view(np.float32).astype(np.float64)


def _box_muller(a: np.ndarray, b: np.ndarray):
    u1 = 2.0 - _unit(a)
    u2 = _unit(b) - 1.0
    radius = np.sqrt(-2.0 * np.log(u1))
    angle = 2.0 * math.pi * u2
    return radius * np.cos(angle), radius * np.sin(angle)


def normals(key: int, offset: int, directions: Sequence[int], length: int) -> np.ndarray:
    """The standard normals ``(len(directions), length)`` of the given
    directions, float64."""
    k0, k1 = np.uint64(key & 0xFFFFFFFF), np.uint64((key >> 32) & 0xFFFFFFFF)
    off_lo, off_hi = np.uint64(offset & 0xFFFFFFFF), np.uint64((offset >> 32) & 0xFFFFFFFF)
    groups = (length + 3) // 4
    q = np.arange(groups, dtype=np.uint64)[None, :]
    i = np.asarray(directions, dtype=np.uint64)[:, None]
    shape = (i.shape[0], groups)
    c0 = np.broadcast_to(q, shape).copy()
    c1 = np.broadcast_to(i, shape).copy()
    c2 = np.full(shape, off_lo, dtype=np.uint64)
    c3 = np.full(shape, off_hi, dtype=np.uint64)
    x0, x1, x2, x3 = _philox(c0, c1, c2, c3, k0, k1)
    a, b = _box_muller(x0, x1)
    c, d = _box_muller(x2, x3)
    out = np.stack((a, b, c, d), axis=-1).reshape(shape[0], 4 * groups)
    return out[:, :length]


def ask_rows(key: int, offset: int, mu: np.ndarray, sigma: np.ndarray, rows: Sequence[int]):
    """The population rows ``rows`` (float64) and the normals behind them."""
    rows = np.asarray(rows, dtype=np.int64)
    e = normals(key, offset, rows // 2, mu.shape[-1])
    sign = np.where(rows % 2 == 0, 1.0, -1.0)[:, None]
    return mu[None, :] + sign * (sigma[None, :] * e), e


class LowRankAsk(NamedTuple):
    basis: Optional[torch.Tensor]  # (L, k) float64, sigma folded in; None where not drawn
    normals: Optional[torch.Tensor]  # (L, k) float64, the basis's standard normals
    coeffs: torch.Tensor  # (N, k) float64, antithetic pairs interleaved


def ask_lowrank(generator: torch.Generator, sigma: torch.Tensor, num_solutions: int, rank: int, *, draw_basis: bool) -> LowRankAsk:
    """A factored ask's draws from ``generator``, which advances as the
    program's did: the basis only where ``draw_basis`` (a generation's first
    round), then the coefficients."""
    rank = int(rank)
    basis = g = None
    if draw_basis:
        g = torch.randn((sigma.shape[-1], rank), generator=generator, dtype=torch.float32, device=generator.device)
        g = g.to(torch.float64)
        basis = sigma.to(torch.float64)[:, None] * (g / float(np.sqrt(np.float32(rank))))
    z = torch.randn((num_solutions // 2, rank), generator=generator, dtype=torch.float32, device=generator.device)
    z = z.to(torch.float64)
    coeffs = torch.stack([z, -z], dim=1).reshape(num_solutions, rank)
    return LowRankAsk(basis, g, coeffs)


class TellState(NamedTuple):
    mu: torch.Tensor
    sigma: torch.Tensor
    velocity: torch.Tensor


def centered_ranks(scores: torch.Tensor) -> torch.Tensor:
    """``rank / (n - 1) - 0.5`` in float64, higher is better, ties by
    index, a non-finite score counting as the worst finite one."""
    x = scores.detach().to(torch.float64)
    finite = torch.isfinite(x)
    worst = x[finite].min() if bool(finite.any()) else torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(finite, x, worst)
    order = torch.argsort(x, stable=True)
    ranks = torch.empty_like(x)
    ranks[order] = torch.arange(x.shape[0], dtype=x.dtype, device=x.device)
    return ranks / (x.shape[0] - 1) - 0.5


def tell(
    state: TellState,
    plus_rows: Iterable[torch.Tensor],
    scores: torch.Tensor,
    *,
    center_learning_rate: float,
    momentum: float,
    max_speed: float,
    stdev_learning_rate: float,
    stdev_max_change: float,
    dtype=torch.float64,
) -> TellState:
    """One PGPE tell (antithetic rows ``[mu + e0, mu - e0, ...]``) computed
    in ``dtype`` (float64 for the reference). ``plus_rows`` holds the
    population's ``+`` rows (rows ``0, 2, 4, ...``) in blocks of rows, in
    order: the gradients are sums over them."""
    mu, sigma = state.mu.to(dtype), state.sigma.to(dtype)
    w = centered_ranks(scores).to(dtype)
    plus, minus = w[0::2], w[1::2]
    directions = w.shape[0] // 2
    center_w, stdev_w = (plus - minus) / 2.0, (plus + minus) / 2.0
    mu_sum = sigma_sum = None
    at = 0
    for block in plus_rows:
        scaled = block.to(dtype) - mu
        rows = slice(at, at + scaled.shape[0])
        at = rows.stop
        mu_part = center_w[rows] @ scaled
        sigma_part = stdev_w[rows] @ ((scaled**2 - sigma**2) / sigma)
        mu_sum = mu_part if mu_sum is None else mu_sum + mu_part
        sigma_sum = sigma_part if sigma_sum is None else sigma_sum + sigma_part
    if at != directions:
        raise ValueError(f"the + rows hold {at} directions, the scores {directions}")
    mu_grad = mu_sum / directions
    sigma_grad = sigma_sum / directions
    velocity = momentum * state.velocity.to(dtype) + center_learning_rate * (mu_grad / torch.linalg.vector_norm(mu_grad))
    speed = torch.linalg.vector_norm(velocity)
    if bool(speed > max_speed):
        velocity = max_speed * (velocity / speed)
    target = sigma + stdev_learning_rate * sigma_grad
    allowed = torch.abs(sigma) * stdev_max_change
    new_sigma = sigma + torch.clamp(target - sigma, -allowed, allowed)
    return TellState(mu + velocity, new_sigma, velocity)
