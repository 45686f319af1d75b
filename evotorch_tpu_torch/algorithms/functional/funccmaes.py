"""Functional CMA-ES: ``cmaes`` / ``cmaes_ask`` / ``cmaes_tell``
(counterpart of ``evotorch_tpu/algorithms/functional/funccmaes.py``, itself
after pycma r3.2.2): rank-mu, rank-1 and active covariance updates, CSA
step-size adaptation with the ``h_sig`` stall, separable (diagonal) mode,
and the Cholesky factor of C refreshed every ``decompose_C_freq``
generations.

The generation counter is a host ``int`` in the state, so choosing whether
to refresh the factor reads nothing from the card (the JAX package keys a
``lax.cond`` on a device counter). ``cmaes_ask`` takes a
``torch.Generator`` where the JAX version takes a PRNG key; it draws the
local coordinates ``zs`` and hands them to ``_cmaes_ask_core``.

The rank-mu update is one product, ``(w[:, None] * ys).T @ ys`` (the JAX
package's ``einsum("i,ij,ik->jk")``); the factorization is
``torch.linalg.cholesky``. Both are library calls, as they are XLA ops
outside any Pallas kernel in the JAX package. Float32 products stay in
full float32 on the card (``_device.resolve_device`` turns TF32 off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .misc import as_center

__all__ = ["CMAESState", "cmaes", "cmaes_ask", "cmaes_tell"]


@dataclasses.dataclass(frozen=True)
class CMAESState:
    # search distribution
    m: torch.Tensor
    sigma: torch.Tensor
    C: torch.Tensor  # (d,) when separable, (d, d) otherwise
    A: torch.Tensor  # square root of C: its diagonal, or its Cholesky factor
    p_sigma: torch.Tensor
    p_c: torch.Tensor
    iteration: int  # generations told so far (a host int)
    # the last population in local (zs) and shaped (ys) coordinates
    zs: torch.Tensor
    ys: torch.Tensor
    # constants
    weights: torch.Tensor
    mu_eff: torch.Tensor
    c_m: torch.Tensor
    c_sigma: torch.Tensor
    damp_sigma: torch.Tensor
    c_c: torch.Tensor
    c_1: torch.Tensor
    c_mu: torch.Tensor
    variance_discount_sigma: torch.Tensor
    variance_discount_c: torch.Tensor
    unbiased_expectation: torch.Tensor
    stdev_min: torch.Tensor
    stdev_max: torch.Tensor
    # configuration
    popsize: int
    mu: int
    separable: bool
    active: bool
    csa_squared: bool
    decompose_C_freq: int
    maximize: bool


def cmaes(
    *,
    center_init,
    stdev_init: float,
    objective_sense: str,
    popsize: Optional[int] = None,
    c_m: float = 1.0,
    c_sigma: Optional[float] = None,
    c_sigma_ratio: float = 1.0,
    damp_sigma: Optional[float] = None,
    damp_sigma_ratio: float = 1.0,
    c_c: Optional[float] = None,
    c_c_ratio: float = 1.0,
    c_1: Optional[float] = None,
    c_1_ratio: float = 1.0,
    c_mu: Optional[float] = None,
    c_mu_ratio: float = 1.0,
    active: bool = True,
    csa_squared: bool = False,
    stdev_min: Optional[float] = None,
    stdev_max: Optional[float] = None,
    separable: bool = False,
    limit_C_decomposition: bool = True,
) -> CMAESState:
    """Initial state with pycma's rules of thumb."""
    m = as_center(center_init)
    if m.ndim != 1:
        raise ValueError(f"center_init must be 1-D, got shape {tuple(m.shape)}")
    d = m.shape[0]
    dtype, device = m.dtype, m.device
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")

    if not popsize:
        popsize = 4 + int(math.floor(3 * math.log(d)))
    popsize = int(popsize)
    mu = int(math.floor(popsize / 2))

    # raw weights log((lambda + 1) / 2) - log(i), in the center's dtype
    raw_weights = math.log((popsize + 1) / 2) - torch.log(torch.arange(popsize, dtype=dtype, device=device) + 1)
    positive_weights = raw_weights[:mu]
    negative_weights = raw_weights[mu:]
    mu_eff = torch.sum(positive_weights) ** 2 / torch.sum(positive_weights**2)
    mu_eff_f = float(mu_eff)

    if c_sigma is None:
        c_sigma = (mu_eff_f + 2.0) / (d + mu_eff_f + 3)
    c_sigma = c_sigma_ratio * c_sigma
    if damp_sigma is None:
        damp_sigma = 1 + 2 * max(0.0, math.sqrt(max(0.0, (mu_eff_f - 1) / (d + 1))) - 1) + c_sigma
    damp_sigma = damp_sigma_ratio * damp_sigma
    if c_c is None:
        if separable:
            c_c = (1 + (1 / d) + (mu_eff_f / d)) / (d**0.5 + (1 / d) + 2 * (mu_eff_f / d))
        else:
            c_c = (4 + mu_eff_f / d) / (d + (4 + 2 * mu_eff_f / d))
    c_c = c_c_ratio * c_c
    if c_1 is None:
        if separable:
            c_1 = 1.0 / (d + 2.0 * math.sqrt(d) + mu_eff_f / d)
        else:
            c_1 = min(1, popsize / 6) * 2 / ((d + 1.3) ** 2.0 + mu_eff_f)
    c_1 = c_1_ratio * c_1
    if c_mu is None:
        if separable:
            c_mu = (0.25 + mu_eff_f + (1.0 / mu_eff_f) - 2) / (d + 4 * math.sqrt(d) + (mu_eff_f / 2.0))
        else:
            c_mu = min(1 - c_1, 2 * ((0.25 + mu_eff_f - 2 + (1 / mu_eff_f)) / ((d + 2) ** 2.0 + mu_eff_f)))
    c_mu = c_mu_ratio * c_mu

    variance_discount_sigma = math.sqrt(c_sigma * (2 - c_sigma) * mu_eff_f)
    variance_discount_c = math.sqrt(c_c * (2 - c_c) * mu_eff_f)

    positive_weights = positive_weights / torch.sum(positive_weights)
    if active:
        mu_eff_neg = torch.sum(negative_weights) ** 2 / torch.sum(negative_weights**2)
        alpha_mu = 1 + c_1 / c_mu
        alpha_mu_eff = 1 + 2 * float(mu_eff_neg) / (mu_eff_f + 2)
        alpha_pos_def = (1 - c_mu - c_1) / (d * c_mu)
        alpha = min([alpha_mu, alpha_mu_eff, alpha_pos_def])
        negative_weights = alpha * negative_weights / torch.sum(torch.abs(negative_weights))
    else:
        negative_weights = torch.zeros_like(negative_weights)
    weights = torch.cat([positive_weights, negative_weights])

    unbiased_expectation = math.sqrt(d) * (1 - (1 / (4 * d)) + 1 / (21 * d**2))

    if limit_C_decomposition:
        denom = 10 * d * (c_1 + c_mu)
        denom = denom if abs(denom) > 1e-8 else 1e-8
        decompose_C_freq = max(1, int(math.floor(1 / denom)))
    else:
        decompose_C_freq = 1

    if separable:
        C = torch.ones(d, dtype=dtype, device=device)
    else:
        C = torch.eye(d, dtype=dtype, device=device)

    def scalar(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=device)

    return CMAESState(
        m=m,
        sigma=scalar(stdev_init),
        C=C,
        A=C.clone(),
        p_sigma=torch.zeros(d, dtype=dtype, device=device),
        p_c=torch.zeros(d, dtype=dtype, device=device),
        iteration=0,
        zs=torch.zeros((popsize, d), dtype=dtype, device=device),
        ys=torch.zeros((popsize, d), dtype=dtype, device=device),
        weights=weights,
        mu_eff=scalar(mu_eff),
        c_m=scalar(c_m),
        c_sigma=scalar(c_sigma),
        damp_sigma=scalar(damp_sigma),
        c_c=scalar(c_c),
        c_1=scalar(c_1),
        c_mu=scalar(c_mu),
        variance_discount_sigma=scalar(variance_discount_sigma),
        variance_discount_c=scalar(variance_discount_c),
        unbiased_expectation=scalar(unbiased_expectation),
        stdev_min=scalar(0.0 if stdev_min is None else stdev_min),
        stdev_max=scalar(math.inf if stdev_max is None else stdev_max),
        popsize=popsize,
        mu=mu,
        separable=bool(separable),
        active=bool(active),
        csa_squared=bool(csa_squared),
        decompose_C_freq=int(decompose_C_freq),
        maximize=(objective_sense == "max"),
    )


def _draw_local_coordinates(generator: torch.Generator, state: CMAESState) -> torch.Tensor:
    """``zs``: ``(popsize, d)`` standard-normal draws."""
    return torch.randn(
        (state.popsize, state.m.shape[0]), generator=generator, dtype=state.m.dtype, device=state.m.device
    )


def _cmaes_ask_core(state: CMAESState, zs: torch.Tensor):
    """``(new_state, xs)`` from the local coordinates ``zs``: ``ys = A zs``
    and ``xs = m + sigma * ys``; the state keeps ``zs`` and ``ys`` for the
    tell."""
    zs = zs.to(state.m.device)
    ys = state.A[None, :] * zs if state.separable else zs @ state.A.T
    xs = state.m[None, :] + state.sigma * ys
    return dataclasses.replace(state, zs=zs, ys=ys), xs


def cmaes_ask(generator: torch.Generator, state: CMAESState):
    """Sample the population: returns ``(new_state, xs)``."""
    return _cmaes_ask_core(state, _draw_local_coordinates(generator, state))


def _h_sig(p_sigma: torch.Tensor, c_sigma: torch.Tensor, iteration: int) -> torch.Tensor:
    """The stall flag of the rank-1 path, as 0 or 1 in the state's dtype."""
    d = p_sigma.shape[-1]
    squared_sum = torch.sum(p_sigma**2) / (1 - (1 - c_sigma) ** float(2 * iteration + 1))
    stall = (squared_sum / d) - 1 < 1 + 4.0 / (d + 1)
    return stall.to(p_sigma.dtype)


def _limit_stdev(sigma, C, stdev_min, stdev_max, separable: bool) -> torch.Tensor:
    """C with the element-wise stdevs of ``sigma^2 C`` clamped."""
    diag = C if separable else torch.diagonal(C)
    stdevs = torch.minimum(torch.maximum(sigma * torch.sqrt(diag), stdev_min), stdev_max)
    unscaled = (stdevs / sigma) ** 2
    if separable:
        return unscaled
    n = C.shape[0]
    return C * (1 - torch.eye(n, dtype=C.dtype, device=C.device)) + torch.diag(unscaled)


def cmaes_tell(state: CMAESState, xs, fitnesses) -> CMAESState:
    """The full CMA-ES update from the evaluated population."""
    fitnesses = torch.as_tensor(fitnesses, device=state.m.device)
    d = state.m.shape[0]

    # weights by rank, best first (a stable sort: ties to the lower index)
    utilities = fitnesses if state.maximize else -fitnesses
    order = torch.argsort(-utilities, stable=True)
    ranks = torch.empty_like(order).index_copy_(0, order, torch.arange(state.popsize, device=order.device))
    assigned_weights = state.weights.index_select(0, ranks)

    zs, ys = state.zs, state.ys

    # center: the weighted mean of the best mu (lax.top_k's order)
    top_idx = torch.argsort(assigned_weights, descending=True, stable=True)[: state.mu]
    top_w = assigned_weights.index_select(0, top_idx)
    local_disp = torch.sum(top_w[:, None] * zs.index_select(0, top_idx), dim=0)
    shaped_disp = torch.sum(top_w[:, None] * ys.index_select(0, top_idx), dim=0)
    m = state.m + state.c_m * state.sigma * shaped_disp

    # step size (CSA)
    p_sigma = (1 - state.c_sigma) * state.p_sigma + state.variance_discount_sigma * local_disp
    if state.csa_squared:
        exponential_update = (torch.sum(p_sigma**2) / d - 1) / 2
    else:
        exponential_update = torch.linalg.vector_norm(p_sigma) / state.unbiased_expectation - 1
    sigma = state.sigma * torch.exp((state.c_sigma / state.damp_sigma) * exponential_update)

    h_sig = _h_sig(p_sigma, state.c_sigma, state.iteration)

    # covariance
    p_c = (1 - state.c_c) * state.p_c + h_sig * state.variance_discount_c * shaped_disp
    if state.active:
        assigned_weights = torch.where(
            assigned_weights > 0,
            assigned_weights,
            d * assigned_weights / torch.clamp(torch.sum(zs**2, dim=-1), min=1e-23),
        )
    c1a = state.c_1 * (1 - (1 - h_sig**2) * state.c_c * (2 - state.c_c))
    weighted_pc = torch.sqrt(state.c_1 / (c1a + 1e-23))
    if state.separable:
        r1_update = c1a * (p_c**2 - state.C)
        rmu_update = state.c_mu * torch.sum(assigned_weights[:, None] * (ys**2 - state.C[None, :]), dim=0)
    else:
        wpc = weighted_pc * p_c
        r1_update = c1a * (torch.outer(wpc, wpc) - state.C)
        rmu_update = state.c_mu * ((assigned_weights[:, None] * ys).T @ ys - torch.sum(state.weights) * state.C)
    C = state.C + r1_update + rmu_update
    C = _limit_stdev(sigma, C, state.stdev_min, state.stdev_max, state.separable)

    A = state.A
    if (state.iteration + 1) % state.decompose_C_freq == 0:
        A = torch.sqrt(C) if state.separable else torch.linalg.cholesky(C)

    return dataclasses.replace(
        state, m=m, sigma=sigma, C=C, A=A, p_sigma=p_sigma, p_c=p_c, iteration=state.iteration + 1
    )
