"""Functional XNES: ``xnes`` / ``xnes_ask`` / ``xnes_tell`` (counterpart of
``evotorch_tpu/algorithms/functional/funcxnes.py``), over the
``ExpGaussian`` full-covariance math of ``distributions.py``. The updates
go through ``torch.linalg.matrix_exp`` where the JAX package calls
``jax.scipy.linalg.expm``. Extra leading dimensions on the state are
independent searches: the fitnesses are ranked along their last axis in
one call, and the update runs under ``expects_ndim``."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ...decorators import expects_ndim
from ...distributions import ExpGaussian
from ...tools.ranking import rank
from .misc import as_center

__all__ = ["XNESState", "xnes", "xnes_ask", "xnes_tell"]


@dataclasses.dataclass(frozen=True)
class XNESState:
    center: torch.Tensor
    A: torch.Tensor
    A_inv: torch.Tensor
    center_learning_rate: torch.Tensor
    stdev_learning_rate: torch.Tensor
    ranking_method: str
    maximize: bool


def xnes(
    *,
    center_init,
    objective_sense: str,
    stdev_init=None,
    radius_init=None,
    center_learning_rate: Optional[float] = None,
    stdev_learning_rate: Optional[float] = None,
    ranking_method: str = "nes",
) -> XNESState:
    """Initial XNES state: ``A`` is ``diag(stdev)`` (one per lane when the
    stdev has the batch's shape); the stdev learning rate defaults to
    ``0.6 * (3 + log n) / (n * sqrt(n))``."""
    center_init = as_center(center_init)
    n = center_init.shape[-1]
    dtype, device = center_init.dtype, center_init.device
    if objective_sense not in ("min", "max"):
        raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
    if (stdev_init is None) == (radius_init is None):
        raise ValueError("Exactly one of stdev_init / radius_init must be provided")
    if radius_init is not None:
        stdev_init = torch.as_tensor(radius_init, dtype=dtype, device=device) / torch.sqrt(
            torch.tensor(n, dtype=dtype, device=device)
        )
    stdev_init = torch.as_tensor(stdev_init, dtype=dtype, device=device)
    batch_shape = tuple(center_init.shape[:-1])
    if stdev_init.ndim > 0 and tuple(stdev_init.shape) == batch_shape:
        diag = stdev_init[..., None].expand(batch_shape + (n,))
    else:
        diag = stdev_init.expand(batch_shape + (n,))
    eye = torch.eye(n, dtype=dtype, device=device)
    A = eye * diag[..., None, :]
    A_inv = eye * (1.0 / torch.clamp(diag, min=1e-30))[..., None, :]
    if center_learning_rate is None:
        center_learning_rate = 1.0
    if stdev_learning_rate is None:
        stdev_learning_rate = 0.6 * (3 + math.log(n)) / (n * math.sqrt(n))
    return XNESState(
        center=center_init,
        A=A,
        A_inv=A_inv,
        center_learning_rate=torch.as_tensor(center_learning_rate, dtype=dtype, device=device),
        stdev_learning_rate=torch.as_tensor(stdev_learning_rate, dtype=dtype, device=device),
        ranking_method=str(ranking_method),
        maximize=(objective_sense == "max"),
    )


def xnes_ask(generator: torch.Generator, state: XNESState, *, popsize: int) -> torch.Tensor:
    """A population per search lane, each from its own noise."""
    return ExpGaussian.functional_sample(
        int(popsize), {"mu": state.center, "sigma": state.A, "sigma_inv": state.A_inv}, generator=generator
    )


def _xnes_tell_core(ranking_method: str):
    @expects_ndim(1, 2, 2, 0, 0, 2, 1)
    def core(center, A, A_inv, clr, slr, values, weights):
        grads = ExpGaussian._compute_gradients(
            {"mu": center, "sigma": A, "sigma_inv": A_inv}, values, weights, ranking_method
        )
        update_d = clr * grads["d"]
        update_M = slr * grads["M"]
        new_center = center + A @ update_d
        new_A = A @ torch.linalg.matrix_exp(0.5 * update_M)
        new_A_inv = torch.linalg.matrix_exp(-0.5 * update_M) @ A_inv
        return new_center, new_A, new_A_inv

    return core


def xnes_tell(state: XNESState, values, evals) -> XNESState:
    weights = rank(torch.as_tensor(evals), state.ranking_method, higher_is_better=state.maximize)
    center, A, A_inv = _xnes_tell_core(state.ranking_method)(
        state.center, state.A, state.A_inv, state.center_learning_rate, state.stdev_learning_rate,
        torch.as_tensor(values), weights,
    )  # fmt: skip
    return dataclasses.replace(state, center=center, A=A, A_inv=A_inv)
