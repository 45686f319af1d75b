"""Search distributions: the gradient-estimation heart of PGPE.

Counterpart of ``evotorch_tpu/distributions.py`` for the separable Gaussians
PGPE uses. The math lives in classmethods over a parameter dict
(``{"mu": ..., "sigma": ..., "divide_*_grad_by": ...}``), as in the JAX
package; ``make_functional_grad_estimator`` wraps ranking plus gradients.

On a CUDA tensor, ``SymmetricSeparableGaussian._sample`` launches the
sampling kernel (``ops.sampling``). The gradients' ``(half,) @ (half, L)``
products are plain ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional, Type

import torch

from .ops.sampling import sample_symmetric_gaussian
from .tools.ranking import rank

__all__ = [
    "SeparableGaussian",
    "SymmetricSeparableGaussian",
    "make_functional_grad_estimator",
]


def _zero_center_weights(weights: torch.Tensor, ranking_used: Optional[str]) -> torch.Tensor:
    """Weights must be 0-centered for the score-function estimators unless
    the ranking already guarantees it."""
    if ranking_used not in ("centered", "normalized"):
        weights = weights - torch.mean(weights)
    return weights


def _divide_grad(parameters: dict, param_name: str, grad: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The configurable gradient divisor ``divide_<param>_grad_by``."""
    option = f"divide_{param_name}_grad_by"
    div_by_what = parameters.get(option, None)
    if div_by_what is None:
        return grad
    if div_by_what == "num_solutions":
        return grad / weights.shape[0]
    if div_by_what == "num_directions":
        return grad / (weights.shape[0] // 2)
    if div_by_what == "total_weight":
        return grad / torch.sum(torch.abs(weights))
    if div_by_what == "weight_stdev":
        return grad / torch.std(weights, correction=1)
    raise ValueError(f"The parameter {option} has an unrecognized value: {div_by_what}")


class SeparableGaussian:
    """Separable multivariate Gaussian (non-symmetric PGPE)."""

    SAMPLES_MUST_BE_EVEN = False

    @classmethod
    def _sample(cls, generator: torch.Generator, parameters: dict, num_solutions: int, *, eps=None) -> torch.Tensor:
        """``mu + sigma * eps``; ``eps`` (``(num_solutions, L)``) may be
        injected, else it is drawn from ``generator``."""
        mu, sigma = parameters["mu"], parameters["sigma"]
        if eps is None:
            eps = torch.randn((num_solutions, mu.shape[-1]), generator=generator, dtype=mu.dtype, device=generator.device)
            eps = eps.to(mu.device)
        return mu + sigma * eps

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples: torch.Tensor, weights: torch.Tensor, ranking_used) -> dict:
        mu, sigma = parameters["mu"], parameters["sigma"]
        scaled_noises = samples - mu
        weights = _zero_center_weights(weights, ranking_used)
        mu_grad = _divide_grad(parameters, "mu", weights @ scaled_noises, weights)
        sigma_grad = _divide_grad(parameters, "sigma", weights @ ((scaled_noises**2 - sigma**2) / sigma), weights)
        return {"mu": mu_grad, "sigma": sigma_grad}


class SymmetricSeparableGaussian(SeparableGaussian):
    """Antithetic separable Gaussian, the PGPE default: rows are interleaved
    ``[mu + e0, mu - e0, mu + e1, mu - e1, ...]``."""

    SAMPLES_MUST_BE_EVEN = True

    @classmethod
    def _sample(cls, generator: torch.Generator, parameters: dict, num_solutions: int, *, eps=None) -> torch.Tensor:
        """``eps`` (``(num_solutions // 2, L)`` standard normal) may be
        injected; otherwise the noise is drawn from ``generator``. Either way
        a CUDA ``mu`` goes through the sampling kernel."""
        if num_solutions % 2 != 0:
            raise ValueError(f"Number of solutions sampled from {cls.__name__} must be even, got {num_solutions}")
        return sample_symmetric_gaussian(
            parameters["mu"],
            parameters["sigma"],
            num_solutions,
            generator=None if eps is not None else generator,
            eps=eps,
        )

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples: torch.Tensor, weights: torch.Tensor, ranking_used) -> dict:
        mu, sigma = parameters["mu"], parameters["sigma"]
        weights = _zero_center_weights(weights, ranking_used)
        scaled_noises = samples[0::2] - mu
        fdplus = weights[0::2]
        fdminus = weights[1::2]
        mu_grad = _divide_grad(parameters, "mu", ((fdplus - fdminus) / 2) @ scaled_noises, weights)
        sigma_grad = _divide_grad(
            parameters,
            "sigma",
            ((fdplus + fdminus) / 2) @ ((scaled_noises**2 - sigma**2) / sigma),
            weights,
        )
        return {"mu": mu_grad, "sigma": sigma_grad}


def make_functional_grad_estimator(
    distribution_class: Type[SeparableGaussian],
    *,
    objective_sense: str,
    ranking_method: str = "raw",
) -> Callable:
    """A stateless estimator ``g(samples, fitnesses, parameters) -> grads``:
    ranks the fitnesses, then computes the distribution's gradients.
    Batched parameters (extra leading dims) are not ported yet."""
    higher_is_better = {"max": True, "min": False}[objective_sense]

    def estimator(samples: torch.Tensor, fitnesses: torch.Tensor, parameters: dict) -> dict:
        if parameters["mu"].ndim != 1 or fitnesses.ndim != 1:
            raise NotImplementedError("batched searches are not ported to evotorch_tpu_torch yet")
        weights = rank(fitnesses, ranking_method, higher_is_better=higher_is_better)
        return distribution_class._compute_gradients(parameters, samples, weights, ranking_method)

    estimator.__name__ = f"functional_grad_estimator_of_{distribution_class.__name__}"
    return estimator
