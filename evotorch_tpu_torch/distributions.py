"""Search distributions: the gradient-estimation heart of the ES family
(counterpart of ``evotorch_tpu/distributions.py``).

The math lives in classmethods over a parameter dict
(``{"mu": ..., "sigma": ..., "divide_*_grad_by": ...}``), as in the JAX
package; a ``Distribution`` instance is a thin stateful convenience around
them (``parameters``, ``sample``, ``compute_gradients``,
``update_parameters``, ``modified_copy``, ``relative_entropy``).
``make_functional_sampler`` and ``make_functional_grad_estimator`` are the
batched functional forms (extra leading dimensions on the parameters are
independent searches).

- ``SeparableGaussian``: PGPE's non-symmetric gradients with configurable
  divisors, and the CEM elite update when ``parenthood_ratio`` is given.
- ``SymmetricSeparableGaussian``: antithetic pairs interleaved as
  ``[+e0, -e0, +e1, -e1, ...]``, the PGPE default; also factored
  populations (``sample_lowrank``, ``_sample_trunk_delta``) and their
  gradients in O(L * rank) (``tools/lowrank.py``).
- ``ExpSeparableGaussian`` (SNES): ``sigma <- sigma * exp(0.5 * lr * grad)``.
- ``ExpGaussian`` (XNES): full covariance through ``A`` and a tracked
  ``A_inv``, updated with ``torch.linalg.matrix_exp``.

No switch decides whether the hand-written kernels run: on a CUDA tensor
``SymmetricSeparableGaussian.sample`` always launches the sampling kernel
(``ops/sampling.py``) and a ``"centered"`` ranking always launches the
ranking kernel (``ops/ranking.py``); on a CPU tensor both run their plain
versions. (The JAX package makes its two kernels opt-in on this path.) The
gradients' products are plain ``torch.matmul``.

Randomness: ``sample`` draws from the ``torch.Generator`` it is given
(searchers pass their problem's), else from the distribution's own; or
takes the standard-normal noise injected as ``eps=`` (the parity tests
feed both packages one population that way). The factored samplers draw
through the private steps ``_draw_lowrank_basis`` and
``_draw_lowrank_coeffs``, which the parity tests patch with the JAX
package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Type

import numpy as np
import torch

from ._device import resolve_device
from .ops.sampling import sample_symmetric_gaussian
from .tools.cloning import Serializable
from .tools.lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch, is_factored
from .tools.misc import to_torch_dtype
from .tools.ranking import rank
from .tools.recursiveprintable import RecursivePrintable
from .tools.tensormaker import TensorMakerMixin

__all__ = [
    "Distribution",
    "ExpGaussian",
    "ExpSeparableGaussian",
    "SeparableGaussian",
    "SymmetricSeparableGaussian",
    "make_functional_grad_estimator",
    "make_functional_sampler",
]


def _parameters_device(parameters: dict, device) -> torch.device:
    """``device``; else the device of a tensor parameter; else the default
    device, the card."""
    if device is None:
        device = next((v.device for v in parameters.values() if isinstance(v, torch.Tensor)), None)
    return resolve_device(device)


class Distribution(TensorMakerMixin, Serializable, RecursivePrintable):
    """Base class of the search distributions."""

    MANDATORY_PARAMETERS: set = set()
    OPTIONAL_PARAMETERS: set = set()
    PARAMETER_NDIMS: dict = {}
    #: antithetic distributions need an even sample count per draw
    SAMPLES_MUST_BE_EVEN: bool = False

    def __init__(
        self,
        *,
        solution_length: int,
        parameters: dict,
        dtype=None,
        device=None,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.solution_length = int(solution_length)
        self.dtype = torch.float32 if dtype is None else to_torch_dtype(dtype)
        self.device = _parameters_device(parameters, device)
        self._parameters = {}
        for k, v in parameters.items():
            if (k not in self.MANDATORY_PARAMETERS) and (k not in self.OPTIONAL_PARAMETERS):
                raise ValueError(f"{type(self).__name__} got an unrecognized parameter: {k!r}")
            if isinstance(v, (str, type(None))):
                self._parameters[k] = v
            elif k == "parenthood_ratio":
                self._parameters[k] = float(v)
            else:
                self._parameters[k] = torch.as_tensor(v, dtype=self.dtype, device=self.device)
        for k in self.MANDATORY_PARAMETERS:
            if k not in self._parameters:
                raise ValueError(f"{type(self).__name__} is missing mandatory parameter {k!r}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else int(seed))
        self.generator = generator

    def manual_seed(self, seed: int):
        self.generator.manual_seed(int(seed))

    # -- parameters ----------------------------------------------------------
    @property
    def parameters(self) -> dict:
        return self._parameters

    def modified_copy(self, *, dtype=None, **overrides) -> "Distribution":
        """A copy with some parameters replaced; it shares this one's
        generator."""
        params = dict(self._parameters)
        params.update(overrides)
        return type(self)(
            parameters=params,
            solution_length=self.solution_length,
            dtype=dtype if dtype is not None else self.dtype,
            device=self.device,
            generator=self.generator,
        )

    # -- sampling ------------------------------------------------------------
    def sample(
        self, num_solutions: int, *, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """``num_solutions`` samples drawn from ``generator`` (the
        distribution's own when None), or made from the injected
        standard-normal ``eps``."""
        return self._sample(self.generator if generator is None else generator, self._parameters, int(num_solutions), eps=eps)

    @classmethod
    def _sample(cls, generator: torch.Generator, parameters: dict, num_solutions: int, *, eps=None) -> torch.Tensor:
        raise NotImplementedError

    # -- gradients -----------------------------------------------------------
    def compute_gradients(
        self,
        samples: torch.Tensor,
        fitnesses: torch.Tensor,
        *,
        objective_sense: str,
        ranking_method: str = "raw",
    ) -> dict:
        """Rank the fitnesses, then compute this distribution's gradients."""
        if objective_sense not in ("min", "max"):
            raise ValueError(f"objective_sense must be 'min' or 'max', got {objective_sense!r}")
        weights = rank(fitnesses, ranking_method, higher_is_better=(objective_sense == "max"))
        return self._compute_gradients(self._parameters, samples, weights, ranking_method)

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples, weights, ranking_used) -> dict:
        raise NotImplementedError

    # -- updates -------------------------------------------------------------
    def _follow_gradient(
        self,
        param_name: str,
        grad: torch.Tensor,
        *,
        learning_rates: Optional[dict] = None,
        optimizers: Optional[dict] = None,
    ) -> torch.Tensor:
        """The optimizer's ``ascent`` step, or the learning-rate step."""
        if optimizers is not None and param_name in optimizers:
            return optimizers[param_name].ascent(grad)
        if learning_rates is not None and param_name in learning_rates:
            # a Python number: no host-to-device copy (it multiplies in grad's dtype)
            return float(learning_rates[param_name]) * grad
        return grad

    def update_parameters(
        self,
        gradients: dict,
        *,
        learning_rates: Optional[dict] = None,
        optimizers: Optional[dict] = None,
    ) -> "Distribution":
        raise NotImplementedError

    # -- misc ----------------------------------------------------------------
    def relative_entropy(self, other: "Distribution") -> float:
        raise NotImplementedError(f"KL divergence is not defined for {type(self).__name__}")

    def _printable_items(self):
        return {"solution_length": self.solution_length, "parameters": self._parameters}


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


def _check_mu_sigma(parameters: dict, solution_length: Optional[int]) -> int:
    mu = torch.as_tensor(parameters["mu"])
    sigma = torch.as_tensor(parameters["sigma"])
    if solution_length is None:
        solution_length = mu.shape[-1]
    elif solution_length != mu.shape[-1]:
        raise ValueError(f"solution_length={solution_length} does not match len(mu)={mu.shape[-1]}")
    if sigma.shape[-1] != mu.shape[-1]:
        raise ValueError(f"mu and sigma have mismatching lengths: {mu.shape[-1]} vs {sigma.shape[-1]}")
    return solution_length


class SeparableGaussian(Distribution):
    """Separable multivariate Gaussian: non-symmetric PGPE, and CEM when
    ``parenthood_ratio`` is given."""

    MANDATORY_PARAMETERS = {"mu", "sigma"}
    OPTIONAL_PARAMETERS = {"divide_mu_grad_by", "divide_sigma_grad_by", "parenthood_ratio"}
    PARAMETER_NDIMS = {"mu": 1, "sigma": 1}

    def __init__(
        self,
        parameters: dict,
        *,
        solution_length: Optional[int] = None,
        dtype=None,
        device=None,
        seed=None,
        generator: Optional[torch.Generator] = None,
    ):
        solution_length = _check_mu_sigma(parameters, solution_length)
        super().__init__(
            solution_length=solution_length,
            parameters=parameters,
            dtype=dtype,
            device=device,
            seed=seed,
            generator=generator,
        )

    @property
    def mu(self) -> torch.Tensor:
        return self._parameters["mu"]

    @property
    def sigma(self) -> torch.Tensor:
        return self._parameters["sigma"]

    @classmethod
    def _sample(cls, generator: torch.Generator, parameters: dict, num_solutions: int, *, eps=None) -> torch.Tensor:
        """``mu + sigma * eps``; ``eps`` (``(num_solutions, L)``) may be
        injected, else it is drawn from ``generator``."""
        mu, sigma = parameters["mu"], parameters["sigma"]
        if eps is None:
            eps = torch.randn((num_solutions, mu.shape[-1]), generator=generator, dtype=mu.dtype, device=generator.device)
        return mu + sigma * eps.to(mu.device)

    @classmethod
    def _compute_gradients_via_parenthood_ratio(cls, parameters: dict, samples, weights) -> dict:
        """CEM's elite update: the gradient is the elites' mean and stdev
        minus the current ``mu`` and ``sigma``. The elites are the top
        weights, ties to the lower index (as ``lax.top_k`` picks them)."""
        num_elites = int(samples.shape[0] * float(parameters["parenthood_ratio"]))
        elite_indices = torch.argsort(weights, descending=True, stable=True)[:num_elites]
        elites = samples.index_select(0, elite_indices)
        return {
            "mu": torch.mean(elites, dim=0) - parameters["mu"],
            "sigma": torch.std(elites, dim=0, correction=1) - parameters["sigma"],
        }

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples: torch.Tensor, weights: torch.Tensor, ranking_used) -> dict:
        if "parenthood_ratio" in parameters:
            return cls._compute_gradients_via_parenthood_ratio(parameters, samples, weights)
        mu, sigma = parameters["mu"], parameters["sigma"]
        scaled_noises = samples - mu
        weights = _zero_center_weights(weights, ranking_used)
        mu_grad = _divide_grad(parameters, "mu", weights @ scaled_noises, weights)
        sigma_grad = _divide_grad(parameters, "sigma", weights @ ((scaled_noises**2 - sigma**2) / sigma), weights)
        return {"mu": mu_grad, "sigma": sigma_grad}

    def update_parameters(self, gradients, *, learning_rates=None, optimizers=None):
        kw = dict(learning_rates=learning_rates, optimizers=optimizers)
        new_mu = self.mu + self._follow_gradient("mu", gradients["mu"], **kw)
        new_sigma = self.sigma + self._follow_gradient("sigma", gradients["sigma"], **kw)
        return self.modified_copy(mu=new_mu, sigma=new_sigma)

    def relative_entropy(self, other: "SeparableGaussian") -> float:
        """KL(self || other) of two diagonal Gaussians."""
        cov0 = self.sigma**2
        cov1 = other.sigma**2
        mu_delta = other.mu - self.mu
        trace_cov = torch.sum(cov0 / cov1)
        scaled_mu = torch.sum(mu_delta**2 / cov1)
        log_det = torch.sum(torch.log(cov1)) - torch.sum(torch.log(cov0))
        return float(0.5 * (trace_cov - self.solution_length + scaled_mu + log_det))


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
    def _compute_gradients(cls, parameters: dict, samples, weights: torch.Tensor, ranking_used) -> dict:
        if is_factored(samples):
            # both factored forms read only .basis and .coeffs
            return cls._compute_gradients_lowrank(parameters, samples, weights, ranking_used)
        if "parenthood_ratio" in parameters:
            return cls._compute_gradients_via_parenthood_ratio(parameters, samples, weights)
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

    # ---------------------------------------------- factored populations
    # theta_i = mu + (sigma * B) z_i with a shared per-generation basis B (L,
    # rank), entries N(0, 1/rank), and per-lane coefficients z_i: sampling
    # and the gradients both factor through the basis, so the dense (N, L)
    # population is never built. A perturbation's per-coordinate variance is
    # sigma^2 in expectation over the basis (for one basis it fluctuates
    # with relative stdev ~sqrt(2/rank)). The gradients are the dense
    # formulas above in factored form:
    #   mu_grad    = B_eff @ (((f+ - f-)/2) @ Z)
    #   sigma_grad = (rowquad(B_eff, Z^T diag((f+ + f-)/2) Z) - sum((f+ + f-)/2) sigma^2) / sigma

    @classmethod
    def _sample_lowrank(
        cls, generator: torch.Generator, parameters: dict, num_solutions: int, rank: int, basis=None
    ) -> LowRankParamsBatch:
        """A ``LowRankParamsBatch``: antithetic coefficient pairs interleaved
        ``[+z0, -z0, +z1, -z1, ...]`` (the dense sampler's layout), sigma
        folded into the basis. With ``basis`` (already sigma-folded) only
        fresh coefficients are drawn against it, so that the rounds of one
        generation share a basis and concatenate."""
        if num_solutions % 2 != 0:
            raise ValueError(f"Number of solutions sampled from {cls.__name__} must be even, got {num_solutions}")
        mu, sigma = parameters["mu"], parameters["sigma"]
        rank = int(rank)
        if basis is None:
            # sqrt(rank) rounded to float32 on the host (no device tensor,
            # no copy): the JAX sampler divides by the same float32 value
            basis = _draw_lowrank_basis(generator, (mu.shape[-1], rank), mu.dtype) / _float32_sqrt(rank)
            basis = sigma[..., None] * basis
        elif basis.shape[-1] != rank:
            raise ValueError(f"basis has rank {basis.shape[-1]} but rank={rank} was requested")
        z = _draw_lowrank_coeffs(generator, (num_solutions // 2, rank), mu.dtype)
        coeffs = torch.stack([z, -z], dim=1).reshape(num_solutions, rank)
        return LowRankParamsBatch(center=mu, basis=basis, coeffs=coeffs)

    def sample_lowrank(
        self, num_solutions: int, rank: int, *, generator: Optional[torch.Generator] = None, basis=None
    ) -> LowRankParamsBatch:
        """:meth:`_sample_lowrank` on this distribution's parameters, drawing
        from ``generator`` (the distribution's own when None). Its center is
        this distribution's ``mu`` tensor, and ``basis`` when given is kept
        as the same tensor, so ``SolutionBatch.cat``'s shared-basis check is
        an ``is`` check."""
        generator = self.generator if generator is None else generator
        return self._sample_lowrank(generator, self._parameters, int(num_solutions), int(rank), basis)

    @classmethod
    def _compute_gradients_lowrank(cls, parameters: dict, samples, weights: torch.Tensor, ranking_used) -> dict:
        """The symmetric gradients of a factored population in O(L * rank):
        the dense ones of ``samples.materialize()`` up to round-off."""
        sigma = parameters["sigma"]
        weights = _zero_center_weights(weights, ranking_used)
        z = samples.coeffs[0::2]  # the +z of each pair
        basis = samples.basis
        fdplus = weights[0::2]
        fdminus = weights[1::2]
        mu_grad = _divide_grad(parameters, "mu", basis @ (((fdplus - fdminus) / 2) @ z), weights)
        w_s = (fdplus + fdminus) / 2
        m = z.T @ (w_s[:, None] * z)
        rowquad = torch.sum((basis @ m) * basis, dim=-1)
        sigma_grad = _divide_grad(parameters, "sigma", (rowquad - torch.sum(w_s) * sigma**2) / sigma, weights)
        return {"mu": mu_grad, "sigma": sigma_grad}

    @classmethod
    def _sample_trunk_delta(
        cls, generator: torch.Generator, parameters: dict, num_solutions: int, rank: int, factors, basis
    ) -> TrunkDeltaParamsBatch:
        """A ``TrunkDeltaParamsBatch`` on a structured ``(factors, basis)``
        pair (``net/lowrank.py``'s ``sample_trunk_delta_factors`` draws it:
        the structure follows the policy's leaves), with
        :meth:`_sample_lowrank`'s coefficients."""
        lr = cls._sample_lowrank(generator, parameters, num_solutions, rank, basis=basis)
        return TrunkDeltaParamsBatch(center=lr.center, basis=lr.basis, coeffs=lr.coeffs, factors=factors)


def _float32_sqrt(x: int) -> float:
    """``sqrt(x)`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.sqrt(np.float32(x)))


def _draw_lowrank_basis(generator: torch.Generator, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The standard-normal ``(L, rank)`` basis draw of a factored sample
    (the parity tests patch this draw)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


def _draw_lowrank_coeffs(generator: torch.Generator, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The standard-normal ``(N/2, rank)`` coefficient draw of a factored
    sample (the parity tests patch this draw)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


class ExpSeparableGaussian(SeparableGaussian):
    """Exponential separable Gaussian, as SNES uses it."""

    OPTIONAL_PARAMETERS: set = set()

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples: torch.Tensor, weights: torch.Tensor, ranking_used) -> dict:
        if ranking_used != "nes":
            weights = weights / torch.sum(torch.abs(weights))
        mu, sigma = parameters["mu"], parameters["sigma"]
        scaled_noises = samples - mu
        raw_noises = scaled_noises / sigma
        return {"mu": weights @ scaled_noises, "sigma": weights @ (raw_noises**2 - 1)}

    def update_parameters(self, gradients, *, learning_rates=None, optimizers=None):
        kw = dict(learning_rates=learning_rates, optimizers=optimizers)
        new_mu = self.mu + self._follow_gradient("mu", gradients["mu"], **kw)
        new_sigma = self.sigma * torch.exp(0.5 * self._follow_gradient("sigma", gradients["sigma"], **kw))
        return self.modified_copy(mu=new_mu, sigma=new_sigma)


class ExpGaussian(Distribution):
    """Exponential full-covariance Gaussian, as XNES uses it. ``sigma`` is
    ``A``, the square root of the covariance; ``sigma_inv`` is tracked on its
    own for numerical stability."""

    MANDATORY_PARAMETERS = {"mu", "sigma"}
    OPTIONAL_PARAMETERS = {"sigma_inv"}
    PARAMETER_NDIMS = {"mu": 1, "sigma": 2, "sigma_inv": 2}

    def __init__(
        self,
        parameters: dict,
        *,
        solution_length: Optional[int] = None,
        dtype=None,
        device=None,
        seed=None,
        generator: Optional[torch.Generator] = None,
    ):
        parameters = dict(parameters)
        device = _parameters_device(parameters, device)
        sigma = torch.as_tensor(parameters["sigma"], device=device)
        if sigma.ndim == 1:
            sigma = torch.diag(sigma)
        parameters["sigma"] = sigma
        if "sigma_inv" not in parameters:
            parameters["sigma_inv"] = torch.linalg.inv(sigma)
        solution_length = _check_mu_sigma(parameters, solution_length)
        super().__init__(
            solution_length=solution_length,
            parameters=parameters,
            dtype=dtype,
            device=device,
            seed=seed,
            generator=generator,
        )

    @property
    def mu(self) -> torch.Tensor:
        return self._parameters["mu"]

    @property
    def sigma(self) -> torch.Tensor:
        return self._parameters["sigma"]

    @property
    def A(self) -> torch.Tensor:
        return self.sigma

    @property
    def sigma_inv(self) -> torch.Tensor:
        return self._parameters["sigma_inv"]

    @property
    def A_inv(self) -> torch.Tensor:
        return self.sigma_inv

    @property
    def cov(self) -> torch.Tensor:
        return self.sigma.T @ self.sigma

    @classmethod
    def _to_global(cls, parameters: dict, z: torch.Tensor) -> torch.Tensor:
        return parameters["mu"] + z @ parameters["sigma"].T

    @classmethod
    def _to_local(cls, parameters: dict, x: torch.Tensor) -> torch.Tensor:
        return (x - parameters["mu"]) @ parameters["sigma_inv"].T

    def to_global_coordinates(self, z: torch.Tensor) -> torch.Tensor:
        return self._to_global(self._parameters, z)

    def to_local_coordinates(self, x: torch.Tensor) -> torch.Tensor:
        return self._to_local(self._parameters, x)

    @classmethod
    def _sample(cls, generator: torch.Generator, parameters: dict, num_solutions: int, *, eps=None) -> torch.Tensor:
        mu = parameters["mu"]
        if eps is None:
            eps = torch.randn((num_solutions, mu.shape[-1]), generator=generator, dtype=mu.dtype, device=generator.device)
        return cls._to_global(parameters, eps.to(mu.device))

    @classmethod
    def _compute_gradients(cls, parameters: dict, samples: torch.Tensor, weights: torch.Tensor, ranking_used) -> dict:
        z = cls._to_local(parameters, samples)
        weights = _zero_center_weights(weights, ranking_used)
        eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
        outer = z[:, :, None] * z[:, None, :]
        return {"d": weights @ z, "M": torch.sum(weights[:, None, None] * (outer - eye), dim=0)}

    def update_parameters(self, gradients, *, learning_rates=None, optimizers=None):
        learning_rates = dict(learning_rates) if learning_rates is not None else {}
        if "d" not in learning_rates and "mu" in learning_rates:
            learning_rates["d"] = learning_rates["mu"]
        if "M" not in learning_rates and "sigma" in learning_rates:
            learning_rates["M"] = learning_rates["sigma"]
        kw = dict(learning_rates=learning_rates, optimizers=optimizers)
        update_d = self._follow_gradient("d", gradients["d"], **kw)
        update_M = self._follow_gradient("M", gradients["M"], **kw)
        new_mu = self.mu + self.A @ update_d
        new_A = self.A @ torch.linalg.matrix_exp(0.5 * update_M)
        new_A_inv = torch.linalg.matrix_exp(-0.5 * update_M) @ self.A_inv
        return self.modified_copy(mu=new_mu, sigma=new_A, sigma_inv=new_A_inv)


def _draw_sampler_noise(generator: torch.Generator, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The standard-normal noise of a functional sampler, one tensor for
    every lane (the parity tests patch this draw)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


def _split_batched(param_ndims: dict, parameters: dict):
    """-> (batch shape, tensor parameters, the others)."""
    arrays = {k: torch.as_tensor(v) for k, v in parameters.items() if k in param_ndims and not isinstance(v, str)}
    others = {k: v for k, v in parameters.items() if k not in arrays}
    batch_shape = ()
    for k, v in arrays.items():
        batch_shape = torch.broadcast_shapes(batch_shape, v.shape[: v.ndim - param_ndims[k]])
    return tuple(batch_shape), arrays, others


def _lanes(param_ndims: dict, arrays: dict, batch_shape: tuple) -> dict:
    """Each tensor parameter broadcast to the batch and flattened to
    ``(lanes, *core)``."""
    out = {}
    for k, v in arrays.items():
        core = tuple(v.shape[v.ndim - param_ndims[k] :])
        out[k] = v.expand(batch_shape + core).reshape((-1,) + core)
    return out


def _functional_sample_core(distribution_class, parameters: dict, num_solutions: int, eps: torch.Tensor) -> torch.Tensor:
    """Samples made from the injected noise ``eps`` (``(*batch, rows, L)``,
    ``rows`` being ``num_solutions``, or half of it for the antithetic
    class). Lanes are taken one by one: the antithetic class's sampling
    kernel takes one lane per launch."""
    batch_shape, arrays, others = _split_batched(distribution_class.PARAMETER_NDIMS, parameters)
    if batch_shape == ():
        return distribution_class._sample(None, {**arrays, **others}, num_solutions, eps=eps)
    lanes = _lanes(distribution_class.PARAMETER_NDIMS, arrays, batch_shape)
    flat_eps = eps.expand(batch_shape + tuple(eps.shape[-2:])).reshape((-1,) + tuple(eps.shape[-2:]))
    out = torch.stack(
        [
            distribution_class._sample(None, {**{k: v[i] for k, v in lanes.items()}, **others}, num_solutions, eps=flat_eps[i])
            for i in range(flat_eps.shape[0])
        ]
    )
    return out.reshape(batch_shape + tuple(out.shape[1:]))


def make_functional_sampler(distribution_class: Type[Distribution]) -> Callable:
    """A stateless sampler ``f(generator, num_solutions, parameters) ->
    samples``. Extra leading dimensions on the parameter tensors give a
    batch of populations, each from its own part of one noise draw."""

    def sampler(generator: torch.Generator, num_solutions: int, parameters: dict) -> torch.Tensor:
        num_solutions = int(num_solutions)
        batch_shape, arrays, _ = _split_batched(distribution_class.PARAMETER_NDIMS, parameters)
        mu = arrays["mu"]
        rows = num_solutions // 2 if distribution_class.SAMPLES_MUST_BE_EVEN else num_solutions
        if distribution_class.SAMPLES_MUST_BE_EVEN and num_solutions % 2 != 0:
            raise ValueError(f"Number of solutions sampled from {distribution_class.__name__} must be even, got {num_solutions}")
        eps = _draw_sampler_noise(generator, batch_shape + (rows, mu.shape[-1]), mu.dtype)
        return _functional_sample_core(distribution_class, parameters, num_solutions, eps)

    sampler.__name__ = f"functional_sampler_of_{distribution_class.__name__}"
    return sampler


def make_functional_grad_estimator(
    distribution_class: Type[Distribution],
    *,
    function: Optional[Callable] = None,
    objective_sense: str,
    ranking_method: str = "raw",
    return_samples: bool = False,
    return_fitnesses: bool = False,
) -> Callable:
    """A stateless gradient estimator.

    Without ``function``: ``g(samples, fitnesses, parameters) -> grads``.
    With a fitness ``function``: ``g(generator, num_solutions, parameters,
    *fn_args, **fn_kwargs) -> grads`` samples, evaluates and estimates, and
    appends the samples and fitnesses when ``return_samples`` /
    ``return_fitnesses`` ask for them.

    Extra leading dimensions on the parameters, samples or fitnesses are
    batch dimensions: the fitnesses are ranked along their last axis in
    one call (on the card, one launch of the ranking kernel for all lanes),
    then the gradients of every lane come from one ``torch.func.vmap``."""
    higher_is_better = {"max": True, "min": False}[objective_sense]
    sampler = make_functional_sampler(distribution_class)
    param_ndims = distribution_class.PARAMETER_NDIMS

    def _estimate(parameters: dict, samples: torch.Tensor, fitnesses: torch.Tensor) -> dict:
        batch_shape, arrays, others = _split_batched(param_ndims, parameters)
        batch_shape = tuple(torch.broadcast_shapes(batch_shape, fitnesses.shape[:-1]))
        weights = rank(fitnesses, ranking_method, higher_is_better=higher_is_better)
        if batch_shape == ():
            return distribution_class._compute_gradients({**arrays, **others}, samples, weights, ranking_method)
        lanes = _lanes(param_ndims, arrays, batch_shape)
        samples = samples.expand(batch_shape + tuple(samples.shape[-2:])).reshape((-1,) + tuple(samples.shape[-2:]))
        weights = weights.expand(batch_shape + tuple(weights.shape[-1:])).reshape((-1,) + tuple(weights.shape[-1:]))

        def one(params, s, w):
            return distribution_class._compute_gradients({**params, **others}, s, w, ranking_method)

        out = torch.func.vmap(one)(lanes, samples, weights)
        return {k: v.reshape(batch_shape + tuple(v.shape[1:])) for k, v in out.items()}

    if function is None:

        def estimator(samples: torch.Tensor, fitnesses: torch.Tensor, parameters: dict) -> dict:
            return _estimate(parameters, samples, fitnesses)

    else:

        def estimator(generator: torch.Generator, num_solutions: int, parameters: dict, *fn_args, **fn_kwargs):
            samples = sampler(generator, num_solutions, parameters)
            fitnesses = function(samples, *fn_args, **fn_kwargs)
            grads = _estimate(parameters, samples, fitnesses)
            extras = ([samples] if return_samples else []) + ([fitnesses] if return_fitnesses else [])
            return (grads, *extras) if extras else grads

    estimator.__name__ = f"functional_grad_estimator_of_{distribution_class.__name__}"
    return estimator


def _make_class_functional_sample(cls):
    def functional_sample(num_solutions: int, parameters: dict, *, generator: torch.Generator):
        """Samples from ``make_functional_sampler``: batched parameters give
        a batch of populations."""
        return make_functional_sampler(cls)(generator, int(num_solutions), parameters)

    return functional_sample


for _cls in (SeparableGaussian, SymmetricSeparableGaussian, ExpSeparableGaussian, ExpGaussian):
    _cls.functional_sample = staticmethod(_make_class_functional_sample(_cls))
del _cls
