"""Distribution-based searchers: the shared Gaussian engine and PGPE, SNES,
CEM and XNES (counterpart of ``evotorch_tpu/algorithms/gaussian.py``).

A step keeps every per-generation scalar on the device: ``mean_eval``,
``center_update_norm`` and the ClipUp velocity norm are tensors until their
status key is read, so a generation that nobody logs makes no host sync of
its own. The adaptive-popsize loop (``num_interactions``) reads the
problem's interaction counter once per round, as in the JAX package.

``lowrank_rank`` (symmetric PGPE only) samples factored populations
(``tools/lowrank.py``): the first round of a generation draws the basis and
later rounds reuse it, so they concatenate. Its guardrail, the share of the
accumulated gradient direction the generation's basis captures
(``basis_capture``), is enqueued as a device scalar and read one generation
later (one host read a generation); it warns once after three generations
under 0.1.

``distributed=True`` steps through ``problem.sample_and_compute_gradients``
(the reference's distributed mode): the problem samples, evaluates and
estimates, over the ranks of a process group when it has a sharded
evaluator (``num_actors``), and the step averages the gradient dicts it
returns (weighted by their populations unless
``popsize_weighted_grad_avg=False``) before the update. No population is
kept between generations in that mode.
"""

from __future__ import annotations

import math
import warnings
from copy import deepcopy
from typing import Optional

import torch

from ..core import Problem, SolutionBatch
from ..observability.tracer import span
from ..distributions import (
    Distribution,
    ExpGaussian,
    ExpSeparableGaussian,
    SeparableGaussian,
    SymmetricSeparableGaussian,
)
from ..optimizers import get_optimizer_class
from ..tools.lowrank import basis_capture
from ..tools.misc import modify_tensor, to_stdev_init
from .searchalgorithm import SearchAlgorithm, SinglePopulationAlgorithmMixin

__all__ = ["GaussianSearchAlgorithm", "PGPE", "SNES", "CEM", "XNES"]


def _scalar_or_none(x) -> Optional[float]:
    return None if x is None else float(x)


class GaussianSearchAlgorithm(SearchAlgorithm, SinglePopulationAlgorithmMixin):
    """The shared engine of PGPE, SNES, CEM and XNES."""

    DISTRIBUTION_TYPE = NotImplemented
    DISTRIBUTION_PARAMS: Optional[dict] = None

    def __init__(
        self,
        problem: Problem,
        *,
        popsize: int,
        center_learning_rate: float,
        stdev_learning_rate: float,
        stdev_init=None,
        radius_init=None,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        optimizer=None,
        optimizer_config: Optional[dict] = None,
        ranking_method: Optional[str] = None,
        center_init=None,
        stdev_min=None,
        stdev_max=None,
        stdev_max_change=None,
        obj_index: Optional[int] = None,
        distributed: bool = False,
        popsize_weighted_grad_avg: Optional[bool] = None,
        ensure_even_popsize: bool = False,
        lowrank_rank: Optional[int] = None,
    ):
        if not distributed and popsize_weighted_grad_avg is not None:
            raise ValueError("popsize_weighted_grad_avg is only meaningful in distributed mode")
        problem.ensure_numeric()
        problem.ensure_unbounded()

        SearchAlgorithm.__init__(
            self,
            problem,
            center=self._get_mu,
            stdev=self._get_sigma,
            mean_eval=self._get_mean_eval,
        )

        if ensure_even_popsize and popsize % 2 != 0:
            raise ValueError(f"popsize must be even, got {popsize}")
        if not distributed and num_interactions is not None:
            self.add_status_getters({"popsize": self._get_popsize})

        if center_init is None:
            mu = problem.generate_values(1).reshape(-1)
        else:
            mu = problem.ensure_tensor_length_and_dtype(center_init, allow_scalar=False, about="center_init")
        stdev_init = to_stdev_init(solution_length=problem.solution_length, stdev_init=stdev_init, radius_init=radius_init)
        sigma = problem.ensure_tensor_length_and_dtype(stdev_init, about="stdev_init")

        dist_params = deepcopy(self.DISTRIBUTION_PARAMS) if self.DISTRIBUTION_PARAMS is not None else {}
        dist_params.update({"mu": mu, "sigma": sigma})
        self._distribution: Distribution = self.DISTRIBUTION_TYPE(dist_params, dtype=problem.dtype, device=problem.device)

        # factored populations (see the module note)
        self._lowrank_rank = None if lowrank_rank is None else int(lowrank_rank)
        if self._lowrank_rank is not None:
            if self._lowrank_rank < 1:
                raise ValueError(f"lowrank_rank must be >= 1, got {lowrank_rank}")
            if not hasattr(self.DISTRIBUTION_TYPE, "_sample_lowrank"):
                raise ValueError(
                    f"{self.DISTRIBUTION_TYPE.__name__} has no factored sampler; lowrank_rank requires symmetric PGPE"
                    " (SymmetricSeparableGaussian)"
                )
            self._basis_capture_dev: Optional[torch.Tensor] = None
            self._grad_direction_ema: Optional[torch.Tensor] = None
            self._low_capture_streak = 0
            self._capture_warned = False
            self.add_status_getters({"basis_capture": self._get_basis_capture})

        self._popsize = int(popsize)
        self._popsize_max = None if popsize_max is None else int(popsize_max)
        self._num_interactions = None if num_interactions is None else int(num_interactions)
        self._center_learning_rate = float(center_learning_rate)
        self._stdev_learning_rate = float(stdev_learning_rate)
        self._optimizer = self._initialize_optimizer(self._center_learning_rate, optimizer, optimizer_config)
        self._ranking_method = None if ranking_method is None else str(ranking_method)

        # device scalars, read on status access (see the module note)
        self._center_update_norm_dev = None
        self.add_status_getters(
            {
                "stdev_norm": self._get_stdev_norm,
                "center_update_norm": self._get_center_update_norm,
                "clipup_velocity_norm": self._get_clipup_velocity_norm,
            }
        )

        ensure = problem.ensure_tensor_length_and_dtype
        self._stdev_min = None if stdev_min is None else ensure(stdev_min, about="stdev_min")
        self._stdev_max = None if stdev_max is None else ensure(stdev_max, about="stdev_max")
        self._stdev_max_change = None if stdev_max_change is None else ensure(stdev_max_change, about="stdev_max_change")

        self._obj_index = problem.normalize_obj_index(obj_index)
        self._mean_eval: Optional[torch.Tensor] = None
        self._population: Optional[SolutionBatch] = None
        self._first_iter = True

        self._distributed = bool(distributed)
        self._popsize_weighted_grad_avg = (
            num_interactions is None if popsize_weighted_grad_avg is None else bool(popsize_weighted_grad_avg)
        )
        SinglePopulationAlgorithmMixin.__init__(self, exclude={"mean_eval"}, enable=not distributed)

    # ------------------------------------------------------------ properties
    @property
    def population(self) -> SolutionBatch:
        if self._population is None:
            raise RuntimeError("The population is not ready yet; take a step first")
        return self._population

    @property
    def distribution(self) -> Distribution:
        return self._distribution

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def obj_index(self) -> int:
        return self._obj_index

    def _get_mu(self):
        return self._distribution.parameters["mu"]

    def _get_sigma(self):
        return self._distribution.parameters["sigma"]

    def _get_mean_eval(self):
        return _scalar_or_none(self._mean_eval)

    def _get_stdev_norm(self):
        return float(torch.linalg.vector_norm(self._distribution.parameters["sigma"]))

    def _get_center_update_norm(self):
        return _scalar_or_none(self._center_update_norm_dev)

    def _get_clipup_velocity_norm(self):
        velocity = getattr(self._optimizer, "_velocity", None)
        return None if velocity is None else float(torch.linalg.vector_norm(velocity))

    def _get_popsize(self):
        return 0 if self._population is None else len(self._population)

    def _get_basis_capture(self):
        return _scalar_or_none(self._basis_capture_dev)

    # -------------------------------------------------------------- plumbing
    def _initialize_optimizer(self, learning_rate, optimizer, optimizer_config):
        if optimizer is None:
            return None
        if isinstance(optimizer, str):
            cls = get_optimizer_class(optimizer, optimizer_config)
            return cls(
                stepsize=float(learning_rate),
                dtype=self._distribution.dtype,
                solution_length=self._distribution.solution_length,
                device=self._distribution.device,
            )
        return optimizer

    def _sample_population(self, popsize: int, *, basis=None) -> SolutionBatch:
        """A fresh population; with ``lowrank_rank`` a factored one, against
        ``basis`` when given."""
        if self._lowrank_rank is not None:
            samples = self._distribution.sample_lowrank(
                popsize, self._lowrank_rank, generator=self._problem.generator, basis=basis
            )
            return SolutionBatch(self._problem, values=samples)
        samples = self._distribution.sample(popsize, generator=self._problem.generator)
        return SolutionBatch(self._problem, samples.shape[0], values=samples)

    def _fill_and_eval_pop(self):
        """Sample and evaluate; with ``num_interactions``, keep sampling
        rounds of ``popsize`` until the problem reports more interactions
        than that (or ``popsize_max`` solutions). Factored rounds after the
        first reuse its basis, so they concatenate."""
        problem = self._problem
        if self._num_interactions is None:
            with span("ask", "algo"):
                self._population = self._sample_population(self._popsize)
            problem.evaluate(self._population)
            return
        first_count = int(problem.status.get("total_interaction_count", 0))
        batches = []
        total_popsize = 0
        prev_made = -1
        gen_basis = None
        while True:
            with span("ask", "algo"):
                batch = self._sample_population(self._popsize, basis=gen_basis)
            if self._lowrank_rank is not None and gen_basis is None:
                gen_basis = batch.values.basis
            problem.evaluate(batch)
            batches.append(batch)
            total_popsize += len(batch)
            if self._popsize_max is not None and total_popsize >= self._popsize_max:
                break
            interactions_made = int(problem.status.get("total_interaction_count", 0)) - first_count
            if interactions_made > self._num_interactions:
                break
            if "total_interaction_count" not in problem.status:
                break  # the problem does not report interactions
            if interactions_made <= prev_made:
                break  # the counter stopped advancing: the budget is unreachable
            prev_made = interactions_made
        self._population = batches[0] if len(batches) == 1 else SolutionBatch.cat(batches)

    def _step(self):
        """From the second generation on: gradients from the previous
        population, a distribution update, then a new population sampled
        and evaluated. The first generation only samples and evaluates.
        Distributed: the problem's gradient dicts, averaged, then the
        update."""
        if self._distributed:
            self._step_distributed()
            return
        if self._first_iter:
            self._first_iter = False
            self._fill_and_eval_pop()
            self._mean_eval = torch.nanmean(self._population.evals[:, self._obj_index])
            return
        pop = self._population
        with span("tell", "algo"):
            grads = self._distribution.compute_gradients(
                pop.values,
                pop.evals[:, self._obj_index],
                objective_sense=self._problem.senses[self._obj_index],
                ranking_method=self._ranking_method if self._ranking_method is not None else "raw",
            )
            if self._lowrank_rank is not None:
                # measured against the basis the gradient was estimated in,
                # before that gradient enters the direction average
                self._update_basis_capture(pop.values.basis, grads["mu"])
            self._update_distribution(grads)
        # the old population is let go before the new one is sampled
        del pop, grads
        self._population = None
        self._fill_and_eval_pop()
        self._mean_eval = torch.nanmean(self._population.evals[:, self._obj_index])

    def _step_distributed(self):
        with span("sample_and_grad", "algo"):
            results = self._problem.sample_and_compute_gradients(
                self._distribution,
                self._popsize,
                popsize_max=self._popsize_max,
                num_interactions=self._num_interactions,
                ranking_method=self._ranking_method if self._ranking_method is not None else "raw",
                obj_index=self._obj_index,
                lowrank_rank=self._lowrank_rank,
            )
        nums = [float(r["num_solutions"]) for r in results]
        rel = [x / sum(nums) for x in nums]
        weights = rel if self._popsize_weighted_grad_avg else [1.0 / len(results)] * len(results)
        avg = {k: sum(w * r["gradients"][k] for w, r in zip(weights, results)) for k in results[0]["gradients"]}
        # a device scalar until the status is read
        self._mean_eval = sum(w * r["mean_eval"] for w, r in zip(rel, results))
        with span("tell", "algo"):
            if self._lowrank_rank is not None and results[0].get("basis") is not None:
                self._update_basis_capture(results[0]["basis"], avg["mu"])
            self._update_distribution(avg)

    # capture under this for _CAPTURE_WARN_STREAK generations in a row warns
    # of subspace exhaustion (the JAX package's constants)
    _CAPTURE_WARN_THRESHOLD = 0.1
    _CAPTURE_WARN_STREAK = 3

    def _update_basis_capture(self, basis: torch.Tensor, mu_grad: torch.Tensor):
        """Enqueue the share of the accumulated gradient direction (an
        average over many bases, a proxy for the dense gradient) that this
        generation's basis spans, as a device scalar, and read the previous
        generation's, whose work has long finished: the streak and the
        warning lag one generation, and the step makes one host read."""
        prev = self._basis_capture_dev
        if prev is not None:
            capture = float(prev)
            self._low_capture_streak = self._low_capture_streak + 1 if capture < self._CAPTURE_WARN_THRESHOLD else 0
            if self._low_capture_streak >= self._CAPTURE_WARN_STREAK and not self._capture_warned:
                self._capture_warned = True
                L = int(self._distribution.solution_length)
                warnings.warn(
                    f"factored (low-rank) search subspace exhaustion: the rank-{self._lowrank_rank} basis captures"
                    f" only {capture:.1%} of the estimated dense gradient direction over {self._low_capture_streak}"
                    f" consecutive generations (random-basis expectation at L={L}:"
                    f" ~{math.sqrt(self._lowrank_rank / max(L, 1)):.1%}). Most of the gradient signal is not"
                    " expressible in the subspace and progress is likely to stall; consider increasing lowrank_rank"
                    " (status key: basis_capture).",
                    stacklevel=3,
                )
        if self._grad_direction_ema is not None:
            self._basis_capture_dev = basis_capture(basis, self._grad_direction_ema)
        direction = mu_grad / torch.clamp(torch.linalg.vector_norm(mu_grad), min=1e-30)
        if self._grad_direction_ema is None:
            self._grad_direction_ema = direction
        else:
            self._grad_direction_ema = 0.8 * self._grad_direction_ema + 0.2 * direction

    # --------------------------------------------------------------- updates
    def _update_distribution(self, gradients: dict):
        """The distribution update, then the stdev clamps (``stdev_min``,
        ``stdev_max``, ``stdev_max_change``)."""
        learning_rates = {"mu": self._center_learning_rate, "sigma": self._stdev_learning_rate}
        optimizers = {"mu": self._optimizer} if self._optimizer is not None else None
        old_sigma = self._distribution.parameters["sigma"]
        old_mu = self._distribution.parameters["mu"]
        new_dist = self._distribution.update_parameters(gradients, learning_rates=learning_rates, optimizers=optimizers)
        self._center_update_norm_dev = torch.linalg.vector_norm(new_dist.parameters["mu"] - old_mu)
        if self._stdev_min is not None or self._stdev_max is not None or self._stdev_max_change is not None:
            clamped = modify_tensor(
                old_sigma,
                new_dist.parameters["sigma"],
                lb=self._stdev_min,
                ub=self._stdev_max,
                max_change=self._stdev_max_change,
            )
            new_dist = new_dist.modified_copy(sigma=clamped)
        self._distribution = new_dist


class PGPE(GaussianSearchAlgorithm):
    """PGPE with 0-centered ranking and ClipUp, the configuration of Toklu
    et al. (2020)."""

    DISTRIBUTION_TYPE = NotImplemented  # set per instance (symmetric or not)
    DISTRIBUTION_PARAMS = NotImplemented

    def __init__(
        self,
        problem: Problem,
        *,
        popsize: int,
        center_learning_rate: float,
        stdev_learning_rate: float,
        stdev_init=None,
        radius_init=None,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        optimizer="clipup",
        optimizer_config: Optional[dict] = None,
        ranking_method: Optional[str] = "centered",
        center_init=None,
        stdev_min=None,
        stdev_max=None,
        stdev_max_change=0.2,
        symmetric: bool = True,
        obj_index: Optional[int] = None,
        distributed: bool = False,
        popsize_weighted_grad_avg: Optional[bool] = None,
        lowrank_rank: Optional[int] = None,
    ):
        if lowrank_rank is not None and not symmetric:
            raise ValueError("lowrank_rank requires symmetric=True (the PGPE default)")
        if symmetric:
            self.DISTRIBUTION_TYPE = SymmetricSeparableGaussian
            divide_by = "num_directions"
        else:
            self.DISTRIBUTION_TYPE = SeparableGaussian
            divide_by = "num_solutions"
        self.DISTRIBUTION_PARAMS = {"divide_mu_grad_by": divide_by, "divide_sigma_grad_by": divide_by}
        super().__init__(
            problem,
            popsize=popsize,
            center_learning_rate=center_learning_rate,
            stdev_learning_rate=stdev_learning_rate,
            stdev_init=stdev_init,
            radius_init=radius_init,
            popsize_max=popsize_max,
            num_interactions=num_interactions,
            optimizer=optimizer,
            optimizer_config=optimizer_config,
            ranking_method=ranking_method,
            center_init=center_init,
            stdev_min=stdev_min,
            stdev_max=stdev_max,
            stdev_max_change=stdev_max_change,
            obj_index=obj_index,
            distributed=distributed,
            popsize_weighted_grad_avg=popsize_weighted_grad_avg,
            ensure_even_popsize=symmetric,
            lowrank_rank=lowrank_rank,
        )


def _nes_defaults(problem: Problem, popsize, center_learning_rate, stdev_learning_rate, scale_learning_rate, stdev_lr_of):
    """The NES defaults: popsize ``4 + floor(3 ln n)``, center learning rate
    1, and the stdev learning rate ``stdev_lr_of(n)`` (a factor on it when
    ``scale_learning_rate``)."""
    n = problem.solution_length
    if popsize is None:
        popsize = int(4 + math.floor(3 * math.log(n)))
    if center_learning_rate is None:
        center_learning_rate = 1.0
    if stdev_learning_rate is None:
        stdev_learning_rate = stdev_lr_of(n)
    else:
        stdev_learning_rate = float(stdev_learning_rate)
        if scale_learning_rate:
            stdev_learning_rate *= stdev_lr_of(n)
    return popsize, center_learning_rate, stdev_learning_rate


class SNES(GaussianSearchAlgorithm):
    """Separable NES (Schaul et al. 2011)."""

    DISTRIBUTION_TYPE = ExpSeparableGaussian
    DISTRIBUTION_PARAMS = None

    def __init__(
        self,
        problem: Problem,
        *,
        stdev_init=None,
        radius_init=None,
        popsize: Optional[int] = None,
        center_learning_rate: Optional[float] = None,
        stdev_learning_rate: Optional[float] = None,
        scale_learning_rate: bool = True,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        optimizer=None,
        optimizer_config: Optional[dict] = None,
        ranking_method: Optional[str] = "nes",
        center_init=None,
        stdev_min=None,
        stdev_max=None,
        stdev_max_change=None,
        obj_index: Optional[int] = None,
        distributed: bool = False,
        popsize_weighted_grad_avg: Optional[bool] = None,
    ):
        popsize, center_learning_rate, stdev_learning_rate = _nes_defaults(
            problem,
            popsize,
            center_learning_rate,
            stdev_learning_rate,
            scale_learning_rate,
            lambda n: 0.2 * (3 + math.log(n)) / math.sqrt(n),
        )
        super().__init__(
            problem,
            popsize=popsize,
            center_learning_rate=center_learning_rate,
            stdev_learning_rate=stdev_learning_rate,
            stdev_init=stdev_init,
            radius_init=radius_init,
            popsize_max=popsize_max,
            num_interactions=num_interactions,
            optimizer=optimizer,
            optimizer_config=optimizer_config,
            ranking_method=ranking_method,
            center_init=center_init,
            stdev_min=stdev_min,
            stdev_max=stdev_max,
            stdev_max_change=stdev_max_change,
            obj_index=obj_index,
            distributed=distributed,
            popsize_weighted_grad_avg=popsize_weighted_grad_avg,
        )


class CEM(GaussianSearchAlgorithm):
    """The cross-entropy method, the variant of Duan et al. (2016)."""

    DISTRIBUTION_TYPE = SeparableGaussian
    DISTRIBUTION_PARAMS = NotImplemented  # set per instance

    def __init__(
        self,
        problem: Problem,
        *,
        popsize: int,
        parenthood_ratio: float,
        stdev_init=None,
        radius_init=None,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        center_init=None,
        stdev_min=None,
        stdev_max=None,
        stdev_max_change=None,
        obj_index: Optional[int] = None,
        distributed: bool = False,
        popsize_weighted_grad_avg: Optional[bool] = None,
    ):
        self.DISTRIBUTION_PARAMS = {"parenthood_ratio": float(parenthood_ratio)}
        super().__init__(
            problem,
            popsize=popsize,
            center_learning_rate=1.0,
            stdev_learning_rate=1.0,
            stdev_init=stdev_init,
            radius_init=radius_init,
            popsize_max=popsize_max,
            num_interactions=num_interactions,
            optimizer=None,
            optimizer_config=None,
            ranking_method=None,
            center_init=center_init,
            stdev_min=stdev_min,
            stdev_max=stdev_max,
            stdev_max_change=stdev_max_change,
            obj_index=obj_index,
            distributed=distributed,
            popsize_weighted_grad_avg=popsize_weighted_grad_avg,
        )


class XNES(GaussianSearchAlgorithm):
    """Exponential NES with full covariance (Glasmachers et al. 2010)."""

    DISTRIBUTION_TYPE = ExpGaussian
    DISTRIBUTION_PARAMS = None

    def __init__(
        self,
        problem: Problem,
        *,
        stdev_init=None,
        radius_init=None,
        popsize: Optional[int] = None,
        center_learning_rate: Optional[float] = None,
        stdev_learning_rate: Optional[float] = None,
        scale_learning_rate: bool = True,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        optimizer=None,
        optimizer_config: Optional[dict] = None,
        ranking_method: Optional[str] = "nes",
        center_init=None,
        obj_index: Optional[int] = None,
        distributed: bool = False,
        popsize_weighted_grad_avg: Optional[bool] = None,
    ):
        popsize, center_learning_rate, stdev_learning_rate = _nes_defaults(
            problem,
            popsize,
            center_learning_rate,
            stdev_learning_rate,
            scale_learning_rate,
            lambda n: 0.6 * (3 + math.log(n)) / (n * math.sqrt(n)),
        )
        super().__init__(
            problem,
            popsize=popsize,
            center_learning_rate=center_learning_rate,
            stdev_learning_rate=stdev_learning_rate,
            stdev_init=stdev_init,
            radius_init=radius_init,
            popsize_max=popsize_max,
            num_interactions=num_interactions,
            optimizer=optimizer,
            optimizer_config=optimizer_config,
            ranking_method=ranking_method,
            center_init=center_init,
            obj_index=obj_index,
            distributed=distributed,
            popsize_weighted_grad_avg=popsize_weighted_grad_avg,
        )
