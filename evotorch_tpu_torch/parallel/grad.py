"""Sharded ES-gradient estimation (counterpart of
``evotorch_tpu/parallel/grad.py``).

Default (the JAX package's GSPMD form): every rank samples the whole
population from a generator seeded alike, evaluates its block of rows,
gathers the fitnesses, ranks them globally and computes the gradients, so
the estimate is the one-rank estimate at any world size and any popsize
(the reference's single-process semantics).

``use_shard_map=True`` / ``EVOTORCH_SHARD_MAP=1`` keeps the reference's
distributed-mode semantics: each rank samples its own sub-population from a
generator of its own, ranks it locally, computes local gradients, and the
gradients are averaged over the ranks. Local ranking is a semantic, not a
layout: rank weights depend on the cohort.
"""

from __future__ import annotations

from typing import Callable, Optional, Type

import torch

from ..neuroevolution.net.vecrl import _params_popsize
from ..tools.lowrank import dense_values
from ..tools.ranking import rank
from .evaluate import _block, _use_shard_map
from .mesh import Mesh, default_mesh

__all__ = ["make_sharded_grad_estimator"]


def _rank_generator(generator: torch.Generator, mesh: Mesh) -> torch.Generator:
    """A generator of this rank's own, for the per-rank form: seeded by the
    rank's entry of one draw of seeds from the common generator (one host
    read), so every call of every rank draws afresh and no two ranks
    alike."""
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=generator, device=generator.device, dtype=torch.int64)
    return torch.Generator(device=generator.device).manual_seed(int(seeds[mesh.rank]))


def _spread_gradients(mesh: Mesh, grads, mean_eval, distribution_class, parameters: dict, samples, ranking_method):
    """A mesh over the first ranks: its gradients on every rank. The
    placeholders are the gradients of zero weights (the same keys, shapes
    and dtypes); a member's own must match them."""
    like = next(iter(parameters.values()))
    weights = torch.zeros((_params_popsize(samples),), dtype=like.dtype, device=like.device)
    template = distribution_class._compute_gradients(parameters, samples, weights, ranking_method)
    placeholder_mean = torch.zeros((), dtype=like.dtype, device=like.device)
    keys = sorted(template)
    if mesh.member:
        for k in keys:
            if grads[k].shape != template[k].shape or grads[k].dtype != template[k].dtype:
                raise TypeError(
                    f"gradient {k!r} is {grads[k].dtype} {tuple(grads[k].shape)}; the spread expects {template[k].dtype}"
                )
        mean_eval = mean_eval.to(like.dtype)
    sent = [grads[k] for k in keys] + [mean_eval] if mesh.member else [template[k] for k in keys] + [placeholder_mean]
    spread = mesh.spread(sent)
    return dict(zip(keys, spread[:-1])), spread[-1]


def make_sharded_grad_estimator(
    distribution_class: Type,
    fitness_func: Callable,
    *,
    objective_sense: str,
    ranking_method: str = "centered",
    mesh: Optional[Mesh] = None,
    with_aux: bool = False,
    lowrank_rank: Optional[int] = None,
    use_shard_map: Optional[bool] = None,
) -> Callable:
    """Build ``g(generator, num_solutions, parameters) -> grads``, the
    sample/evaluate/rank/grad pipeline run over ``mesh``'s ranks (the
    default: every rank of the default group), with the same gradient dict
    returned on every rank.

    Default: any ``num_solutions``, global ranking. Under ``use_shard_map``
    ``num_solutions`` must divide over the ranks (and the local size be
    even for a symmetric distribution).

    ``with_aux=True`` returns ``(grads, aux)``: ``aux["mean_eval"]`` is the
    population's mean fitness and, with ``lowrank_rank``, ``aux["basis"]``
    the basis of the generation (this rank's, under ``use_shard_map``).
    With ``lowrank_rank`` the population is sampled in factored form and
    its gradients come from the factors; only the fitness evaluation
    densifies the evaluated rows."""
    mesh = default_mesh() if mesh is None else mesh
    higher_is_better = {"max": True, "min": False}[objective_sense]
    local_form = _use_shard_map(use_shard_map)

    def sample(generator, parameters, n):
        if lowrank_rank is not None:
            return distribution_class._sample_lowrank(generator, parameters, n, int(lowrank_rank))
        return distribution_class._sample(generator, parameters, n)

    def estimator(generator: torch.Generator, num_solutions: int, parameters: dict):
        n = int(num_solutions)
        if local_form:
            if n % mesh.size != 0:
                raise ValueError(f"num_solutions={n} must be divisible by the mesh's {mesh.size} ranks")
            samples = sample(_rank_generator(generator, mesh), parameters, n // mesh.size)
        else:
            samples = sample(generator, parameters, n)
        if mesh.member:
            if local_form:
                fitnesses = fitness_func(dense_values(samples))
                weights = rank(fitnesses, ranking_method, higher_is_better=higher_is_better)
                local = distribution_class._compute_gradients(parameters, samples, weights, ranking_method)
                grads = {k: mesh.all_sum(v) / mesh.size for k, v in local.items()}
                mean_eval = mesh.all_sum(torch.mean(fitnesses)) / mesh.size
            else:
                rows, _, per = _block(samples, mesh)
                fitnesses = mesh.gather_rows(fitness_func(dense_values(rows)), per * mesh.size, mesh.rank * per)[:n]
                weights = rank(fitnesses, ranking_method, higher_is_better=higher_is_better)
                grads = distribution_class._compute_gradients(parameters, samples, weights, ranking_method)
                mean_eval = torch.mean(fitnesses)
        if mesh.partial:
            if not mesh.member:
                grads = mean_eval = None
            grads, mean_eval = _spread_gradients(
                mesh, grads, mean_eval, distribution_class, parameters, samples, ranking_method
            )
        if not with_aux:
            return grads
        aux = {"mean_eval": mean_eval}
        if lowrank_rank is not None:
            aux["basis"] = samples.basis
        return grads, aux

    return estimator
