"""Pure-functional variation operators and Pareto utilities (counterpart of
``evotorch_tpu/operators/functional.py``).

**Randomness.** A function that draws takes a ``torch.Generator`` where the
JAX package takes a PRNG key. Each one is split into a private draw step
(``_draw_*``: one tensor of shape ``(*batch, ...)`` from the generator, so
that batched inputs get independent noise per lane) and a deterministic
core that takes the draws as tensors (``_*_core``). The parity tests call
the cores with the JAX package's draws, or patch the draw steps.

**Batching.** Extra leading dimensions on the arrays are batch dimensions,
as in the JAX package. The cores broadcast over them; the Pareto functions,
whose front peeling reads the host once per front, take lanes one by one.

**Ties.** The JAX package breaks ties by the lower index (a stable argsort,
``lax.top_k``, ``argmax``); so do ``torch.argsort(..., stable=True)`` and
``torch.argmax``. ``torch.topk`` is not used: its tie order on CUDA is not
specified.

**Pareto ranks** peel fronts by domination counts (the fast non-dominated
sort): the ``(N, N)`` domination matrix is built once (one compare pass
per objective), each solution's count of dominators is its column sum, and
each front subtracts the column sums of its own rows. Every row is read
once in total, where the JAX package's ``lax.while_loop`` rereads the whole
matrix per front; the price is one host read per front (its indices, which
also end the loop). At N = 20,000 the matrix takes 400 MB.

**Kernels.** Single-objective tournaments and CoSyNE's rank-biased
permutation rank with ``"centered"`` (``"linear"`` is centered + 0.5),
which on a CUDA tensor launches the centered-rank kernel
(``ops/ranking.py``). Sorts, gathers and the domination compares are
library calls, as they are XLA ops outside any Pallas kernel in the JAX
package.

**Object-typed populations.** ``tournament``, ``combine`` and
``take_best`` also take an ``ObjectArray`` of solutions (``dtype=object``
problems): the draws and the selection run on the evals as for a tensor,
and the chosen objects are picked on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from ..tools.objectarray import ObjectArray
from ..tools.ranking import rank

__all__ = [
    "TournamentResult",
    "combine",
    "cosyne_permutation",
    "crowding_distances",
    "dominates",
    "domination_counts",
    "domination_matrix",
    "gaussian_mutation",
    "multi_point_cross_over",
    "one_point_cross_over",
    "pareto_ranks",
    "pareto_utility",
    "polynomial_mutation",
    "simulated_binary_cross_over",
    "take_best",
    "tournament",
    "two_point_cross_over",
    "utility",
]


def _float_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _lane_scalar(x: torch.Tensor, core_ndim: int) -> torch.Tensor:
    """A per-lane scalar ``(*batch)`` shaped to broadcast against arrays of
    ``core_ndim`` core dimensions."""
    return x.reshape(tuple(x.shape) + (1,) * core_ndim) if x.ndim > 0 else x


# ---------------------------------------------------------------------------
# Pareto utilities
# ---------------------------------------------------------------------------


def _sign_adjusted(evals: torch.Tensor, objective_sense) -> torch.Tensor:
    """Minimized objectives negated, so that higher is better on every
    column."""
    if isinstance(objective_sense, str):
        raise ValueError("Multi-objective utilities expect `objective_sense` as a list of 'min'/'max' strings")
    signs = torch.tensor([1.0 if s == "max" else -1.0 for s in objective_sense], dtype=evals.dtype, device=evals.device)
    return evals * signs


def dominates(evals1, evals2, *, objective_sense: list) -> torch.Tensor:
    """True where ``evals1`` Pareto-dominates ``evals2`` (last axis:
    objectives)."""
    adj1 = _sign_adjusted(evals1, objective_sense)
    adj2 = _sign_adjusted(evals2, objective_sense)
    return torch.all(adj1 >= adj2, dim=-1) & torch.any(adj1 > adj2, dim=-1)


def domination_matrix(evals, *, objective_sense: list) -> torch.Tensor:
    """Boolean ``(..., N, N)`` matrix: ``[i, j]`` says "solution i dominates
    solution j" (the JAX package's orientation). Built one objective at a
    time, so no ``(N, N, n_obj)`` temporary."""
    adj = _sign_adjusted(evals, objective_sense)
    no_worse = better = None
    for j in range(adj.shape[-1]):
        a = adj[..., :, j]
        ge = a[..., :, None] >= a[..., None, :]
        gt = a[..., :, None] > a[..., None, :]
        no_worse = ge if no_worse is None else no_worse & ge
        better = gt if better is None else better | gt
    return no_worse & better


def domination_counts(evals, *, objective_sense: list) -> torch.Tensor:
    """For each solution, how many solutions dominate it (int32; 0 on the
    Pareto front)."""
    return torch.sum(domination_matrix(evals, objective_sense=objective_sense), dim=-2, dtype=torch.int32)


def _per_lane(fn, *arrays, core_ndims):
    """``fn`` applied lane by lane over the leading batch dimensions (for
    the functions whose loops read the host)."""
    batch = arrays[0].shape[: arrays[0].ndim - core_ndims[0]]
    if len(batch) == 0:
        return fn(*arrays)
    flat = [a.reshape((-1,) + tuple(a.shape[a.ndim - nd :])) for a, nd in zip(arrays, core_ndims)]
    out = torch.stack([fn(*lane) for lane in zip(*flat)])
    return out.reshape(tuple(batch) + tuple(out.shape[1:]))


def _pareto_ranks_2d(evals: torch.Tensor, objective_sense) -> torch.Tensor:
    n = evals.shape[0]
    dom = domination_matrix(evals, objective_sense=objective_sense)
    counts = torch.sum(dom, dim=0, dtype=torch.int32)
    ranks = torch.zeros(n, dtype=torch.int32, device=evals.device)
    unranked = torch.ones(n, dtype=torch.bool, device=evals.device)
    front = counts == 0
    k = 0
    while True:
        members = torch.nonzero(front).flatten()  # the one host read per front
        if members.numel() == 0:
            return ranks
        ranks.index_fill_(0, members, k)  # a Python scalar: no host-to-device copy
        unranked.index_fill_(0, members, False)
        counts -= torch.sum(dom.index_select(0, members), dim=0, dtype=torch.int32)
        front = (counts == 0) & unranked
        k += 1


def pareto_ranks(evals, *, objective_sense: list) -> torch.Tensor:
    """Front index per solution (0 = best front), int32. See the module
    note for the peeling."""
    evals = torch.as_tensor(evals)
    return _per_lane(lambda e: _pareto_ranks_2d(e, objective_sense), evals, core_ndims=(2,))


def _crowding_distances_2d(evals: torch.Tensor, ranks: torch.Tensor, objective_sense) -> torch.Tensor:
    adj = _sign_adjusted(evals, objective_sense)
    n, k = adj.shape
    ranks = ranks.to(torch.int64)
    total = torch.zeros(n, dtype=adj.dtype, device=adj.device)
    false = torch.zeros(1, dtype=torch.bool, device=adj.device)
    one = torch.ones((), dtype=adj.dtype, device=adj.device)
    for j in range(k):
        vals = adj[:, j]
        # sorted by front, then by value, then by index (jnp.lexsort's order)
        by_value = torch.argsort(vals, stable=True)
        order = by_value.index_select(0, torch.argsort(ranks.index_select(0, by_value), stable=True))
        sorted_vals = vals.index_select(0, order)
        sorted_ranks = ranks.index_select(0, order)
        prev_vals = torch.cat([sorted_vals[:1], sorted_vals[:-1]])
        next_vals = torch.cat([sorted_vals[1:], sorted_vals[-1:]])
        prev_same = torch.cat([false, sorted_ranks[1:] == sorted_ranks[:-1]])
        next_same = torch.cat([sorted_ranks[:-1] == sorted_ranks[1:], false])
        # each gap normalized by the objective's range within the front
        front_max = torch.full((n,), -math.inf, dtype=adj.dtype, device=adj.device)
        front_max = front_max.scatter_reduce(0, ranks, vals, "amax", include_self=False)
        front_min = torch.full((n,), math.inf, dtype=adj.dtype, device=adj.device)
        front_min = front_min.scatter_reduce(0, ranks, vals, "amin", include_self=False)
        front_range = front_max - front_min
        front_range = torch.where(front_range <= 0, one, front_range)
        dist = torch.where(
            prev_same & next_same,
            (next_vals - prev_vals) / front_range.index_select(0, sorted_ranks),
            torch.full_like(sorted_vals, math.inf),
        )
        total = total + torch.zeros_like(total).index_copy(0, order, dist)
    return total


def crowding_distances(evals, *, objective_sense: list, ranks=None) -> torch.Tensor:
    """NSGA-II crowding distance per solution; each front's boundary
    solutions get ``+inf``."""
    evals = torch.as_tensor(evals)
    if ranks is None:
        ranks = pareto_ranks(evals, objective_sense=objective_sense)
    return _per_lane(
        lambda e, r: _crowding_distances_2d(e, r, objective_sense), evals, torch.as_tensor(ranks), core_ndims=(2, 1)
    )


def _pareto_utility_2d(evals: torch.Tensor, objective_sense, crowdsort: bool) -> torch.Tensor:
    ranks = _pareto_ranks_2d(evals, objective_sense)
    utilities = -ranks.to(evals.dtype)
    if crowdsort:
        crowd = _crowding_distances_2d(evals, ranks, objective_sense)
        n = evals.shape[0]
        # crowding mapped into [0, 1) by its ordinal rank: the order within a
        # front is kept and the term stays below one front step
        crowd_rank = torch.argsort(torch.argsort(crowd, stable=True), stable=True).to(evals.dtype)
        utilities = utilities + crowd_rank / torch.full((), n + 1, dtype=evals.dtype, device=evals.device)
    return utilities


def pareto_utility(evals, *, objective_sense: list, crowdsort: bool = True) -> torch.Tensor:
    """Scalar utility per solution for multi-objective selection: higher
    means a better front, ties broken by crowding distance."""
    evals = torch.as_tensor(evals)
    return _per_lane(lambda e: _pareto_utility_2d(e, objective_sense, bool(crowdsort)), evals, core_ndims=(2,))


# ---------------------------------------------------------------------------
# Fitness shaping
# ---------------------------------------------------------------------------


def utility(evals, *, objective_sense, ranking_method: Optional[str] = "centered") -> torch.Tensor:
    """Fitness-shaped utilities along the last axis, higher = better (Pareto
    utilities when ``objective_sense`` is a list)."""
    if not isinstance(objective_sense, str):
        return pareto_utility(evals, objective_sense=objective_sense)
    higher_is_better = {"max": True, "min": False}[objective_sense]
    return rank(evals, "raw" if ranking_method is None else ranking_method, higher_is_better=higher_is_better)


# ---------------------------------------------------------------------------
# Tournament selection
# ---------------------------------------------------------------------------


class TournamentResult(NamedTuple):
    parent1_values: torch.Tensor
    parent1_evals: Optional[torch.Tensor]
    parent2_values: torch.Tensor
    parent2_evals: Optional[torch.Tensor]


def _tournament_utilities(evals: torch.Tensor, objective_sense) -> torch.Tensor:
    if isinstance(objective_sense, str):
        return utility(evals, objective_sense=objective_sense, ranking_method="centered")
    return pareto_utility(evals, objective_sense=objective_sense)


def _draw_tournament(generator, batch_shape: tuple, half: int, tournament_size: int, n: int, device):
    """The two candidate sets: ``(*batch, half, size)`` indices in ``[0, n)``
    and in ``[0, n - 1)`` (the second set skips the first set's winner)."""
    shape = tuple(batch_shape) + (half, tournament_size)
    cand1 = torch.randint(0, n, shape, generator=generator, device=device)
    cand2 = torch.randint(0, n - 1, shape, generator=generator, device=device)
    return cand1, cand2


def _tournament_core(utilities: torch.Tensor, cand1: torch.Tensor, cand2: torch.Tensor) -> torch.Tensor:
    """Winner indices ``(*batch, 2 * half)``: the first set's, then the
    second set's, where the first winner of pair i is kept out of the
    second tournament i (so each crossover pairs two distinct parents)."""
    cand1 = cand1.to(utilities.device, torch.int64)
    cand2 = cand2.to(utilities.device, torch.int64)
    rows = utilities[..., None, :]
    win1 = torch.argmax(torch.take_along_dim(rows, cand1, dim=-1), dim=-1, keepdim=True)
    winners1 = torch.take_along_dim(cand1, win1, dim=-1)
    cand2 = torch.where(cand2 >= winners1, cand2 + 1, cand2)
    win2 = torch.argmax(torch.take_along_dim(rows, cand2, dim=-1), dim=-1, keepdim=True)
    winners2 = torch.take_along_dim(cand2, win2, dim=-1)
    return torch.cat([winners1[..., 0], winners2[..., 0]], dim=-1)


def tournament(
    generator: torch.Generator,
    solutions: torch.Tensor,
    evals: torch.Tensor,
    *,
    num_tournaments: int,
    tournament_size: int,
    objective_sense: Union[str, list],
    return_indices: bool = False,
    with_evals: bool = False,
    split_results: bool = False,
):
    """Pairs of tournaments whose winners form two parent sets. Returns
    indices, values or ``(values, evals)``, optionally split into the two
    sets (a :class:`TournamentResult` with evals), as in the JAX package."""
    num_tournaments = int(num_tournaments)
    tournament_size = int(tournament_size)
    if num_tournaments % 2 != 0:
        raise ValueError(f"num_tournaments must be even, got {num_tournaments}")
    evals = torch.as_tensor(evals)
    utilities = _tournament_utilities(evals, objective_sense)
    half = num_tournaments // 2
    cand1, cand2 = _draw_tournament(
        generator, tuple(utilities.shape[:-1]), half, tournament_size, utilities.shape[-1], utilities.device
    )
    indices = _tournament_core(utilities, cand1, cand2)
    if return_indices:
        return (indices[..., :half], indices[..., half:]) if split_results else indices
    if isinstance(solutions, ObjectArray):
        return _picked_objects(solutions, evals, indices, half, with_evals=with_evals, split_results=split_results)

    solutions = torch.as_tensor(solutions)
    picked = torch.take_along_dim(solutions, indices[..., None], dim=-2)
    picked_evals = None
    if with_evals:
        if evals.ndim == utilities.ndim:
            picked_evals = torch.take_along_dim(evals, indices, dim=-1)
        else:
            picked_evals = torch.take_along_dim(evals, indices[..., None], dim=-2)
    if split_results:
        p1, p2 = picked[..., :half, :], picked[..., half:, :]
        if with_evals:
            if picked_evals.ndim == indices.ndim:
                e1, e2 = picked_evals[..., :half], picked_evals[..., half:]
            else:
                e1, e2 = picked_evals[..., :half, :], picked_evals[..., half:, :]
            return TournamentResult(p1, e1, p2, e2)
        return p1, p2
    return (picked, picked_evals) if with_evals else picked


def _picked_objects(solutions: ObjectArray, evals: torch.Tensor, indices: torch.Tensor, half: int, *, with_evals, split_results):
    """The tournament's result forms for an ``ObjectArray`` population."""
    order = indices.tolist()
    picked = solutions[order]
    picked_evals = evals[indices] if with_evals else None
    if split_results:
        p1, p2 = picked[:half], picked[half:]
        if with_evals:
            return TournamentResult(p1, picked_evals[:half], p2, picked_evals[half:])
        return p1, p2
    return (picked, picked_evals) if with_evals else picked


# ---------------------------------------------------------------------------
# Crossover
# ---------------------------------------------------------------------------


def _maybe_tournament(generator, parents, evals, tournament_size, num_children, objective_sense):
    """Split the given parents in half, or pick the two sets by tournament."""
    if tournament_size is None:
        if num_children is not None:
            raise ValueError("`num_children` requires `tournament_size`")
        n = parents.shape[-2]
        if n % 2 != 0:
            raise ValueError(f"Number of parents must be even, got {n}")
        half = n // 2
        return parents[..., :half, :], parents[..., half:, :]
    if evals is None or objective_sense is None:
        raise ValueError("tournament selection requires `evals` and `objective_sense`")
    if num_children is None:
        num_children = parents.shape[-2]
    if num_children % 2 != 0:
        raise ValueError(f"num_children must be even, got {num_children}")
    return tournament(
        generator,
        parents,
        evals,
        num_tournaments=num_children,
        tournament_size=tournament_size,
        objective_sense=objective_sense,
        split_results=True,
    )


def _draw_cut_points(generator, batch_shape: tuple, half: int, num_points: int, length: int, device):
    """``(*batch, half, num_points)`` cut positions in ``[1, length)``."""
    shape = tuple(batch_shape) + (half, num_points)
    return torch.randint(1, length, shape, generator=generator, device=device)


def _kpoint_crossover_core(parents1: torch.Tensor, parents2: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Both children of each pair: a position takes the other parent's
    value where an odd number of cuts lie at or before it."""
    positions = torch.arange(parents1.shape[-1], device=parents1.device)
    counts = torch.sum(positions >= cuts.to(parents1.device, torch.int64)[..., None], dim=-2)
    use_other = (counts % 2) == 1
    child1 = torch.where(use_other, parents2, parents1)
    child2 = torch.where(use_other, parents1, parents2)
    return torch.cat([child1, child2], dim=-2)


def multi_point_cross_over(
    generator: torch.Generator,
    parents: torch.Tensor,
    evals: Optional[torch.Tensor] = None,
    *,
    num_points: int,
    tournament_size: Optional[int] = None,
    num_children: Optional[int] = None,
    objective_sense=None,
) -> torch.Tensor:
    """k-point crossover: each pair is cut at ``num_points`` random
    positions and recombined into two complementary children."""
    parents = torch.as_tensor(parents)
    p1, p2 = _maybe_tournament(generator, parents, evals, tournament_size, num_children, objective_sense)
    batch = torch.broadcast_shapes(p1.shape[:-2], p2.shape[:-2])
    length = p1.shape[-1]
    num_points = min(int(num_points), length - 1)
    cuts = _draw_cut_points(generator, tuple(batch), p1.shape[-2], num_points, length, p1.device)
    return _kpoint_crossover_core(p1, p2, cuts)


def one_point_cross_over(generator, parents, evals=None, *, tournament_size=None, num_children=None, objective_sense=None):
    return multi_point_cross_over(
        generator, parents, evals, num_points=1, tournament_size=tournament_size,
        num_children=num_children, objective_sense=objective_sense,
    )  # fmt: skip


def two_point_cross_over(generator, parents, evals=None, *, tournament_size=None, num_children=None, objective_sense=None):
    return multi_point_cross_over(
        generator, parents, evals, num_points=2, tournament_size=tournament_size,
        num_children=num_children, objective_sense=objective_sense,
    )  # fmt: skip


def _draw_uniform(generator, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, dtype=dtype, device=device)


def _draw_normal(generator, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def _sbx_core(parents1: torch.Tensor, parents2: torch.Tensor, eta: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SBX children from the uniform draws ``u`` (shape of ``parents1``);
    ``eta`` is a scalar or one per lane."""
    exponent = 1.0 / (_lane_scalar(eta, 2) + 1.0)
    beta = torch.where(u <= 0.5, (2 * u) ** exponent, (1.0 / (2 * (1.0 - u))) ** exponent)
    child1 = 0.5 * ((1 + beta) * parents1 + (1 - beta) * parents2)
    child2 = 0.5 * ((1 - beta) * parents1 + (1 + beta) * parents2)
    return torch.cat([child1, child2], dim=-2)


def simulated_binary_cross_over(
    generator: torch.Generator,
    parents: torch.Tensor,
    evals: Optional[torch.Tensor] = None,
    *,
    eta,
    tournament_size: Optional[int] = None,
    num_children: Optional[int] = None,
    objective_sense=None,
) -> torch.Tensor:
    """Simulated binary crossover (Deb & Kumar 1995)."""
    parents = torch.as_tensor(parents)
    p1, p2 = _maybe_tournament(generator, parents, evals, tournament_size, num_children, objective_sense)
    eta = _float_tensor(eta, parents)
    shape = torch.broadcast_shapes(p1.shape, p2.shape[:-2] + (1, 1), eta.shape + (1, 1))
    u = _draw_uniform(generator, shape, p1.dtype, p1.device)
    return _sbx_core(p1, p2, eta, u)


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------


def _gaussian_mutation_core(values, stdev, z, mutate=None) -> torch.Tensor:
    """``values + stdev * z``, where ``mutate`` (when given) is True."""
    noise = z * _lane_scalar(stdev, 2)
    if mutate is None:
        return values + noise
    return values + torch.where(mutate, noise, torch.zeros_like(noise))


def gaussian_mutation(generator: torch.Generator, values, *, stdev, mutation_probability: Optional[float] = None):
    """Additive Gaussian noise, optionally gated element by element
    (``stdev`` and the probability may be one per lane)."""
    values = torch.as_tensor(values)
    stdev = _float_tensor(stdev, values)
    shape = torch.broadcast_shapes(values.shape, stdev.shape + (1, 1))
    z = _draw_normal(generator, shape, values.dtype, values.device)
    if mutation_probability is None:
        return _gaussian_mutation_core(values, stdev, z)
    p = _float_tensor(mutation_probability, values)
    u = _draw_uniform(generator, torch.broadcast_shapes(shape, p.shape + (1, 1)), torch.float32, values.device)
    return _gaussian_mutation_core(values, stdev, z, u < _lane_scalar(p, 2))


def _bound_vector(bound, values: torch.Tensor) -> torch.Tensor:
    bound = _float_tensor(bound, values)
    return bound.expand(values.shape[-1:]) if bound.ndim == 0 else bound


def _polynomial_delta(values, lb, ub, eta, u):
    span = ub - lb
    delta1 = (values - lb) / span
    delta2 = (ub - values) / span
    mut_pow = 1.0 / (eta + 1.0)
    xy1 = 1.0 - delta1
    xy2 = 1.0 - delta2
    val1 = 2.0 * u + (1.0 - 2.0 * u) * xy1 ** (eta + 1.0)
    val2 = 2.0 * (1.0 - u) + 2.0 * (u - 0.5) * xy2 ** (eta + 1.0)
    deltaq = torch.where(u <= 0.5, val1**mut_pow - 1.0, 1.0 - val2**mut_pow)
    return values + deltaq * span


def _polynomial_mutation_core(values, lb, ub, eta, u, mutate=None) -> torch.Tensor:
    """Bounded polynomial mutation from the uniform draws ``u``; ``lb`` and
    ``ub`` are ``(*batch, L)``, ``eta`` a scalar or one per lane."""
    lb, ub = lb[..., None, :], ub[..., None, :]
    mutated = _polynomial_delta(values, lb, ub, _lane_scalar(eta, 2), u)
    if mutate is not None:
        mutated = torch.where(mutate, mutated, values)
    return torch.minimum(torch.maximum(mutated, lb), ub)


def polynomial_mutation(generator: torch.Generator, values, *, lb, ub, eta: float = 20.0, mutation_probability: Optional[float] = None):
    """Bounded polynomial mutation (Deb & Deb 2014)."""
    values = torch.as_tensor(values)
    lb, ub = _bound_vector(lb, values), _bound_vector(ub, values)
    eta = _float_tensor(eta, values)
    shape = torch.broadcast_shapes(values.shape, lb.shape[:-1] + (1, 1), eta.shape + (1, 1))
    u = _draw_uniform(generator, shape, values.dtype, values.device)
    if mutation_probability is None:
        return _polynomial_mutation_core(values, lb, ub, eta, u)
    p = _float_tensor(mutation_probability, values)
    gate = _draw_uniform(generator, torch.broadcast_shapes(shape, p.shape + (1, 1)), torch.float32, values.device)
    return _polynomial_mutation_core(values, lb, ub, eta, u, gate < _lane_scalar(p, 2))


# ---------------------------------------------------------------------------
# CoSyNE permutation
# ---------------------------------------------------------------------------


def _cosyne_full_permutation_core(values: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Each column shuffled by the stable argsort of its column of uniform
    ``noise`` (``(*batch, N, L)``)."""
    order = torch.argsort(noise.to(values.device), dim=-2, stable=True)
    return torch.take_along_dim(values, order, dim=-2)


def _cosyne_partial_permutation_core(values, evals, objective_sense: str, noise, gate) -> torch.Tensor:
    """A value takes its permuted counterpart where ``gate < 1 -
    linear_rank ** (1 / n)``: better solutions keep theirs more often."""
    n = values.shape[-2]
    permuted = _cosyne_full_permutation_core(values, noise)
    ranks = rank(evals, "linear", higher_is_better=(objective_sense == "max"))
    permutation_probs = 1.0 - ranks ** (1.0 / n)
    to_permute = gate.to(values.device) < permutation_probs[..., :, None]
    return torch.where(to_permute, permuted, values)


def cosyne_permutation(
    generator: torch.Generator,
    values: torch.Tensor,
    evals: Optional[torch.Tensor] = None,
    *,
    permute_all: bool = True,
    objective_sense: Optional[str] = None,
) -> torch.Tensor:
    """Column-wise shuffling of decision values (CoSyNE). With
    ``permute_all=False``, a value is permuted with probability ``1 -
    linear_rank ** (1 / n)`` of its solution."""
    values = torch.as_tensor(values)
    noise = _draw_uniform(generator, values.shape, torch.float32, values.device)
    if permute_all:
        return _cosyne_full_permutation_core(values, noise)
    if evals is None or objective_sense is None:
        raise ValueError("When permute_all is False, `evals` and `objective_sense` are required")
    evals = torch.as_tensor(evals)
    shape = torch.broadcast_shapes(values.shape, evals.shape[:-1] + (1, 1))
    gate = _draw_uniform(generator, shape, torch.float32, values.device)
    return _cosyne_partial_permutation_core(values, evals, objective_sense, noise, gate)


# ---------------------------------------------------------------------------
# combine & take_best
# ---------------------------------------------------------------------------


def _is_pair(x) -> bool:
    return isinstance(x, (tuple, list)) and len(x) == 2


def combine(a, b, *, objective_sense=None):
    """Merge two populations, given as value tensors (or ``ObjectArray``s)
    or ``(values, evals)`` pairs."""
    if _is_pair(a) != _is_pair(b):
        raise ValueError("combine expects both arguments in the same form (values or (values, evals))")
    if _is_pair(a):
        values1, evals1 = a
        values2, evals2 = b
        if isinstance(values1, ObjectArray) or isinstance(values2, ObjectArray):
            merged = ObjectArray.from_values(list(values1) + list(values2))
        else:
            merged = torch.cat([torch.as_tensor(values1), torch.as_tensor(values2)], dim=-2)
        evals1, evals2 = torch.as_tensor(evals1), torch.as_tensor(evals2)
        if evals1.ndim != evals2.ndim:
            raise ValueError("evals of both populations must have the same ndim")
        # multi-objective evals carry a trailing objective axis
        solution_axis = -2 if (objective_sense is not None and not isinstance(objective_sense, str)) else -1
        return merged, torch.cat([evals1, evals2], dim=solution_axis)
    if isinstance(a, ObjectArray) or isinstance(b, ObjectArray):
        return ObjectArray.from_values(list(a) + list(b))
    return torch.cat([torch.as_tensor(a), torch.as_tensor(b)], dim=-2)


def _best_indices(utilities: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` highest utilities' indices along the last axis, best first,
    ties to the lower index (``lax.top_k``'s order)."""
    return torch.argsort(utilities, dim=-1, descending=True, stable=True)[..., :n]


def take_best(values, evals, n: Optional[int] = None, *, objective_sense, crowdsort: bool = True):
    """The best solution (``n=None``) or the best ``n`` solutions, as
    ``(values, evals)``; with several objectives, NSGA-II selection (Pareto
    fronts, then crowding). An ``ObjectArray`` of values is picked on the
    host."""
    evals = torch.as_tensor(evals)
    if isinstance(values, ObjectArray):
        if isinstance(objective_sense, str):
            utilities = evals if objective_sense == "max" else -evals
        else:
            utilities = pareto_utility(evals, objective_sense=list(objective_sense), crowdsort=crowdsort)
        if n is None:
            i = int(torch.argmax(utilities))
            return values[i], evals[i]
        idx = _best_indices(utilities, int(n))
        return values[idx.tolist()], evals[idx]
    values = torch.as_tensor(values)
    if isinstance(objective_sense, str):
        maximize = {"max": True, "min": False}[objective_sense]
        utilities = evals if maximize else -evals
        if n is None:
            best = torch.argmax(utilities, dim=-1, keepdim=True)
            return (
                torch.take_along_dim(values, best[..., None], dim=-2)[..., 0, :],
                torch.take_along_dim(evals, best, dim=-1)[..., 0],
            )
        idx = _best_indices(utilities, int(n))
        return torch.take_along_dim(values, idx[..., None], dim=-2), torch.take_along_dim(evals, idx, dim=-1)
    if n is None:
        raise ValueError("take_best with multiple objectives requires an explicit `n`")
    utilities = pareto_utility(evals, objective_sense=list(objective_sense), crowdsort=crowdsort)
    idx = _best_indices(utilities, int(n))[..., None]
    return torch.take_along_dim(values, idx, dim=-2), torch.take_along_dim(evals, idx, dim=-2)
