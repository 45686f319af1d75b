"""Sharded population evaluation and whole generations (counterpart of
``evotorch_tpu/parallel/evaluate.py``).

The JAX package writes the evaluation once as the global program and lets
GSPMD partition it over the mesh, so a sharded evaluation equals the
unsharded one at any mesh shape. The port keeps that meaning over a process
group with one rank per card (``parallel/mesh.py``):

- every rank holds the whole sampled population, drawn from a generator
  seeded alike on every rank (so each rank launches the sampling kernel
  once per generation);
- each rank evaluates one block of rows: lanes with global ``lane_ids``,
  every random table drawn at its global size and each lane taking its
  rows, popsizes that do not divide the ranks padded with copies of the
  first row that earn nothing (``num_valid``);
- observation statistics are updated from every rank's observations each
  step (the block's observations gathered), and ``episodes_refill`` runs one
  queue over every rank's lanes (the idle masks gathered each step, every
  rank taking its own lanes' part of the one decision);
- the scores are gathered to the full ``(N,)`` on every rank, with the
  counters and the health block, so the tell (the rank kernel included)
  runs replicated and the state stays the same everywhere.

Each lane computes what it computes in the one-rank run, from the same
rows and the same draws. Whether it rounds the same depends on the
device: on the CPU the results equal the one-rank run's bit for bit at
any world size; on the card a rank runs its kernels at its block's shapes,
and cuBLAS picks its kernels by shape, so a lane may round otherwise than
in a one-rank run over all the lanes (a chaotic closed loop, as the
flagship's, then parts that lane's trajectory). Every rank holds the same
result either way.

With no process group (world size 1) and no mesh given,
``make_generation_step`` runs the unsharded path unchanged.

The JAX package's explicit ``shard_map`` form survives behind
``use_shard_map=True`` / ``EVOTORCH_SHARD_MAP=1``, by the same names: each
rank runs its own rollout on its rows (per-rank refill queues,
observation statistics merged at the end, or every step with
``stats_sync``), counters summed, popsizes that must divide the ranks.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..neuroevolution.net.vecrl import (
    RolloutResult,
    _merge_shard_results,
    _params_popsize,
    _Sync,
    run_vectorized_rollout,
)
from ..observability.devicemetrics import append_health_block, compute_health_block
from ..tools.lowrank import _row_block, is_factored
from .mesh import Mesh, default_mesh, device_count

__all__ = [
    "make_generation_step",
    "make_sharded_evaluator",
    "make_sharded_rollout_evaluator",
    "population_spec",
    "shard_population",
]


def _use_shard_map(flag: Optional[bool]) -> bool:
    """The explicit argument, else the ``EVOTORCH_SHARD_MAP=1`` switch
    (default: the global form)."""
    if flag is None:
        return os.environ.get("EVOTORCH_SHARD_MAP", "0") == "1"
    return bool(flag)


def population_spec(mesh: Mesh) -> tuple:
    """The axes a population's rows are laid over: all of the mesh's,
    flattened (a ``model`` axis shards rows like ``pop``), as in the JAX
    package's ``P(("pop", "model"))``."""
    return tuple(mesh.axis_names)


def _block(values, mesh: Mesh):
    """This rank's block of rows, padded with first-row copies, and its
    global lane ids (host integers) and rows per rank."""
    n = _params_popsize(values)
    start, stop, per = mesh.block(n)
    rows = values.block(start, stop, per) if is_factored(values) else _row_block(values, start, stop, per)
    lo = mesh.rank * per
    return rows, torch.arange(lo, lo + per), per


def shard_population(values, mesh: Optional[Mesh] = None):
    """The rows this rank holds of a population laid over ``mesh`` (the
    default: every rank of the default group): its block, padded with
    first-row copies where the popsize does not divide the ranks."""
    return _block(values, default_mesh() if mesh is None else mesh)[0]


def _check_device(values, device: torch.device) -> None:
    here = values.coeffs.device if is_factored(values) else values.device
    if here != device:
        raise ValueError(f"the population lies on {here}; the sharded evaluation runs on {device}")


def make_sharded_evaluator(fitness_func: Callable, *, mesh: Optional[Mesh] = None, device=None) -> Callable:
    """Wrap a vectorized fitness function ``f(values (n, L)) -> (n,) | (n, K)``
    (or a tuple of such) into an evaluator that computes each rank's block
    of rows and gathers the results to every rank. Populations that do not
    divide the ranks are padded with their first row and the padding's
    results dropped (the JAX package's two forms compute the same for a
    plain function). Runs on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    mesh = default_mesh() if mesh is None else mesh

    def evaluator(values):
        _check_device(values, device)
        n = _params_popsize(values)
        rows, _, per = _block(values, mesh)
        out = fitness_func(rows)
        gather = lambda r: mesh.gather_rows(torch.as_tensor(r, device=device), per * mesh.size, mesh.rank * per)[:n]
        return tuple(gather(r) for r in out) if isinstance(out, tuple) else gather(out)

    return evaluator


_RESERVED_ROLLOUT_KWARGS = {"lane_ids", "stats_sync_axis", "seed_stride", "num_valid", "nonfinite_sync_axis"}


def _check_reserved(rollout_kwargs, what: str):
    reserved = _RESERVED_ROLLOUT_KWARGS & set(rollout_kwargs)
    if reserved:
        raise ValueError(
            f"{what} sets {sorted(reserved)} itself (the global lane and table wiring and the padding mask are what"
            " the helper exists to get right); drop them from the rollout kwargs"
        )


def make_sharded_rollout_evaluator(
    env, policy, *, mesh: Optional[Mesh] = None, stats_sync: bool = False, use_shard_map: Optional[bool] = None,
    **rollout_kwargs,
):  # fmt: skip
    """Shard ``run_vectorized_rollout`` over ``mesh``'s ranks (the default:
    every rank of the default group). Returns ``evaluator(values,
    generator, stats, **tables) -> (RolloutResult, per_shard_steps)``; every
    rank gets the evaluation's ``(N,)`` scores, statistics, counters and
    wire. ``tables`` (``reset_noise``, ``action_noise``) are the whole
    evaluation's, as ``run_vectorized_rollout`` takes them.

    The default form is the one-rank evaluation at any world size (see
    the module note for how it rounds): ``stats_sync`` is moot there. ``use_shard_map=True``
    (or ``EVOTORCH_SHARD_MAP=1``) selects the per-rank form: each rank's
    rollout on its rows with global lane ids, its own refill queue (an
    explicit ``refill_width`` is global and must divide the ranks), its
    observation statistics merged at the end, or every step with
    ``stats_sync``, and a popsize that must divide the ranks.

    Dense populations and factored batches (whose coefficient rows are
    split; the shared center, basis and factors stay whole on every rank,
    where the JAX package storage-shards a trunk-delta trunk over ``model``)
    are taken. ``per_shard_steps`` is the one-element total under the
    default form and each rank's env steps under the per-rank form."""
    _check_reserved(rollout_kwargs, "make_sharded_rollout_evaluator")
    mesh = default_mesh() if mesh is None else mesh
    refill = rollout_kwargs.get("eval_mode", "episodes") == "episodes_refill"
    if _use_shard_map(use_shard_map):
        return _per_rank_rollout_evaluator(env, policy, mesh=mesh, stats_sync=stats_sync, **rollout_kwargs)

    def evaluator(values, generator: torch.Generator, stats, **tables):
        _check_device(values, env.device)
        n = _params_popsize(values)
        if refill:
            # every rank holds the whole population; the engine takes
            # this rank's block of the queue's lanes
            result = run_vectorized_rollout(
                env, policy, values, generator, stats, _sync=_Sync("global", mesh), **rollout_kwargs, **tables
            )
        else:
            rows, lane_ids, per = _block(values, mesh)
            sync = _Sync("global", mesh, lo=mesh.rank * per, width=per * mesh.size, valid=n)
            result = run_vectorized_rollout(
                env, policy, rows, generator, stats, lane_ids=lane_ids, num_valid=n, seed_stride=n, _sync=sync,
                **rollout_kwargs, **tables,
            )  # fmt: skip
        return result, torch.tensor([result.total_steps])

    return evaluator


def _per_rank_rollout_evaluator(env, policy, *, mesh: Mesh, stats_sync: bool, **rollout_kwargs):
    """The per-rank (``shard_map``) form of ``make_sharded_rollout_evaluator``."""
    kwargs = dict(rollout_kwargs)
    if kwargs.get("eval_mode") == "episodes_refill" and kwargs.get("refill_width") is not None:
        width = int(kwargs["refill_width"])
        if width % mesh.size != 0:
            raise ValueError(f"refill_width={width} is global and must be divisible by the mesh's {mesh.size} ranks")
        kwargs["refill_width"] = width // mesh.size
    # the worst finite score of the quarantine is the global one
    if kwargs.get("nonfinite_quarantine") and kwargs.get("nonfinite_penalty") is None:
        kwargs["nonfinite_sync_axis"] = mesh
    # the health block is computed on the gathered scores, not per rank
    health = bool(kwargs.pop("health", True))
    kwargs["health"] = False

    def evaluator(values, generator: torch.Generator, stats, **tables):
        _check_device(values, env.device)
        n = _params_popsize(values)
        if n % mesh.size != 0:
            raise ValueError(f"num_solutions={n} must be divisible by the mesh's {mesh.size} ranks (use_shard_map)")
        start, stop, per = mesh.block(n)
        rows = values.take(slice(start, stop)) if is_factored(values) else values[start:stop]
        result = run_vectorized_rollout(
            env, policy, rows, generator, stats, lane_ids=torch.arange(start, stop), seed_stride=n,
            stats_sync_axis=mesh if stats_sync else None, **kwargs, **tables,
        )  # fmt: skip
        per_shard = mesh.gather_rows(torch.tensor([result.total_steps], device=env.device), mesh.size, mesh.rank)
        merged = _merge_shard_results(
            result, mesh, stats0=stats, popsize=n, start=start, per_rank=per, stats_synced=stats_sync, health=health
        )
        return merged, per_shard

    return evaluator


def make_generation_step(
    env, policy, *, ask: Callable, tell: Callable, popsize: int, mesh: Optional[Mesh] = None, device=None,
    **rollout_kwargs,
):  # fmt: skip
    """One whole generation, ``ask -> rollout -> tell``.

    ``ask(generator, state) -> values`` samples the population (a dense
    ``(popsize, L)`` tensor, or a factored batch such as
    ``pgpe_ask_lowrank``'s or ``pgpe_ask_trunk_delta``'s), ``tell(state,
    values, scores) -> state`` applies the update (``pgpe_tell_lowrank`` for
    a factored one). ``rollout_kwargs`` go to ``run_vectorized_rollout``:
    ``eval_mode`` ``"episodes"`` (the default), ``"episodes_refill"`` or
    ``"budget"``, ``trunk_block`` for a trunk-delta population;
    ``"episodes_compact"`` is refused, as in the JAX package: call
    ``run_vectorized_rollout_compacting`` between ask and tell instead.

    With a ``mesh``, or a process group of more than one rank initialized
    (``init_distributed``), the rollout is sharded over the ranks
    (``make_sharded_rollout_evaluator``'s default form): every rank asks,
    evaluates its block, and tells on the gathered scores, so every rank
    holds the same state, scores, statistics and wire, those of the
    one-rank generation (see the module note for how they round). Every
    rank must pass a generator seeded alike.

    Returns ``generation(state, generator, stats) -> (state, scores, stats,
    total_steps, telemetry)``. ``telemetry`` is the rollout's ``(1, 20)``
    int32 wire, its health block computed on the ``popsize`` scores (an
    empty int32 tensor with ``telemetry=False``). Runs on ``cuda`` unless
    ``device`` says otherwise; the env must live on that device."""
    _check_reserved(rollout_kwargs, "make_generation_step")
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"the env lives on {env.device}, the generation runs on {device}")
    eval_mode = rollout_kwargs.get("eval_mode", "episodes")
    if eval_mode not in ("budget", "episodes", "episodes_refill"):
        raise ValueError(
            f"make_generation_step runs eval_mode 'episodes', 'episodes_refill' or 'budget', got {eval_mode!r};"
            " for episodes_compact call run_vectorized_rollout_compacting between ask and tell"
        )
    popsize = int(popsize)
    if mesh is None and device_count() > 1:
        mesh = default_mesh()
    if mesh is not None:
        evaluate = make_sharded_rollout_evaluator(env, policy, mesh=mesh, use_shard_map=False, **rollout_kwargs)

        def rollout(values, generator, stats) -> RolloutResult:
            return evaluate(values, generator, stats)[0]

    else:
        health = bool(rollout_kwargs.pop("health", True))
        rollout_kwargs["health"] = False

        def rollout(values, generator, stats) -> RolloutResult:
            result = run_vectorized_rollout(env, policy, values, generator, stats, **rollout_kwargs)
            scores = result.scores[:popsize]
            if result.telemetry is not None and health:
                result = result._replace(telemetry=append_health_block(result.telemetry, compute_health_block(scores)))
            return result._replace(scores=scores)

    def generation(state, generator: torch.Generator, stats):
        values = ask(generator, state)
        result = rollout(values, generator, stats)
        new_state = tell(state, values, result.scores)
        telemetry = result.telemetry
        if telemetry is None:
            telemetry = torch.zeros((0,), dtype=torch.int32, device=device)
        return new_state, result.scores, result.stats, result.total_steps, telemetry

    return generation
