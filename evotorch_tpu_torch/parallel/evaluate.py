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
from ..tools.misc import stack_trees
from .mesh import Mesh, TrunkShard, default_mesh, device_count, gather_trunk, shard_trunk

__all__ = [
    "make_generation_step",
    "make_sharded_evaluator",
    "make_sharded_rollout_evaluator",
    "make_training_span",
    "population_spec",
    "shard_population",
    "spread_rollout_result",
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


def spread_rollout_result(
    mesh: Mesh, result: Optional[RolloutResult], generator: torch.Generator, *, popsize: int, stats, health: bool = True
) -> RolloutResult:
    """A mesh over the first ranks (``num_actors`` below the world size):
    its rollout result on every rank of the default group, with the state
    of the ``generator`` the rollout drew from (so that every rank's stream
    stays in step), in one ``all_reduce`` (``Mesh.spread``). ``result`` is
    None outside the mesh. ``stats`` are the statistics the rollout started
    from (the result's have their shapes); the wire is ``(1, 20)``
    (``(1, 15)`` without ``health``)."""
    from ..observability.devicemetrics import GROUP_TELEMETRY_WIDTH, HEALTH_TELEMETRY_WIDTH

    device = stats.sum.device
    width = HEALTH_TELEMETRY_WIDTH if health else GROUP_TELEMETRY_WIDTH
    state = generator.get_state()
    placeholders = [
        torch.zeros((popsize,), dtype=torch.float32, device=device),
        torch.zeros_like(stats.count), torch.zeros_like(stats.sum), torch.zeros_like(stats.sum_of_squares),
        torch.zeros((2,), dtype=torch.int64, device=device),
        torch.zeros((1, width), dtype=torch.int32, device=device),
        state.to(device),
    ]  # fmt: skip
    if result is not None:
        counters = torch.stack([torch.as_tensor(result.total_steps, device=device), result.total_episodes.to(torch.int64)])
        sent = [result.scores, result.stats.count, result.stats.sum, result.stats.sum_of_squares, counters, result.telemetry]
        for got, like in zip(sent, placeholders):
            if got is None or got.shape != like.shape or got.dtype != like.dtype:
                got = None if got is None else (got.dtype, tuple(got.shape))
                raise TypeError(f"a rollout result holds {got}; the spread expects {like.dtype} {tuple(like.shape)}")
        placeholders = sent + placeholders[-1:]
    scores, count, total, squares, counters, wire, state = mesh.spread(placeholders)
    generator.set_state(state.cpu())
    return RolloutResult(
        scores=scores, stats=type(stats)(count, total, squares), total_steps=int(counters[0]), total_episodes=counters[1],
        telemetry=wire,
    )  # fmt: skip


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
    split; the shared center, basis and factors stay whole on every rank)
    are taken, and a trunk-delta population held sharded over ``model``
    (``mesh.TrunkShard``), whose whole trunk is gathered for the rollout.
    ``per_shard_steps`` is the one-element total under the default form and
    each rank's env steps under the per-rank form."""
    _check_reserved(rollout_kwargs, "make_sharded_rollout_evaluator")
    mesh = default_mesh() if mesh is None else mesh
    refill = rollout_kwargs.get("eval_mode", "episodes") == "episodes_refill"
    if _use_shard_map(use_shard_map):
        return _per_rank_rollout_evaluator(env, policy, mesh=mesh, stats_sync=stats_sync, **rollout_kwargs)

    def evaluator(values, generator: torch.Generator, stats, **tables):
        if isinstance(values, TrunkShard):
            values = gather_trunk(values, mesh)  # for this rollout only
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


def _generation_body(
    env, policy, *, ask: Callable, tell: Callable, popsize: int, mesh: Optional[Mesh], device, **rollout_kwargs
):  # fmt: skip
    """The ``ask -> rollout -> tell`` closure that ``make_generation_step``
    returns and ``make_training_span`` loops over."""
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
        if mesh is not None:
            # a trunk-delta trunk rests sharded over a model axis; the
            # rollout and the tell each gather it for their own use
            values = shard_trunk(values, mesh)
        result = rollout(values, generator, stats)
        if isinstance(values, TrunkShard):
            values = gather_trunk(values, mesh)
        new_state = tell(state, values, result.scores)
        telemetry = result.telemetry
        if telemetry is None:
            telemetry = torch.zeros((0,), dtype=torch.int32, device=device)
        return new_state, result.scores, result.stats, result.total_steps, telemetry

    return generation


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
    return _generation_body(
        env, policy, ask=ask, tell=tell, popsize=popsize, mesh=mesh, device=resolve_device(device), **rollout_kwargs
    )


def make_training_span(
    env, policy, *, ask: Callable, tell: Callable, popsize: int, span: int, mesh: Optional[Mesh] = None,
    device=None, donate_state: bool = True, state_metrics: Optional[Callable] = None, **rollout_kwargs,
):  # fmt: skip
    """``span`` generations of ``make_generation_step`` as one call: the
    same generation body, run ``span`` times, so the result is that of
    ``span`` sequential ``make_generation_step`` calls given the same
    generators, bit for bit, at any mesh (padded popsizes included). The
    observation statistics are carried from one generation to the next.

    ``ask``, ``tell``, ``popsize``, ``mesh``, ``device`` and
    ``rollout_kwargs`` mean what they mean for ``make_generation_step``.
    ``eval_mode="episodes_compact"`` is refused: compaction is driven from
    the host (chunks re-dispatched as lanes finish), so it cannot be one
    fused span; ``episodes_refill`` is the on-device work-conserving
    contract. ``state_metrics(state) -> pytree`` (e.g.
    ``algorithms.functional.pgpe_health``) is evaluated on the state after
    every tell and stacked. ``donate_state`` is accepted for the JAX
    package's signature: eager PyTorch donates nothing, and the functional
    states are never changed in place.

    Returns ``training_span(state, generators, stats) -> (state, scores,
    stats, total_steps, telemetry[, metrics])``. ``generators`` holds one
    ``torch.Generator`` per generation (the same object ``span`` times to
    draw every generation from one stream), where the JAX package takes a
    ``(span,)`` key array; every rank of a mesh passes generators seeded
    alike. The outputs are stacked per generation: ``scores (span,
    popsize)``, ``total_steps (span,)`` int64, ``telemetry (span, 1, 20)``
    int32 (``(span, 0)`` with telemetry off; decode it row by row, as
    ``VecNE.consume_span`` does), and the stacked ``state_metrics``."""
    _check_reserved(rollout_kwargs, "make_training_span")
    span = int(span)
    if span < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    if rollout_kwargs.get("eval_mode") == "episodes_compact":
        raise ValueError(
            "make_training_span cannot fuse eval_mode='episodes_compact': lane compaction is driven from the host"
            " (chunks re-dispatched as lanes finish) and cannot run inside one fused span; use 'episodes_refill' for"
            " the on-device work-conserving contract"
        )
    device = resolve_device(device)
    generation = _generation_body(
        env, policy, ask=ask, tell=tell, popsize=popsize, mesh=mesh, device=device, **rollout_kwargs
    )

    def training_span(state, generators, stats):
        generators = [generators] if isinstance(generators, torch.Generator) else list(generators)
        if len(generators) != span:
            raise ValueError(
                f"training_span expects span={span} generators, one per generation (the same generator {span} times"
                f" for one stream), got {len(generators)}"
            )
        # The generations run one after another in eager PyTorch, each
        # reading back only what one make_generation_step call reads; a CUDA
        # graph of the span waits for the graph of one control step.
        scores, telemetry, metrics = [], [], []
        steps = torch.empty((span,), dtype=torch.int64, device=device)
        for g, generator in enumerate(generators):
            state, gen_scores, stats, gen_steps, gen_telemetry = generation(state, generator, stats)
            scores.append(gen_scores)
            telemetry.append(gen_telemetry)
            steps[g].fill_(gen_steps)  # a fill from a host int: no copy, no host sync
            if state_metrics is not None:
                metrics.append(state_metrics(state))
        out = (state, torch.stack(scores), stats, steps, torch.stack(telemetry))
        return out + (stack_trees(metrics),) if state_metrics is not None else out

    return training_span
