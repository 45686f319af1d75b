"""The registered programs of the port (counterpart of
``evotorch_tpu/observability/inventory.py``).

One place declares which programs make up the framework, so that the
program ledger (:mod:`~evotorch_tpu_torch.observability.programs`), the
report CLI and the regression gate of the CPU tests see the same surface:

- the four eval contracts' rollouts (``budget``, ``episodes``,
  ``episodes_refill``, and the full-width chunk of ``episodes_compact``)
  and the trunk-delta forms of ``budget`` and ``episodes_refill``;
- the functional PGPE ask and tell, and ``make_search_span`` over batched
  CEM searches;
- ``make_generation_step``, dense and trunk-delta, and
  ``make_training_span``;
- ``make_resident_rollout_program``;
- the sharded rollout evaluator, over the default group, only where a
  process group is initialized (so the gate's inventory, captured without
  one, does not hold it).

Each is built at a *gate shape* (:class:`GateConfig`, tiny by default, so a
whole capture takes seconds on the CPU). Op counts per control step and
FLOPs scale with the shape for a fixed structure, so a structural change at
the gate shape is one at the flagship too.

Programs of the JAX inventory with no port counterpart are left out by
name: ``bench.generation`` (``bench.py``'s jitted generation: the port's
is ``make_generation_step``), ``multichip.generation`` (``shard_map`` over
XLA devices), and ``gspmd.generation`` / ``gspmd.training_span`` (the
GSPMD-partitioned programs: the port shards over a process group, and its
generation step and span are the ones above). The JAX ``donated_programs``
sweep has none either: every capture checks that its program leaves its
inputs alone.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .programs import ProgramLedger, ProgramRecord, ledger, program_key

__all__ = [
    "GateConfig",
    "ProgramSpec",
    "build_specs",
    "capture_compact_chunk",
    "capture_inventory",
    "inventory_keys",
]


@dataclass(frozen=True)
class GateConfig:
    """The shapes of an inventory capture. The defaults are the gate shapes
    held in ``ledger_baseline.json``; the report CLI's ``--flagship`` swaps
    in the benchmark's."""

    env_name: str = "cartpole"
    popsize: int = 8
    episode_length: int = 16
    hidden: Tuple[int, ...] = (8,)
    refill_width: int = 4
    chunk_size: int = 8
    trunk_rank: int = 4
    batched_searches: int = 4
    batched_dim: int = 8
    batched_popsize: int = 8
    batched_generations: int = 3
    span: int = 3


@dataclass(frozen=True)
class ProgramSpec:
    """One registered program: its (name, shape) identity and a function
    that captures it into a ledger."""

    name: str
    shape: Dict[str, Any] = field(compare=False, default_factory=dict)
    capture: Callable[[ProgramLedger], ProgramRecord] = field(compare=False, default=None)

    @property
    def key(self) -> str:
        return program_key(self.name, self.shape)


def _env_policy(env_name: str, hidden: Tuple[int, ...], device: torch.device):
    from ..envs import make_env
    from ..neuroevolution.net import FlatParamsPolicy, tanh_mlp

    env = make_env(env_name, device=device)
    return env, FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, list(hidden)))


def _fresh_pgpe_state(parameter_count: int, device: torch.device):
    from ..algorithms.functional import pgpe

    return pgpe(
        center_init=torch.zeros(parameter_count, dtype=torch.float32, device=device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=0.1,
    )


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _steps_issued(loop_stats: dict, times: int = 1) -> Callable[[Any], int]:
    """A capture's ``control_steps``: the loop iterations the rollout
    issued (``times`` rollouts of the same count, as a budget span)."""
    return lambda _: times * int(loop_stats["steps_issued"])


def capture_compact_chunk(
    led: ProgramLedger,
    env,
    policy,
    popsize: int,
    episode_length: int,
    *,
    chunk_size: int,
    compute_dtype=None,
    name: str = "rollout.episodes_compact.chunk",
    shape: Optional[Dict[str, Any]] = None,
) -> ProgramRecord:
    """Capture the lane-compacting runner's full-width chunk: ``chunk_size``
    control steps of the episodes step at all ``popsize`` lanes, from a
    fresh carry. It dominates the cost of ``episodes_compact`` (the width
    descent reruns the same step on fewer lanes). Shared by the inventory
    and the autotuner's ``CompactHarness``, so that the two cannot
    drift."""
    from ..neuroevolution.net import vecrl
    from ..neuroevolution.net.runningnorm import RunningNorm

    device = env.device
    params = torch.zeros((popsize, policy.parameter_count), dtype=torch.float32, device=device)
    stats = RunningNorm(env.observation_size, device=device).stats
    max_t = vecrl._max_t(env, episode_length)
    options = vecrl._make_options(False, None, None, compute_dtype, None)
    ctx, store = vecrl._forward_ctx(policy, vecrl._params_cast(params, options))
    forward = functools.partial(vecrl._batched_forward, policy, ctx)
    lanes = vecrl._lane_view(popsize, None, None, None, device)
    table, noise_table = vecrl._local_tables(
        env, None, None, _generator(device), options, lanes, num_episodes=1, max_t=max_t, device=device
    )
    stats_fn = vecrl._stats_fn(vecrl._ALONE, options, lanes)
    carry = vecrl._episodes_init(
        env, policy, store, table, stats, options, lanes=lanes, stats_fn=stats_fn, num_episodes=1, lane_steps=False
    )
    step = vecrl._make_episodes_step(
        env, policy, table, noise_table, popsize=popsize, num_episodes=1, max_t=max_t, options=options,
        forward=forward, stats_fn=stats_fn,
    )  # fmt: skip

    def chunk(carry, num_steps: int):
        for _ in range(num_steps):
            carry = step(carry)
        return carry

    return led.capture(name, chunk, carry, shape=shape, control_steps=int(chunk_size), num_steps=int(chunk_size))


def _process_group_size() -> Optional[int]:
    """The default group's world size, or None without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def build_specs(cfg: Optional[GateConfig] = None, *, device=None) -> List[ProgramSpec]:
    """The registered programs at ``cfg``'s shapes on ``device`` (the card
    unless ``device="cpu"``; raises without one). Building specs makes the
    env and the policy only; each capture builds and runs its program."""
    from .._device import resolve_device
    from ..algorithms.functional import (
        cem,
        cem_ask,
        cem_tell,
        make_search_span,
        pgpe_ask,
        pgpe_ask_trunk_delta,
        pgpe_tell,
        pgpe_tell_trunk_delta,
    )
    from ..neuroevolution.net.runningnorm import RunningNorm
    from ..neuroevolution.net.vecrl import run_vectorized_rollout
    from ..parallel.evaluate import (
        make_generation_step,
        make_resident_rollout_program,
        make_sharded_rollout_evaluator,
        make_training_span,
    )

    cfg = cfg if cfg is not None else GateConfig()
    device = resolve_device(device)
    env, policy = _env_policy(cfg.env_name, cfg.hidden, device)
    L = policy.parameter_count
    base_shape = {"env": cfg.env_name, "popsize": cfg.popsize, "episode_length": cfg.episode_length, "params": L}
    trunk_shape = dict(base_shape, rank=cfg.trunk_rank)
    specs: List[ProgramSpec] = []

    def add(name, shape, capture):
        specs.append(ProgramSpec(name=name, shape=shape, capture=capture))

    def stats():
        return RunningNorm(env.observation_size, device=device).stats

    def population():
        return pgpe_ask(_generator(device, 1), _fresh_pgpe_state(L, device), popsize=cfg.popsize)

    def trunk_population():
        state = _fresh_pgpe_state(L, device)
        return pgpe_ask_trunk_delta(_generator(device, 1), state, popsize=cfg.popsize, rank=cfg.trunk_rank, policy=policy)

    def rollout_capture(name, mode, shape, params, **extra):
        def _capture(led):
            loop_stats = {}
            return led.capture(
                name, run_vectorized_rollout, env, policy, params(), _generator(device), stats(), shape=shape,
                control_steps=_steps_issued(loop_stats), num_episodes=1, episode_length=cfg.episode_length,
                eval_mode=mode, loop_stats=loop_stats, **extra,
            )  # fmt: skip

        return _capture

    for mode in ("budget", "episodes"):
        add(f"rollout.{mode}", base_shape, rollout_capture(f"rollout.{mode}", mode, base_shape, population))
    refill_shape = dict(base_shape, width=cfg.refill_width)
    add(
        "rollout.episodes_refill",
        refill_shape,
        rollout_capture("rollout.episodes_refill", "episodes_refill", refill_shape, population, refill_width=cfg.refill_width),
    )
    compact_shape = dict(base_shape, chunk=cfg.chunk_size)
    add(
        "rollout.episodes_compact.chunk",
        compact_shape,
        lambda led: capture_compact_chunk(
            led, env, policy, cfg.popsize, cfg.episode_length, chunk_size=cfg.chunk_size, shape=compact_shape
        ),
    )
    add(
        "rollout.budget.trunk_delta",
        trunk_shape,
        rollout_capture("rollout.budget.trunk_delta", "budget", trunk_shape, trunk_population),
    )
    trunk_refill_shape = dict(trunk_shape, width=cfg.refill_width)
    add(
        "rollout.episodes_refill.trunk_delta",
        trunk_refill_shape,
        rollout_capture(
            "rollout.episodes_refill.trunk_delta", "episodes_refill", trunk_refill_shape, trunk_population,
            refill_width=cfg.refill_width,
        ),
    )  # fmt: skip

    ask_shape = {"popsize": cfg.popsize, "params": L}
    add(
        "gaussian.ask",
        ask_shape,
        lambda led: led.capture(
            "gaussian.ask", pgpe_ask, _generator(device), _fresh_pgpe_state(L, device), shape=ask_shape,
            popsize=cfg.popsize,
        ),
    )  # fmt: skip

    def tell_capture(led):
        fitnesses = torch.linspace(-1.0, 1.0, cfg.popsize, device=device)
        return led.capture("gaussian.tell", pgpe_tell, _fresh_pgpe_state(L, device), population(), fitnesses, shape=ask_shape)

    add("gaussian.tell", ask_shape, tell_capture)

    batched_shape = {
        "searches": cfg.batched_searches,
        "dim": cfg.batched_dim,
        "popsize": cfg.batched_popsize,
        "generations": cfg.batched_generations,
    }

    def batched_capture(led):
        span_fn = make_search_span(
            lambda pop: torch.sum(pop**2, dim=-1),
            ask=functools.partial(cem_ask, popsize=cfg.batched_popsize),
            tell=cem_tell,
            metrics=lambda pop, fit: torch.min(fit, dim=-1).values,
        )
        centers = 3.0 * torch.randn((cfg.batched_searches, cfg.batched_dim), generator=_generator("cpu"))
        state = cem(
            center_init=centers.to(device), parenthood_ratio=0.5, objective_sense="min", stdev_init=2.0,
            stdev_max_change=0.2,
        )  # fmt: skip
        return led.capture(
            "functional_batched_search", span_fn, state, [_generator(device, 1)] * cfg.batched_generations,
            shape=batched_shape, control_steps=cfg.batched_generations,
        )  # fmt: skip

    add("functional_batched_search", batched_shape, batched_capture)

    def generation_capture(name, shape, ask, tell, span=None):
        def _capture(led):
            loop_stats = {}
            kwargs = dict(
                ask=ask, tell=tell, popsize=cfg.popsize, device=device, num_episodes=1,
                episode_length=cfg.episode_length, eval_mode="budget", loop_stats=loop_stats,
            )  # fmt: skip
            if span is None:
                fn, generators = make_generation_step(env, policy, **kwargs), _generator(device)
            else:
                fn, generators = make_training_span(env, policy, span=span, **kwargs), [_generator(device)] * span
            return led.capture(
                name, fn, _fresh_pgpe_state(L, device), generators, stats(), shape=shape,
                control_steps=_steps_issued(loop_stats, span or 1),
            )  # fmt: skip

        return _capture

    dense_ask = functools.partial(pgpe_ask, popsize=cfg.popsize)
    trunk_ask = functools.partial(pgpe_ask_trunk_delta, popsize=cfg.popsize, rank=cfg.trunk_rank, policy=policy)
    add("generation_step", base_shape, generation_capture("generation_step", base_shape, dense_ask, pgpe_tell))
    add(
        "generation_step.trunk_delta",
        trunk_shape,
        generation_capture("generation_step.trunk_delta", trunk_shape, trunk_ask, pgpe_tell_trunk_delta),
    )
    span_shape = dict(base_shape, span=cfg.span)
    add("training_span", span_shape, generation_capture("training_span", span_shape, dense_ask, pgpe_tell, span=cfg.span))

    def resident_capture(led):
        loop_stats = {}
        program = make_resident_rollout_program(
            env, policy, device=device, num_episodes=1, episode_length=cfg.episode_length,
            refill_width=cfg.refill_width, loop_stats=loop_stats,
        )  # fmt: skip
        return led.capture(
            "resident_program", program, population(), _generator(device), stats(), shape=refill_shape,
            control_steps=_steps_issued(loop_stats),
        )  # fmt: skip

    add("resident_program", refill_shape, resident_capture)

    world = _process_group_size()
    if world is not None:
        sharded_shape = dict(base_shape, mesh=world)

        def sharded_capture(led):
            loop_stats = {}
            evaluator = make_sharded_rollout_evaluator(
                env, policy, num_episodes=1, episode_length=cfg.episode_length, eval_mode="budget",
                loop_stats=loop_stats,
            )  # fmt: skip
            return led.capture(
                "sharded_evaluator", evaluator, population(), _generator(device), stats(), shape=sharded_shape,
                control_steps=_steps_issued(loop_stats),
            )  # fmt: skip

        add("sharded_evaluator", sharded_shape, sharded_capture)
    return specs


def inventory_keys(cfg: Optional[GateConfig] = None, *, device=None) -> List[str]:
    return [spec.key for spec in build_specs(cfg, device=device)]


def capture_inventory(
    cfg: Optional[GateConfig] = None, led: Optional[ProgramLedger] = None, *, device=None, strict: bool = True
) -> Tuple[List[ProgramRecord], Dict[str, str]]:
    """Capture every registered program into ``led`` (the process ledger by
    default). Returns ``(records, errors)``; with ``strict`` (the default)
    the first failing capture raises instead."""
    led = led if led is not None else ledger
    records: List[ProgramRecord] = []
    errors: Dict[str, str] = {}
    for spec in build_specs(cfg, device=device):
        try:
            records.append(spec.capture(led))
        except Exception as e:  # a report lists what failed; strict re-raises
            if strict:
                raise
            errors[spec.key] = f"{type(e).__name__}: {e}"
    return records, errors
