"""The autotuner: measured telemetry, not guesses, picks the eval schedule
(counterpart of ``evotorch_tpu/observability/autotune.py``).

The loop::

    on-device counters --> trial harness --> measured-timing ledger
      (occupancy,          (interleaved      (timings.TimingLedger:
       queue_wait,          medians)          steps/s, occupancy, first-use
       refill_events)            |            count per machine key)
                                 |                      |
    program ledger --> analytic pruning           winner persisted
      (peak bytes,      (before any timing)             |
       FLOPs)                                           v
                                           tuned_configs.json --> VecNE, GymNE,
                                                                  the host engines,
                                                                  the sharded evaluator

Three layers:

- **The pure search core**: :func:`candidate_grid`, :func:`neighborhood`,
  :func:`analytic_prune`, :func:`successive_halving`, :func:`select_winner`,
  :func:`autotune_search`. Deterministic and free of torch and clocks, so
  the tests run it on synthetic measurements against the JAX package's.
  Selection is on medians, with an occupancy floor on the winner.
- **The trial harnesses**: :class:`RefillHarness`, :class:`CompactHarness`,
  :class:`PolicyHarness`, :class:`SpanHarness` (the device knobs of the
  eval contracts) and :class:`HostPipelineHarness` (the host path's).
  Candidates are interleaved within each sweep of trials in one process.
  Each timed call runs from a drained card to a drained card
  (``torch.cuda.synchronize`` before and after) inside the first-use
  sentinel (:func:`~evotorch_tpu_torch.analysis.track_first_use`): a kernel
  built or an allocator segment allocated inside it lands in
  ``steady_compiles`` and bars the winner from the cache. The telemetry is
  decoded after the clock stops, and each trial records an
  ``autotune.trial`` span on the host tracer with the candidate as its
  arguments.
- **The CLI**: ``python -m evotorch_tpu_torch.observability.autotune``
  tunes the requested groups at the benchmark's shapes (the ``BENCH_*``
  knobs honored), records every candidate in the measured-timing ledger
  and persists each winner to the tuned-config cache
  (:mod:`~evotorch_tpu_torch.observability.timings`). It runs on the card
  unless given ``--device cpu`` and exits non-zero without one: a tuning
  run never falls back to the CPU on its own.

Where the JAX harnesses pay an XLA compile in their warm-up, eager torch
compiles nothing: a width or chunk candidate's warm-up runs it at its own
shapes with the episodes cut to :data:`WARMUP_STEPS` control steps, which
allocates its buffers. A candidate's cost is captured through the program
ledger with the episodes cut the same way (the counters slow a run down,
so they never run inside a timed trial), its FLOPs scaled to the
configured episode length. Where the JAX harnesses fold a fresh key per
call, each timed call here gets a fresh ``torch.Generator`` seeded from a
base seed and a nonce; the population is drawn once per harness by the
port's ``pgpe_ask``, which launches the sampling kernel on the card.
"""

from __future__ import annotations

import itertools
import math
import time
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import tracer
from .timings import TimingLedger, TimingRecord, TunedEntry, _median, dtype_label, machine_fingerprint, timings

__all__ = [
    "CandidateStats",
    "CompactHarness",
    "HostPipelineHarness",
    "KnobGroup",
    "KnobSpec",
    "PolicyHarness",
    "RefillHarness",
    "SearchOutcome",
    "SpanHarness",
    "TuneShape",
    "analytic_prune",
    "autotune_search",
    "candidate_grid",
    "neighborhood",
    "select_winner",
    "successive_halving",
    "tune_group",
]

#: control steps a warm-up or a cost capture runs (episodes cut to this)
WARMUP_STEPS = 4


# ---------------------------------------------------------------------------
# the pure search core (no torch, no clocks: the tests run it synthetically)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KnobSpec:
    """One tunable knob: a name and its ORDERED value grid. ``refine``
    marks knobs whose neighborhood may propose off-grid midpoints (widths
    and chunk sizes are continuous-ish integers; a boolean or enum knob
    sets it False)."""

    name: str
    values: Tuple[Any, ...]
    refine: bool = True


@dataclass(frozen=True)
class KnobGroup:
    """A named set of knobs tuned together (one cache entry per group)."""

    name: str
    knobs: Tuple[KnobSpec, ...]


def candidate_grid(group: KnobGroup) -> List[Dict[str, Any]]:
    """The full cartesian candidate grid, in deterministic knob-major
    order (the order is load-bearing: ties in the search break toward
    earlier candidates, so grids should list preferred defaults first)."""
    names = [k.name for k in group.knobs]
    return [
        dict(zip(names, combo))
        for combo in itertools.product(*(k.values for k in group.knobs))
    ]


def neighborhood(group: KnobGroup, config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One-knob-at-a-time refinements around ``config``: for each
    refinable integer knob, the (rounded) midpoints between its current
    value and the adjacent grid values. Off-grid by construction —
    candidates already in the grid were already measured — and
    deterministic (no randomness anywhere in the core)."""
    out: List[Dict[str, Any]] = []
    seen = set()
    for knob in group.knobs:
        if not knob.refine:
            continue
        current = config.get(knob.name)
        if not isinstance(current, int):
            continue
        values = sorted(v for v in knob.values if isinstance(v, int))
        if current not in values:
            continue
        i = values.index(current)
        for j in (i - 1, i + 1):
            if not (0 <= j < len(values)):
                continue
            mid = (current + values[j]) // 2
            if mid in values or mid == current or mid <= 0:
                continue
            candidate = dict(config, **{knob.name: mid})
            key = tuple(sorted(candidate.items()))
            if key not in seen:
                seen.add(key)
                out.append(candidate)
    return out


def analytic_prune(
    candidates: Sequence[Dict[str, Any]],
    cost_fn: Optional[Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]],
    *,
    hbm_budget_bytes: Optional[float] = None,
    flops_bound: Optional[float] = None,
) -> Tuple[List[Dict[str, Any]], List[Tuple[Dict[str, Any], str]], Dict[int, Dict]]:
    """Reject candidates on the program ledger's cost before any wall-clock
    is spent on them: a candidate whose captured program peaks over the
    memory budget or exceeds the FLOPs bound never reaches the trial
    harness.

    ``cost_fn(config)`` returns ``{"peak_bytes", "flops",
    "compile_seconds"}`` (any field nullable) or ``None`` when no
    cost is available: an unknown cost never prunes.

    Returns ``(kept, pruned, costs)`` where ``pruned`` carries the
    human-readable reason and ``costs`` maps an index INTO ``kept`` (the
    surviving candidates, in order) to its cost dict, so the caller can
    attach ``compile_seconds`` to the matching measurement records."""
    kept: List[Dict[str, Any]] = []
    pruned: List[Tuple[Dict[str, Any], str]] = []
    costs: Dict[int, Dict] = {}
    for config in candidates:
        cost = cost_fn(config) if cost_fn is not None else None
        if cost is not None:
            peak = cost.get("peak_bytes")
            if (
                hbm_budget_bytes is not None
                and peak is not None
                and peak > hbm_budget_bytes
            ):
                pruned.append(
                    (
                        config,
                        f"peak_bytes {peak:.3g} exceeds HBM budget "
                        f"{hbm_budget_bytes:.3g}",
                    )
                )
                continue
            flops = cost.get("flops")
            if flops_bound is not None and flops is not None and flops > flops_bound:
                pruned.append(
                    (config, f"flops {flops:.3g} exceeds bound {flops_bound:.3g}")
                )
                continue
        if cost is not None:
            costs[len(kept)] = cost
        kept.append(config)
    return kept, pruned, costs


@dataclass
class CandidateStats:
    """Accumulated measurement state of one candidate across rounds."""

    config: Dict[str, Any]
    samples: List[float] = field(default_factory=list)
    occupancies: List[float] = field(default_factory=list)
    steady_compiles: int = 0
    refill_events: Optional[int] = None
    queue_wait: Optional[int] = None
    cost: Optional[Dict[str, Any]] = None

    @property
    def steps_per_sec(self) -> float:
        """The headline figure: the MEDIAN of every timed sample."""
        return _median(self.samples)

    @property
    def occupancy(self) -> Optional[float]:
        return _median(self.occupancies) if self.occupancies else None

    def merge(self, measurement: Dict[str, Any]) -> None:
        self.samples.extend(measurement.get("samples", ()))
        self.occupancies.extend(measurement.get("occupancies", ()))
        self.steady_compiles += int(measurement.get("steady_compiles", 0))
        for key in ("refill_events", "queue_wait"):
            value = measurement.get(key)
            if value is not None:
                setattr(self, key, value)


#: measure(configs, trials, round_index) -> one measurement dict per config,
#: each {"samples": [...], "occupancies": [...], "steady_compiles": int, ...}
MeasureFn = Callable[[List[Dict[str, Any]], int, int], List[Dict[str, Any]]]


def successive_halving(
    candidates: Sequence[Dict[str, Any]],
    measure: MeasureFn,
    *,
    trials_per_round: int = 3,
    survivor_frac: float = 0.5,
    min_survivors: int = 2,
    max_rounds: int = 2,
) -> List[CandidateStats]:
    """Successive halving on MEDIANS: every round measures all surviving
    candidates (``trials_per_round`` more samples each — the harness
    interleaves them in one process), then keeps the top
    ``survivor_frac`` by median steps/s. Survivors accumulate samples
    across rounds, so the final ranking rests on the most-measured
    medians. Deterministic: ties break toward the earlier candidate."""
    results = [CandidateStats(config=dict(c)) for c in candidates]
    alive = list(range(len(results)))
    trials = max(1, int(trials_per_round))
    for round_index in range(max(1, int(max_rounds))):
        if not alive:
            break
        measured = measure(
            [results[i].config for i in alive], trials, round_index
        )
        for i, m in zip(alive, measured):
            results[i].merge(m)
        if len(alive) <= min_survivors:
            break
        ranked = sorted(alive, key=lambda i: (-results[i].steps_per_sec, i))
        keep = max(min_survivors, math.ceil(len(alive) * survivor_frac))
        alive = sorted(ranked[:keep])
    return results


def select_winner(
    results: Sequence[CandidateStats],
    *,
    min_occupancy: Optional[float] = None,
    tolerance: Optional[float] = None,
    prefer: Optional[Callable[[Dict[str, Any]], Any]] = None,
) -> Optional[CandidateStats]:
    """Highest median steps/s among measured candidates meeting the
    occupancy floor — falling back to the unconstrained winner when none
    do (a floor must never select nothing). Candidates whose timed
    trials did first-use work (``steady_compiles``: a kernel build or a new
    allocator segment) are untrustworthy timings and lose to any clean
    candidate.

    ``tolerance`` + ``prefer`` select on a SECONDARY objective inside a
    throughput band: among candidates whose median steps/s is within
    ``tolerance`` (a fraction) of the best, the one maximizing
    ``prefer(config)`` wins, with throughput breaking preference ties.
    The policy group uses this — expressivity (rank) is worth a bounded
    throughput haircut, so the highest rank within the band wins rather
    than the outright-fastest rank-4 corner."""
    measured = [r for r in results if r.samples]
    if not measured:
        return None
    clean = [r for r in measured if r.steady_compiles == 0]
    pool = clean or measured
    if min_occupancy is not None:
        eligible = [
            r for r in pool if r.occupancy is not None and r.occupancy >= min_occupancy
        ]
        if eligible:
            pool = eligible
    best = max(pool, key=lambda r: r.steps_per_sec)
    if tolerance is None or prefer is None:
        return best
    floor = best.steps_per_sec * (1.0 - float(tolerance))
    near = [r for r in pool if r.steps_per_sec >= floor]
    return max(near, key=lambda r: (prefer(r.config), r.steps_per_sec))


@dataclass
class SearchOutcome:
    """Everything one group's search produced: ranked candidate stats
    (grid + refinement), the analytically-pruned configs with reasons,
    and the selected winner. ``cache_written`` is stamped by
    :func:`tune_group`: False when the winner was withheld from the cache
    (first-use work in a timed trial, occupancy floor not met, or
    ``write_cache`` off)."""

    results: List[CandidateStats]
    pruned: List[Tuple[Dict[str, Any], str]]
    winner: Optional[CandidateStats]
    cache_written: bool = False


def autotune_search(
    group: KnobGroup,
    measure: MeasureFn,
    *,
    cost_fn: Optional[Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]] = None,
    hbm_budget_bytes: Optional[float] = None,
    flops_bound: Optional[float] = None,
    trials_per_round: int = 3,
    survivor_frac: float = 0.5,
    min_survivors: int = 2,
    max_rounds: int = 2,
    min_occupancy: Optional[float] = None,
    tolerance: Optional[float] = None,
    prefer: Optional[Callable[[Dict[str, Any]], Any]] = None,
    refine: bool = True,
) -> SearchOutcome:
    """The full (pure) search: grid → analytic prune → successive
    halving → winner → one neighborhood-refinement round around the
    winner (off-grid midpoints, themselves prune-checked) → final
    winner. ``measure``/``cost_fn`` carry all the impurity; everything
    here is deterministic given their outputs. ``tolerance``/``prefer``
    pass through to :func:`select_winner` (secondary-objective
    selection inside a throughput band)."""
    grid = candidate_grid(group)
    kept, pruned, costs = analytic_prune(
        grid, cost_fn, hbm_budget_bytes=hbm_budget_bytes, flops_bound=flops_bound
    )
    results = successive_halving(
        kept,
        measure,
        trials_per_round=trials_per_round,
        survivor_frac=survivor_frac,
        min_survivors=min_survivors,
        max_rounds=max_rounds,
    )
    for index, cost in costs.items():
        results[index].cost = cost
    winner = select_winner(
        results, min_occupancy=min_occupancy, tolerance=tolerance, prefer=prefer
    )
    if refine and winner is not None:
        measured_keys = {tuple(sorted(r.config.items())) for r in results}
        fresh = [
            c
            for c in neighborhood(group, winner.config)
            if tuple(sorted(c.items())) not in measured_keys
        ]
        kept2, pruned2, costs2 = analytic_prune(
            fresh,
            cost_fn,
            hbm_budget_bytes=hbm_budget_bytes,
            flops_bound=flops_bound,
        )
        pruned.extend(pruned2)
        if kept2:
            refined = successive_halving(
                kept2,
                measure,
                trials_per_round=trials_per_round,
                survivor_frac=1.0,  # no halving inside one refinement round
                min_survivors=len(kept2),
                max_rounds=1,
            )
            for index, cost in costs2.items():
                refined[index].cost = cost
            results = results + refined
            winner = select_winner(
                results,
                min_occupancy=min_occupancy,
                tolerance=tolerance,
                prefer=prefer,
            )
    return SearchOutcome(results=results, pruned=pruned, winner=winner)


# ---------------------------------------------------------------------------
# trial harnesses (the impure half: torch programs, clocks, telemetry)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TuneShape:
    """The workload shape a tuning run measures at (the benchmark's)."""

    env_name: str = "humanoid"
    popsize: int = 1024
    episode_length: int = 100
    hidden: Tuple[int, ...] = (64, 64)
    compute_dtype: Any = None  # e.g. torch.bfloat16; None = float32
    num_episodes: int = 1

    def as_dict(self) -> Dict[str, Any]:
        return {"env": self.env_name, "popsize": self.popsize, "episode_length": self.episode_length}


def _fresh_pgpe_state(parameter_count: int, device):
    import torch

    from ..algorithms.functional import pgpe

    return pgpe(
        center_init=torch.zeros(parameter_count, dtype=torch.float32, device=device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=0.1,
    )


def _cost_of(record, steps: int) -> Dict[str, Any]:
    """A candidate's cost dict from its capture (episodes cut short): the
    FLOPs scaled from a control step to ``steps``."""
    return {
        "peak_bytes": record.peak_bytes,
        "flops": None if record.flops_per_step is None else record.flops_per_step * steps,
        "compile_seconds": record.compile_seconds,
    }


class _BespokeHarness:
    """What the device-program harnesses share: one env, policy and
    population built once; a fresh generator per call, seeded from a base
    seed and a nonce (never reused); timed trials interleaved, each from a
    drained card to a drained card inside the first-use sentinel;
    telemetry decoded after the clock stops; an ``autotune.trial`` span per
    timed call. Runs on the card unless ``device="cpu"``."""

    group = ""  # knob group, the cache entry's name
    program = ""  # the timing ledger's program name
    #: the group's winner floor (None: throughput only)
    default_min_occupancy: Optional[float] = None
    #: secondary-objective selection (select_winner's tolerance/prefer)
    winner_tolerance: Optional[float] = None
    winner_prefer: Optional[Callable[[Dict[str, Any]], Any]] = None

    def __init__(self, shape: TuneShape, *, seed: int = 0, device=None):
        import torch

        from .._device import resolve_device
        from ..algorithms.functional import pgpe_ask
        from ..envs import make_env
        from ..neuroevolution.net import FlatParamsPolicy, tanh_mlp
        from ..neuroevolution.net.runningnorm import RunningNorm

        self.shape = shape
        self.device = resolve_device(device)
        self.env = make_env(shape.env_name, device=self.device)
        self.policy = FlatParamsPolicy(tanh_mlp(self.env.observation_size, self.env.action_size, list(shape.hidden)))
        # one fixed population for every candidate and trial: candidates
        # compete on the same work, so the schedule is all that differs
        state = _fresh_pgpe_state(self.policy.parameter_count, self.device)
        self.values = pgpe_ask(torch.Generator(device=self.device).manual_seed(seed), state, popsize=shape.popsize)
        self.stats = RunningNorm(self.env.observation_size, device=self.device).stats
        self._base_seed = int(seed) + 1
        self._nonce = itertools.count()
        self._episodes_baseline: Optional[Dict[str, Any]] = None
        self._warmed_configs: set = set()
        #: one row per timed call, in order: label, config, steps/s,
        #: occupancy, control steps (capacity over lane width), whether
        #: every score was finite, first-use count
        self.trials: List[Dict[str, Any]] = []
        self._sync()

    # -- per-candidate runners (overridden) ---------------------------------
    def run_once(self, config: Dict[str, Any], generator, *, episode_length: Optional[int] = None):
        """One evaluation of ``config`` drawing from ``generator``; with
        ``episode_length`` the episodes are cut to it (a warm-up)."""
        raise NotImplementedError

    def tuned_config(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """The cache entry's config keys of a harness config."""
        return dict(config)

    def default_config(self) -> Optional[Dict[str, Any]]:
        """The built-in default candidate: the anchor of the relative memory
        budget (the default is feasible by definition)."""
        return None

    def knob_group(self) -> KnobGroup:
        raise NotImplementedError

    def cost(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return None

    # -- the shared measurement machinery ------------------------------------
    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_generator(self):
        import torch

        # a fresh stream per call: the nonce makes every seed unique
        seed = (self._base_seed << 32) + next(self._nonce)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _rollout_kwargs(self, episode_length: Optional[int] = None) -> Dict[str, Any]:
        return dict(
            num_episodes=self.shape.num_episodes,
            episode_length=self.shape.episode_length if episode_length is None else episode_length,
            compute_dtype=self.shape.compute_dtype,
        )

    def _capture(self, runner, config: Dict[str, Any]) -> Dict[str, Any]:
        """The cost of ``runner(generator, loop_stats)`` (episodes cut to
        :data:`WARMUP_STEPS`) through the program ledger."""
        from .programs import ProgramLedger

        loop_stats: dict = {}
        record = ProgramLedger().capture(
            self.program, runner, self._next_generator(), loop_stats, shape=dict(self.shape.as_dict(), **config),
            control_steps=lambda _: loop_stats["steps_issued"], device=self.device,
        )  # fmt: skip
        return _cost_of(record, self.shape.episode_length * self.shape.num_episodes)

    def _timed_call(self, label: str, config: Dict[str, Any], runner):
        """One timed trial: the card drained, the clock started, the run,
        the card drained, the clock stopped, all inside the first-use
        sentinel; the telemetry decoded afterwards. Returns
        ``(steps_per_sec, telemetry, first_uses)``."""
        from ..analysis import track_first_use
        from .devicemetrics import EvalTelemetry

        generator = self._next_generator()
        with tracer.span("autotune.trial", "autotune", group=label, **config):
            self._sync()
            with track_first_use() as first_use:
                t0 = time.perf_counter()
                result = runner(generator)
                self._sync()
                elapsed = time.perf_counter() - t0
        import torch

        steps = int(result.total_steps)
        sps = steps / elapsed if elapsed > 0 else 0.0
        telemetry = EvalTelemetry.from_array(result.telemetry) if result.telemetry is not None else None
        self.trials.append(
            {
                "label": label,
                "config": dict(config),
                "steps_per_sec": sps,
                "occupancy": None if telemetry is None else telemetry.occupancy,
                "control_steps": (
                    telemetry.capacity // telemetry.lane_width if telemetry is not None and telemetry.lane_width else None
                ),
                "finite": bool(torch.isfinite(result.scores).all()),
                "first_uses": first_use.count,
            }
        )
        return sps, telemetry, first_use.count

    def _warm(self, config: Dict[str, Any]) -> None:
        """Once per candidate per search: run it at its own shapes with the
        episodes cut, so that its buffers are allocated before any clock."""
        key = tuple(sorted(config.items()))
        if key not in self._warmed_configs:
            self._warmed_configs.add(key)
            self.run_once(config, self._next_generator(), episode_length=WARMUP_STEPS)
            self._sync()

    def measure(self, configs: List[Dict[str, Any]], trials: int, round_index: int) -> List[Dict[str, Any]]:
        """The real MeasureFn: warm every candidate, then interleave the
        candidates within each sweep of trials, so that the host's drift
        hits them alike."""
        for config in configs:
            self._warm(config)
        out = [{"samples": [], "occupancies": [], "steady_compiles": 0} for _ in configs]
        for _ in range(trials):
            for i, config in enumerate(configs):
                sps, telemetry, first_uses = self._timed_call(
                    self.group, config, lambda generator, c=config: self.run_once(c, generator)
                )
                out[i]["samples"].append(sps)
                out[i]["steady_compiles"] += first_uses
                if telemetry is not None:
                    out[i]["occupancies"].append(telemetry.occupancy)
                    out[i]["refill_events"] = telemetry.refill_events
                    out[i]["queue_wait"] = telemetry.queue_wait
        return out

    def _baseline_from(self, label: str, runner, trials: int, *, warm) -> Dict[str, Any]:
        if self._episodes_baseline is None:
            warm()
            self._sync()
            samples, occupancies = [], []
            for _ in range(max(1, trials)):
                sps, telemetry, _ = self._timed_call(label, {"contract": label}, runner)
                samples.append(sps)
                if telemetry is not None:
                    occupancies.append(telemetry.occupancy)
            self._episodes_baseline = {
                "steps_per_sec": _median(samples),
                "occupancy": _median(occupancies) if occupancies else None,
                "samples": samples,
            }
        return self._episodes_baseline

    def _contract_runner(self, eval_mode: str, episode_length: Optional[int] = None):
        from ..neuroevolution.net.vecrl import run_vectorized_rollout

        def runner(generator):
            return run_vectorized_rollout(
                self.env, self.policy, self.values, generator, self.stats, eval_mode=eval_mode,
                **self._rollout_kwargs(episode_length),
            )  # fmt: skip

        return runner

    def baseline(self, trials: int = 3) -> Dict[str, Any]:
        """Median steps/s of the plain ``episodes`` contract at the same
        shape and population, measured in this process: the denominator of
        ``speedup_vs_baseline``."""
        warm = self._contract_runner("episodes", WARMUP_STEPS)
        return self._baseline_from(
            "episodes", self._contract_runner("episodes"), trials, warm=lambda: warm(self._next_generator())
        )


def _pow2_menu(values, lo: int, hi: int) -> Tuple[int, ...]:
    return tuple(sorted({int(v) for v in values if lo <= int(v) <= hi}))


class RefillHarness(_BespokeHarness):
    """Tunes the ``episodes_refill`` scheduler: lane width and refill
    period. The default width menu brackets the engine's work/8 default
    with the 64-512 rungs, so the search always measures the default it
    might replace."""

    group = "refill"
    program = "rollout.episodes_refill"
    #: a refill schedule that starves its lanes must not win on a lucky run
    default_min_occupancy: Optional[float] = 0.9

    def __init__(
        self, shape: TuneShape, *, widths: Optional[Sequence[int]] = None, periods: Sequence[int] = (1,), seed: int = 0,
        device=None,
    ):  # fmt: skip
        super().__init__(shape, seed=seed, device=device)
        from ..neuroevolution.net.vecrl import _default_refill_width

        total_items = shape.popsize * shape.num_episodes
        if widths is None:
            base = _default_refill_width(total_items)
            widths = _pow2_menu((64, 128, 256, 512, base // 2, base, base * 2), lo=8, hi=total_items)
        self.widths = tuple(int(w) for w in widths)
        if not self.widths:
            raise ValueError(
                f"empty refill width menu for work-list size {total_items} (the default rungs all fall outside"
                " [8, work]); pass --widths explicitly"
            )
        self.periods = tuple(int(p) for p in periods)
        self._default_width = min(_default_refill_width(total_items), max(self.widths))

    def default_config(self):
        return {"refill_width": self._default_width, "refill_period": self.periods[0]}

    def knob_group(self) -> KnobGroup:
        return KnobGroup(
            name=self.group,
            knobs=(KnobSpec("refill_width", self.widths), KnobSpec("refill_period", self.periods, refine=False)),
        )

    def run_once(self, config, generator, *, episode_length=None, loop_stats=None):
        from ..neuroevolution.net.vecrl import run_vectorized_rollout

        return run_vectorized_rollout(
            self.env, self.policy, self.values, generator, self.stats, eval_mode="episodes_refill",
            refill_width=int(config["refill_width"]), refill_period=int(config.get("refill_period", 1)),
            loop_stats=loop_stats, **self._rollout_kwargs(episode_length),
        )  # fmt: skip

    def cost(self, config):
        """The candidate's peak bytes and FLOPs, captured through the
        program ledger with the episodes cut short (outside every timed
        trial)."""
        return self._capture(
            lambda generator, loop_stats: self.run_once(config, generator, episode_length=WARMUP_STEPS, loop_stats=loop_stats),
            config,
        )

    def tuned_config(self, config):
        return {"width": int(config["refill_width"]), "period": int(config.get("refill_period", 1))}


class CompactHarness(_BespokeHarness):
    """Tunes the lane-compacting runner: the host chunk size and the width
    menu's floor."""

    group = "compact"
    program = "rollout.episodes_compact"
    #: compaction runs below full occupancy by design (each chunk pads to
    #: its slowest survivor), so a refill-style floor would bar every
    #: winner: select on throughput
    default_min_occupancy: Optional[float] = None

    def __init__(
        self, shape: TuneShape, *, chunks: Sequence[int] = (10, 25, 50), min_widths: Sequence[int] = (128, 256, 512),
        seed: int = 0, device=None,
    ):  # fmt: skip
        super().__init__(shape, seed=seed, device=device)
        total = shape.popsize * shape.num_episodes
        self.chunks = tuple(int(c) for c in chunks)
        self.min_widths = tuple(w for w in (int(w) for w in min_widths) if w < total)
        if not self.min_widths:
            raise ValueError(
                f"no min_width candidate below the work-list size {total}; pass --min-widths values smaller than"
                " popsize*num_episodes"
            )

    def default_config(self):
        chunk = 25 if 25 in self.chunks else self.chunks[0]
        width = 256 if 256 in self.min_widths else self.min_widths[0]
        return {"chunk_size": chunk, "min_width": width}

    def knob_group(self) -> KnobGroup:
        return KnobGroup(name=self.group, knobs=(KnobSpec("chunk_size", self.chunks), KnobSpec("min_width", self.min_widths)))

    def run_once(self, config, generator, *, episode_length=None):
        from ..neuroevolution.net.vecrl import run_vectorized_rollout_compacting

        return run_vectorized_rollout_compacting(
            self.env, self.policy, self.values, generator, self.stats, chunk_size=int(config["chunk_size"]),
            min_width=int(config["min_width"]), **self._rollout_kwargs(episode_length),
        )  # fmt: skip

    def cost(self, config):
        """The cost of the full-width chunk, the dominant unit of the
        contract (the width descent reruns the same step on fewer lanes)."""
        from .inventory import capture_compact_chunk
        from .programs import ProgramLedger

        record = capture_compact_chunk(
            ProgramLedger(), self.env, self.policy, self.shape.popsize, self.shape.episode_length,
            chunk_size=int(config["chunk_size"]), compute_dtype=self.shape.compute_dtype, name=self.program + ".chunk",
            shape=dict(self.shape.as_dict(), **config),
        )  # fmt: skip
        return _cost_of(record, self.shape.episode_length * self.shape.num_episodes)

    def tuned_config(self, config):
        return {"chunk_size": int(config["chunk_size"]), "min_width": int(config["min_width"])}


class PolicyHarness(_BespokeHarness):
    """Tunes the trunk-delta policy form: delta rank and lane-block size.
    Each rank evaluates its own factored population (the same trunk, the
    same seed), built once: the rank changes the program measured, not
    only its schedule. Selection is throughput within a tolerance, with
    rank as the preference: the highest rank within
    ``winner_tolerance`` of the fastest candidate wins."""

    group = "policy"
    program = "rollout.budget.trunk_delta"
    #: the budget contract keeps every lane active; throughput selection
    default_min_occupancy: Optional[float] = None
    #: within 10% of the fastest median counts as "as fast"
    winner_tolerance: Optional[float] = 0.1
    winner_prefer = staticmethod(lambda config: int(config.get("rank", 0)))

    def __init__(
        self, shape: TuneShape, *, ranks: Sequence[int] = (4, 16, 64), trunk_blocks: Sequence[int] = (0,), seed: int = 0,
        device=None,
    ):  # fmt: skip
        super().__init__(shape, seed=seed, device=device)
        self.ranks = tuple(sorted({int(r) for r in ranks if int(r) > 0}))
        if not self.ranks:
            raise ValueError("empty rank menu; pass --ranks with positive ints")
        # a block must divide the popsize (0, unblocked, always does)
        self.trunk_blocks = tuple(
            sorted({int(b) for b in trunk_blocks if int(b) == 0 or (0 < int(b) < shape.popsize and shape.popsize % int(b) == 0)})
        ) or (0,)
        self._rank_batches: Dict[int, Any] = {}
        self._seed = int(seed)

    def _params_for(self, rank: int):
        """The rank's trunk-delta population, built once per search."""
        import torch

        from ..algorithms.functional import pgpe_ask_trunk_delta

        rank = int(rank)
        if rank not in self._rank_batches:
            self._rank_batches[rank] = pgpe_ask_trunk_delta(
                torch.Generator(device=self.device).manual_seed(self._seed),
                _fresh_pgpe_state(self.policy.parameter_count, self.device), popsize=self.shape.popsize, rank=rank,
                policy=self.policy,
            )  # fmt: skip
        return self._rank_batches[rank]

    def default_config(self):
        return {"rank": self.ranks[0], "trunk_block": 0}

    def knob_group(self) -> KnobGroup:
        # menu-only: an off-grid rank needs a population of its own, and a
        # block off the divisor menu breaks popsize % block
        return KnobGroup(
            name=self.group,
            knobs=(KnobSpec("rank", self.ranks, refine=False), KnobSpec("trunk_block", self.trunk_blocks, refine=False)),
        )

    def run_once(self, config, generator, *, episode_length=None, loop_stats=None):
        from ..neuroevolution.net.vecrl import run_vectorized_rollout

        return run_vectorized_rollout(
            self.env, self.policy, self._params_for(config["rank"]), generator, self.stats, eval_mode="budget",
            trunk_block=int(config.get("trunk_block", 0)), loop_stats=loop_stats,
            **self._rollout_kwargs(episode_length),
        )  # fmt: skip

    def cost(self, config):
        return self._capture(
            lambda generator, loop_stats: self.run_once(config, generator, episode_length=WARMUP_STEPS, loop_stats=loop_stats),
            config,
        )

    def baseline(self, trials: int = 3) -> Dict[str, Any]:
        """Median steps/s of the dense ``budget`` contract at the same
        shape: the policy group's speedup is dense against trunk-delta."""
        warm = self._contract_runner("budget", WARMUP_STEPS)
        return self._baseline_from(
            "budget_dense", self._contract_runner("budget"), trials, warm=lambda: warm(self._next_generator())
        )

    def tuned_config(self, config):
        return {"rank": int(config["rank"]), "trunk_block": int(config.get("trunk_block", 0))}


class SpanHarness(_BespokeHarness):
    """Tunes the training-span length K (``parallel.make_training_span``):
    how many generations one call runs before the host reads the results.
    Each K keeps its own (state, statistics) pair, carried from call to
    call as a training loop carries them; the ``budget`` contract keeps the
    work of a generation the same in every trial. The baseline is the same
    generation body called from the host, ``max(spans)`` times
    (``make_generation_step``), which makes ``speedup_vs_baseline`` the
    span's speedup. Unsharded unless a process group is initialized.

    The port's span is an eager loop over the generation body, so a span
    and K generation steps launch the same kernels: until the span runs as
    a CUDA graph (``ROADMAP.md`` §B, perf item 2) the two differ by the
    host's Python between generations only."""

    group = "span"
    program = "training_span"
    #: the budget contract keeps every lane active; throughput selection
    default_min_occupancy: Optional[float] = None

    def __init__(self, shape: TuneShape, *, spans: Sequence[int] = (1, 2, 4, 8, 16), seed: int = 0, device=None):
        super().__init__(shape, seed=seed, device=device)
        self.spans = tuple(sorted({int(s) for s in spans if int(s) >= 1}))
        if not self.spans:
            raise ValueError("empty span menu; pass --spans with ints >= 1")
        self._programs: Dict[int, Any] = {}
        self._span_state: Dict[int, Any] = {}
        self._baseline_step = None
        self._baseline_state = None

    def _ask_tell(self):
        from functools import partial

        from ..algorithms.functional import pgpe_ask, pgpe_tell

        return partial(pgpe_ask, popsize=self.shape.popsize), pgpe_tell

    def _fresh_state(self):
        from ..neuroevolution.net.runningnorm import RunningNorm

        stats = RunningNorm(self.env.observation_size, device=self.device).stats
        return _fresh_pgpe_state(self.policy.parameter_count, self.device), stats

    def _make(self, span: Optional[int], **extra):
        from ..parallel import make_generation_step, make_training_span

        ask, tell = self._ask_tell()
        kwargs = dict(
            ask=ask, tell=tell, popsize=self.shape.popsize, device=self.device, eval_mode="budget",
            **self._rollout_kwargs(), **extra,
        )  # fmt: skip
        if span is None:
            return make_generation_step(self.env, self.policy, **kwargs)
        return make_training_span(self.env, self.policy, span=span, **kwargs)

    def _program_for(self, span: int):
        span = int(span)
        if span not in self._programs:
            self._programs[span] = self._make(span)
            self._span_state[span] = self._fresh_state()
        return self._programs[span]

    def default_config(self):
        return {"span": self.spans[0]}

    def knob_group(self) -> KnobGroup:
        # menu-only: a span length is a program of its own
        return KnobGroup(name=self.group, knobs=(KnobSpec("span", self.spans, refine=False),))

    def run_once(self, config, generator, *, episode_length=None):
        """One span call, its state carried to the next. A warm-up
        (``episode_length`` given) runs the whole span: its length is fixed
        when the program is made."""
        span = int(config["span"])
        fn = self._program_for(span)
        state, stats = self._span_state[span]
        new_state, scores, new_stats, steps, _ = fn(state, [generator] * span, stats)
        self._span_state[span] = (new_state, new_stats)
        return types.SimpleNamespace(scores=scores, total_steps=int(steps.sum()), telemetry=None)

    def cost(self, config):
        """The span program's cost, captured on a fresh state (outside every
        timed trial); its FLOPs those of the configured episodes."""
        from .programs import ProgramLedger

        span = int(config["span"])
        loop_stats: dict = {}
        fn = self._make(span, loop_stats=loop_stats)
        state, stats = self._fresh_state()
        record = ProgramLedger().capture(
            self.program, fn, state, [self._next_generator()] * span, stats, shape=dict(self.shape.as_dict(), span=span),
            control_steps=lambda _: span * loop_stats["steps_issued"], device=self.device,
        )  # fmt: skip
        return _cost_of(record, span * self.shape.episode_length)

    def baseline(self, trials: int = 3) -> Dict[str, Any]:
        """Median steps/s of ``max(spans)`` ``make_generation_step`` calls
        from the host, on their own carried state."""
        if self._baseline_step is None:
            self._baseline_step = self._make(None)
            self._baseline_state = self._fresh_state()
        gens = max(self.spans)

        def runner(generator):
            state, stats = self._baseline_state
            steps_total = 0
            scores = None
            for _ in range(gens):
                state, scores, stats, steps, _ = self._baseline_step(state, generator, stats)
                steps_total += int(steps)
            self._baseline_state = (state, stats)
            return types.SimpleNamespace(scores=scores, total_steps=steps_total, telemetry=None)

        return self._baseline_from("span_hostloop", runner, trials, warm=lambda: runner(self._next_generator()))

    def tuned_config(self, config):
        return {"span": int(config["span"])}


class HostPipelineHarness:
    """Tunes the host path's knobs: the pipelined scheduler's lane-block
    count and, over MuJoCo, the physics thread-pool width. They are
    properties of the machine, so the cache entry is machine-scoped (shape
    ``{}``) and every ``GymNE`` / host-pipeline run on the machine takes it.

    It needs gymnasium (and MuJoCo for the thread knob), which the card's
    machine lacks: it runs in the CPU tests only. The policy forward runs
    on the card unless ``device="cpu"``."""

    group = "host_pipeline"
    program = "host_pipeline.rollout"
    #: host-path occupancy means no device starvation; select on throughput
    default_min_occupancy: Optional[float] = None

    def __init__(
        self, env_id: Optional[str] = None, *, popsize: int = 64, num_envs: int = 16, episode_length: int = 200,
        hidden: Tuple[int, ...] = (64, 64), seed: int = 0, device=None,
    ):  # fmt: skip
        import gymnasium as gym
        import numpy as np
        import torch

        from .._device import resolve_device
        from ..neuroevolution.net import FlatParamsPolicy, tanh_mlp

        self.device = resolve_device(device)
        if env_id is None:
            env_id = "Hopper-v5" if self._mujoco_importable() else "CartPole-v1"
        self.env_id = env_id
        self.popsize = int(popsize)
        self.num_envs = int(num_envs)
        self.episode_length = int(episode_length)
        probe = gym.make(env_id)
        obs_dim = int(np.prod(probe.observation_space.shape))
        act_space = probe.action_space
        act_dim = int(act_space.n) if hasattr(act_space, "n") else int(np.prod(act_space.shape))
        probe.close()
        self.policy = FlatParamsPolicy(tanh_mlp(obs_dim, act_dim, list(hidden)))
        rng = np.random.default_rng(seed)
        self.params = torch.as_tensor(
            rng.normal(size=(self.popsize, self.policy.parameter_count)), dtype=torch.float32, device=self.device
        )
        self._mujoco = self._mujoco_backend()
        self._warmed_splits: set = set()
        self._sync_baseline: Optional[Dict[str, Any]] = None

    @staticmethod
    def _mujoco_importable() -> bool:
        try:
            from ..envs.mujoco.mjvecenv import MjVecEnv  # noqa: F401
        except ImportError:
            return False
        return True

    def _mujoco_backend(self) -> bool:
        """Whether ``MjVecEnv`` steps this env: it raises ``ValueError`` for
        a family it does not know, and its import fails without MuJoCo."""
        if not self._mujoco_importable():
            return False
        import gymnasium as gym

        from ..envs.mujoco.mjvecenv import MjVecEnv

        try:
            MjVecEnv(lambda: gym.make(self.env_id), 1).close()
        except ValueError:
            return False
        return True

    def default_config(self) -> Optional[Dict[str, Any]]:
        return None  # no cost model on the host path; grid[0] anchors

    def knob_group(self) -> KnobGroup:
        import os

        blocks = tuple(b for b in (1, 2, 4) if b <= self.num_envs)
        knobs = [KnobSpec("num_blocks", blocks, refine=False)]
        if self._mujoco:
            cores = int(os.cpu_count() or 1)
            nthreads = tuple(sorted({1, 2, cores} & set(range(1, self.num_envs + 1))))
            knobs.append(KnobSpec("mj_nthread", nthreads, refine=False))
        return KnobGroup(name=self.group, knobs=tuple(knobs))

    def cost(self, config):
        return None  # host-orchestrated: no single program to capture

    def _fresh_vec(self, config):
        import gymnasium as gym

        if self._mujoco:
            from ..envs.mujoco.mjvecenv import MjVecEnv

            vec = MjVecEnv(lambda: gym.make(self.env_id), self.num_envs, nthread=config.get("mj_nthread"))
        else:
            from ..neuroevolution.net.hostvecenv import SyncVectorEnv

            vec = SyncVectorEnv(lambda: gym.make(self.env_id), self.num_envs)
        vec.seed(range(1000, 1000 + self.num_envs))
        return vec

    def _run(self, config, *, episode_length: Optional[int] = None, mode="pipelined"):
        import numpy as np

        from ..neuroevolution.net.hostvecenv import run_host_pipelined_rollout

        vec = self._fresh_vec(config)
        try:
            t0 = time.perf_counter()
            result = run_host_pipelined_rollout(
                vec, self.policy, self.params, num_episodes=1,
                episode_length=self.episode_length if episode_length is None else episode_length, mode=mode,
                num_blocks=config.get("num_blocks"),
                # never measure through the tuner's own earlier output: the
                # baseline (and a config with no block count) takes the
                # built-in rule, not a cached entry
                use_tuned_cache=False, rng=np.random.default_rng(0), device=self.device,
            )  # fmt: skip
            # graftlint: allow(timing): the host engine returns after its last copy of actions to the host
            elapsed = time.perf_counter() - t0
        finally:
            vec.close()
        return result["interactions"] / elapsed if elapsed else 0.0, result

    def _warm(self, config):
        """Each block split once, outside every clock: its first forward at
        that block width allocates."""
        split = (config.get("num_blocks"), config.get("mj_nthread"))
        if split not in self._warmed_splits:
            self._warmed_splits.add(split)
            self._run(config, episode_length=3)

    def measure(self, configs, trials, round_index):
        from ..analysis import track_first_use

        for config in configs:
            self._warm(config)
        out = [{"samples": [], "occupancies": [], "steady_compiles": 0} for _ in configs]
        for _ in range(trials):
            for i, config in enumerate(configs):
                with tracer.span("autotune.trial", "autotune", group=self.group, **config):
                    with track_first_use() as first_use:
                        sps, result = self._run(config)
                out[i]["samples"].append(sps)
                out[i]["occupancies"].append(result["occupancy"])
                out[i]["steady_compiles"] += first_use.count
        return out

    def baseline(self, trials: int = 3) -> Dict[str, Any]:
        """The ``sync`` scheduler (the same event order, no worker thread)
        at the default block count: the pipelined-against-sync
        denominator."""
        if self._sync_baseline is not None:
            return self._sync_baseline
        samples = []
        self._warm({})
        for _ in range(max(1, trials)):
            with tracer.span("autotune.trial", "autotune", group="host_sync"):
                sps, _ = self._run({}, mode="sync")
            samples.append(sps)
        self._sync_baseline = {"steps_per_sec": _median(samples), "occupancy": None, "samples": samples}
        return self._sync_baseline

    def tuned_config(self, config):
        out = {"num_blocks": int(config["num_blocks"])}
        if "mj_nthread" in config:
            out["mj_nthread"] = int(config["mj_nthread"])
        return out


# ---------------------------------------------------------------------------
# the tuning driver: search a harness, fill the ledger, persist the winner
# ---------------------------------------------------------------------------


def tune_group(
    harness,
    *,
    trials: int = 3,
    max_rounds: int = 2,
    survivor_frac: float = 0.5,
    min_occupancy="auto",
    hbm_budget_bytes: Optional[float] = None,
    hbm_budget_ratio: Optional[float] = 8.0,
    flops_bound: Optional[float] = None,
    refine: bool = True,
    ledger_out: Optional[TimingLedger] = None,
    cache_path=None,
    write_cache: bool = True,
) -> SearchOutcome:
    """Run one knob group end to end: derive the memory budget from the
    default candidate's captured peak (``hbm_budget_ratio``: a guard
    against pathological corners of the grid), search, record every
    candidate in the measured-timing ledger, and persist the winner to the
    tuned-config cache, keyed to the harness's device
    (``machine_fingerprint``, ``runtime="torch"``).

    ``min_occupancy="auto"`` takes the harness's floor
    (``default_min_occupancy``: 0.9 for refill, none for compact, policy,
    span and the host pipeline). The winner is written only when its timed
    trials did no first-use work, the floor is met and ``write_cache`` is
    set."""
    if min_occupancy == "auto":
        min_occupancy = getattr(harness, "default_min_occupancy", None)
    tolerance = getattr(harness, "winner_tolerance", None)
    prefer = getattr(harness, "winner_prefer", None)
    led = ledger_out if ledger_out is not None else timings
    group = harness.knob_group()
    machine = machine_fingerprint(getattr(harness, "device", None))
    cost_cache: Dict[Tuple, Optional[Dict]] = {}

    def cost_fn(config):
        key = tuple(sorted(config.items()))
        if key not in cost_cache:
            cost_cache[key] = harness.cost(config)
        return cost_cache[key]

    budget = hbm_budget_bytes
    if budget is None and hbm_budget_ratio is not None:
        anchor = harness.default_config() or candidate_grid(group)[0]
        reference = cost_fn(anchor)
        if reference is not None and reference.get("peak_bytes") is not None:
            budget = float(reference["peak_bytes"]) * float(hbm_budget_ratio)

    outcome = autotune_search(
        group,
        harness.measure,
        cost_fn=cost_fn,
        hbm_budget_bytes=budget,
        flops_bound=flops_bound,
        trials_per_round=trials,
        survivor_frac=survivor_frac,
        max_rounds=max_rounds,
        min_occupancy=min_occupancy,
        tolerance=tolerance,
        prefer=prefer,
        refine=refine,
    )

    shape = harness.shape.as_dict() if hasattr(harness, "shape") else {}
    for stats in outcome.results:
        led.add(
            TimingRecord(
                program=harness.program,
                shape=shape,
                machine=machine,
                config=dict(stats.config),
                samples=tuple(stats.samples),
                occupancy=stats.occupancy,
                refill_events=stats.refill_events,
                queue_wait=stats.queue_wait,
                compile_seconds=None if stats.cost is None else stats.cost.get("compile_seconds"),
                steady_compiles=stats.steady_compiles,
            )
        )
    for config, reason in outcome.pruned:
        led.add(TimingRecord(program=harness.program, shape=shape, machine=machine, config=dict(config), pruned=reason))

    # never persist an untrustworthy winner: first-use work inside a timed
    # trial contaminates its medians, and a winner that exists only because
    # no candidate met the floor (select_winner's fallback) is the lucky
    # run the floor is there to bar
    floor_met = outcome.winner is not None and (
        min_occupancy is None or (outcome.winner.occupancy is not None and outcome.winner.occupancy >= min_occupancy)
    )
    if outcome.winner is not None and outcome.winner.steady_compiles == 0 and floor_met and write_cache:
        from .timings import save_tuned_entry

        baseline = harness.baseline(trials)
        speedup = None
        if baseline["steps_per_sec"]:
            speedup = outcome.winner.steps_per_sec / baseline["steps_per_sec"]
        entry = TunedEntry(
            group=harness.group,
            shape=_cache_shape(harness),
            machine=machine,
            config=harness.tuned_config(outcome.winner.config),
            evidence={
                "steps_per_sec": round(outcome.winner.steps_per_sec, 1),
                "occupancy": None if outcome.winner.occupancy is None else round(outcome.winner.occupancy, 4),
                "baseline_steps_per_sec": round(baseline["steps_per_sec"], 1),
                "speedup_vs_baseline": None if speedup is None else round(speedup, 3),
                "trials": len(outcome.winner.samples),
                "steady_compiles": outcome.winner.steady_compiles,
                "episode_length": getattr(getattr(harness, "shape", None), "episode_length", None),
                "tuned_at": time.strftime("%Y-%m-%d"),
            },
        )
        save_tuned_entry(entry, cache_path)
        outcome.cache_written = True
    return outcome


def _cache_shape(harness) -> Dict[str, Any]:
    """The cache key's shape: (env, popsize, episode length and count,
    parameter count, compute dtype, mesh) for the device-program groups,
    the JAX package's keys, and empty (machine-scoped) for the host
    pipeline, whose knobs are the host's."""
    from .timings import canonical_env_label

    if isinstance(harness, HostPipelineHarness):
        return {}
    return {
        # canonicalized as every consumer's lookup is
        "env": canonical_env_label(harness.shape.env_name),
        "popsize": harness.shape.popsize,
        "episode_length": harness.shape.episode_length,
        "num_episodes": harness.shape.num_episodes,
        "params": harness.policy.parameter_count,
        "dtype": dtype_label(harness.shape.compute_dtype),
        # the tuner measures the unsharded program; a sharded consumer
        # looks up under its own mesh label (parallel.mesh.mesh_label)
        "mesh": "none",
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _shape_from_args(args, on_cpu: bool) -> TuneShape:
    """The tuning shape, from the same ``BENCH_*`` knobs and defaults as the
    JAX package's: a cache hit needs (env, popsize, params, dtype) exactly,
    so a default drifting here turns every lookup into a fallback."""
    import json as _json
    import os

    import torch

    popsize = args.popsize
    if popsize is None:
        popsize = int(os.environ.get("BENCH_POPSIZE", 1024 if on_cpu else 10_000))
    episode_length = args.episode_length
    if episode_length is None:
        episode_length = int(os.environ.get("BENCH_EPISODE_LENGTH", 100 if on_cpu else 200))
    hidden_raw = args.hidden or os.environ.get("BENCH_HIDDEN", "64,64")
    hidden = tuple(int(h) for h in hidden_raw.split(",") if h)
    env_name = args.env or os.environ.get("BENCH_ENV", "humanoid")
    if _json.loads(os.environ.get("BENCH_ENV_ARGS", "{}")):
        raise SystemExit(
            "autotune keys the tuned-config cache by plain env name; BENCH_ENV_ARGS would make the entry ambiguous"
            " (unset it)"
        )
    compute_dtype = torch.bfloat16 if os.environ.get("BENCH_BF16", "0") == "1" else None
    return TuneShape(
        env_name=env_name, popsize=popsize, episode_length=episode_length, hidden=hidden, compute_dtype=compute_dtype
    )


def _emit(payload: dict) -> None:
    import json as _json

    print(_json.dumps(payload), flush=True)


def _ints(text: str) -> List[int]:
    return [int(x) for x in text.split(",") if x != ""]


GROUPS = ("refill", "compact", "host_pipeline", "policy", "span")


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m evotorch_tpu_torch.observability.autotune",
        description="Occupancy-driven autotuner: search the eval-schedule knobs at the benchmark's shapes, record"
        " measured timings, persist the winners to the tuned-config cache.",
    )
    parser.add_argument("--group", default="refill", help="comma list of knob groups: " + ", ".join(GROUPS))
    parser.add_argument("--device", default=None, help="'cpu' to tune on the CPU (default: the card; exits without one)")
    parser.add_argument("--env", default=None, help="env name (BENCH_ENV)")
    parser.add_argument("--popsize", type=int, default=None)
    parser.add_argument("--episode-length", type=int, default=None)
    parser.add_argument("--hidden", default=None, help="comma list, e.g. 64,64")
    parser.add_argument("--trials", type=int, default=3, help="timed trials per candidate per round (medians)")
    parser.add_argument("--max-rounds", type=int, default=2, help="successive-halving rounds")
    parser.add_argument(
        "--min-occupancy", type=float, default=None,
        help="occupancy floor on the winner (default: each group's own: 0.9 for refill, none for the others)",
    )  # fmt: skip
    parser.add_argument("--widths", default=None, help="refill width grid (comma list)")
    parser.add_argument("--periods", default="1", help="refill period grid (comma list)")
    parser.add_argument("--chunks", default="10,25,50", help="compact chunk-size grid (comma list)")
    parser.add_argument("--min-widths", default="128,256,512", help="compact width-menu floor grid (comma list)")
    parser.add_argument("--ranks", default="4,16,64", help="policy group's trunk-delta rank grid (comma list)")
    parser.add_argument(
        "--trunk-blocks", default="0", help="policy group's lane-block grid (comma list; 0 = unblocked, others divide the popsize)"
    )
    parser.add_argument("--spans", default="1,2,4,8,16", help="span group's span-length grid (comma list)")
    parser.add_argument("--hbm-budget", type=float, default=None, help="absolute peak-memory prune budget in bytes")
    parser.add_argument(
        "--hbm-budget-ratio", type=float, default=8.0,
        help="prune budget as a multiple of the default candidate's captured peak (0: none)",
    )  # fmt: skip
    parser.add_argument("--flops-bound", type=float, default=None, help="absolute FLOPs prune bound")
    parser.add_argument("--no-refine", action="store_true", help="skip the neighborhood-refinement round")
    parser.add_argument("--no-write-cache", action="store_true", help="search and ledger only; leave the cache alone")
    parser.add_argument("--cache", default=None, help="another tuned_configs.json path")
    parser.add_argument("--timings-out", default=None, help="write the measured-timing ledger JSON here")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from .._device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"autotune: {exc}", file=sys.stderr)
        return 2
    groups = [g.strip() for g in args.group.split(",") if g.strip()]
    unknown = set(groups) - set(GROUPS)
    if unknown:
        parser.error(f"unknown group(s): {sorted(unknown)}")

    shape = _shape_from_args(args, device.type == "cpu")
    ratio = args.hbm_budget_ratio if args.hbm_budget_ratio else None
    session = TimingLedger()
    rc = 0
    for group_name in groups:
        if group_name == "refill":
            widths = _ints(args.widths) if args.widths else None
            harness = RefillHarness(shape, widths=widths, periods=_ints(args.periods), seed=args.seed, device=device)
        elif group_name == "compact":
            harness = CompactHarness(
                shape, chunks=_ints(args.chunks), min_widths=_ints(args.min_widths), seed=args.seed, device=device
            )
        elif group_name == "policy":
            harness = PolicyHarness(
                shape, ranks=_ints(args.ranks), trunk_blocks=_ints(args.trunk_blocks), seed=args.seed, device=device
            )
        elif group_name == "span":
            harness = SpanHarness(shape, spans=_ints(args.spans), seed=args.seed, device=device)
        else:
            harness = HostPipelineHarness(seed=args.seed, device=device)
        print(
            f"[autotune] group={group_name} shape={_cache_shape(harness)} machine={machine_fingerprint(device)}",
            file=sys.stderr,
        )
        outcome = tune_group(
            harness,
            trials=args.trials,
            max_rounds=args.max_rounds,
            min_occupancy=args.min_occupancy if args.min_occupancy is not None else "auto",
            hbm_budget_bytes=args.hbm_budget,
            hbm_budget_ratio=ratio,
            flops_bound=args.flops_bound,
            refine=not args.no_refine,
            ledger_out=session,
            cache_path=args.cache,
            write_cache=not args.no_write_cache,
        )
        for stats in outcome.results:
            _emit(
                {
                    "metric": "autotune_steps_per_sec",
                    "group": group_name,
                    "config": stats.config,
                    "steps_per_sec": round(stats.steps_per_sec, 1),
                    "occupancy": None if stats.occupancy is None else round(stats.occupancy, 4),
                    "trials": len(stats.samples),
                    "steady_compiles": stats.steady_compiles,
                }
            )
        for config, reason in outcome.pruned:
            _emit({"metric": "autotune_pruned", "group": group_name, "config": config, "reason": reason})
        if outcome.winner is None:
            _emit({"metric": "autotune_winner", "group": group_name, "error": "no candidate produced a timing"})
            rc = 1
            continue
        baseline = harness.baseline(args.trials)
        speedup = outcome.winner.steps_per_sec / baseline["steps_per_sec"] if baseline["steps_per_sec"] else None
        _emit(
            {
                "metric": "autotune_winner",
                "group": group_name,
                "config": harness.tuned_config(outcome.winner.config),
                "steps_per_sec": round(outcome.winner.steps_per_sec, 1),
                "occupancy": None if outcome.winner.occupancy is None else round(outcome.winner.occupancy, 4),
                "baseline_steps_per_sec": round(baseline["steps_per_sec"], 1),
                "speedup_vs_baseline": None if speedup is None else round(speedup, 3),
                "steady_compiles": outcome.winner.steady_compiles,
                "cache_written": outcome.cache_written,
                # the device the trials ran on
                "backend": device.type,
            }
        )
        # first-use work inside a timed trial voids the run's claim to
        # steady-state timings: a nonzero exit
        if outcome.winner.steady_compiles:
            rc = 1
    if args.timings_out:
        session.save(args.timings_out)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
