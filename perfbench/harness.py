"""The benchmark's harness: one cell, one seed, one measured window.

A cell is a configuration (``configs/<name>.json``: the env, the policy,
PGPE's constants) under a traffic mix (``traffic/<name>.json``: the
evaluation contract and its knobs), both found by the names that
``BENCHMARK.json`` gives. A configuration's policy is the port's network
string and a plain policy file under ``reference/`` (``mlp_policy.py``'s
tanh network of its ``hidden`` unless it names others:
``reference/policies.py``). A metric is a reader ``metrics/<name>.py``
whose ``read(summary)`` returns a number or None. A configuration may hold
its population factored: ``"lowrank_rank": k`` runs PGPE's low-rank
populations (``center + basis @ coeffs``, the policy forward on the port's
factored path), which the checks compare in those terms (``check.py``); a
run whose forward falls back to the dense population is an error. Adding a
configuration, its plain policy, a traffic mix or a metric adds files; no
file here changes.

A run:

1. Set-up (``setup_s``, from the process's start): builds the port's
   kernels where they are not built yet, makes the problem
   (``evotorch_tpu_torch.neuroevolution.VecNE``) and the searcher
   (``evotorch_tpu_torch.algorithms.PGPE``) on the card, the center drawn
   from the seed, samples once, evaluates the center on as many lanes as
   the cell has (every shape of the window's rollouts), launches the
   ranking kernel once, and puts the observation statistics and the
   counters back as they were. A factored configuration samples a factored
   population, evaluates the center as one (a zero basis: the factored
   forward's shapes) and solves the tell's basis capture once.
2. The window: ``searcher.step()`` in a closed loop. It ends at the first
   evaluation round (a call of ``problem.evaluate``) that ends at or after
   ``--seconds``, inside a generation if need be. Hooks on the problem's
   evaluations synchronize the card at each round's start and end, read the
   interaction counter and the generator's state, and keep what the checks
   need.
3. Untimed: the rest of the generation in progress, its tell and the next
   generation's first ask, where the run ends. With ``--trace 1`` the
   profiler records the segment from the end of the window's last round to
   the ``TRACE_STEPS``-th control step after it (the window itself is not
   traced), and the run ends there at the earliest.
4. The checks (``check.py``) against the plain reference, after the
   program's state is freed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import factored
from .reference import policies

ROOT = Path(__file__).resolve().parents[1]
#: control steps of the traced segment
TRACE_STEPS = 40
#: the first generations whose tells are checked
TELL_GENERATIONS = 3

#: top-level modules that no run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "evotorch_tpu")
#: the port's warning where a factored population's forward falls back to
#: the dense one, an error in a run
DENSE_FALLBACK = ".*fell back to materializing.*"

__all__ = ["WindowClosed", "cell_spec", "forbidden_modules", "load_benchmark", "run_cell"]


class WindowClosed(Exception):
    """Raised by the evaluation hook at the first round boundary past the
    window's end: it leaves ``searcher.step()`` wherever it is."""


# ------------------------------------------------------------------ the spec


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(workload: str, *, root: Path = ROOT, bench: Optional[dict] = None) -> dict:
    """A workload entry with its configuration, traffic and metrics, read
    from the files that ``BENCHMARK.json`` names."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (there are {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    with open(root / config_entry["file"]) as f:
        config = policies.check_config(json.load(f), root)
    with open(root / "perfbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return dict(
        name=workload,
        chips=int(cell["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=str(root),
    )


def reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one that no run may load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


# ------------------------------------------------------------- traffic -> program


_TRAFFIC_KEYS = {"eval_mode", "refill_width", "refill_period"}


def program_kwargs(config: dict, traffic: dict) -> dict:
    """The problem's and the searcher's arguments for a cell: the one place
    that turns data files into calls."""
    unknown = set(traffic) - _TRAFFIC_KEYS - {"why"}
    if unknown:
        raise ValueError(f"traffic keys not understood: {sorted(unknown)}")
    mode = traffic["eval_mode"]
    refill = None
    if mode == "episodes_refill":
        refill = {"width": int(traffic["refill_width"]), "period": int(traffic.get("refill_period", 1))}
    problem = dict(
        env=config["env"],
        network=policies.network(config),
        observation_normalization=bool(config["observation_normalization"]),
        decrease_rewards_by=config.get("decrease_rewards_by"),
        episode_length=int(config["episode_length"]),
        eval_mode=mode,
        refill_config=refill,
    )
    searcher = dict(
        popsize=int(config["popsize"]),
        popsize_max=config.get("popsize_max"),
        num_interactions=config.get("num_interactions"),
        center_learning_rate=float(config["center_learning_rate"]),
        stdev_learning_rate=float(config["stdev_learning_rate"]),
        radius_init=float(config["radius_init"]),
        stdev_max_change=float(config["stdev_max_change"]),
        optimizer="clipup",
        optimizer_config={"max_speed": float(config["max_speed"]), "momentum": float(config["momentum"])},
        ranking_method=config["ranking_method"],
    )
    if "lowrank_rank" in config:
        searcher["lowrank_rank"] = int(config["lowrank_rank"])
    lanes = int(config["popsize"]) if refill is None else min(int(config["popsize"]), refill["width"])
    return {"problem": problem, "searcher": searcher, "warmup_solutions": lanes + lanes % 2}


# ------------------------------------------------------------------ recording


class Recorder:
    """The evaluation hooks: per round, the host times, the interaction
    counter, the generator's states, the statistics and the populations
    that the checks read; one round of the window kept for the rollout
    check (a reservoir draw from the seed), with its control steps from the
    ``StepTap``; the first ``TELL_GENERATIONS`` generations' populations and
    the asks after them for the tell check.

    The window closes at the first round that ends at or after the
    deadline. The run goes on, untimed, to the end of the generation then
    in progress, its tell and the next generation's first ask, where the
    hooks end it (with ``--trace 1``, once the traced segment is over too)."""

    def __init__(self, problem, searcher, rng, tap, *, sync: Callable[[], None], min_rounds: int = 0):
        self.problem = problem
        self.searcher = searcher
        self.rng = rng
        self.tap = tap
        self.sync = sync
        self.initial_gen_state = problem.generator.get_state()
        self.rounds: List[dict] = []  # every round, warm-up included, without tensors
        self.in_window = False
        self.closed_in: Optional[int] = None  # the generation in progress when the window closed
        self.deadline = math.inf
        self.min_rounds = int(min_rounds)
        self.kept: Optional[dict] = None
        self.window_rounds = 0
        self.generation = 0  # steps started in the window
        self.generations: Dict[int, dict] = {}
        self.tracer: Optional["Tracer"] = None
        self.memory_peak = 0
        self.read_memory_peak: Callable[[], int] = lambda: 0
        self._current: Optional[dict] = None
        problem.before_eval_hook.append(self.before)
        problem.after_eval_hook.append(self.after)

    def _count(self) -> int:
        return int(self.problem.status.get("total_interaction_count", 0))

    _TENSORS = ("stats_before", "stats_after", "mu", "sigma", "values", "scores")

    def asked_after_close(self) -> bool:
        """The generation after the one that the window closed in has made
        its first ask (its tell has run)."""
        return self.closed_in is not None and self.generation > self.closed_in

    def before(self, batch):
        self.sync()
        count = self._count()  # the problem's status is updated after the hooks
        if self.rounds:
            self.rounds[-1]["count_after"] = count
        params = self.searcher.distribution.parameters
        g = self.generations.get(self.generation)
        if g is not None and "mu_ask" not in g:
            g["mu_ask"], g["sigma_ask"] = params["mu"], params["sigma"]
        if self.asked_after_close() and (self.tracer is None or not self.tracer.active):
            raise WindowClosed()
        rec = {
            "t_before": time.perf_counter(),
            "in_window": self.in_window,
            "generation": self.generation,
            "size": len(batch),
            "count_before": count,
            "gen_state_before": self.problem.generator.get_state(),
            "gen_state_prev": self.rounds[-1]["gen_state_after"] if self.rounds else self.initial_gen_state,
            "stats_before": self.problem.obs_norm.stats,
            "mu": params["mu"],
            "sigma": params["sigma"],
            "values": batch.values,
        }
        # a factored ask draws its basis on a generation's first round only,
        # from the state before that round's ask
        first = not self.rounds or self.rounds[-1]["generation"] != self.generation
        rec["first_in_generation"] = first
        rec["basis_state"] = rec["gen_state_prev"] if first else self.rounds[-1]["basis_state"]
        if self.tracer is not None and self.tracer.active:
            self.tracer.round = rec
        if self.in_window:
            self.tap.begin()
        self._current = rec

    def after(self, batch):
        self.sync()
        rec = self._current
        rec["t_after"] = time.perf_counter()
        rec["gen_state_after"] = self.problem.generator.get_state()
        rec["stats_after"] = self.problem.obs_norm.stats
        rec["scores"] = batch.evals[:, 0]
        steps = self.tap.end() if rec["in_window"] else None
        prev = self.problem.last_group_telemetry
        if prev is not None and self.rounds:
            self.rounds[-1]["telemetry"] = prev.total()
        g = self.generations.get(rec["generation"])
        if g is not None and rec["generation"] <= TELL_GENERATIONS:
            g["values"].append(rec["values"])
            g["scores"].append(rec["scores"])
        tensors = {k: rec.pop(k) for k in self._TENSORS}
        self.rounds.append(rec)
        if self.tracer is not None:
            self.tracer.stop()  # the traced round ended before its last traced step
        if not rec["in_window"]:
            return
        self.window_rounds += 1
        # a reservoir of one round over the window's rounds
        if self.rng.random() < 1.0 / self.window_rounds:
            if self.kept is not None:
                for k in (*self._TENSORS, "steps"):
                    self.kept.pop(k, None)
            rec.update(tensors, steps=steps)
            self.kept = rec
        if rec["t_after"] >= self.deadline and self.window_rounds >= self.min_rounds:
            self.in_window = False
            self.closed_in = self.generation
            self.memory_peak = self.read_memory_peak()
            if self.tracer is not None:
                self.tracer.start(self)

    def step(self):
        """One ``searcher.step()``, keeping the generation's rounds for the
        tell check while it is one of the first."""
        self.generation += 1
        if self.generation <= TELL_GENERATIONS + 1:
            self.generations[self.generation] = {"values": [], "scores": []}
        self.searcher.step()

    def finish(self):
        """The last round's count, once the problem's status holds it."""
        if self.rounds and "count_after" not in self.rounds[-1]:
            self.rounds[-1]["count_after"] = self._count()

    def final_telemetry(self, group_telemetry_cls):
        """The last round's wire, which the problem has not decoded yet."""
        pending = getattr(self.problem, "_pending_telemetry", None)
        if pending is not None and self.rounds and "telemetry" not in self.rounds[-1]:
            self.rounds[-1]["telemetry"] = group_telemetry_cls.from_array(pending).total()


# ------------------------------------------------------------------ the run


def _device_name(torch, device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, timeout=20,
        )  # fmt: skip
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else None


def run_cell(
    spec: dict,
    *,
    seed: int,
    seconds: float,
    trace: bool,
    t_start: float,
    device: str = "cuda",
    control=None,
) -> dict:
    """One run of a cell: the result line's fields, the compared numbers
    (``checks``) and the summary the metric readers read. ``control`` (a
    dtype, or None) runs the control instead: the program's policy in that
    precision (``control.py`` reads the rest of the control from the
    result's ``kept``, ``generations`` and ``center0``). A spec's
    ``min_rounds`` keeps the window open for that many rounds at least."""
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.observability import GroupTelemetry
    from evotorch_tpu_torch.ops import ranking
    from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch, basis_capture

    from . import check as checks
    from .capture import StepTap

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from evotorch_tpu_torch.ops import _build

        _build.build()
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    config, traffic = spec["config"], spec["traffic"]
    kwargs = program_kwargs(config, traffic)
    rank = kwargs["searcher"].get("lowrank_rank")
    seed = int(seed)
    problem = VecNE(device=device, seed=seed % (2**63), compute_dtype=control, **kwargs["problem"])
    # the center, made by the benchmark from the seed
    lo, hi = config["center_init_bounds"]
    center_gen = torch.Generator(device=device).manual_seed((seed + 1) % (2**63))
    center0 = lo + (hi - lo) * torch.rand(problem.solution_length, generator=center_gen, device=device)
    searcher = PGPE(problem, center_init=center0, **kwargs["searcher"])
    policy = policies.make(config, problem.env.observation_size, problem.env.action_size)
    if policy.parameter_count != problem.solution_length:
        raise ValueError(f"the program's policy has {problem.solution_length} parameters, the plain one {policy.parameter_count}")
    rng = np.random.default_rng(seed)
    tap = StepTap(rng)
    rec = Recorder(problem, searcher, rng, tap, sync=sync, min_rounds=spec.get("min_rounds", 0))

    # warm-up: the sampler once, then one evaluation on as many lanes as the
    # window's rounds use (every shape of their rollouts) of the center with
    # the output layer's bias at 1, which drives every action to its bound:
    # every lane falls within ~21 steps, whatever the seed; then the ranking
    # kernel. The observation statistics and the problem's counters are put
    # back as they were, so the window starts where a user's first
    # generation does. From here to the window's end a factored
    # population's dense fallback is an error, not a warning.
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=DENSE_FALLBACK)
        stats0 = problem.obs_norm.stats
        counters0 = problem._interaction_count, problem._episode_count
        n = kwargs["warmup_solutions"]
        offset, out_size = policy.output_bias()
        if rank is None:
            warm = searcher.distribution.sample(n, generator=problem.generator)
            falling = searcher.distribution.parameters["mu"].expand(n, -1).clone()
            falling[:, offset : offset + out_size] = 1.0
        else:
            # the factored sampler, and the center as a factored population of
            # the window's lanes: prepare_lowrank's context at its shapes
            warm = searcher.distribution.sample_lowrank(n, rank, generator=problem.generator)
            center = searcher.distribution.parameters["mu"].clone()
            center[offset : offset + out_size] = 1.0
            falling = LowRankParamsBatch(center, torch.zeros_like(warm.basis), torch.zeros_like(warm.coeffs))
        problem.evaluate(SolutionBatch(problem, values=falling))
        del falling
        ranking.centered_rank(torch.zeros(int(config["popsize"]), device=device))
        if rank is not None:
            basis_capture(warm.basis, warm.center)  # the tell's solve, from the second tell on
        del warm
        problem.obs_norm.stats = stats0
        problem._interaction_count, problem._episode_count = counters0
        problem.update_status({"total_interaction_count": counters0[0], "total_episode_count": counters0[1]})
        sync()
        setup_s = time.perf_counter() - t_start

        # the window, then the traced segment and the untimed rest of its last
        # generation
        if cuda:
            rec.read_memory_peak = lambda: int(torch.cuda.max_memory_allocated(device))
        if trace:
            rec.tracer = Tracer(problem, TRACE_STEPS, cuda, sampled=rank is None)
        rec.in_window = True
        t0 = time.perf_counter()
        rec.deadline = t0 + float(seconds)
        try:
            while True:
                rec.step()
        except WindowClosed:
            pass
        finally:
            tap.close()
    window_rounds = [r for r in rec.rounds if r["in_window"]]
    t_end = window_rounds[-1]["t_after"]
    rec.finish()
    rec.final_telemetry(GroupTelemetry)

    summary = _window_summary(window_rounds, t0, t_end)
    summary.update(
        setup_s=setup_s,
        workload=spec["name"],
        seed=seed,
        policy_flops_per_step=2 * policy.macs() if rank is None else factored.policy_flops_per_step(policy, rank),
        solution_length=int(problem.solution_length),
        memory_peak_bytes=rec.memory_peak,
    )
    if rec.tracer is not None:
        summary["trace"] = rec.tracer.summary(window_rounds, int(problem.solution_length))

    mu0 = center0
    gens = rec.generations
    kept = rec.kept
    ended = [r for r in rec.rounds if 1 <= r["generation"] <= rec.closed_in]
    attempted = sum(r["size"] for r in window_rounds)
    failed = sum(r["telemetry"].nonfinite for r in window_rounds if "telemetry" in r)
    # the program's state goes before the reference runs
    del searcher, problem, rec
    import gc

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, tells_checked, step_parts = checks.run_checks(
        config, traffic, device=device, kept=kept, generations=gens, rounds=ended, center0=mu0, rng=rng
    )
    summary["tells_checked"] = tells_checked
    return {
        "summary": summary,
        "checks": numbers,
        "step_parts": step_parts,
        "kept": kept,
        "generations": gens,
        "center0": mu0,
        "attempted": attempted,
        "failed": failed,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": _device_name(torch, device),
            "count": 1,
            "memory_peak_bytes": summary["memory_peak_bytes"],
        },
    }


class Tracer:
    """The traced segment: ``torch.profiler`` (the device's operations and
    the CUDA runtime's calls) from the end of the window's last round to the
    ``steps``-th control step after it (or the end of that round), where the
    run ends if the next generation has asked already. The env's
    ``batch_step`` is wrapped to stamp each control step on the host's clock
    (the profiler's clock), which splits the device's idle time by what the
    host was doing."""

    def __init__(self, problem, steps: int, cuda: bool, *, sampled: bool = True):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=activities, record_shapes=False, with_stack=False, profile_memory=False)
        self.steps = steps
        self.sampled = sampled  # a factored ask launches no sampling kernel
        self.active = False
        self.round: Optional[dict] = None  # the traced round's record, from its start
        self.recorder: Optional[Recorder] = None
        self.last_window_round: Optional[dict] = None
        self.env_steps: List[tuple] = []
        env = problem.env
        original = env.batch_step

        def stamped_step(*args, **kwargs):
            if not self.active:
                return original(*args, **kwargs)
            start = time.time_ns()
            out = original(*args, **kwargs)
            self.env_steps.append((start, time.time_ns()))
            if len(self.env_steps) >= self.steps:
                self.stop()
                if self.recorder.asked_after_close():
                    raise WindowClosed()
            return out

        env.batch_step = stamped_step

    def start(self, rec: "Recorder"):
        self.recorder = rec
        self.last_window_round = rec.rounds[-1]
        self.prof.start()
        self.active = True

    def stop(self):
        if self.active:
            self.prof.stop()
            self.active = False

    def summary(self, window_rounds: List[dict], length: int) -> dict:
        """``tracing.summarize`` of the segment, with the sampler's ``(N,
        L)`` of the traced round's ask (none for a factored ask) and, when a
        tell ran in the segment, the ranking's ``n`` (the generation's
        population)."""
        from . import tracing

        self.stop()
        out = tracing.summarize(self.prof, self.env_steps)
        sampling, ranking = [], []
        if self.round is not None:
            if self.sampled:
                sampling.append([self.round["size"], length])
            last = self.last_window_round
            if self.round["generation"] != last["generation"]:
                ranking.append(sum(r["size"] for r in window_rounds if r["generation"] == last["generation"]))
        out.update(sampling_shapes=sampling, ranking_sizes=ranking)
        return out


def _window_summary(rounds: List[dict], t0: float, t_end: float) -> dict:
    """Host-clock and counter figures of the window's rounds."""
    tels = [r["telemetry"] for r in rounds if "telemetry" in r]
    return {
        "window_s": t_end - t0,
        "env_steps": rounds[-1]["count_after"] - rounds[0]["count_before"],
        "rounds": len(rounds),
        "eval_s": sum(r["t_after"] - r["t_before"] for r in rounds),
        "ctrl_steps": sum(t.capacity // max(t.lane_width, 1) for t in tels) if len(tels) == len(rounds) else None,
        "telemetry_env_steps": sum(t.env_steps for t in tels),
        "telemetry_capacity": sum(t.capacity for t in tels),
    }
