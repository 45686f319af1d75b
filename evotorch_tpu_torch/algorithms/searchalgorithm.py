"""Search-algorithm machinery (counterpart of
``evotorch_tpu/algorithms/searchalgorithm.py``): ``SearchAlgorithm`` with
its hooks and ``step()``/``run()`` orchestration, and
``SinglePopulationAlgorithmMixin``, the status getters over ``.population``.

``step`` publishes ``iter`` and ``step_seconds``, the per-step deltas of
the counter registry's ``compiles``, ``compile_seconds``, ``trace_spans``
and ``telemetry_fetches``, and ``peak_hbm_bytes``
(``torch.cuda.max_memory_allocated`` of the problem's card; 0 on the CPU),
and records a ``generation`` span on the host tracer
(``observability/tracer.py``). Where the JAX package's ``compiles`` count
XLA compiles, the port's count kernel libraries built or loaded
(``observability/compilecache.py``): a nonzero ``compiles`` after the
first generation is first-use work in a step that should have none.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..core import Problem
from ..observability.registry import counters
from ..observability.tracer import span
from ..tools.hook import Hook
from ..tools.lazyreporter import LazyReporter, LazyStatusDict

__all__ = [
    "LazyReporter",
    "LazyStatusDict",
    "SearchAlgorithm",
    "SinglePopulationAlgorithmMixin",
]


class SearchAlgorithm(LazyReporter):
    """Base class of the search algorithms: hooks, step orchestration, the
    run loop."""

    def __init__(self, problem: Problem, **kwargs):
        super().__init__(**kwargs)
        self._problem = problem
        self._before_step_hook = Hook()
        self._after_step_hook = Hook()
        self._log_hook = Hook()
        self._end_of_run_hook = Hook()
        self._steps_count = 0
        self._first_step_datetime: Optional[datetime] = None
        self._problem_status_keys: tuple = ()

    # ---- problem-status passthrough (lazy; lowest precedence) --------------
    # The problem's status merges into the algorithm's without reading its
    # device-resident entries. Precedence: _computed (update_status results,
    # after-step hooks included) > _getters (the algorithm's getters) > the
    # problem's keys. A read memoizes into _computed for the rest of the step.
    def get_status_value(self, key: str):
        try:
            return super().get_status_value(key)
        except KeyError:
            if key in self._problem_status_keys:
                value = self._problem.get_status_value(key)
                self._computed[key] = value
                return value
            raise

    def has_status_key(self, key: str) -> bool:
        return super().has_status_key(key) or key in self._problem_status_keys

    def iter_status_keys(self):
        seen = set()
        for k in super().iter_status_keys():
            seen.add(k)
            yield k
        for k in self._problem_status_keys:
            if k not in seen:
                yield k

    @property
    def problem(self) -> Problem:
        return self._problem

    @property
    def before_step_hook(self) -> Hook:
        return self._before_step_hook

    @property
    def after_step_hook(self) -> Hook:
        return self._after_step_hook

    @property
    def log_hook(self) -> Hook:
        return self._log_hook

    @property
    def end_of_run_hook(self) -> Hook:
        return self._end_of_run_hook

    @property
    def step_count(self) -> int:
        return self._steps_count

    @property
    def steps_count(self) -> int:
        return self._steps_count

    @property
    def first_step_datetime(self) -> Optional[datetime]:
        return self._first_step_datetime

    @property
    def is_terminated(self) -> bool:
        """Overridable termination criterion."""
        return False

    def _step(self):
        raise NotImplementedError

    def _peak_device_bytes(self) -> int:
        """The card's allocation high-water mark (0 on the CPU): read from
        the allocator's own count, no device sync."""
        device = getattr(self._problem, "device", None)
        if device is None or torch.device(device).type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(device))

    def step(self):
        """One generation. Publishes ``iter`` and ``step_seconds`` (the
        host's wall time of the step: the work it launched may still be
        running on the card when it returns), the step's deltas of the
        ``compiles``, ``compile_seconds`` (kernel libraries built or loaded,
        and their seconds), ``trace_spans`` and ``telemetry_fetches``
        counters, and ``peak_hbm_bytes``, the card's allocation high-water
        mark."""
        self._before_step_hook()
        self.clear_status()
        if self._first_step_datetime is None:
            self._first_step_datetime = datetime.now()
        meters = counters.snapshot(("compiles", "trace_spans", "telemetry_fetches", "compile_seconds"))
        t0 = time.perf_counter()
        with span("generation", "algo", n=self._steps_count + 1):
            self._step()
        step_seconds = time.perf_counter() - t0  # graftlint: allow(timing): the host's seconds by design (see above)
        self._steps_count += 1
        self.update_status({"iter": self._steps_count, "step_seconds": step_seconds})
        self.update_status(counters.delta(meters))
        self.update_status({"peak_hbm_bytes": self._peak_device_bytes()})
        self._problem_status_keys = tuple(self._problem.iter_status_keys())
        extra = self._after_step_hook.accumulate_dict()
        if extra:
            self.update_status(extra)
        if len(self._log_hook) >= 1:
            self._log_hook(dict(self.status.items()))

    def run(self, num_generations: int, *, reset_first_step_datetime: bool = True, profile_dir: Optional[str] = None):
        """Run ``num_generations`` steps. ``profile_dir`` takes a
        ``torch.profiler`` trace of the whole run (the host, and the card
        where there is one) and writes it there as ``trace.json``, readable
        in Perfetto or ``chrome://tracing``."""
        if reset_first_step_datetime:
            self.reset_first_step_datetime()

        def _run():
            for _ in range(int(num_generations)):
                self.step()
                if self.is_terminated:
                    break

        if profile_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._problem.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                _run()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(str(profile_dir), "trace.json"))
        else:
            _run()
        if len(self._end_of_run_hook) >= 1:
            self._end_of_run_hook(dict(self.status.items()))

    def reset_first_step_datetime(self):
        self._first_step_datetime = None


class SinglePopulationAlgorithmMixin:
    """Status getters over ``.population``: ``pop_best``, ``pop_best_eval``,
    ``mean_eval`` and ``median_eval`` (prefixed per objective when the
    algorithm works on all objectives of a multi-objective problem)."""

    def __init__(self, *, exclude: Optional[set] = None, enable: bool = True):
        if not enable:
            return
        exclude = exclude or set()
        problem = self.problem

        def make_getters(obj_index: int, prefix: str):
            # partials over bound methods (not closures) keep searchers picklable
            return {
                f"{prefix}pop_best": partial(self._status_pop_best, obj_index),
                f"{prefix}pop_best_eval": partial(self._status_pop_best_eval, obj_index),
                f"{prefix}mean_eval": partial(self._status_mean_eval, obj_index),
                f"{prefix}median_eval": partial(self._status_median_eval, obj_index),
            }

        algo_obj_index = getattr(self, "obj_index", None)
        if problem.is_multi_objective and algo_obj_index is None:
            getters = {}
            for i in range(problem.num_objectives):
                getters.update(make_getters(i, f"obj{i}_"))
        else:
            getters = make_getters(0 if algo_obj_index is None else int(algo_obj_index), "")
        self.update_status_getters({k: v for k, v in getters.items() if k not in exclude})

    def _status_pop_best(self, obj_index: int):
        batch = self.population
        return batch[int(batch.argbest(obj_index))].clone()

    def _status_pop_best_eval(self, obj_index: int) -> float:
        batch = self.population
        return float(batch.evals[int(batch.argbest(obj_index)), obj_index])

    def _status_mean_eval(self, obj_index: int) -> float:
        return float(np.nanmean(self.population.evals[:, obj_index].cpu().numpy()))

    def _status_median_eval(self, obj_index: int) -> float:
        return float(np.nanmedian(self.population.evals[:, obj_index].cpu().numpy()))
