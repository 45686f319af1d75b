"""Core runtime: ``Problem``, ``SolutionBatch``, ``SolutionBatchPieces``,
``Solution`` and ``ProblemBoundEvaluator`` (counterpart of
``evotorch_tpu/core.py``).

- **Device and randomness.** A ``Problem`` lives on one device (``cuda``
  unless ``device="cpu"`` is given; see ``_device.resolve_device``) and
  owns a ``torch.Generator`` there, seeded from ``seed``, where the JAX
  package keeps a PRNG key chain (``next_rng_key()``).
- **Population storage.** ``SolutionBatch`` holds the ``(N, L)`` values
  tensor it is given, without copying it (at popsize 10,000 and L 12,305 a
  copy would move 492 MB), and an ``(N, n_obj + eval_data_length)`` eval
  matrix where NaN means "not evaluated". ``values`` is that tensor itself:
  do not mutate it in place; write through ``set_values`` (or mutate what
  ``access_values`` returns, which invalidates the evals). Slices remember
  their parent and scatter evaluation results back into it by index, as in
  the JAX package.
- **Factored populations.** A batch may hold a ``LowRankParamsBatch`` or
  ``TrunkDeltaParamsBatch`` (``tools/lowrank.py``) as it is: ``values``
  returns it, slices and ``take`` gather its coefficient rows, ``cat``
  joins batches that share one center and basis (an ``is`` check, no host
  sync), a ``Solution``'s values densify its one row, and writes of values
  raise (a dense row has no representation in the basis). A plain fitness
  function gets the dense matrix (``dense_values``); ``VecNE`` keeps the
  population factored.
- **Best/worst tracking stays on the device.** Each evaluation reduces the
  batch to one best and one worst row per objective (for a factored batch,
  coefficient rows, then only those are densified) and merges them into
  ``(K, L)``/``(K, W)`` snapshots with tensor ops only; a Python float or
  a ``Solution`` is made when a status key is read.

- **Fan-out.** ``num_actors`` with a vectorized objective shards the
  population's rows over the ranks of the process group (one rank per
  card, ``parallel/``): every rank evaluates its block and gathers the
  results. With any other objective it starts that many worker processes
  (``parallel.HostEvaluatorPool``); a problem that cannot be pickled is
  evaluated serially, with a logged warning. ``num_subbatches`` /
  ``subbatch_size`` evaluate in pieces; ``num_gpus_per_actor`` is kept and
  unused, as in the JAX package (the port's layout is one rank per card).
  ``sample_and_compute_gradients`` is the distributed gradient path
  (``GaussianSearchAlgorithm(distributed=True)``).
- **Object-typed problems.** With ``dtype=object`` (no ``solution_length``,
  no bounds) a batch holds its values in an ``ObjectArray`` on the host
  (variable-length sequences, trees, ...), stored as immutable copies; the
  problem overrides ``_fill`` and evaluates one solution at a time. The
  evals stay a tensor on the problem's device, and best and worst are
  tracked on the host.

A multi-objective batch sorts by Pareto utility when no ``obj_index`` is
given (``operators.functional.pareto_utility``: fronts, then crowding), so
``take_best`` is NSGA-II selection; ``take`` reads its indices on the host,
one sync per call.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
from typing import Any, Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .operators.functional import pareto_ranks, pareto_utility
from .tools.cloning import Serializable, deep_clone
from .tools.hook import Hook
from .tools.lazyreporter import LazyReporter
from .tools.lowrank import dense_values, is_factored
from .tools.misc import ensure_tensor_length_and_dtype, is_dtype_object, to_torch_dtype
from .tools.objectarray import ObjectArray
from .tools.ranking import rank
from .tools.recursiveprintable import RecursivePrintable
from .tools.tensormaker import TensorMakerMixin

__all__ = [
    "Problem",
    "Solution",
    "SolutionBatch",
    "SolutionBatchPieces",
    "ProblemBoundEvaluator",
]

ObjectiveSense = Union[str, Iterable[str]]
BoundsPair = Any


def _normalize_senses(objective_sense: ObjectiveSense) -> List[str]:
    senses = [objective_sense] if isinstance(objective_sense, str) else list(objective_sense)
    for s in senses:
        if s not in ("min", "max"):
            raise ValueError(f"Invalid objective sense: {s!r} (expected 'min' or 'max')")
    if len(senses) == 0:
        raise ValueError("At least one objective sense is required")
    return senses


def _batch_extremes(values: torch.Tensor, evdata: torch.Tensor, senses: tuple):
    """The best and worst row of ONE batch for each objective, as ``(K, L)``
    and ``(K, W)`` stacks, found on the device. An all-NaN column yields a
    NaN eval row, which the merge ignores."""
    bvs, bes, wvs, wes = [], [], [], []
    for i, sense in enumerate(senses):
        col = evdata[:, i]
        valid = ~torch.isnan(col)
        any_valid = valid.any()
        for extreme_is_max, (vs, es) in ((sense == "max", (bvs, bes)), (sense != "max", (wvs, wes))):
            masked = torch.where(valid, col, -math.inf if extreme_is_max else math.inf)
            idx = (torch.argmax(masked) if extreme_is_max else torch.argmin(masked)).reshape(1)
            vs.append(values.index_select(0, idx)[0])
            row = evdata.index_select(0, idx)[0]
            es.append(torch.where(any_valid, row, torch.full_like(row, math.nan)))
    return torch.stack(bvs), torch.stack(bes), torch.stack(wvs), torch.stack(wes)


def _merge_snapshots(bv, be, wv, we, cbv, cbe, cwv, cwe, senses: tuple):
    """Fold one batch's candidate extreme rows into the running snapshots,
    with tensor ops only (no host round trip)."""

    def fold(cur_v, cur_e, cand_v, cand_e, i, higher_better):
        cand = cand_e[i]
        cur = cur_e[i]
        better = (cand > cur) if higher_better else (cand < cur)
        take = ~torch.isnan(cand) & (torch.isnan(cur) | better)
        return torch.where(take, cand_v, cur_v), torch.where(take, cand_e, cur_e)

    bv, be, wv, we = bv.clone(), be.clone(), wv.clone(), we.clone()
    for i, sense in enumerate(senses):
        hb = sense == "max"
        bv[i], be[i] = fold(bv[i], be[i], cbv[i], cbe[i], i, hb)
        wv[i], we[i] = fold(wv[i], we[i], cwv[i], cwe[i], i, not hb)
    return bv, be, wv, we


class Problem(TensorMakerMixin, LazyReporter, Serializable, RecursivePrintable):
    """The problem abstraction: objective sense(s), decision-variable dtype,
    length and bounds, and an evaluation procedure, either a fitness function
    given as ``objective_func`` (``vectorized=True``, or a function marked
    ``__evotorch_vectorized__``, takes the whole ``(N, L)`` values tensor)
    or an overridden ``_evaluate`` / ``_evaluate_batch``.

    The status (``problem.status``) is lazy: best and worst solutions are
    tracked as device tensors and reach the host only when a status entry is
    read."""

    def __init__(
        self,
        objective_sense: ObjectiveSense,
        objective_func: Optional[Callable] = None,
        *,
        initial_bounds: Optional[BoundsPair] = None,
        bounds: Optional[BoundsPair] = None,
        solution_length: Optional[int] = None,
        dtype: Any = None,
        eval_dtype: Any = None,
        device: Any = None,
        eval_data_length: int = 0,
        seed: Optional[int] = None,
        num_actors: Optional[Union[int, str]] = None,
        num_gpus_per_actor: Optional[Union[int, float, str]] = None,
        num_subbatches: Optional[int] = None,
        subbatch_size: Optional[int] = None,
        store_solution_stats: Optional[bool] = None,
        vectorized: Optional[bool] = None,
    ):
        if num_subbatches is not None and subbatch_size is not None:
            raise ValueError("Provide at most one of num_subbatches / subbatch_size")
        if num_subbatches is not None and int(num_subbatches) < 1:
            raise ValueError(f"num_subbatches must be >= 1, got {num_subbatches}")
        if subbatch_size is not None and int(subbatch_size) < 1:
            raise ValueError(f"subbatch_size must be >= 1, got {subbatch_size}")
        # the fan-out request, resolved at the first evaluation
        self._num_actors_requested = num_actors
        self._num_gpus_per_actor = num_gpus_per_actor
        self._num_subbatches = num_subbatches
        self._subbatch_size = subbatch_size
        self._sharded_evaluator = None
        self._eval_mesh = None
        self._sharded_grad_cache: dict = {}
        self._host_pool = None
        self._senses = _normalize_senses(objective_sense)
        self._objective_func = objective_func
        self._dtype = torch.float32 if dtype is None else to_torch_dtype(dtype)
        self._eval_dtype = torch.float32 if eval_dtype is None else to_torch_dtype(eval_dtype)
        if is_dtype_object(self._eval_dtype):
            raise ValueError("eval_dtype cannot be object")
        self._eval_data_length = int(eval_data_length)
        self._device = resolve_device(device)

        if is_dtype_object(self._dtype):
            if solution_length is not None:
                raise ValueError("solution_length must be None when dtype is object")
            if initial_bounds is not None or bounds is not None:
                raise ValueError("bounds are not supported when dtype is object")
            self.solution_length = None
            self._bounds_are_strict = False
            self._lower_bounds = self._upper_bounds = None
            self._initial_lower_bounds = self._initial_upper_bounds = None
        else:
            if solution_length is None:
                raise ValueError("solution_length is required for non-object dtypes")
            self.solution_length = int(solution_length)
            self._bounds_are_strict = bounds is not None
            if bounds is not None and initial_bounds is None:
                initial_bounds = bounds
            self._lower_bounds, self._upper_bounds = self._process_bounds(bounds)
            self._initial_lower_bounds, self._initial_upper_bounds = self._process_bounds(initial_bounds)

        if vectorized is None:
            vectorized = bool(objective_func is not None and getattr(objective_func, "__evotorch_vectorized__", False))
        self._vectorized = bool(vectorized)

        self._seed = 0 if seed is None else int(seed)
        self._generator = torch.Generator(device=self._device).manual_seed(self._seed)

        self._store_solution_stats = True if store_solution_stats is None else bool(store_solution_stats)
        self._best_snapshot = None  # device-side (values (K, L), evals (K, W))
        self._worst_snapshot = None
        self._best: Optional[List[Optional["Solution"]]] = None  # object-typed problems
        self._worst: Optional[List[Optional["Solution"]]] = None

        self.before_eval_hook: Hook = Hook()
        self.after_eval_hook: Hook = Hook()
        self.before_grad_hook: Hook = Hook()
        self.after_grad_hook: Hook = Hook()

        self._prepared = False
        LazyReporter.__init__(self)

    # ------------------------------------------------------------------ info
    @property
    def senses(self) -> List[str]:
        return list(self._senses)

    @property
    def objective_sense(self) -> Union[str, List[str]]:
        return self._senses[0] if len(self._senses) == 1 else list(self._senses)

    @property
    def is_multi_objective(self) -> bool:
        return len(self._senses) > 1

    @property
    def num_objectives(self) -> int:
        return len(self._senses)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def eval_dtype(self) -> torch.dtype:
        return self._eval_dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def generator(self) -> torch.Generator:
        """The problem's random stream (the JAX package's key chain)."""
        return self._generator

    @property
    def eval_data_length(self) -> int:
        return self._eval_data_length

    @property
    def lower_bounds(self):
        return self._lower_bounds

    @property
    def upper_bounds(self):
        return self._upper_bounds

    @property
    def initial_lower_bounds(self):
        return self._initial_lower_bounds

    @property
    def initial_upper_bounds(self):
        return self._initial_upper_bounds

    @property
    def is_main(self) -> bool:
        """False inside a host-pool worker process (the reference actors'
        ``is_main``); True in the main program. The sharded paths never
        leave their ranks' processes, so every rank is a main program."""
        return getattr(self, "_is_main", True)

    def _process_bounds(self, bounds: Optional[BoundsPair]):
        if bounds is None:
            return None, None
        lb, ub = bounds
        lb = self.ensure_tensor_length_and_dtype(lb, about="lower bound")
        ub = self.ensure_tensor_length_and_dtype(ub, about="upper bound")
        if bool(torch.any(lb > ub)):
            raise ValueError("Some lower bounds exceed their upper bounds")
        return lb, ub

    # ------------------------------------------------------------------ PRNG
    def manual_seed(self, seed: Optional[int] = None):
        """Re-seed the problem's generator."""
        self._seed = 0 if seed is None else int(seed)
        self._generator.manual_seed(self._seed)

    # ------------------------------------------------------------- solutions
    def generate_values(
        self, num_solutions: int, *, generator: Optional[torch.Generator] = None
    ) -> Union[torch.Tensor, ObjectArray]:
        """Decision values for ``num_solutions`` new solutions; delegates to
        ``_fill``."""
        return self._fill(int(num_solutions), self._generator if generator is None else generator)

    def _fill(self, num_solutions: int, generator: torch.Generator) -> Union[torch.Tensor, ObjectArray]:
        """Default initialization: uniform within the initial bounds.
        Override for custom initialization (an object-typed problem must)."""
        if is_dtype_object(self._dtype):
            raise NotImplementedError("Object-typed problems must override _fill (or generate_values)")
        if self._initial_lower_bounds is None:
            raise RuntimeError(
                "Cannot generate solutions: no initial_bounds / bounds were given and _fill was not overridden"
            )
        if self._dtype == torch.bool:
            return self.make_uniform(num_solutions=num_solutions, dtype=torch.float32, generator=generator) < 0.5
        return self.make_uniform(
            num_solutions=num_solutions,
            lb=self._initial_lower_bounds,
            ub=self._initial_upper_bounds,
            generator=generator,
        )

    def generate_batch(
        self,
        popsize: int,
        *,
        empty: bool = False,
        center: Optional[torch.Tensor] = None,
        stdev: Optional[float] = None,
        symmetric: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> "SolutionBatch":
        """A new ``SolutionBatch``."""
        if empty:
            return SolutionBatch(self, popsize, empty=True)
        if center is not None or stdev is not None:
            values = self.make_gaussian(
                num_solutions=popsize, center=center, stdev=stdev, symmetric=symmetric, generator=generator
            )
        else:
            values = self.generate_values(popsize, generator=generator)
        return SolutionBatch(self, popsize, values=values)

    # ------------------------------------------------------------- evaluation
    def _start_preparations(self):
        if not self._prepared:
            self._prepare()
            self._prepared = True

    def _prepare(self):
        """One-time preparation before the first evaluation."""

    def evaluate(self, batch: Union["SolutionBatch", "Solution"]):
        """Evaluate every solution of the batch: run the before-hooks,
        compute the fitnesses, scatter them into the batch, track best and
        worst, run the after-hooks (their dict results go into
        ``problem.status``)."""
        if isinstance(batch, Solution):
            batch = batch.to_batch()
        if not isinstance(batch, SolutionBatch):
            raise TypeError(f"evaluate expects a SolutionBatch or Solution, got {type(batch)}")
        self._start_preparations()
        self.before_eval_hook(batch)
        with torch.profiler.record_function("evotorch_tpu_torch.evaluate"):
            self._evaluate_all(batch)
            if self._store_solution_stats:
                self._update_best_and_worst(batch)
        hook_results = self.after_eval_hook.accumulate_dict(batch)
        if hook_results:
            self.update_status(hook_results)

    def _evaluate_all(self, batch: "SolutionBatch"):
        """One evaluation of the whole batch: over the worker processes when
        a pool was started (``num_actors`` with a non-vectorized objective),
        over the ranks when a sharded evaluator is installed
        (``use_sharded_evaluation``, or ``num_actors`` with a vectorized
        objective), else in pieces (``num_subbatches`` / ``subbatch_size``)
        or at once."""
        self._resolve_num_actors_request()
        if self._host_pool is not None and len(batch) > 0:
            self._evaluate_with_host_pool(batch)
            return
        if self._sharded_evaluator is not None:
            # the ranks already bound each one's rows: no sub-batches
            mesh = self._eval_mesh
            if mesh.member:
                batch.set_evals(*self._split_eval_outputs(self._sharded_evaluator(dense_values(batch.values))))
            if mesh.partial:
                # a mesh over the first ranks: the others take its evals
                batch._set_evdata(mesh.spread([batch._evdata])[0])
            return
        if (self._num_subbatches is not None or self._subbatch_size is not None) and len(batch) > 0:
            for piece in self._pieces(batch):
                self._evaluate_batch(piece)
            return
        self._evaluate_batch(batch)

    def _pieces(self, batch: "SolutionBatch", default: Optional[int] = None) -> "SolutionBatchPieces":
        if self._num_subbatches is not None:
            return batch.split(min(int(self._num_subbatches), len(batch)))
        if self._subbatch_size is not None:
            return batch.split(max_size=int(self._subbatch_size))
        return batch.split(min(int(default), len(batch)))

    def _resolve_num_actors_request(self):
        """``num_actors``, resolved once at the first evaluation: with a
        vectorized objective, a sharded evaluator over the ranks of the
        process group (``"max"``, ``"num_devices"``, ``"num_gpus"``,
        ``"num_cpus"``: all of them; a number: at most that many, which must
        then be all of them, one shard per rank); with any other objective,
        that many worker processes (``"max"``: one per CPU core)."""
        if self._num_actors_requested is None or self._sharded_evaluator is not None or self._host_pool is not None:
            return
        request = self._num_actors_requested
        self._num_actors_requested = None  # resolve once
        named = ("max", "num_cpus", "num_devices", "num_gpus")
        if isinstance(request, str) and request not in named:
            raise ValueError(f"Unrecognized num_actors request: {request!r}")
        if not self._vectorized or self._objective_func is None:
            n = (os.cpu_count() or 1) if isinstance(request, str) else int(request)
            if n <= 1:
                return
            from .parallel.hostpool import HostEvaluatorPool

            # each worker's seed drawn from the problem's generator
            seeds = torch.randint(0, 2**31 - 1, (n,), generator=self._generator, device=self._device).tolist()
            try:
                self._host_pool = HostEvaluatorPool(self, n, seeds=seeds)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                logging.getLogger("evotorch_tpu_torch").warning(
                    "num_actors=%r: the problem could not be pickled for worker processes (%s); evaluating serially"
                    " instead. Define the objective at module level to enable the pool.",
                    request,
                    e,
                )
            return
        from .parallel.mesh import num_actors_mesh

        mesh = num_actors_mesh(request)
        if mesh is not None:
            self.use_sharded_evaluation(mesh)

    def _evaluate_with_host_pool(self, batch: "SolutionBatch"):
        """Split, map over the worker processes, scatter back, with the sync
        protocol around it."""
        pool = self._host_pool
        pieces = self._pieces(batch, default=pool.num_workers)
        sync = self._make_sync_data_for_actors()
        try:
            evals, sync_back = pool.evaluate_pieces([dense_values(p.values) for p in pieces], sync)
        except Exception:
            # the pool shut itself down; a later evaluation must not use it
            self._host_pool = None
            raise
        for piece, piece_evals in zip(pieces, evals):
            piece.set_evals(torch.as_tensor(piece_evals, dtype=self._eval_dtype, device=self._device))
        self._use_sync_data_from_actors(sync_back)

    # ------------------------------------- main <-> worker sync protocol
    def _make_sync_data_for_actors(self) -> Optional[dict]:
        """State sent to every worker before an evaluation round (default:
        nothing)."""
        return None

    def _use_sync_data_from_main(self, data: dict):
        """Worker side: apply the state sent by the main process."""

    def _make_sync_data_for_main(self) -> dict:
        """Worker side: what to send home after a round (default: nothing)."""
        return {}

    def _use_sync_data_from_actors(self, data_list: List[dict]):
        """Merge what the workers sent home."""

    def kill_actors(self):
        """Shut the worker processes down, if a pool was started."""
        if self._host_pool is not None:
            self._host_pool.shutdown()
            self._host_pool = None

    @property
    def is_remote(self) -> bool:
        return False

    def _get_cloned_state(self, *, memo: dict) -> dict:
        # evaluators, meshes and worker processes neither pickle nor clone
        state = {}
        for k, v in self.__dict__.items():
            if k in ("_sharded_evaluator", "_eval_mesh", "_host_pool"):
                state[k] = None
            elif k == "_sharded_grad_cache":
                state[k] = {}
            else:
                state[k] = deep_clone(v, memo=memo)
        return state

    def _evaluate_batch(self, batch: "SolutionBatch"):
        """Vectorized objective call, or a per-solution loop. A factored
        population is densified here: a plain fitness function takes dense
        vectors (``VecNE`` overrides this and keeps it factored)."""
        if self._vectorized and self._objective_func is not None:
            result = self._objective_func(dense_values(batch.values))
            batch.set_evals(*self._split_eval_outputs(result))
        elif self._objective_func is not None and not is_dtype_object(self._dtype):
            # per-solution loop, accumulated on the host and scattered once
            values = dense_values(batch.values)
            rows = []
            width = self.num_objectives + self._eval_data_length
            for i in range(len(batch)):
                result = self._objective_func(values[i])
                if isinstance(result, torch.Tensor):
                    result = result.detach().cpu().numpy()
                row = np.atleast_1d(np.asarray(result, dtype=np.float64))
                if row.shape[0] < width:
                    row = np.concatenate([row, np.full(width - row.shape[0], np.nan)])
                rows.append(row)
            batch.set_evals(torch.as_tensor(np.stack(rows), dtype=self._eval_dtype, device=self._device))
        else:
            for sln in batch:
                self._evaluate(sln)

    def _evaluate(self, solution: "Solution"):
        """Per-solution evaluation."""
        if self._objective_func is None:
            raise NotImplementedError("Either provide objective_func, or override _evaluate/_evaluate_batch")
        solution.set_evals(self._objective_func(solution.values))

    def _split_eval_outputs(self, result):
        """A fitness function's result as ``(fitnesses,)`` or
        ``(fitnesses, eval_data)``."""
        if isinstance(result, tuple):
            return result
        result = torch.as_tensor(result, device=self._device)
        width = len(self._senses) + self._eval_data_length
        if self._eval_data_length > 0 and result.ndim == 2 and result.shape[-1] == width:
            return result[:, : len(self._senses)], result[:, len(self._senses) :]
        return (result,)

    # --------------------------------------------------------- best tracking
    def _update_best_and_worst(self, batch: "SolutionBatch"):
        """Track the best and worst solution of each objective, merged on the
        device; Solutions and floats are made by the status getters."""
        if len(batch) == 0:
            return
        if is_dtype_object(self._dtype):
            self._update_best_and_worst_host(batch)
            return
        if self._best_snapshot is None:
            k, w = len(self._senses), len(self._senses) + self._eval_data_length
            zeros_v = torch.zeros((k, self.solution_length), dtype=self._dtype, device=self._device)
            nans_e = torch.full((k, w), math.nan, dtype=self._eval_dtype, device=self._device)
            self._best_snapshot = (zeros_v, nans_e)
            self._worst_snapshot = (zeros_v, nans_e)
            self._register_best_status_getters()
        senses = tuple(self._senses)
        values = batch.values
        if is_factored(values):
            # the extreme coefficient rows, then only those K rows densified
            cbv, cbe, cwv, cwe = _batch_extremes(values.coeffs, batch.evals, senses)
            candidates = (values.materialize_rows(cbv), cbe, values.materialize_rows(cwv), cwe)
        else:
            candidates = _batch_extremes(values, batch.evals, senses)
        bv, be, wv, we = _merge_snapshots(*self._best_snapshot, *self._worst_snapshot, *candidates, senses)
        self._best_snapshot = (bv, be)
        self._worst_snapshot = (wv, we)
        for key in self._best_status_keys():
            self._computed.pop(key, None)

    def _update_best_and_worst_host(self, batch: "SolutionBatch"):
        """The object-typed path: the best and worst solutions of each
        objective kept as ``Solution`` clones, merged on the host."""
        if self._best is None:
            self._best = [None] * len(self._senses)
            self._worst = [None] * len(self._senses)
        evals = batch.evals.detach().cpu().numpy()
        for i, sense in enumerate(self._senses):
            col = evals[:, i]
            if np.all(np.isnan(col)):
                continue
            best_idx = int(np.nanargmax(col) if sense == "max" else np.nanargmin(col))
            worst_idx = int(np.nanargmin(col) if sense == "max" else np.nanargmax(col))
            for kept, idx, higher in ((self._best, best_idx, sense == "max"), (self._worst, worst_idx, sense != "max")):
                current = kept[i]
                candidate = float(col[idx])
                if current is None or (candidate > float(current.evals[i]) if higher else candidate < float(current.evals[i])):
                    kept[i] = batch[idx].clone()
        if len(self._senses) == 1:
            if self._best[0] is not None:
                self.update_status(
                    {
                        "best": self._best[0],
                        "worst": self._worst[0],
                        "best_eval": float(self._best[0].evals[0]),
                        "worst_eval": float(self._worst[0].evals[0]),
                    }
                )
        else:
            # each objective publishes on its own (one may be all-NaN so far)
            for i in range(len(self._senses)):
                if self._best[i] is not None:
                    self.update_status({f"obj{i}_best": self._best[i], f"obj{i}_worst": self._worst[i]})

    def _best_status_keys(self):
        if len(self._senses) == 1:
            return ("best", "worst", "best_eval", "worst_eval")
        keys = []
        for i in range(len(self._senses)):
            keys += [f"obj{i}_best", f"obj{i}_worst"]
        return tuple(keys)

    def _register_best_status_getters(self):
        from functools import partial

        if len(self._senses) == 1:
            self.update_status_getters(
                {
                    "best": partial(self._materialize_extreme, "best", 0),
                    "worst": partial(self._materialize_extreme, "worst", 0),
                    "best_eval": partial(self._materialize_extreme_eval, "best", 0),
                    "worst_eval": partial(self._materialize_extreme_eval, "worst", 0),
                }
            )
        else:
            getters = {}
            for i in range(len(self._senses)):
                getters[f"obj{i}_best"] = partial(self._materialize_extreme, "best", i)
                getters[f"obj{i}_worst"] = partial(self._materialize_extreme, "worst", i)
            self.update_status_getters(getters)

    def _materialize_extreme(self, which: str, obj_index: int) -> "Solution":
        snap = self._best_snapshot if which == "best" else self._worst_snapshot
        if snap is None:
            raise KeyError(which)
        values, evals = snap
        if bool(torch.isnan(evals[obj_index, obj_index])):
            raise KeyError(which)  # not ready: no valid evaluation yet
        batch = SolutionBatch(self, 1, values=values[obj_index][None, :], evals=evals[obj_index][None, :])
        return batch[0]

    def _materialize_extreme_eval(self, which: str, obj_index: int) -> float:
        snap = self._best_snapshot if which == "best" else self._worst_snapshot
        if snap is None:
            raise KeyError(which)
        value = float(snap[1][obj_index, obj_index])
        if math.isnan(value):
            raise KeyError(which)  # not ready: no valid evaluation yet
        return value

    # ------------------------------------------------ sharded evaluation
    def use_sharded_evaluation(self, mesh=None):
        """Shard the population's rows over ``mesh``'s ranks (the default:
        every rank of the default group): each rank evaluates its block of
        rows and the results are gathered to every rank. Needs a vectorized
        objective function."""
        from .parallel import default_mesh, make_sharded_evaluator

        if not self._vectorized or self._objective_func is None:
            raise ValueError("Sharded evaluation requires a @vectorized objective_func")
        mesh = default_mesh() if mesh is None else mesh
        self._sharded_evaluator = make_sharded_evaluator(self._objective_func, mesh=mesh, device=self._device)
        self._eval_mesh = mesh
        self._sharded_grad_cache.clear()
        return self

    def _drop_sharded_evaluation(self):
        self._sharded_evaluator = None
        self._eval_mesh = None
        self._sharded_grad_cache.clear()

    # --------------------------------- distributed ES-gradient estimation
    def sample_and_compute_gradients(
        self,
        distribution,
        popsize: int,
        *,
        num_interactions: Optional[int] = None,
        popsize_max: Optional[int] = None,
        obj_index: int = 0,
        ranking_method: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        lowrank_rank: Optional[int] = None,
    ) -> List[dict]:
        """Sample a population from ``distribution``, evaluate it and return
        its ES gradients, as a list of one dict (``gradients``,
        ``num_solutions``, ``mean_eval``, and ``basis`` for a factored
        population) for the reference's list-of-actors signature.

        With a sharded evaluator (``num_actors`` or
        ``use_sharded_evaluation``) and no interaction budget, the pipeline
        runs over the ranks (``parallel.make_sharded_grad_estimator``):
        every rank samples the whole population, evaluates its block, ranks
        the gathered fitnesses globally; the same gradients on every rank.
        Under ``EVOTORCH_SHARD_MAP=1`` each rank samples its own
        sub-population (the popsize rounded up to an equal, and for an
        antithetic distribution even, share per rank) and ranks it locally,
        the gradients averaged (the reference's distributed mode).
        Otherwise the population is sampled from ``generator`` (the
        problem's), evaluated and its gradients computed here; with
        ``num_interactions`` rounds of ``popsize`` are sampled until the
        problem reports more interactions than that (or ``popsize_max``
        solutions). ``lowrank_rank`` samples factored populations (later
        rounds reuse the first round's basis)."""
        generator = self._generator if generator is None else generator
        if lowrank_rank is not None and not hasattr(type(distribution), "_sample_lowrank"):
            raise ValueError(
                f"{type(distribution).__name__} has no factored sampler; lowrank_rank requires SymmetricSeparableGaussian"
            )
        self._start_preparations()
        self.before_grad_hook()
        self._resolve_num_actors_request()
        if self._eval_mesh is not None and num_interactions is None:
            result = self._sharded_sample_and_compute_gradients(
                distribution, popsize, obj_index=obj_index, ranking_method=ranking_method, generator=generator,
                lowrank_rank=lowrank_rank,
            )  # fmt: skip
            basis = result.pop("basis", None)
            hook_results = self.after_grad_hook.accumulate_dict(result)
            if hook_results:
                self.update_status(hook_results)
            if basis is not None:
                result["basis"] = basis
            return [result]

        def sample_and_eval(n, basis=None):
            if lowrank_rank is not None:
                samples = distribution.sample_lowrank(int(n), int(lowrank_rank), generator=generator, basis=basis)
                batch = SolutionBatch(self, values=samples)
            else:
                samples = distribution.sample(int(n), generator=generator)
                batch = SolutionBatch(self, samples.shape[0], values=samples)
            self.evaluate(batch)
            return samples, batch.evals[:, obj_index]

        if num_interactions is None:
            all_samples, all_fitnesses = sample_and_eval(popsize)
        else:
            first_count = int(self.status.get("total_interaction_count", 0))
            sample_chunks, fitness_chunks = [], []
            total, prev_made, gen_basis = 0, -1, None
            while True:
                chunk, fitnesses = sample_and_eval(popsize, basis=gen_basis)
                if lowrank_rank is not None and gen_basis is None:
                    gen_basis = chunk.basis  # later rounds stay concatenable
                sample_chunks.append(chunk)
                fitness_chunks.append(fitnesses)
                total += fitnesses.shape[0]
                if popsize_max is not None and total >= int(popsize_max):
                    break
                made = int(self.status.get("total_interaction_count", 0)) - first_count
                if made > int(num_interactions) or "total_interaction_count" not in self.status or made <= prev_made:
                    break  # the budget is met, not reported, or no longer advancing
                prev_made = made
            if lowrank_rank is not None:
                all_samples = sample_chunks[0]._replace(coeffs=torch.cat([c.coeffs for c in sample_chunks]))
            else:
                all_samples = torch.cat(sample_chunks)
            all_fitnesses = torch.cat(fitness_chunks)
        grads = distribution.compute_gradients(
            all_samples,
            all_fitnesses,
            objective_sense=self._senses[obj_index],
            ranking_method=ranking_method if ranking_method is not None else "raw",
        )
        num_solutions = all_samples.popsize if is_factored(all_samples) else int(all_samples.shape[0])
        result = {"gradients": grads, "num_solutions": num_solutions, "mean_eval": torch.mean(all_fitnesses)}
        hook_results = self.after_grad_hook.accumulate_dict(result)
        if hook_results:
            self.update_status(hook_results)
        if is_factored(all_samples):
            result["basis"] = all_samples.basis
        return [result]

    def _sharded_sample_and_compute_gradients(
        self, distribution, popsize: int, *, obj_index: int, ranking_method, generator, lowrank_rank=None
    ) -> dict:
        from .parallel.evaluate import _use_shard_map
        from .parallel.grad import make_sharded_grad_estimator

        mesh = self._eval_mesh
        dist_cls = type(distribution)
        total = int(popsize)
        if _use_shard_map(None):
            # an equal (and, for antithetic sampling, even) share per rank
            local = -(-total // mesh.size)
            if dist_cls.SAMPLES_MUST_BE_EVEN and local % 2 != 0:
                local += 1
            total = local * mesh.size
        ranking = ranking_method if ranking_method is not None else "raw"
        sense = self._senses[obj_index]
        cache_key = (dist_cls, ranking, obj_index, sense, lowrank_rank, _use_shard_map(None))
        estimator = self._sharded_grad_cache.get(cache_key)
        if estimator is None:

            def fitness_for_grad(values):
                fitnesses = torch.as_tensor(self._split_eval_outputs(self._objective_func(values))[0])
                return fitnesses[:, obj_index] if fitnesses.ndim == 2 else fitnesses

            estimator = self._sharded_grad_cache[cache_key] = make_sharded_grad_estimator(
                dist_cls, fitness_for_grad, objective_sense=sense, ranking_method=ranking, mesh=mesh, with_aux=True,
                lowrank_rank=lowrank_rank,
            )  # fmt: skip
        grads, aux = estimator(generator, total, distribution.parameters)
        result = {"gradients": grads, "num_solutions": total, "mean_eval": aux["mean_eval"]}
        if "basis" in aux:
            result["basis"] = aux["basis"]
        return result

    # ----------------------------------------------------------------- misc
    def ensure_numeric(self):
        """Raise if the problem is object-typed (distribution-based
        searchers need a numeric problem)."""
        if is_dtype_object(self._dtype):
            raise ValueError("This operation requires a numeric (non-object) problem dtype")

    def ensure_unbounded(self):
        """Raise if the problem declares strict bounds (distribution-based
        searchers cannot respect them)."""
        if self._bounds_are_strict:
            raise ValueError(
                "Distribution-based searchers require an unbounded problem; "
                "use initial_bounds (not bounds) to seed the search"
            )

    def normalize_obj_index(self, obj_index: Optional[int] = None) -> int:
        """Validate and normalize an objective index."""
        if obj_index is None:
            if len(self._senses) > 1:
                raise ValueError("obj_index must be given explicitly for multi-objective problems")
            return 0
        i = int(obj_index)
        if i < 0:
            i += len(self._senses)
        if not (0 <= i < len(self._senses)):
            raise IndexError(f"obj_index {obj_index} out of range")
        return i

    def ensure_tensor_length_and_dtype(self, x, *, about=None, allow_scalar=True) -> torch.Tensor:
        return ensure_tensor_length_and_dtype(
            x, self.solution_length, self._dtype, device=self._device, about=about, allow_scalar=allow_scalar
        )

    def make_callable_evaluator(self, *, obj_index: int = 0) -> "ProblemBoundEvaluator":
        """This problem as a callable ``f(values) -> fitnesses`` for the
        functional algorithms."""
        return ProblemBoundEvaluator(self, obj_index=obj_index)

    def _printable_items(self):
        return {"objective_sense": self.objective_sense, "solution_length": self.solution_length, "dtype": self._dtype}


def _cat_factored(parts: list):
    """Factored populations of one form that share one center and basis
    (checked with ``is``: the rounds of one generation carry the same
    tensors, and no host sync is made), as one."""
    first = parts[0]
    if not all(type(p) is type(first) for p in parts):
        raise TypeError(
            "Cannot concatenate factored batches with dense ones or with a different factored form; materialize"
            " first (batch.values.materialize())"
        )
    if not all(p.center is first.center and p.basis is first.basis for p in parts[1:]):
        raise ValueError(
            "Factored batches concatenate only when they share one generation's center and basis tensors (sample the"
            " later rounds with sample_lowrank(..., basis=first_batch.values.basis)); batches drawn against different"
            " bases have no shared factored form: materialize first (batch.values.materialize())"
        )
    return first._replace(coeffs=torch.cat([p.coeffs for p in parts], dim=0))


def _check_batch_device(device, here: torch.device):
    device = torch.device(device)
    if device.type != here.type or device.index not in (None, here.index):
        raise ValueError(f"a batch lives on its problem's device ({here}), not on {device}")


class SolutionBatch(Serializable, RecursivePrintable):
    """Population container: decision values ``(N, L)`` and an eval matrix
    ``(N, n_obj + eval_data_length)`` where NaN means "not evaluated"."""

    def __init__(
        self,
        problem: Optional[Problem] = None,
        popsize: Optional[int] = None,
        *,
        device: Any = None,
        empty: bool = False,
        slice_of: Optional[tuple] = None,
        like: Optional["SolutionBatch"] = None,
        merging_of: Optional[Iterable["SolutionBatch"]] = None,
        values: Any = None,
        evals: Any = None,
    ):
        """``device``, when given, must be the problem's: a batch lives on
        its problem's device."""
        self._parent: Optional[tuple] = None  # (parent batch, row indices tensor)
        if device is not None:
            merging_of = None if merging_of is None else list(merging_of)
            sources = (like, slice_of[0] if slice_of is not None else None, *(merging_of or ()))
            owner = problem or next((b._problem for b in sources if b is not None), None)
            if owner is not None:
                _check_batch_device(device, owner.device)

        if merging_of is not None:
            batches = list(merging_of)
            if not batches:
                raise ValueError("merging_of needs at least one batch")
            self._problem = batches[0]._problem
            if any(is_factored(b._values) for b in batches):
                self._values = _cat_factored([b._values for b in batches])
            elif isinstance(batches[0]._values, ObjectArray):
                self._values = ObjectArray.from_values([v for b in batches for v in b._values])
            else:
                self._values = torch.cat([b._values for b in batches], dim=0)
            self._evdata = torch.cat([b._evdata for b in batches], dim=0)
            return

        if slice_of is not None:
            source, sl = slice_of
            self._problem = source._problem
            if isinstance(sl, slice):
                # a basic slice is a view: no copy of the values (an object
                # one shares its storage with the source)
                indices = torch.arange(len(source), device=source.device)[sl]
                self._values = source._values.take(sl) if is_factored(source._values) else source._values[sl]
            else:
                indices = torch.as_tensor(np.asarray(sl), dtype=torch.int64, device=source.device).reshape(-1)
                if isinstance(source._values, ObjectArray):
                    # a copy: writes go up through _scatter_object_values
                    self._values = source._values[indices.tolist()]
                elif is_factored(source._values):
                    # coefficient rows; center, basis and factors are shared
                    self._values = source._values.take(indices)
                else:
                    self._values = source._values.index_select(0, indices)
            self._parent = (source, indices)
            self._evdata = source._evdata.index_select(0, indices)
            return

        if like is not None:
            problem = like._problem
            popsize = len(like) if popsize is None else popsize

        if problem is None:
            raise ValueError("SolutionBatch requires a problem (or slice_of/like/merging_of)")
        self._problem = problem
        n_evals = problem.num_objectives + problem.eval_data_length

        if values is not None and is_factored(values):
            # stored as it is: the dense (N, L) matrix is never built here
            _check_batch_device(values.coeffs.device, problem.device)
            self._values = values
            self._evdata = (
                torch.as_tensor(evals, dtype=problem.eval_dtype, device=problem.device)
                if evals is not None
                else torch.full((values.popsize, n_evals), math.nan, dtype=problem.eval_dtype, device=problem.device)
            )
            return

        if isinstance(values, ObjectArray):
            self._values = values
            self._evdata = (
                torch.as_tensor(evals, dtype=problem.eval_dtype, device=problem.device)
                if evals is not None
                else torch.full((len(values), n_evals), math.nan, dtype=problem.eval_dtype, device=problem.device)
            )
            return

        if values is not None:
            # the tensor itself, not a copy (see the module note)
            values = torch.as_tensor(values, device=problem.device, dtype=problem.dtype)
            if values.ndim != 2:
                raise ValueError(f"values must be 2-D, got shape {tuple(values.shape)}")
            self._values = values
            popsize = values.shape[0]
            self._evdata = (
                torch.as_tensor(evals, dtype=problem.eval_dtype, device=problem.device)
                if evals is not None
                else torch.full((popsize, n_evals), math.nan, dtype=problem.eval_dtype, device=problem.device)
            )
            return

        if popsize is None:
            raise ValueError("popsize is required")
        popsize = int(popsize)
        if is_dtype_object(problem.dtype):
            self._values = ObjectArray(popsize)  # empty slots, filled by set_values
        elif empty:
            self._values = torch.zeros((popsize, problem.solution_length), dtype=problem.dtype, device=problem.device)
        else:
            self._values = problem.generate_values(popsize)
        self._evdata = torch.full((popsize, n_evals), math.nan, dtype=problem.eval_dtype, device=problem.device)

    # ------------------------------------------------------------ properties
    @property
    def problem(self) -> Problem:
        return self._problem

    def __len__(self) -> int:
        return self._values.popsize if is_factored(self._values) else int(self._values.shape[0])

    @property
    def device(self) -> torch.device:
        """The problem's device (an object batch's values are on the host,
        its evals there)."""
        return self._evdata.device

    @property
    def values(self):
        """The decision values. This is the stored tensor, not a copy: do not
        mutate it in place (use ``set_values`` or ``access_values``). A
        factored population is returned as the factored batch itself; call
        its ``materialize()`` where a dense matrix is really needed. An
        object batch's ``ObjectArray`` comes as a read-only view."""
        if isinstance(self._values, ObjectArray):
            return self._values.get_read_only_view()
        return self._values

    @property
    def evals(self) -> torch.Tensor:
        """The eval matrix ``(N, n_obj + eval_data_length)``."""
        return self._evdata

    @property
    def evdata(self) -> torch.Tensor:
        return self._evdata[:, self._problem.num_objectives :]

    @property
    def is_evaluated(self) -> bool:
        return not bool(torch.any(torch.isnan(self._evdata[:, : self._problem.num_objectives])))

    def evals_of(self, obj_index: int = 0) -> torch.Tensor:
        return self._evdata[:, obj_index]

    # -------------------------------------------------------------- mutation
    def access_values(self, *, keep_evals: bool = False) -> torch.Tensor:
        """The decision values for modification in place (an object batch's
        ``ObjectArray`` itself); unless ``keep_evals=True`` every evaluation
        result is invalidated (NaN). A piece taken by fancy indexing holds a
        copy: write it back with ``set_values``."""
        if not keep_evals:
            self.forget_evals()
        return self._values

    def forget_evals(self):
        self._set_evdata(torch.full_like(self._evdata, math.nan))

    def set_values(self, values, *, keep_evals: bool = False):
        """Replace the decision values. A batch holding a factored
        population takes another of the same form and popsize, and not
        through a slice (a coefficient scatter-back is ambiguous across
        bases)."""
        if is_factored(self._values):
            if type(values) is not type(self._values):
                raise TypeError(
                    f"This batch holds a factored population; set_values expects another {type(self._values).__name__}"
                    " of the same popsize"
                )
            if values.popsize != len(self):
                raise ValueError(f"set_values popsize mismatch: {values.popsize} vs {len(self)}")
            if self._parent is not None:
                raise NotImplementedError(
                    "Writing values into a slice view of a factored batch is not supported (coefficient scatter-back"
                    " is ambiguous across bases)"
                )
            self._values = values
            if not keep_evals:
                self.forget_evals()
            return
        if isinstance(self._values, ObjectArray):
            if len(values) != len(self):
                raise ValueError("Length mismatch in set_values")
            values = list(values)
            self._values[:] = values
            if self._parent is not None:
                parent, indices = self._parent
                parent._scatter_object_values(indices, values)
            if not keep_evals:
                self.forget_evals()
            return
        values = torch.as_tensor(values, dtype=self._problem.dtype, device=self._values.device)
        if values.shape != self._values.shape:
            raise ValueError(f"set_values shape mismatch: {tuple(values.shape)} vs {tuple(self._values.shape)}")
        self._set_values_array(values)
        if not keep_evals:
            self.forget_evals()

    def set_evals(self, evals, eval_data=None):
        """Store evaluation results: ``evals`` may be ``(N,)`` (one
        objective), ``(N, n_obj)``, or the full ``(N, n_obj +
        eval_data_length)`` matrix."""
        problem = self._problem
        n_obj = problem.num_objectives
        evals = torch.as_tensor(evals, dtype=problem.eval_dtype, device=self._evdata.device)
        if evals.ndim == 1:
            evals = evals[:, None]
            if n_obj != 1:
                raise ValueError("1-D evals are only valid for single-objective problems")
        if evals.shape[0] != len(self):
            raise ValueError(f"evals row count {evals.shape[0]} != batch size {len(self)}")
        full_width = n_obj + problem.eval_data_length
        if evals.shape[1] == full_width:
            if eval_data is not None:
                raise ValueError("eval_data given although evals already contains it")
            new_evdata = evals
        elif evals.shape[1] == n_obj:
            if eval_data is not None:
                eval_data = torch.as_tensor(eval_data, dtype=problem.eval_dtype, device=self._evdata.device)
                if eval_data.ndim == 1:
                    eval_data = eval_data[:, None]
                new_evdata = torch.cat([evals, eval_data], dim=1)
            elif problem.eval_data_length:
                pad = torch.full(
                    (len(self), problem.eval_data_length), math.nan, dtype=problem.eval_dtype, device=evals.device
                )
                new_evdata = torch.cat([evals, pad], dim=1)
            else:
                new_evdata = evals
        else:
            raise ValueError(f"evals has {evals.shape[1]} columns; expected {n_obj} or {full_width}")
        self._set_evdata(new_evdata)

    def _set_evdata(self, new_evdata: torch.Tensor):
        self._evdata = new_evdata
        if self._parent is not None:
            parent, indices = self._parent
            parent._scatter_evdata(indices, new_evdata)

    def _scatter_evdata(self, indices: torch.Tensor, evdata: torch.Tensor):
        self._evdata = self._evdata.index_copy(0, indices, evdata)
        if self._parent is not None:
            parent, parent_indices = self._parent
            parent._scatter_evdata(parent_indices.index_select(0, indices), evdata)

    def _set_values_array(self, values: torch.Tensor):
        self._values = values
        if self._parent is not None:
            parent, indices = self._parent
            parent._scatter_values(indices, values)

    def _scatter_values(self, indices: torch.Tensor, values: torch.Tensor):
        if isinstance(self._values, ObjectArray):
            raise TypeError("Cannot scatter tensor values into an object-typed batch")
        self._values = self._values.index_copy(0, indices, values)
        if self._parent is not None:
            parent, parent_indices = self._parent
            parent._scatter_values(parent_indices.index_select(0, indices), values)

    def _scatter_object_values(self, indices: torch.Tensor, values: list):
        """Object value writes up the parent chain (a plain slice shares
        storage already; a piece taken by fancy indexing goes through
        here)."""
        for i, v in zip(indices.reshape(-1).tolist(), values):
            self._values[i] = v
        if self._parent is not None:
            parent, parent_indices = self._parent
            parent._scatter_object_values(parent_indices[indices.reshape(-1)], values)

    # ------------------------------------------------------------- selection
    def _utility_for_sort(self, obj_index: Optional[int]) -> torch.Tensor:
        n_obj = self._problem.num_objectives
        if obj_index is None and n_obj > 1:
            return pareto_utility(self._evdata[:, :n_obj], objective_sense=self._problem.senses)
        i = 0 if obj_index is None else int(obj_index)
        col = self._evdata[:, i]
        return col if self._problem.senses[i] == "max" else -col

    def argsort(self, obj_index: Optional[int] = None) -> torch.Tensor:
        """Indices sorted best to worst (stable; NaN last)."""
        return torch.argsort(-self._utility_for_sort(obj_index), stable=True)

    def argbest(self, obj_index: Optional[int] = None) -> torch.Tensor:
        return torch.argmax(self._utility_for_sort(obj_index))

    def argworst(self, obj_index: Optional[int] = None) -> torch.Tensor:
        return torch.argmin(self._utility_for_sort(obj_index))

    def take(self, indices) -> "SolutionBatch":
        """Sub-batch sharing eval scatter-back with this batch."""
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().numpy()
        return SolutionBatch(slice_of=(self, np.asarray(indices)))

    def take_best(self, n: Optional[int] = None, *, obj_index: Optional[int] = None) -> "SolutionBatch":
        """The best ``n`` solutions (the best one when ``n`` is None)."""
        if n is None:
            return self.take(self.argbest(obj_index).reshape(1))
        return self.take(self.argsort(obj_index)[: int(n)])

    def compute_pareto_ranks(self) -> torch.Tensor:
        """Front index per solution, 0 = best."""
        n_obj = self._problem.num_objectives
        return pareto_ranks(self._evdata[:, :n_obj], objective_sense=self._problem.senses)

    def arg_pareto_sort(self) -> List[torch.Tensor]:
        """Indices grouped by Pareto front, best front first, each in
        ascending order."""
        ranks = self.compute_pareto_ranks().cpu().numpy()
        return [torch.as_tensor(np.nonzero(ranks == k)[0], device=self.device) for k in range(int(ranks.max()) + 1)]

    def utility(self, obj_index: int = 0, *, ranking_method: Optional[str] = None) -> torch.Tensor:
        """Fitness-shaped utilities for one objective."""
        col = self._evdata[:, int(obj_index)]
        method = "raw" if ranking_method is None else ranking_method
        return rank(col, method, higher_is_better=(self._problem.senses[int(obj_index)] == "max"))

    def utils(self, *, ranking_method: Optional[str] = None) -> torch.Tensor:
        """Utilities for all objectives, shape ``(N, n_obj)``."""
        cols = [self.utility(i, ranking_method=ranking_method) for i in range(self._problem.num_objectives)]
        return torch.stack(cols, dim=1)

    # ------------------------------------------------------------- structure
    def split(self, num_pieces: Optional[int] = None, *, max_size: Optional[int] = None) -> "SolutionBatchPieces":
        return SolutionBatchPieces(self, num_pieces=num_pieces, max_size=max_size)

    def concat(self, other: Union["SolutionBatch", Iterable["SolutionBatch"]]) -> "SolutionBatch":
        """This batch merged with other(s) (see :meth:`cat` for factored
        batches)."""
        others = [other] if isinstance(other, SolutionBatch) else list(other)
        return SolutionBatch(merging_of=[self] + others)

    @classmethod
    def cat(cls, batches: Iterable["SolutionBatch"]) -> "SolutionBatch":
        """Concatenate batches. Factored batches concatenate when they are
        of one form and share one generation's center and basis tensors
        (sample the later rounds with ``sample_lowrank(..., basis=
        first.values.basis)``); otherwise materialize them first."""
        return cls(merging_of=list(batches))

    def to(self, device) -> "SolutionBatch":
        """This batch, which lives on its problem's device: asking for
        another device is an error."""
        _check_batch_device(device, self.device)
        return self

    def __getitem__(self, i) -> Union["Solution", "SolutionBatch"]:
        if isinstance(i, slice):
            return SolutionBatch(slice_of=(self, i))
        if isinstance(i, torch.Tensor):
            if i.ndim == 0:
                return Solution(self, int(i))
            return SolutionBatch(slice_of=(self, i.cpu().numpy()))
        if hasattr(i, "ndim"):
            if i.ndim == 0:
                return Solution(self, int(i))
            return SolutionBatch(slice_of=(self, i))
        if hasattr(i, "__len__") and not isinstance(i, str):
            return SolutionBatch(slice_of=(self, i))
        return Solution(self, int(i))

    def __iter__(self):
        for i in range(len(self)):
            yield Solution(self, i)

    def clone(self, *, memo: Optional[dict] = None) -> "SolutionBatch":
        if memo is None:
            memo = {}
        if id(self) in memo:
            return memo[id(self)]
        values = self._values
        # a factored population's shared tensors are never written in place
        values = values._replace(coeffs=values.coeffs.clone()) if is_factored(values) else values.clone()
        # (an ObjectArray's clone holds mutable copies of its elements)
        result = SolutionBatch(self._problem, len(self), values=values, evals=self._evdata.clone())
        memo[id(self)] = result
        return result

    def _get_cloned_state(self, *, memo: dict) -> dict:
        # the problem is kept by reference (pickle memoizes it; cloning it
        # here would recurse problem -> best solutions -> batches -> problem),
        # and a pickled or cloned piece no longer scatters into its parent
        return {
            "_problem": self._problem,
            "_values": deep_clone(self._values, memo=memo),
            "_evdata": deep_clone(self._evdata, memo=memo),
            "_parent": None,
        }

    def _printable_items(self):
        return {"size": len(self), "evaluated": self.is_evaluated}


class SolutionBatchPieces(RecursivePrintable):
    """Read-only list of slice views of a batch, with scatter-back."""

    def __init__(self, batch: SolutionBatch, *, num_pieces: Optional[int] = None, max_size: Optional[int] = None):
        if (num_pieces is None) == (max_size is None):
            raise ValueError("Provide exactly one of num_pieces / max_size")
        n = len(batch)
        if max_size is not None:
            num_pieces = math.ceil(n / int(max_size))
        num_pieces = int(num_pieces)
        base, rem = divmod(n, num_pieces)
        self._bounds = []
        start = 0
        for i in range(num_pieces):
            size = base + (1 if i < rem else 0)
            self._bounds.append((start, start + size))
            start += size
        self._batch = batch
        self._pieces = [SolutionBatch(slice_of=(batch, slice(lo, hi))) for (lo, hi) in self._bounds]

    def __getitem__(self, i) -> SolutionBatch:
        return self._pieces[i]

    def __len__(self) -> int:
        return len(self._pieces)

    def __iter__(self):
        return iter(self._pieces)

    def indices_of(self, i: int) -> tuple:
        """(row_begin, row_end) of piece ``i`` within the source batch."""
        return self._bounds[i]


class Solution(Serializable, RecursivePrintable):
    """One row of a SolutionBatch, sharing its storage."""

    def __init__(self, batch: SolutionBatch, index: int):
        self._batch = batch
        self._index = int(index)

    @property
    def problem(self) -> Problem:
        return self._batch.problem

    @property
    def values(self):
        """The row's values (an object problem's: the stored immutable
        object)."""
        values = self._batch._values
        if is_factored(values):
            # densify this row only: center + basis @ coeffs[i]
            return values.materialize_rows(values.coeffs[self._index][None])[0]
        return values[self._index]

    @property
    def evals(self) -> torch.Tensor:
        return self._batch._evdata[self._index]

    @property
    def is_evaluated(self) -> bool:
        n_obj = self.problem.num_objectives
        return not bool(torch.any(torch.isnan(self.evals[:n_obj])))

    def set_values(self, values):
        """Replace this solution's values (its evals become NaN). Not in a
        factored batch: a dense row has in general no representation in the
        batch's basis."""
        if is_factored(self._batch._values):
            raise NotImplementedError(
                "Writing a single solution's values into a factored batch is not supported: an arbitrary dense row"
                " generally has no representation in the batch's basis"
            )
        batch = self._batch
        if isinstance(batch._values, ObjectArray):
            batch._values[self._index] = values
            if batch._parent is not None:
                parent, parent_indices = batch._parent
                parent._scatter_object_values(parent_indices[self._index : self._index + 1], [batch._values[self._index]])
        else:
            row = torch.as_tensor(values, dtype=self.problem.dtype, device=batch._values.device)
            new = batch._values.clone()
            new[self._index] = row
            batch._set_values_array(new)
        new_evdata = self._batch._evdata.clone()
        new_evdata[self._index] = math.nan
        self._batch._set_evdata(new_evdata)

    def set_evals(self, evals, eval_data=None):
        problem = self.problem
        n_obj = problem.num_objectives
        width = n_obj + problem.eval_data_length
        device = self._batch._evdata.device
        evals = torch.atleast_1d(torch.as_tensor(evals, dtype=problem.eval_dtype, device=device))
        if evals.shape[0] == width:
            row = evals
        else:
            parts = [evals]
            if eval_data is not None:
                parts.append(torch.atleast_1d(torch.as_tensor(eval_data, dtype=problem.eval_dtype, device=device)))
            row = torch.cat(parts)
            if row.shape[0] < width:
                pad = torch.full((width - row.shape[0],), math.nan, dtype=problem.eval_dtype, device=device)
                row = torch.cat([row, pad])
        new_evdata = self._batch._evdata.clone()
        new_evdata[self._index] = row
        self._batch._set_evdata(new_evdata)

    def set_evaluation(self, evaluation, eval_data=None):
        self.set_evals(evaluation, eval_data)

    def to_batch(self) -> SolutionBatch:
        return SolutionBatch(slice_of=(self._batch, slice(self._index, self._index + 1)))

    def clone(self, *, memo: Optional[dict] = None) -> "Solution":
        if memo is None:
            memo = {}
        if id(self) in memo:
            return memo[id(self)]
        if isinstance(self._batch._values, ObjectArray):
            values = ObjectArray.from_values([self._batch._values[self._index]])
        else:
            values = self.values[None].clone()
        evals = self._batch._evdata[self._index][None].clone()
        result = Solution(SolutionBatch(self.problem, 1, values=values, evals=evals), 0)
        memo[id(self)] = result
        return result

    def _get_cloned_state(self, *, memo: dict) -> dict:
        # the batch is kept by reference: pickle memoizes it, and the chain
        # batch -> problem ends there (see SolutionBatch._get_cloned_state)
        return {"_batch": self._batch, "_index": self._index}

    def _printable_items(self):
        return {"values": self.values, "evals": self.evals}


class ProblemBoundEvaluator:
    """A problem as a callable ``f(values) -> fitnesses`` for the functional
    algorithms; extra leading batch dimensions are flattened."""

    def __init__(self, problem: Problem, *, obj_index: int = 0):
        self._problem = problem
        self._obj_index = int(obj_index)
        self._sense = problem.senses[self._obj_index]

    @property
    def problem(self) -> Problem:
        return self._problem

    @property
    def objective_sense(self) -> str:
        return self._sense

    def __call__(self, values) -> torch.Tensor:
        values = torch.as_tensor(values, dtype=self._problem.dtype, device=self._problem.device)
        batch_shape = values.shape[:-2]
        flat = values.reshape((-1, values.shape[-1])) if batch_shape else values
        batch = SolutionBatch(self._problem, flat.shape[0], values=flat)
        self._problem.evaluate(batch)
        fitnesses = batch.evals[:, self._obj_index]
        if batch_shape:
            fitnesses = fitnesses.reshape(batch_shape + (values.shape[-2],))
        return fitnesses
