"""Vectorized neuroevolution over a batched env on one device (counterpart
of ``evotorch_tpu/neuroevolution/vecneproblem.py``).

One lane per solution (or a refill width of lanes), the whole population
stepped at once by the port's rollout engine (``net/vecrl.py``) under one
of its contracts: ``eval_mode`` ``"episodes"`` (the default),
``"episodes_refill"`` (``refill_config``), ``"episodes_compact"``
(``compact_config``) or ``"budget"``.

No per-generation scalar is read on the host unless a status key asks for
it: the interaction and episode counters are device scalars, and the
telemetry wire of each evaluation is decoded one evaluation later (when its
work has long finished), as in the JAX package. The engine itself makes one
host sync per evaluation (its step count).

Recurrent policies (``RNN``, ``LSTM`` in the network string) and
``action_noise_stdev`` run under every contract; ``to_policy_callable``
hands the policy's state to the caller and takes it back. A factored
population (``PGPE(lowrank_rank=...)``) stays factored into the rollout
engine, its ``(N, L)`` matrix never built.

``num_actors`` shards each evaluation's rows over the ranks of the process
group (``evaluate_sharded``, ``parallel.make_sharded_rollout_evaluator``):
by default the result equals the one-rank evaluation's, observation
statistics included. Under ``EVOTORCH_SHARD_MAP=1`` (and for
``episodes_compact``, which has its own sharded runner) each rank
normalizes by its own lanes' statistics, merged at the end
(``obs_norm_sync="cohort"``, the reference's per-actor statistics) or
every step (``obs_norm_sync="step"``), as in the JAX package.

``make_training_span`` runs K generations of functional ``ask``/``tell``
with this problem's whole eval configuration (``parallel.make_training_span``);
``consume_span`` feeds each span's result back into the counters, the
statistics and the telemetry decode.

``EVOTORCH_FAULTS="eval.scores:nonfinite@G[:share]"`` turns a seeded
share of the G-th evaluation's scores into NaN at the host boundary, the
same indices as the JAX package's, then quarantines them when quarantine is
on (``resilience/faults.py``).

``solution_groups`` maps each solution to an accounting group (a tenant,
an island): the engines charge every counter to its group on the device,
and the status gains the per-group keys (``eval_g{g}_*``), on every path:
unsharded, sharded by ``num_actors`` in each form (the rows summed over the
ranks) and taken from a mesh over the first ranks. ``slo`` checks
declarative rules (``observability.slo``) against each generation's decoded
telemetry and publishes ``slo_ok`` / ``slo_violations`` / ``slo_detail``.
``eval_backend`` (a ``serving.RemoteEvalBackend``, or an
``serving.EvalServer`` to admit into) routes every evaluation through a
shared evaluation server: the problem's own generator draws the request's
table rows, so the scores are the standalone ones at the server's refill
width.

Refill and compaction knobs not given explicitly are looked up in the
tuned-config cache (``observability.timings.resolve_knobs``: explicit >
cache > the engine's default) for this env, popsize, episode shape,
parameter count, dtype and mesh; where they came from is published as the
``tuned_config_source`` status key (``override``, ``cache`` or
``fallback``).
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..core import SolutionBatch
from ..envs import Env, make_env
from ..observability import GroupTelemetry
from ..observability.registry import counters
from ..observability.timings import canonical_env_label, dtype_label, machine_fingerprint, resolve_knobs
from ..resilience.faults import fault_point
from .neproblem import NEProblem
from .net.layers import FrozenModule, Module
from .net.rl import ActClipLayer
from .net.runningnorm import RunningNorm
from .net.vecrl import (
    _params_popsize,
    _params_take,
    _quarantine_nonfinite,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    run_vectorized_rollout_compacting_sharded,
)

__all__ = ["VecNE", "VecGymNE"]

_EVAL_MODES = ("episodes", "episodes_compact", "episodes_refill", "budget")


class VecNE(NEProblem):
    """Vectorized neuroevolution over one of the port's batched envs (by
    name, with ``env_config``, or an ``Env`` on the problem's device). The
    objective is maximized: a solution's score is its mean episodic
    return."""

    def __init__(
        self,
        env: Union[str, Env],
        network: Union[str, Module, Callable],
        *,
        env_config: Optional[dict] = None,
        max_num_envs: Optional[int] = None,
        network_args: Optional[dict] = None,
        observation_normalization: bool = False,
        decrease_rewards_by: Optional[float] = None,
        alive_bonus_schedule: Optional[tuple] = None,
        action_noise_stdev: Optional[float] = None,
        num_episodes: int = 1,
        episode_length: Optional[int] = None,
        eval_mode: str = "episodes",
        obs_norm_sync: str = "cohort",
        compact_config: Optional[dict] = None,
        refill_config: Optional[dict] = None,
        solution_groups=None,
        slo=None,
        health_telemetry: bool = True,
        nonfinite_quarantine: bool = True,
        nonfinite_penalty: Optional[float] = None,
        eval_backend=None,
        compute_dtype=None,
        initial_bounds=(-0.00001, 0.00001),
        seed: Optional[int] = None,
        num_actors=None,
        device=None,
        **kwargs,
    ):
        if obs_norm_sync not in ("cohort", "step"):
            raise ValueError(f"obs_norm_sync must be 'cohort' or 'step', got {obs_norm_sync!r}")
        if eval_mode not in _EVAL_MODES:
            raise ValueError(
                f"eval_mode must be 'episodes', 'episodes_compact', 'episodes_refill' or 'budget', got {eval_mode!r}"
            )
        for config, allowed, what in (
            (compact_config, {"chunk_size", "min_width", "allowed_widths"}, "compact_config"),
            (refill_config, {"width", "period"}, "refill_config"),
        ):
            unknown = set(config or {}) - allowed
            if unknown:
                raise ValueError(f"Unknown {what} keys: {sorted(unknown)}")

        device = resolve_device(device)
        if isinstance(env, str):
            self._env: Env = make_env(env, device=device, **(env_config or {}))
        else:
            if env.device != device:
                raise ValueError(f"the env lives on {env.device}, the problem on {device}")
            self._env = env
        self._observation_normalization = bool(observation_normalization)
        self._obs_norm_sync = str(obs_norm_sync)
        self._decrease_rewards_by = decrease_rewards_by
        self._alive_bonus_schedule = tuple(alive_bonus_schedule) if alive_bonus_schedule is not None else None
        self._action_noise_stdev = None if action_noise_stdev is None else float(action_noise_stdev)
        self._num_episodes = int(num_episodes)
        self._episode_length = None if episode_length is None else int(episode_length)
        self._eval_mode = str(eval_mode)
        self._compact_config = dict(compact_config or {})
        self._refill_config = dict(refill_config or {})
        self._nonfinite_quarantine = bool(nonfinite_quarantine)
        self._nonfinite_penalty = None if nonfinite_penalty is None else float(nonfinite_penalty)
        self._health_telemetry = bool(health_telemetry)
        self._max_num_envs = None if max_num_envs is None else int(max_num_envs)
        self._compute_dtype = compute_dtype
        # per-group accounting: one small id per solution
        if solution_groups is not None:
            g = np.asarray(solution_groups, dtype=np.int64)
            if g.ndim != 1 or g.size == 0:
                raise ValueError("solution_groups must be a non-empty 1-D array of group ids")
            if int(g.min()) < 0:
                raise ValueError("solution_groups ids must be >= 0")
            self._solution_groups = g
            self._num_groups = int(g.max()) + 1
        else:
            self._solution_groups = None
            self._num_groups = 1
        if slo is not None:
            from ..observability.slo import SLOWatchdog

            self._slo = slo if isinstance(slo, SLOWatchdog) else SLOWatchdog(slo)
        else:
            self._slo = None
        if eval_backend is not None:
            from ..serving import EvalServer, RemoteEvalBackend

            if isinstance(eval_backend, EvalServer):
                eval_backend = RemoteEvalBackend(eval_backend)
            if not isinstance(eval_backend, RemoteEvalBackend):
                raise TypeError(f"eval_backend must be a serving.RemoteEvalBackend or serving.EvalServer, got {type(eval_backend).__name__}")
            if self._solution_groups is not None:
                raise ValueError("solution_groups cannot combine with eval_backend: the server's group axis is the tenant axis")
        self._eval_backend = eval_backend
        # the tuned-config cache: an env modified by env_config is not the
        # env its label names, so the cache is skipped for it
        self._env_label = canonical_env_label(env)
        self._tuned_cacheable = not (isinstance(env, str) and env_config)
        self._tuned_resolution: dict = {}
        self._tuned_config_source: Optional[str] = None

        self._obs_norm = RunningNorm(self._env.observation_size, device=device)
        self._interaction_count = torch.zeros((), dtype=torch.int64, device=device)
        self._episode_count = torch.zeros((), dtype=torch.int64, device=device)
        # the wire of the latest evaluation, and the decode of the one before
        self._pending_telemetry = None
        self._last_telemetry = None
        self._last_group_telemetry = None
        # the reset and action-noise tables injected for one evaluate()
        self._injected = {}

        super().__init__(
            "max",
            network,
            network_args=network_args,
            initial_bounds=initial_bounds,
            seed=seed,
            num_actors=num_actors,
            device=device,
            **kwargs,
        )
        self.after_eval_hook.append(self._report_counters)

    # ---------------------------------------------------------------- wiring
    def _network_constants(self) -> dict:
        env = self._env
        return {
            "obs_length": env.observation_size,
            "act_length": env.action_size,
            "obs_shape": tuple(env.observation_space.shape),
            "obs_space": env.observation_space,
            "act_space": env.action_space,
        }

    @property
    def env(self) -> Env:
        return self._env

    @property
    def observation_normalization(self) -> bool:
        return self._observation_normalization

    @property
    def obs_norm(self) -> RunningNorm:
        return self._obs_norm

    @property
    def eval_backend(self):
        """The attached RemoteEvalBackend (None when evaluating locally)."""
        return self._eval_backend

    @property
    def last_group_telemetry(self) -> Optional[GroupTelemetry]:
        """The previous evaluation's decoded telemetry (None until two
        evaluations have run)."""
        return self._last_group_telemetry

    def _bump_counters(self, steps, episodes):
        # device scalars: the additions are queued, nothing is read back
        self._interaction_count = self._interaction_count + steps
        self._episode_count = self._episode_count + episodes

    def _consume_telemetry(self, telemetry):
        """Keep this evaluation's wire and decode the previous one, whose
        work has finished (a copy of 20 ints, not a stall). A span's stacked
        ``(K, 1, 20)`` wire feeds the same swap row by row: rows ``0..K-2``
        decode at once, the last stays pending until the next consume
        (lag-by-span)."""
        if telemetry is None:
            return
        if telemetry.numel() == 0:
            return  # a span's stacked telemetry-off wire
        if telemetry.ndim == 3:
            for row in telemetry:
                self._consume_telemetry(row)
            return
        prev, self._pending_telemetry = self._pending_telemetry, telemetry
        if prev is not None:
            gt = GroupTelemetry.from_array(prev)
            self._last_group_telemetry = gt
            self._last_telemetry = gt.total()

    def _report_counters(self, batch) -> dict:
        status = {
            "total_interaction_count": self._interaction_count,
            "total_episode_count": self._episode_count,
        }
        if self._last_telemetry is not None:
            # the previous evaluation's figures (one behind; the shapes are
            # the same every generation)
            status.update(self._last_telemetry.as_status(prefix="eval_"))
            status["eval_nonfinite_share"] = float(self._last_telemetry.nonfinite) / max(1, len(batch))
        if self._last_group_telemetry is not None:
            status.update(self._last_group_telemetry.as_status(prefix="eval_"))
            if self._last_group_telemetry.has_health:
                stats = self._last_group_telemetry.score_stats()
                if stats["count"] > 0:
                    status["eval_score_mean"] = round(stats["mean"], 6)
                    status["eval_score_std"] = round(stats["std"], 6)
            if self._slo is not None:
                status.update(self._slo.check(self._last_group_telemetry, status=status).as_status())
        if self._tuned_config_source is not None:
            status["tuned_config_source"] = self._tuned_config_source
        return status

    # ------------------------------------------------------------ evaluation
    def evaluate(
        self, batch, *, reset_noise: Optional[torch.Tensor] = None, action_noise: Optional[torch.Tensor] = None
    ):
        """Evaluate a batch (see ``Problem.evaluate``). ``reset_noise``: the
        ``(N * num_episodes, ...)`` table of reset rows of the episodes
        contracts, in item order (``episode * N + solution``);
        ``action_noise``: the ``(N * num_episodes, max_t, act)`` table of
        their action noise (with ``action_noise_stdev``). Each is drawn
        from the problem's generator when None. The tests inject the JAX
        package's draws this way, and the chip check holds this path and the
        functional one to one table."""
        self._injected = {k: v for k, v in (("reset_noise", reset_noise), ("action_noise", action_noise)) if v is not None}
        try:
            super().evaluate(batch)
        finally:
            self._injected = {}

    def _tuned_knobs(self, group: str, explicit: dict, popsize: int, mesh_label: str = "none") -> dict:
        """One knob group resolved by ``timings.resolve_knobs``: explicit
        config > a tuned-cache entry for this (env, popsize, episode length
        and count, parameter count, dtype, mesh) on this problem's device
        and host > the engine's default. Memoized per (group, popsize,
        mesh); the source
        of the last resolution is what ``tuned_config_source`` reports."""
        memo_key = (group, int(popsize), mesh_label)
        if memo_key not in self._tuned_resolution:
            shape = {
                "env": self._env_label,
                "popsize": int(popsize),
                "episode_length": self._episode_length,
                "num_episodes": self._num_episodes,
                "params": self._policy.parameter_count,
                "dtype": dtype_label(self._compute_dtype),
                "mesh": mesh_label,
            }
            self._tuned_resolution[memo_key] = resolve_knobs(
                explicit, group, shape, machine=machine_fingerprint(self.device), use_cache=self._tuned_cacheable
            )
        config, source = self._tuned_resolution[memo_key]
        self._tuned_config_source = source
        return config

    def _compact_kwargs(self, popsize: int, mesh_label: str = "none") -> dict:
        """The compaction knobs: ``compact_config``, else the tuned cache's."""
        return dict(self._tuned_knobs("compact", self._compact_config, popsize, mesh_label))

    def _refill_kwargs(self, popsize: int, mesh_label: str = "none") -> dict:
        """The refill scheduler's knobs (the width global): ``refill_config``,
        else the tuned cache's for ``popsize``, else the engine's defaults;
        empty for the other contracts."""
        if self._eval_mode != "episodes_refill":
            return {}
        config = self._tuned_knobs("refill", self._refill_config, popsize, mesh_label)
        kwargs = {}
        if config.get("width") is not None:
            kwargs["refill_width"] = int(config["width"])
        if config.get("period") is not None:
            kwargs["refill_period"] = int(config["period"])
        return kwargs

    def _rollout_batch(self, values, tables: dict, groups=None):
        if self._eval_backend is not None:
            if tables:
                raise ValueError("reset_noise= and action_noise= cannot ride through an eval_backend: the request draws its own rows")
            return self._eval_backend.evaluate(self, values, self.generator, groups=groups)
        kwargs = dict(self._rollout_kwargs(), **tables)
        if groups is not None:
            # num_groups stays the problem's: the sub-batches' rows add up
            kwargs.update(groups=torch.as_tensor(groups), num_groups=self._num_groups)
        stats = self._obs_norm.stats
        popsize = _params_popsize(values)
        if self._eval_mode == "episodes_compact":
            return run_vectorized_rollout_compacting(
                self._env, self._policy, values, self.generator, stats, **self._compact_kwargs(popsize), **kwargs
            )
        kwargs.update(self._refill_kwargs(popsize))
        return run_vectorized_rollout(
            self._env, self._policy, values, self.generator, stats, eval_mode=self._eval_mode, **kwargs
        )

    def _resolve_num_actors_request(self):
        """``VecNE`` honors ``num_actors`` through its own sharded path
        (``_num_actors_mesh``), not through a sharded objective."""

    def _num_actors_mesh(self, popsize: int):
        """The mesh of the ``num_actors`` request (None: unsharded). The
        default form pads a popsize that does not divide the ranks; the
        per-rank form (``EVOTORCH_SHARD_MAP=1``) and ``episodes_compact``
        step down to the largest dividing count, as in the JAX package."""
        from ..parallel.evaluate import _use_shard_map
        from ..parallel.mesh import num_actors_mesh

        if self._num_actors_requested is None:
            return None
        divisible = _use_shard_map(None) or self._eval_mode == "episodes_compact"
        return num_actors_mesh(self._num_actors_requested, popsize, divisible=divisible)

    def _check_solution_groups(self, popsize: int):
        """The per-solution group ids, checked against the batch size (None
        without per-group accounting)."""
        groups = self._solution_groups
        if groups is not None and len(groups) != popsize:
            raise ValueError(f"solution_groups maps {len(groups)} solutions but the batch holds {popsize}")
        return groups

    def _group_kwargs(self, popsize: int) -> dict:
        """``groups``/``num_groups`` of the rollout entry points (empty
        without per-group accounting)."""
        groups = self._check_solution_groups(popsize)
        if groups is None:
            return {}
        return {"groups": torch.as_tensor(groups), "num_groups": self._num_groups}

    def _evaluate_batch(self, batch: SolutionBatch):
        # the backend path owns the device program: the local mesh request
        # does not apply through it
        mesh = None if self._eval_backend is not None else self._num_actors_mesh(len(batch))
        if mesh is not None:
            self.evaluate_sharded(batch, mesh=mesh)
            return
        values = batch.values
        n = len(batch)
        tables = self._injected
        groups = self._check_solution_groups(n)
        if self._max_num_envs is not None and n > self._max_num_envs:
            # evaluate in sub-batches of at most max_num_envs lanes; an
            # injected table is cut to each piece's items, in item order
            scores = []
            for start in range(0, n, self._max_num_envs):
                stop = min(start + self._max_num_envs, n)
                pieces = {}
                for name, table in tables.items():
                    per_episode = table.reshape(self._num_episodes, n, *table.shape[1:])
                    pieces[name] = per_episode[:, start:stop].reshape(-1, *table.shape[1:])
                result = self._rollout_batch(
                    _params_take(values, slice(start, stop)), pieces, None if groups is None else groups[start:stop]
                )
                scores.append(result.scores)
                self._consume_rollout_side_effects(result)
            batch.set_evals(self._maybe_inject_nonfinite(torch.cat(scores)))
            return
        result = self._rollout_batch(values, tables, groups)
        self._consume_rollout_side_effects(result)
        batch.set_evals(self._maybe_inject_nonfinite(result.scores))

    def _maybe_inject_nonfinite(self, scores: torch.Tensor) -> torch.Tensor:
        """``EVOTORCH_FAULTS="eval.scores:nonfinite@G[:share]"``: NaN a
        seeded share (default 0.25) of the G-th evaluation's scores, the
        indices drawn as the JAX package draws them
        (``np.random.default_rng(1234 + count)``), then apply the engines'
        quarantine rule when it is on, so an injected run shows what a
        quarantined diverging run shows."""
        rule = fault_point("eval.scores")
        if rule is None or rule.kind != "nonfinite":
            return scores
        n = int(scores.shape[0])
        k = max(1, int(round(rule.float_arg(0.25) * n)))
        idx = np.random.default_rng(1234 + rule.count).choice(n, size=min(k, n), replace=False)
        scores = scores.index_put((torch.as_tensor(idx, device=scores.device),), torch.tensor(float("nan"), dtype=scores.dtype, device=scores.device))
        counters.increment("faults.injected_nonfinite", len(idx))
        if self._nonfinite_quarantine:
            scores, _ = _quarantine_nonfinite(scores, penalty=self._nonfinite_penalty)
        return scores

    def _consume_rollout_side_effects(self, result):
        if self._observation_normalization:
            self._obs_norm.stats = result.stats
        self._bump_counters(result.total_steps, result.total_episodes)
        self._consume_telemetry(result.telemetry)

    def _rollout_kwargs(self) -> dict:
        return dict(
            num_episodes=self._num_episodes,
            episode_length=self._episode_length,
            observation_normalization=self._observation_normalization,
            alive_bonus_schedule=self._alive_bonus_schedule,
            decrease_rewards_by=self._decrease_rewards_by,
            compute_dtype=self._compute_dtype,
            action_noise_stdev=self._action_noise_stdev,
            nonfinite_quarantine=self._nonfinite_quarantine,
            nonfinite_penalty=self._nonfinite_penalty,
            health=self._health_telemetry,
        )

    def _sharded_rollout_evaluator(self, mesh, popsize: int):
        """The sharded evaluator of this problem on ``mesh``, made once per
        mesh and popsize."""
        from ..parallel.evaluate import make_sharded_rollout_evaluator

        memo = self.__dict__.setdefault("_sharded_evaluator_memo", {})
        evaluator = memo.get((mesh, popsize))
        if evaluator is None:
            # the refill width is global here; the per-rank form divides it
            kwargs = dict(self._rollout_kwargs(), eval_mode=self._eval_mode, **self._refill_kwargs(popsize, f"{mesh.size} rank"))
            kwargs.update(self._group_kwargs(popsize))
            evaluator = memo[(mesh, popsize)] = make_sharded_rollout_evaluator(
                self._env,
                self._policy,
                mesh=mesh,
                stats_sync=self._observation_normalization and self._obs_norm_sync == "step",
                **kwargs,
            )
        return evaluator

    def evaluate_sharded(self, batch: SolutionBatch, mesh=None):
        """Evaluate with the population's rows sharded over ``mesh``'s ranks
        (the default: every rank of the default group): every rank returns
        the whole batch's scores. The default form equals the one-rank
        evaluation (``parallel.make_sharded_rollout_evaluator``); under
        ``EVOTORCH_SHARD_MAP=1`` the per-rank form, with its divisibility
        and per-rank statistics (``obs_norm_sync``). ``episodes_compact``
        runs ``run_vectorized_rollout_compacting_sharded``, whose widths
        (``compact_config``) are divided over the ranks. Tables injected
        through ``evaluate(reset_noise=..., action_noise=...)`` are the
        whole batch's. On a mesh over the first ranks (``num_actors`` below
        the world size) the other ranks take its result, and the state of
        the problem's generator, in one ``all_reduce``
        (``parallel.evaluate.spread_rollout_result``)."""
        from ..parallel.evaluate import spread_rollout_result
        from ..parallel.mesh import default_mesh

        mesh = default_mesh() if mesh is None else mesh
        values = batch.values
        stats = self._obs_norm.stats
        step_sync = self._observation_normalization and self._obs_norm_sync == "step"
        if not mesh.member:
            result = None  # a mesh over the first ranks: this rank takes its result
        elif self._eval_mode == "episodes_compact":
            config = self._compact_kwargs(len(batch), f"{mesh.size} rank")
            if config.get("min_width") is not None:
                config["min_width"] = max(1, int(config["min_width"]) // mesh.size)
            if config.get("allowed_widths") is not None:
                config["allowed_widths"] = tuple(sorted({int(w) // mesh.size for w in config["allowed_widths"] if int(w) >= mesh.size}))
            result = run_vectorized_rollout_compacting_sharded(
                self._env, self._policy, values, self.generator, stats, mesh=mesh, stats_sync=step_sync,
                **config, **self._rollout_kwargs(), **self._group_kwargs(len(batch)), **self._injected,
            )  # fmt: skip
        else:
            result, _ = self._sharded_rollout_evaluator(mesh, len(batch))(values, self.generator, stats, **self._injected)
        if mesh.partial:
            result = spread_rollout_result(
                mesh, result, self.generator, popsize=len(batch), stats=stats, health=self._health_telemetry,
                num_groups=self._num_groups,
            )  # fmt: skip
        self._consume_rollout_side_effects(result)
        batch.set_evals(self._maybe_inject_nonfinite(result.scores))
        self.update_status(self._report_counters(batch))

    # ---------------------------------------------------- training spans
    def make_training_span(
        self, *, ask, tell, popsize: int, span: int, mesh=None, donate_state: bool = True, state_metrics=None
    ):
        """K generations of ``ask -> evaluate -> tell`` for this problem as
        one call (``parallel.make_training_span``), with its whole eval
        configuration: the contract, the episode shape, observation
        normalization, the alive bonus, ``decrease_rewards_by``, action
        noise, ``compute_dtype``, the quarantine, health telemetry, and the
        refill knobs of ``episodes_refill`` resolved as ``evaluate`` resolves
        them. ``ask``/``tell`` are functional ones (the searcher classes
        hold host state between generations). Feed each result to
        ``consume_span``. ``episodes_compact`` is refused."""
        from ..parallel.evaluate import make_training_span

        groups = self._group_kwargs(int(popsize))
        return make_training_span(
            self._env, self._policy, ask=ask, tell=tell, popsize=int(popsize), span=span, mesh=mesh,
            device=self.device, donate_state=donate_state, state_metrics=state_metrics,
            eval_mode=self._eval_mode, **self._rollout_kwargs(), **self._refill_kwargs(int(popsize)), **groups,
        )  # fmt: skip

    def consume_span(self, result):
        """Feed one ``make_training_span`` result back into the problem:
        the observation statistics, the interaction and episode counters
        (the steps summed on the device; the episodes from the stacked
        wire's ``episodes`` slot by ``device_episode_total``, else 0 under
        ``budget`` and popsize x ``num_episodes`` x span elsewhere) and the
        telemetry decode (rows ``0..K-2`` now, the last one pending:
        lag-by-span). Returns the stacked ``(span, popsize)`` scores."""
        from ..observability.devicemetrics import device_episode_total

        _, scores, stats, total_steps, telemetry = result[:5]
        if self._observation_normalization:
            self._obs_norm.stats = stats
        if telemetry.numel() > 0:
            episodes = device_episode_total(telemetry)
        elif self._eval_mode == "budget":
            episodes = 0  # a budget's episode count lives only in the wire
        else:
            episodes = int(scores.shape[-1]) * self._num_episodes * int(scores.shape[0])
        self._bump_counters(total_steps.sum(), episodes)
        self._consume_telemetry(telemetry)
        # _report_counters reads only len() of its argument: the last
        # generation's scores stand in for the batch
        self.update_status(self._report_counters(scores[-1]))
        return scores

    # ------------------------------------------------------- policy exports
    def _use_obs_norm(self) -> bool:
        return self._observation_normalization and self._obs_norm.count >= 2

    def to_policy(self, solution) -> Module:
        """A deployable policy carrying the solution's weights: the frozen
        observation normalization (once statistics were collected), the
        network as a ``FrozenModule``, and action clipping. Call it as
        ``policy([], obs, state)`` with ``obs`` of shape ``(B,
        obs_length)``; it returns ``(actions, state)``, the state that of a
        recurrent network (None on the first call)."""
        module: Module = FrozenModule(*self.make_net(solution))
        if self._use_obs_norm():
            module = self._obs_norm.to_layer() >> module
        space = self._env.action_space
        if not space.is_discrete and space.lb is not None:
            module = module >> ActClipLayer(space.lb, space.ub)
        return module

    def to_policy_callable(self, solution) -> Callable:
        """``f(obs, state=None) -> (actions, state)`` over ``(B,
        obs_length)`` observations, with the observation normalization and
        the action space applied (argmax for a discrete space, clipping for
        a bounded one): the JAX package's calling contract. The state is
        the caller's: None on the first call, then what the last call
        returned (the ``(B, hidden)`` leaves of a recurrent network; None
        for a stateless one)."""
        module, leaves = self.make_net(solution)
        frozen = FrozenModule(module, leaves)
        norm = self._obs_norm.to_layer() if self._use_obs_norm() else None
        space = self._env.action_space

        def apply(x, state=None):
            y = x if norm is None else norm.apply([], x)[0]
            out, state = frozen.apply([], y, state)
            if space.is_discrete:
                out = torch.argmax(out, dim=-1)
            elif space.lb is not None:
                out = torch.clamp(out, space.lb, space.ub)
            return out, state

        return apply

    def save_solution(self, solution, fname: str):
        """Pickle a solution's values with the observation statistics and
        the network specification."""
        values = self._solution_values(solution).detach().cpu().numpy()
        use_norm = self._obs_norm.count >= 2
        payload = {
            "values": values,
            "obs_mean": self._obs_norm.mean.detach().cpu().numpy() if use_norm else None,
            "obs_stdev": self._obs_norm.stdev.detach().cpu().numpy() if use_norm else None,
            "network_spec": self._network_spec if isinstance(self._network_spec, str) else repr(self._network_spec),
        }
        with open(fname, "wb") as f:
            pickle.dump(payload, f)


#: the reference's class name
VecGymNE = VecNE
