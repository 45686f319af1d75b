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

Not ported yet, each raising ``NotImplementedError`` with its
``ROADMAP.md`` item: ``solution_groups``, ``slo`` and ``eval_backend``
(A.12); and fault injection through ``EVOTORCH_FAULTS`` (A.13). The JAX
package's tuned-config cache (A.12) is not consulted:
refill and compaction knobs not given take the engine's defaults, and no
``tuned_config_source`` status key is published.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional, Union

import torch

from .._device import resolve_device
from ..core import SolutionBatch
from ..envs import Env, make_env
from ..observability import GroupTelemetry
from .neproblem import NEProblem
from .net.layers import FrozenModule, Module
from .net.rl import ActClipLayer
from .net.runningnorm import RunningNorm
from .net.vecrl import (
    _params_take,
    run_vectorized_rollout,
    run_vectorized_rollout_compacting,
    run_vectorized_rollout_compacting_sharded,
)

__all__ = ["VecNE", "VecGymNE"]

_EVAL_MODES = ("episodes", "episodes_compact", "episodes_refill", "budget")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to evotorch_tpu_torch yet (ROADMAP.md, item {item})")


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
        for name, value in (("solution_groups", solution_groups), ("slo", slo), ("eval_backend", eval_backend)):
            if value is not None:
                raise _unported(f"{name}=", "A.12, services")
        if os.environ.get("EVOTORCH_FAULTS"):
            raise _unported("fault injection (EVOTORCH_FAULTS)", "A.13, tools")
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

    def _refill_kwargs(self) -> dict:
        """The refill scheduler's knobs from ``refill_config`` (the width
        global), the engine's defaults for the rest; empty for the other
        contracts."""
        if self._eval_mode != "episodes_refill":
            return {}
        config = self._refill_config
        kwargs = {}
        if config.get("width") is not None:
            kwargs["refill_width"] = int(config["width"])
        if config.get("period") is not None:
            kwargs["refill_period"] = int(config["period"])
        return kwargs

    def _rollout_batch(self, values, tables: dict):
        kwargs = dict(self._rollout_kwargs(), **tables)
        stats = self._obs_norm.stats
        if self._eval_mode == "episodes_compact":
            return run_vectorized_rollout_compacting(
                self._env, self._policy, values, self.generator, stats, **self._compact_config, **kwargs
            )
        kwargs.update(self._refill_kwargs())
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

    def _evaluate_batch(self, batch: SolutionBatch):
        mesh = self._num_actors_mesh(len(batch))
        if mesh is not None:
            self.evaluate_sharded(batch, mesh=mesh)
            return
        values = batch.values
        n = len(batch)
        tables = self._injected
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
                result = self._rollout_batch(_params_take(values, slice(start, stop)), pieces)
                scores.append(result.scores)
                self._consume_rollout_side_effects(result)
            batch.set_evals(torch.cat(scores))
            return
        result = self._rollout_batch(values, tables)
        self._consume_rollout_side_effects(result)
        batch.set_evals(result.scores)

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

    def _sharded_rollout_evaluator(self, mesh):
        """The sharded evaluator of this problem on ``mesh``, made once per
        mesh."""
        from ..parallel.evaluate import make_sharded_rollout_evaluator

        memo = self.__dict__.setdefault("_sharded_evaluator_memo", {})
        evaluator = memo.get(mesh)
        if evaluator is None:
            # the refill width is global here; the per-rank form divides it
            kwargs = dict(self._rollout_kwargs(), eval_mode=self._eval_mode, **self._refill_kwargs())
            evaluator = memo[mesh] = make_sharded_rollout_evaluator(
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
            config = dict(self._compact_config)
            if config.get("min_width") is not None:
                config["min_width"] = max(1, int(config["min_width"]) // mesh.size)
            if config.get("allowed_widths") is not None:
                config["allowed_widths"] = tuple(sorted({int(w) // mesh.size for w in config["allowed_widths"] if int(w) >= mesh.size}))
            result = run_vectorized_rollout_compacting_sharded(
                self._env, self._policy, values, self.generator, stats, mesh=mesh, stats_sync=step_sync,
                **config, **self._rollout_kwargs(), **self._injected,
            )  # fmt: skip
        else:
            result, _ = self._sharded_rollout_evaluator(mesh)(values, self.generator, stats, **self._injected)
        if mesh.partial:
            result = spread_rollout_result(
                mesh, result, self.generator, popsize=len(batch), stats=stats, health=self._health_telemetry
            )
        self._consume_rollout_side_effects(result)
        batch.set_evals(result.scores)
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

        return make_training_span(
            self._env, self._policy, ask=ask, tell=tell, popsize=int(popsize), span=span, mesh=mesh,
            device=self.device, donate_state=donate_state, state_metrics=state_metrics,
            eval_mode=self._eval_mode, **self._rollout_kwargs(), **self._refill_kwargs(),
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
