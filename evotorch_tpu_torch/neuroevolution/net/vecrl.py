"""The vectorized rollout engine (counterpart of
``evotorch_tpu/neuroevolution/net/vecrl.py``).

``run_vectorized_rollout`` evaluates ``N`` policies in a batched env, all
on the device, under one of three contracts (``eval_mode``):

- ``"episodes"`` (the default, the reference's ``VecGymNE`` contract): lane
  ``s`` runs solution ``s`` for exactly ``num_episodes`` episodes, then
  idles masked until every lane is done; the score is the mean episodic
  return.
- ``"episodes_refill"``: the same contract on a fixed width ``W`` of lanes
  kept busy from an on-device queue of (solution, episode) items, item
  ``episode * N + solution``: a lane whose episode ends takes the next
  item, and finished returns are credited to their solution with
  ``index_add_``.
- ``"budget"``: every lane runs ``num_episodes * max_t`` steps,
  auto-resetting, and scores its return per (fractional) episode.

``run_vectorized_rollout_compacting`` is the ``episodes`` contract run in
chunks, narrowing the working width to the survivors between chunks.

Randomness of the three episodes contracts belongs to the item, not to the
lane: the engine draws the reset noise of all ``N * num_episodes`` items at
once (``env.reset_noise``, in item order, or the ``reset_noise=`` table a
caller injects), and every reset of item ``e * N + s`` uses row
``e * N + s``. Action noise (``action_noise_stdev``) is drawn the same way,
a ``(N * num_episodes, max_t, act)`` table (or the ``action_noise=`` one a
caller injects) whose entry ``[e * N + s, t]`` is added at step ``t`` of
that item's episode. So the three contracts compute the same trajectories
and, with observation normalization off, the same scores bit for bit on
the CPU, at any width. ``budget`` draws fresh resets and noise every step.

A recurrent policy's state rides in every carry, population axis first, in
the policy's compute dtype, from the policy's initial state. Under
``budget`` a lane that ends an episode restarts from zeros (the JAX
engine's reset); under the episodes contracts a lane that starts an item
starts from the initial state (the JAX refill engine's rule, equal to zeros
for ``RNN`` and ``LSTM``), a frozen lane keeps its state, and compaction
gathers the states with the lanes.

The loops are eager PyTorch with no host sync per step. The end of an
episodes loop (no lane active, and for refill no item queued) is watched by
a non-blocking copy of an on-device flag (``_EndPoll``); the steps that run
past the true end before the host sees it are exact no-ops: the step
counter, capacity and queue counters advance by an on-device ``work_left``
flag. Every contract returns the JAX package's ``(1, 20)`` int32
telemetry wire (``observability/devicemetrics.py``).

A population is a dense ``(N, L)`` tensor or a factored batch
(``LowRankParamsBatch``, ``TrunkDeltaParamsBatch``, ``tools/lowrank.py``),
which stays factored: each rollout builds the policy's loop-invariant
factored context once (``net/lowrank.py``), the carries hold per-lane
coefficient rows ``(W, k)`` where a dense population's hold parameter
rows, and refill and compaction gather those. ``trunk_block`` runs the
trunk-delta forward in blocks of lanes (not under compaction, as in the JAX
engine).

Options of the JAX engine that this port does not take yet raise
``NotImplementedError`` naming their item in ``ROADMAP.md``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch

from ...observability.devicemetrics import (
    QUEUE_WAIT_BUCKET_EDGES,
    QUEUE_WAIT_BUCKETS,
    append_health_block,
    compute_health_block,
    pack_eval_telemetry,
    pack_group_telemetry,
    queue_wait_bucket_index,
)
from ...tools.lowrank import TrunkDeltaParamsBatch, is_factored
from ...tools.misc import to_torch_dtype
from .functional import FlatParamsPolicy
from .layers import Module, map_state, state_leaves
from .lowrank import (
    _apply_lowrank,
    _Factor,
    _fallback_warning,
    _trunk_forward_prepared,
    _TrunkPrepared,
    lowrank_supported,
    prepare_lowrank,
    prepare_trunk_delta,
)
from .rl import alive_bonus_for_step
from .runningnorm import CollectedStats, stats_normalize, stats_update

__all__ = ["Policy", "RolloutResult", "reset_tensors", "run_vectorized_rollout", "run_vectorized_rollout_compacting"]

#: options of the JAX engine left out of the port, with their ROADMAP.md item
_UNPORTED = {
    "groups": "A.12, per-group telemetry and the serving substrate",
    "num_groups": "A.12, per-group telemetry and the serving substrate",
    "solution_keys": "A.12, per-group telemetry and the serving substrate",
    "lane_ids": "A.10, multi-GPU",
    "num_valid": "A.10, multi-GPU",
    "seed_stride": "A.10, multi-GPU",
    "stats_sync_axis": "A.10, multi-GPU",
    "nonfinite_sync_axis": "A.10, multi-GPU",
}


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        if name not in _UNPORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value is None or (name == "num_groups" and value == 1):
            continue
        raise NotImplementedError(f"{name}= is not ported to evotorch_tpu_torch yet (ROADMAP.md, item {_UNPORTED[name]})")


class RolloutResult(NamedTuple):
    scores: torch.Tensor  # (N,) mean episodic return per solution
    stats: CollectedStats  # obs-norm statistics after the rollout
    total_steps: int  # env interactions
    total_episodes: torch.Tensor  # scalar: episodes finished
    # the (1, 20) int32 wire of observability.devicemetrics ((1, 15) with
    # health=False), computed on the device with the scores; None with
    # telemetry=False
    telemetry: Optional[torch.Tensor] = None


def _policy_to_action(raw: torch.Tensor, action_space, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax for a discrete space (``noise`` ignored); else the raw output
    plus ``noise``, clipped into a bounded space."""
    if action_space.is_discrete:
        return torch.argmax(raw, dim=-1)
    act = raw if noise is None else raw + noise
    if action_space.lb is not None:
        return torch.clamp(act, action_space.lb, action_space.ub)
    return act


def reset_tensors(states, mask: torch.Tensor):
    """Recurrent states with the rows where ``mask`` is True zeroed (a new
    structure; the states are nested tuples of tensors, or None)."""

    def zero_rows(leaf):
        return leaf.masked_fill(mask.view(mask.shape + (1,) * (leaf.ndim - mask.ndim)), 0)

    return map_state(zero_rows, states)


def _select_states(mask: torch.Tensor, a, b):
    """Per lane, ``a``'s state where ``mask`` is True, else ``b``'s."""
    return map_state(lambda x, y: torch.where(mask.view(mask.shape + (1,) * (x.ndim - 1)), x, y), a, b)


def _state_proto(policy: FlatParamsPolicy, device: torch.device, options: "_Options"):
    """One policy's initial state on ``device``, in the compute dtype: the
    one definition of a lane's fresh state in every contract."""
    dtype = options.compute_dtype
    return map_state(lambda leaf: leaf.to(device=device, dtype=dtype or leaf.dtype), policy.initial_state())


def _broadcast_states(proto, width: int):
    """The initial states of ``width`` lanes (views of ``proto``)."""
    return map_state(lambda leaf: leaf.expand(width, *leaf.shape), proto)


def _act_and_step(env, forward, params, obs, stats, env_states, steps_in_episode, policy_states, noise, *, max_t, options):
    """The policy acts (``forward(params, obs, states)`` on the lanes'
    parameter or coefficient rows ``params``) and the env steps, for every
    lane: returns the new env states and observations, the adjusted
    rewards, the dones (with truncation at ``max_t``), the incremented step
    counters and the new policy states. With a ``compute_dtype`` the policy
    input is cast to it (``params`` and the policy states already are) and
    the raw output back to float32; ``noise`` (float32, or None) is added to
    it before the clip."""
    policy_in = stats_normalize(stats, obs) if options.observation_normalization else obs
    if options.compute_dtype is not None:
        policy_in = policy_in.to(options.compute_dtype)
    raw, policy_states = forward(params, policy_in, policy_states)
    if options.compute_dtype is not None:
        raw = raw.to(torch.float32)
    actions = _policy_to_action(raw, env.action_space, noise)
    new_states, new_obs, rewards, dones = env.batch_step(env_states, actions)
    steps = steps_in_episode + 1
    # truncation at max_t (gym TimeLimit semantics)
    dones = dones | (steps >= max_t)
    if options.decrease_rewards_by is not None:
        rewards = rewards - options.decrease_rewards_by
    if options.alive_bonus_schedule is not None:
        rewards = rewards + alive_bonus_for_step(steps, options.alive_bonus_schedule) * (~dones)
    return new_states, new_obs, rewards, dones, steps, policy_states


@dataclasses.dataclass(frozen=True)
class _Options:
    observation_normalization: bool = False
    alive_bonus_schedule: Optional[tuple] = None
    decrease_rewards_by: Optional[float] = None
    compute_dtype: Optional[torch.dtype] = None
    action_noise_stdev: Optional[float] = None


def _make_options(observation_normalization, alive_bonus_schedule, decrease_rewards_by, compute_dtype, action_noise_stdev) -> _Options:
    return _Options(
        bool(observation_normalization),
        alive_bonus_schedule,
        decrease_rewards_by,
        None if compute_dtype is None else to_torch_dtype(compute_dtype),
        None if action_noise_stdev is None else float(action_noise_stdev),
    )


def _draws_noise(env, options: _Options) -> bool:
    return options.action_noise_stdev is not None and not env.action_space.is_discrete


def _noise_table(env, action_noise, num_items: int, max_t: int, generator: torch.Generator, options: _Options):
    """The action noise of every (item, step of its episode), as ``(items *
    max_t, act)`` rows (row ``item * max_t + t``): injected, or drawn in one
    call as ``action_noise_stdev * N(0, 1)``. None without noise, and for a
    discrete action space, whose actions take no noise."""
    if action_noise is not None and options.action_noise_stdev is None:
        raise ValueError("action_noise= is the table of an action_noise_stdev; pass that too")
    if not _draws_noise(env, options):
        return None
    shape = (num_items, max_t, env.action_size)
    if action_noise is None:
        table = options.action_noise_stdev * torch.randn(shape, generator=generator, device=env.device)
    elif tuple(action_noise.shape) != shape:
        raise ValueError(f"action_noise has shape {tuple(action_noise.shape)}; (items, max_t, act) = {shape} is needed")
    else:
        table = action_noise.to(device=env.device, dtype=torch.float32)
    return table.reshape(num_items * max_t, env.action_size)


class Policy:
    """A stateful wrapper of a flat-parameter policy (counterpart of the JAX
    ``vecrl.Policy``): give it one solution's ``(L,)`` parameters or a batch
    ``(N, L)``, call it on observations, and it keeps the recurrent state,
    with ``reset(indices)`` for some rows. With ``(L,)`` parameters the
    observations are ``(B, in)`` (or one ``(in,)``) and every row uses those
    parameters; with ``(N, L)`` they are ``(N, in)``, row ``k`` from
    solution ``k``."""

    def __init__(self, net):
        if isinstance(net, FlatParamsPolicy):
            self._flat = net
        elif isinstance(net, Module):
            self._flat = FlatParamsPolicy(net)
        else:
            raise TypeError(f"Policy expects a Module or FlatParamsPolicy, got {type(net)}")
        self._params: Optional[torch.Tensor] = None
        self._state = None

    @property
    def parameter_count(self) -> int:
        return self._flat.parameter_count

    def set_parameters(self, parameters: torch.Tensor, *, reset: bool = True) -> None:
        """``(L,)`` for one policy or ``(N, L)`` for a batch of them."""
        parameters = torch.as_tensor(parameters)
        if parameters.ndim not in (1, 2):
            raise ValueError(f"expected (L,) or (N, L) parameters, got shape {tuple(parameters.shape)}")
        self._params = parameters
        if reset:
            self._state = None

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        if self._params is None:
            raise RuntimeError("Call set_parameters(...) before using the Policy")
        obs = torch.as_tensor(obs, device=self._params.device)
        single_obs = obs.ndim == 1
        x = obs.unsqueeze(0) if single_obs else obs
        params = self._params if self._params.ndim == 2 else self._params.unsqueeze(0).expand(x.shape[0], -1)
        out, self._state = self._flat(params, x, self._state)
        return out[0] if single_obs else out

    def reset(self, indices=None) -> None:
        """Forget the state entirely (``indices=None``), or zero the rows
        given by a boolean mask or an index array."""
        if self._state is None or indices is None:
            self._state = None
            return
        indices = torch.as_tensor(indices, device=self._params.device)
        if indices.dtype == torch.bool:
            mask = indices
        else:
            rows = state_leaves(self._state)[0].shape[0]
            mask = torch.zeros(rows, dtype=torch.bool, device=indices.device)
            mask[indices] = True
        self._state = reset_tensors(self._state, mask)

    @property
    def h(self):
        """The current recurrent state (None before the first call)."""
        return self._state


# ------------------- population representations -------------------
# A population is a dense (N, L) tensor or a factored batch; these helpers
# are the only places that care which. A rollout's carries hold "lane rows":
# parameter rows of a dense population, coefficient rows of a factored one.


def _params_popsize(params_batch) -> int:
    return params_batch.popsize if is_factored(params_batch) else int(params_batch.shape[0])


def _params_cast(params_batch, options: _Options):
    """The population in the policy's compute dtype, cast once per rollout:
    a dense population is copied (246 MB in bfloat16 at 10,000 x 12,305),
    a factored one has every tensor cast (center, basis, coefficients,
    factors), its ``(N, L)`` matrix never built."""
    dtype = options.compute_dtype
    if dtype is None:
        return params_batch
    if not is_factored(params_batch):
        return params_batch.to(dtype)
    cast = params_batch._replace(
        center=params_batch.center.to(dtype), basis=params_batch.basis.to(dtype), coeffs=params_batch.coeffs.to(dtype)
    )
    if isinstance(cast, TrunkDeltaParamsBatch):
        cast = cast._replace(factors=[_Factor(f.a.to(dtype), f.b.to(dtype)) for f in cast.factors])
    return cast


def _params_take(params_batch, idx):
    """The solutions ``idx`` of a population, dense or factored."""
    return params_batch.take(idx) if is_factored(params_batch) else params_batch[idx]


def _forward_ctx(policy: FlatParamsPolicy, params_batch, trunk_block: int = 0):
    """The loop-invariant forward context of a rollout, built once outside
    the stepping loop, and the lane-row store it reads: ``(None, the dense
    population)``, or ``(the prepared factored context, the coefficients)``.
    A module without a structured factored path falls back to the dense
    population, with a warning (the JAX engine's rule). ``trunk_block``
    blocks the trunk-delta forward's lanes (0: one block)."""
    if not is_factored(params_batch):
        return None, params_batch
    if not lowrank_supported(policy.module):
        form = "trunk-delta" if isinstance(params_batch, TrunkDeltaParamsBatch) else "low-rank"
        _fallback_warning(form, params_batch, policy.module)
        return None, params_batch.materialize()
    if isinstance(params_batch, TrunkDeltaParamsBatch):
        return prepare_trunk_delta(policy, params_batch, trunk_block=trunk_block), params_batch.coeffs
    return prepare_lowrank(policy, params_batch), params_batch.coeffs


def _batched_forward(policy: FlatParamsPolicy, ctx, lane_params: torch.Tensor, obs: torch.Tensor, states):
    """The policy forward of every lane from its lane rows, for any
    representation: ``(actions, new states)``."""
    if ctx is None:
        return policy(lane_params, obs, states)
    if isinstance(ctx, _TrunkPrepared):
        return _trunk_forward_prepared(policy.module, ctx, lane_params, obs, states)
    return _apply_lowrank(policy.module, ctx.layers, lane_params, obs, states)


def _quarantine_nonfinite(scores: torch.Tensor, *, penalty: Optional[float] = None):
    """Replace non-finite scores by the worst finite score (or ``penalty``);
    returns the scores and the replacement mask. An all-non-finite batch
    gets 0.0."""
    finite = torch.isfinite(scores)
    bad = ~finite
    if penalty is not None:
        repl = torch.full((), float(penalty), dtype=scores.dtype, device=scores.device)
    else:
        big = torch.finfo(scores.dtype).max
        worst = torch.where(finite, scores, big).min()
        repl = torch.where(worst >= big, 0.0, worst).to(scores.dtype)
    return torch.where(bad, repl, scores), bad


def _finish(scores, stats, total_steps, episodes, *, capacity, lane_width, telemetry, health, quarantine, penalty, refill_events=0, queue_wait=0, hist=None):
    """Quarantine the mean scores, pack the telemetry wire and build the
    result (the one sync: ``total_steps`` as a Python int)."""
    bad = None
    if quarantine:
        scores, bad = _quarantine_nonfinite(scores, penalty=penalty)
    wire = None
    if telemetry:
        counts = pack_eval_telemetry(
            env_steps=total_steps,
            episodes=episodes,
            capacity=capacity,
            lane_width=lane_width,
            refill_events=refill_events,
            queue_wait=queue_wait,
            nonfinite=0 if bad is None else bad.sum(),
            device=scores.device,
        )
        wire = pack_group_telemetry(counts[None], None if hist is None else hist[None])
        if health:
            wire = append_health_block(wire, compute_health_block(scores))
    total = total_steps if isinstance(total_steps, int) else int(total_steps)
    return RolloutResult(scores=scores, stats=stats, total_steps=total, total_episodes=episodes, telemetry=wire)


class _EndPoll:
    """Watches a loop's on-device "work left" flag with no sync per step.

    On the card each call enqueues a copy of the flag into pinned host
    memory and an event after it, then reads, oldest first, the flags whose
    event has completed (``Event.query`` never blocks). It waits on an event
    only when more than ``lag`` are pending, that is when the card has
    fallen that many steps behind the host. So when the card keeps up with
    the host (the launch-bound case) the loop stops at its true end or one
    step after it, and otherwise at most ``lag`` steps after it; those
    steps are no-ops. On the CPU the flag is read directly."""

    def __init__(self, device: torch.device, lag: int = 8):
        self.cuda = device.type == "cuda"
        self.lag = int(lag)
        self.pending = collections.deque()
        if self.cuda:
            self.slots = [torch.empty((), dtype=torch.bool, pin_memory=True) for _ in range(self.lag + 1)]
            self.next_slot = 0

    def finished(self, work_left: torch.Tensor) -> bool:
        if not self.cuda:
            return not bool(work_left)
        slot = self.slots[self.next_slot]
        self.next_slot = (self.next_slot + 1) % len(self.slots)
        slot.copy_(work_left, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.pending.append((slot, event))
        while self.pending:
            slot, event = self.pending[0]
            if len(self.pending) <= self.lag and not event.query():
                return False
            event.synchronize()
            self.pending.popleft()
            if not bool(slot):
                return True
        return False


def _drive(step, carry, *, hard_cap: int, loop_stats: Optional[dict]):
    """Step ``carry`` until its ``work_left`` flag is seen false (or
    ``hard_cap`` steps, the JAX engine's safety net, have run)."""
    poll = _EndPoll(carry.active.device)
    issued = 0
    while issued < hard_cap:
        carry = step(carry)
        issued += 1
        if poll.finished(carry.work_left):
            break
    _note(loop_stats, steps_issued=issued, steps=carry.t_global)
    return carry


def _host_int_later(value: torch.Tensor):
    """Start copying an on-device integer to the host without blocking;
    returns a function that waits on that copy's event (not on the stream)
    and gives the int."""
    if value.device.type != "cuda":
        return lambda: int(value)
    slot = torch.empty((), dtype=value.dtype, pin_memory=True)
    slot.copy_(value, non_blocking=True)
    event = torch.cuda.Event()
    event.record()

    def read() -> int:
        event.synchronize()
        return int(slot)

    return read


def _max_t(env, episode_length) -> int:
    max_t = env.max_episode_steps if env.max_episode_steps is not None else 1000
    if episode_length is not None:
        max_t = min(max_t, int(episode_length))
    return max_t


def _reset_table(env, reset_noise, num_items: int, generator: torch.Generator) -> torch.Tensor:
    """The reset noise of every (solution, episode) item, in item order:
    injected, or drawn in one call."""
    if reset_noise is None:
        return env.reset_noise(num_items, generator)
    if reset_noise.shape[0] != num_items:
        raise ValueError(f"reset_noise has {reset_noise.shape[0]} rows; popsize * num_episodes = {num_items} are needed")
    return reset_noise.to(env.device)


def _note(loop_stats: Optional[dict], **values) -> None:
    if loop_stats is not None:
        loop_stats.update({k: (int(v) if isinstance(v, torch.Tensor) else v) for k, v in values.items()})


# ------------------------------- budget contract -------------------------------


@dataclasses.dataclass(frozen=True)
class BudgetCarry:
    """Loop state of the budget contract; per-lane tensors are
    population-leading except ``env_states``, whose layout belongs to the
    env. Every lane is active on every step, so there is no activity mask."""

    env_states: Any
    obs: torch.Tensor
    policy_states: Any
    scores: torch.Tensor
    episodes_done: torch.Tensor
    steps_in_episode: torch.Tensor
    stats: CollectedStats
    total_steps: int


def _budget_init(env, policy, store: torch.Tensor, generator: torch.Generator, stats, options: _Options) -> BudgetCarry:
    """Reset every lane; the reset observations are the policy's first
    input, so they enter the normalization statistics."""
    n = store.shape[0]
    device = store.device
    env_states, obs = env.batch_reset(n, generator)
    if options.observation_normalization:
        stats = stats_update(stats, obs)
    return BudgetCarry(
        env_states=env_states,
        obs=obs,
        policy_states=_broadcast_states(_state_proto(policy, device, options), n),
        scores=torch.zeros(n, device=device),
        episodes_done=torch.zeros(n, dtype=torch.int32, device=device),
        steps_in_episode=torch.zeros(n, dtype=torch.int32, device=device),
        stats=stats,
        total_steps=0,
    )


def _make_budget_step(env, policy, store: torch.Tensor, generator, *, max_t: int, options: _Options, forward=None):
    """One control step of the whole population under the budget contract,
    ``step(carry) -> carry``: every lane is active on every step, its action
    noise drawn from ``generator``, and finished lanes restart from a fresh
    reset drawn from ``generator`` and zeroed policy states. Lane ``i`` acts
    from row ``i`` of ``store`` through ``forward`` (``_batched_forward``
    bound to a rollout's context; the dense ``policy`` when None)."""
    forward = policy if forward is None else forward
    noisy = _draws_noise(env, options)

    def step(c: BudgetCarry) -> BudgetCarry:
        n = c.scores.shape[0]
        noise = None
        if noisy:
            noise = options.action_noise_stdev * torch.randn((n, env.action_size), generator=generator, device=c.obs.device)
        new_env_states, new_obs, rewards, finished, steps_in_episode, policy_states = _act_and_step(
            env, forward, store, c.obs, c.stats, c.env_states, c.steps_in_episode, c.policy_states, noise,
            max_t=max_t, options=options,
        )  # fmt: skip
        scores = c.scores + rewards
        episodes_done = c.episodes_done + finished.to(torch.int32)

        fresh_states, fresh_obs = env.batch_reset(n, generator)
        env_states_next = env.batch_where(finished, fresh_states, new_env_states)
        obs_next = torch.where(finished[:, None], fresh_obs, new_obs)
        steps_in_episode = torch.where(finished, 0, steps_in_episode)
        # normalization statistics come from the observations the policy
        # consumes next step: after the reset selection
        new_stats = stats_update(c.stats, obs_next) if options.observation_normalization else c.stats
        return BudgetCarry(
            env_states=env_states_next,
            obs=obs_next,
            policy_states=reset_tensors(policy_states, finished),
            scores=scores,
            episodes_done=episodes_done,
            steps_in_episode=steps_in_episode,
            stats=new_stats,
            total_steps=c.total_steps + n,
        )

    return step


def _run_budget(env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, finish_kw, loop_stats):
    carry = _budget_init(env, policy, store, generator, stats, options)
    step = _make_budget_step(env, policy, store, generator, max_t=max_t, options=options, forward=forward)
    budget = max_t * int(num_episodes)
    for _ in range(budget):
        carry = step(carry)
    _note(loop_stats, steps_issued=budget, steps=budget)

    n = store.shape[0]
    max_t_f = torch.full((), float(max_t), device=store.device)
    episodes_frac = carry.episodes_done + carry.steps_in_episode.to(torch.float32) / max_t_f
    mean_scores = carry.scores / torch.clamp(episodes_frac, min=1.0 / max_t)
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        torch.sum(carry.episodes_done),
        capacity=n * budget,
        lane_width=n,
        **finish_kw,
    )


# ------------------------- episodes contract (and compaction) -------------------------


@dataclasses.dataclass(frozen=True)
class EpisodesCarry:
    """Loop state of the ``episodes`` contract at working width ``W``
    (``N`` until compaction narrows it): lane ``i`` runs solution
    ``lane_ids[i]`` with lane row ``params[i]`` (a parameter row, or a
    factored population's coefficient row) and policy state
    ``policy_states[i]``. ``lane_score`` is the return of the current
    episode, ``scores`` the sum of the finished ones. ``work_left`` (any
    lane active) gates ``t_global`` and ``capacity`` so that steps past the
    end count nothing."""

    env_states: Any
    obs: torch.Tensor
    policy_states: Any
    lane_ids: torch.Tensor
    params: torch.Tensor
    lane_score: torch.Tensor
    scores: torch.Tensor
    episodes_done: torch.Tensor
    steps_in_episode: torch.Tensor
    active: torch.Tensor
    stats: CollectedStats
    total_steps: torch.Tensor
    t_global: torch.Tensor
    capacity: torch.Tensor
    work_left: torch.Tensor


def _episodes_init(env, policy, store, table, stats, options) -> EpisodesCarry:
    """Every lane starts episode 0 of its solution from reset row ``s`` and
    the policy's initial state; the reset observations enter the
    normalization statistics."""
    n = store.shape[0]
    device = store.device
    lane_ids = torch.arange(n, device=device)
    env_states, obs = env.batch_reset_from(table[:n])
    if options.observation_normalization:
        stats = stats_update(stats, obs)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return EpisodesCarry(
        env_states=env_states,
        obs=obs,
        policy_states=_broadcast_states(_state_proto(policy, device, options), n),
        lane_ids=lane_ids,
        params=store,
        lane_score=torch.zeros(n, device=device),
        scores=torch.zeros(n, device=device),
        episodes_done=torch.zeros(n, dtype=torch.int32, device=device),
        steps_in_episode=torch.zeros(n, dtype=torch.int32, device=device),
        active=torch.ones(n, dtype=torch.bool, device=device),
        stats=stats,
        total_steps=zero,
        t_global=zero,
        capacity=zero,
        work_left=torch.ones((), dtype=torch.bool, device=device),
    )


def _make_episodes_step(
    env, policy, table, noise_table, *, popsize: int, num_episodes: int, max_t: int, options: _Options, forward=None
):
    """One masked control step of the ``episodes`` contract at the carry's
    width, ``step(carry) -> carry``.

    A lane whose episode ends with episodes left restarts from the reset
    row of its next item (``episodes_done * N + solution``) and the policy's
    initial state. A lane whose last episode ends is frozen at its last
    pre-terminal state, its policy state kept, and stays masked: it never
    needs a reset, and a bounded state cannot leak NaN into the masked
    statistics. At ``num_episodes == 1`` no lane ever restarts, so the step
    draws no reset at all. Row ``item * max_t + t`` of ``noise_table`` (if
    any) is the action noise of step ``t`` of the lane's item. The lanes act
    through ``forward`` (the dense ``policy`` when None) on their rows of the
    carry's ``params``."""
    forward = policy if forward is None else forward
    auto_reset = num_episodes > 1
    proto = _state_proto(policy, table.device, options) if auto_reset else None

    def step(c: EpisodesCarry) -> EpisodesCarry:
        width = c.active.shape[0]
        noise = None
        if noise_table is not None:
            item = c.lane_ids
            if auto_reset:
                item = torch.clamp(c.episodes_done, max=num_episodes - 1).to(torch.int64) * popsize + item
            noise = noise_table.index_select(0, item * max_t + c.steps_in_episode)
        new_states, new_obs, rewards, dones, steps, policy_states = _act_and_step(
            env, forward, c.params, c.obs, c.stats, c.env_states, c.steps_in_episode, c.policy_states, noise,
            max_t=max_t, options=options,
        )  # fmt: skip
        lane_score = c.lane_score + torch.where(c.active, rewards, 0.0)
        finished = dones & c.active
        episodes_done = c.episodes_done + finished.to(torch.int32)
        scores = c.scores + torch.where(finished, lane_score, 0.0)
        active = episodes_done < num_episodes
        running = c.active & ~finished

        env_states = env.batch_where(active, new_states, c.env_states)
        obs = torch.where(active[:, None], new_obs, c.obs)
        policy_states = _select_states(running, policy_states, c.policy_states)
        steps = torch.where(running, steps, 0)
        lane_score = torch.where(running, lane_score, 0.0)
        if auto_reset:
            restart = finished & active
            rows = torch.clamp(episodes_done, max=num_episodes - 1).to(torch.int64) * popsize + c.lane_ids
            fresh_states, fresh_obs = env.batch_reset_from(table.index_select(0, rows))
            env_states = env.batch_where(restart, fresh_states, env_states)
            obs = torch.where(restart[:, None], fresh_obs, obs)
            policy_states = _select_states(restart, _broadcast_states(proto, width), policy_states)

        # the statistics take the observations the lanes still running
        # consume next step
        stats = stats_update(c.stats, obs, mask=active) if options.observation_normalization else c.stats
        return EpisodesCarry(
            env_states=env_states,
            obs=obs,
            policy_states=policy_states,
            lane_ids=c.lane_ids,
            params=c.params,
            lane_score=lane_score,
            scores=scores,
            episodes_done=episodes_done,
            steps_in_episode=steps,
            active=active,
            stats=stats,
            total_steps=c.total_steps + c.active.sum(),
            t_global=c.t_global + c.work_left.to(torch.int64),
            capacity=c.capacity + c.work_left.to(torch.int64) * width,
            work_left=active.any(),
        )

    return step


def _run_episodes(
    env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, reset_noise, action_noise, finish_kw,
    loop_stats,
):  # fmt: skip
    n = store.shape[0]
    table = _reset_table(env, reset_noise, n * num_episodes, generator)
    noise_table = _noise_table(env, action_noise, n * num_episodes, max_t, generator, options)
    carry = _episodes_init(env, policy, store, table, stats, options)
    step = _make_episodes_step(
        env, policy, table, noise_table, popsize=n, num_episodes=num_episodes, max_t=max_t, options=options,
        forward=forward,
    )  # fmt: skip
    carry = _drive(step, carry, hard_cap=max_t * num_episodes + 1, loop_stats=loop_stats)
    mean_scores = carry.scores / torch.clamp(carry.episodes_done, min=1)
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        torch.sum(carry.episodes_done),
        capacity=carry.capacity,
        lane_width=n,
        **finish_kw,
    )


# ------------------------------ episodes_refill ------------------------------


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _default_refill_width(total_items: int) -> int:
    """About 1/8 of the work-list, a power of two, at least 128 (the JAX
    package's default)."""
    return min(total_items, max(128, _pow2_at_least(max(1, total_items // 8))))


@dataclasses.dataclass(frozen=True)
class RefillCarry:
    """Loop state of the refill engine: ``lane_*`` and the other ``(W,)``
    tensors are per lane; ``scores_buf``/``eps_buf`` are per solution;
    ``next_item`` is the head of the queue of items ``episode * N +
    solution``. ``capacity``, ``wait_sum``, ``idle_since`` and ``hist`` are
    the telemetry accumulators (``idle_since``: the step at which each lane
    went idle; ``hist``: the queue-wait histogram). ``lane_item`` is the
    item each lane runs (or last ran), ``lane_sol`` its solution."""

    env_states: Any
    obs: torch.Tensor
    policy_states: Any
    lane_item: torch.Tensor
    lane_sol: torch.Tensor
    lane_score: torch.Tensor
    steps_in_episode: torch.Tensor
    active: torch.Tensor
    scores_buf: torch.Tensor
    eps_buf: torch.Tensor
    next_item: torch.Tensor
    stats: CollectedStats
    total_steps: torch.Tensor
    t_global: torch.Tensor
    capacity: torch.Tensor
    wait_sum: torch.Tensor
    idle_since: torch.Tensor
    hist: torch.Tensor
    work_left: torch.Tensor


def _refill_init(env, policy, store, table, stats, options, *, width: int) -> RefillCarry:
    """Lanes ``0..W-1`` start items ``0..W-1`` (solution ``item % N``,
    episode 0 when ``W <= N``) from the policy's initial state; the queue
    head is ``W``."""
    n = store.shape[0]
    device = store.device
    env_states, obs = env.batch_reset_from(table[:width])
    if options.observation_normalization:
        stats = stats_update(stats, obs)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    items = torch.arange(width, device=device)
    return RefillCarry(
        env_states=env_states,
        obs=obs,
        policy_states=_broadcast_states(_state_proto(policy, device, options), width),
        lane_item=items,
        lane_sol=items % n,
        lane_score=torch.zeros(width, device=device),
        steps_in_episode=torch.zeros(width, dtype=torch.int32, device=device),
        active=torch.ones(width, dtype=torch.bool, device=device),
        scores_buf=torch.zeros(n, dtype=torch.float32, device=device),
        eps_buf=torch.zeros(n, dtype=torch.int32, device=device),
        next_item=torch.full((), width, dtype=torch.int64, device=device),
        stats=stats,
        total_steps=zero,
        t_global=zero,
        capacity=zero,
        wait_sum=zero,
        idle_since=torch.zeros(width, dtype=torch.int64, device=device),
        hist=torch.zeros(QUEUE_WAIT_BUCKETS, dtype=torch.int64, device=device),
        work_left=torch.ones((), dtype=torch.bool, device=device),
    )


def _make_refill_step(
    env, policy, store, table, noise_table, *, num_episodes: int, period: int, max_t: int, options: _Options, forward=None
):
    """One control step of the refill engine at the carry's width,
    ``step(carry) -> carry``. The refill (a reset of every lane from its
    candidate item's row) is computed on every step and selected by
    ``take``, which is all-false when the gate is closed: no host sync
    decides it. Every lane that is not running after the step returns to
    the policy's initial state (the JAX refill engine's rule), so a
    refilled item starts as ``_refill_init``'s do. Row ``item * max_t + t``
    of ``noise_table`` (if any) is the action noise of step ``t`` of the
    lane's item. Each step gathers the lanes' rows of ``store``: ``(W,
    L)`` parameter rows, or ``(W, k)`` coefficient rows of a factored
    population, through ``forward`` (the dense ``policy`` when None)."""
    forward = policy if forward is None else forward
    n = store.shape[0]
    total_items = n * num_episodes
    edges = torch.tensor(QUEUE_WAIT_BUCKET_EDGES, device=store.device)
    proto = _state_proto(policy, store.device, options)

    def step(c: RefillCarry) -> RefillCarry:
        params = store.index_select(0, c.lane_sol)
        noise = None
        if noise_table is not None:
            noise = noise_table.index_select(0, c.lane_item * max_t + c.steps_in_episode)
        new_states, new_obs, rewards, dones, steps, policy_states = _act_and_step(
            env, forward, params, c.obs, c.stats, c.env_states, c.steps_in_episode, c.policy_states, noise,
            max_t=max_t, options=options,
        )  # fmt: skip
        lane_score = c.lane_score + torch.where(c.active, rewards, 0.0)
        finished = dones & c.active
        # credit finished episodes to their solutions (idle lanes add an
        # exact 0.0 to the row they last ran)
        scores_buf = c.scores_buf.index_add(0, c.lane_sol, torch.where(finished, lane_score, 0.0))
        eps_buf = c.eps_buf.index_add(0, c.lane_sol, finished.to(torch.int32))
        running = c.active & ~finished
        # freeze the lanes that stopped at their pre-step state
        env_base = env.batch_where(running, new_states, c.env_states)
        obs_base = torch.where(running[:, None], new_obs, c.obs)
        steps = torch.where(running, steps, 0)
        lane_score = torch.where(running, lane_score, 0.0)
        policy_states = _select_states(running, policy_states, _broadcast_states(proto, running.shape[0]))

        idle = ~running
        gate = idle.any() & (c.next_item < total_items)
        if period > 1:
            gate = gate & (((c.t_global + 1) % period) == 0)
        # ranks among idle lanes -> candidate items; lanes past the queue's
        # end stay idle
        cand = c.next_item + torch.cumsum(idle.to(torch.int64), 0) - 1
        take = idle & (cand < total_items) & gate
        items = torch.where(take, cand, 0)
        fresh_states, fresh_obs = env.batch_reset_from(table.index_select(0, items))
        env_states = env.batch_where(take, fresh_states, env_base)
        obs = torch.where(take[:, None], fresh_obs, obs_base)
        lane_item = torch.where(take, items, c.lane_item)
        lane_sol = torch.where(take, items % n, c.lane_sol)
        active = running | take
        next_item = c.next_item + take.sum()

        # telemetry: W lane-step slots per step that did work; lanes idle
        # after this step's refill while items remain are waiting; a
        # refilled item waited (now - the step its lane went idle)
        work = c.work_left.to(torch.int64)
        tcur = c.t_global + 1
        idle_since = torch.where(finished, tcur, c.idle_since)
        waits = torch.where(take, tcur - idle_since, 0)
        stats = stats_update(c.stats, obs, mask=active) if options.observation_normalization else c.stats
        return RefillCarry(
            env_states=env_states,
            obs=obs,
            policy_states=policy_states,
            lane_item=lane_item,
            lane_sol=lane_sol,
            lane_score=lane_score,
            steps_in_episode=steps,
            active=active,
            scores_buf=scores_buf,
            eps_buf=eps_buf,
            next_item=next_item,
            stats=stats,
            total_steps=c.total_steps + c.active.sum(),
            t_global=c.t_global + work,
            capacity=c.capacity + work * c.active.shape[0],
            wait_sum=c.wait_sum + torch.where(next_item < total_items, (~active).sum(), 0),
            idle_since=idle_since,
            hist=c.hist.index_add(0, queue_wait_bucket_index(waits, edges), take.to(torch.int64)),
            work_left=active.any() | (next_item < total_items),
        )

    return step


def _run_refill(
    env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, reset_noise, action_noise,
    refill_width, refill_period, finish_kw, loop_stats,
):  # fmt: skip
    """The ``episodes_refill`` evaluation: each solution is scored by the
    mean return of exactly ``num_episodes`` episodes, run on a fixed width
    of lanes fed from the item queue."""
    n = store.shape[0]
    total_items = n * num_episodes
    width = refill_width if refill_width is not None else _default_refill_width(total_items)
    width = int(min(max(1, int(width)), total_items))
    period = max(1, int(refill_period))
    table = _reset_table(env, reset_noise, total_items, generator)
    noise_table = _noise_table(env, action_noise, total_items, max_t, generator, options)
    carry = _refill_init(env, policy, store, table, stats, options, width=width)
    step = _make_refill_step(
        env, policy, store, table, noise_table, num_episodes=num_episodes, period=period, max_t=max_t, options=options,
        forward=forward,
    )  # fmt: skip
    # greedy-scheduling makespan bound plus the refill-period slack (the
    # JAX engine's safety net)
    hard_cap = (total_items * max_t) // width + max_t + period * (total_items // width + 1) + 2
    carry = _drive(step, carry, hard_cap=hard_cap, loop_stats=loop_stats)
    mean_scores = carry.scores_buf / torch.clamp(carry.eps_buf, min=1).to(torch.float32)
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        torch.sum(carry.eps_buf),
        capacity=carry.capacity,
        lane_width=width,
        # items 0..W-1 seeded the lanes; every later one was a refill
        refill_events=carry.next_item - width,
        queue_wait=carry.wait_sum,
        hist=carry.hist,
        **finish_kw,
    )


# ------------------------------- entry points -------------------------------


def _check_inputs(env, params_batch, stats, unported):
    _reject_unported(unported)
    if not (isinstance(params_batch, torch.Tensor) or is_factored(params_batch)):
        raise TypeError(
            "a population is a dense (N, L) tensor or a factored batch (LowRankParamsBatch,"
            f" TrunkDeltaParamsBatch); got {type(params_batch).__name__}"
        )
    if stats is not None and stats.count.ndim == 1:
        raise NotImplementedError(
            "stacked (per-group) statistics are not ported to evotorch_tpu_torch yet"
            " (ROADMAP.md, item A.12, per-group telemetry and the serving substrate)"
        )
    device = params_batch.coeffs.device if is_factored(params_batch) else params_batch.device
    if device != env.device:
        raise ValueError(f"the population lies on {device} and the env on {env.device}")


def run_vectorized_rollout(
    env,
    policy: FlatParamsPolicy,
    params_batch,
    generator: torch.Generator,
    stats: CollectedStats,
    *,
    num_episodes: int = 1,
    episode_length: Optional[int] = None,
    observation_normalization: bool = False,
    alive_bonus_schedule: Optional[tuple] = None,
    decrease_rewards_by: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    action_noise_stdev: Optional[float] = None,
    eval_mode: str = "episodes",
    refill_width: Optional[int] = None,
    refill_period: int = 1,
    trunk_block: int = 0,
    telemetry: bool = True,
    health: bool = True,
    nonfinite_quarantine: bool = False,
    nonfinite_penalty: Optional[float] = None,
    reset_noise: Optional[torch.Tensor] = None,
    action_noise: Optional[torch.Tensor] = None,
    loop_stats: Optional[dict] = None,
    **unported,
) -> RolloutResult:
    """Evaluate the ``N`` solutions of ``params_batch`` (a dense ``(N, L)``
    tensor or a factored batch, on the env's device) under ``eval_mode``
    ``"episodes"``, ``"episodes_refill"`` or ``"budget"`` (see the module
    docstring).

    - ``num_episodes``/``episode_length``: episodes per solution and the
      truncation length ``max_t`` (at most the env's own).
    - ``decrease_rewards_by`` is subtracted from every reward, and the
      ``alive_bonus_schedule`` bonus added on every step that does not end
      an episode, under every contract.
    - ``compute_dtype`` (e.g. ``torch.bfloat16``) is the policy forward's
      dtype: the parameters are cast to it once per rollout and the policy
      input on every step, and the raw output is cast back to float32. Env
      dynamics, rewards and statistics stay float32. On the card the
      forward's ``baddbmm`` then runs in that dtype. A recurrent policy's
      state is kept in it too.
    - ``action_noise_stdev``: Gaussian noise of that stdev is added to the
      raw policy output before the clip (not for a discrete action space),
      every step of every lane.
    - ``refill_width`` (default: about an eighth of ``N * num_episodes``)
      and ``refill_period`` (refill only every that many steps):
      ``episodes_refill`` only.
    - ``trunk_block``: a trunk-delta population's forward runs over blocks
      of that many lanes, one after the other, when the block is smaller
      than the width and divides it (0, the default: one block); ignored for
      the other representations.
    - ``nonfinite_quarantine``: replace non-finite final scores by the
      worst finite one, or ``nonfinite_penalty``, and count them in the
      telemetry's ``nonfinite`` slot.
    - ``telemetry``/``health``: return the ``(1, 20)`` int32 wire (``(1,
      15)`` without the health block; None without telemetry).
    - ``reset_noise``: the ``(N * num_episodes, ...)`` table of reset rows
      the episodes contracts use (``env.reset_noise`` draws it from
      ``generator`` when None); the tests inject the JAX package's draws.
    - ``action_noise``: the ``(N * num_episodes, max_t, act)`` table of the
      action noise the episodes contracts add (drawn from ``generator`` as
      ``action_noise_stdev * N(0, 1)`` when None; it needs
      ``action_noise_stdev``); the tests inject the JAX package's draws.
    - ``loop_stats``: a dict that receives ``steps_issued`` (loop
      iterations the host launched) and ``steps`` (those that did work).

    ``generator`` draws the reset and action noise (the tables, or every
    step's under ``budget``). The options of the JAX engine that the port
    does not take yet (groups, solution keys, lane ids, padding, seed
    strides, sync axes) raise ``NotImplementedError`` naming their item in
    ``ROADMAP.md``."""
    if eval_mode not in ("episodes", "budget", "episodes_refill"):
        raise ValueError(f"eval_mode must be 'episodes', 'budget' or 'episodes_refill', got {eval_mode!r}")
    _check_inputs(env, params_batch, stats, unported)
    max_t = _max_t(env, episode_length)
    num_episodes = int(num_episodes)
    options = _make_options(
        observation_normalization, alive_bonus_schedule, decrease_rewards_by, compute_dtype, action_noise_stdev
    )
    ctx, store = _forward_ctx(policy, _params_cast(params_batch, options), trunk_block=int(trunk_block))
    forward = functools.partial(_batched_forward, policy, ctx)
    finish_kw = dict(telemetry=telemetry, health=health, quarantine=nonfinite_quarantine, penalty=nonfinite_penalty)
    if eval_mode == "budget":
        if reset_noise is not None or action_noise is not None:
            raise ValueError(
                "reset_noise= and action_noise= apply to the episodes contracts; budget draws its resets and noise every step"
            )
        return _run_budget(
            env, policy, forward, store, generator, stats, num_episodes=num_episodes, max_t=max_t, options=options,
            finish_kw=finish_kw, loop_stats=loop_stats,
        )  # fmt: skip
    if eval_mode == "episodes_refill":
        return _run_refill(
            env, policy, forward, store, generator, stats, num_episodes=num_episodes, max_t=max_t, options=options,
            reset_noise=reset_noise, action_noise=action_noise, refill_width=refill_width, refill_period=refill_period,
            finish_kw=finish_kw, loop_stats=loop_stats,
        )  # fmt: skip
    return _run_episodes(
        env, policy, forward, store, generator, stats, num_episodes=num_episodes, max_t=max_t, options=options,
        reset_noise=reset_noise, action_noise=action_noise, finish_kw=finish_kw, loop_stats=loop_stats,
    )  # fmt: skip


def _compact(env, c: EpisodesCarry, scores_buf, eps_buf, new_width: int):
    """Flush every lane's results into the full-width buffers (keyed by
    solution), then gather the active lanes to the front at ``new_width``."""
    scores_buf = scores_buf.index_copy(0, c.lane_ids, c.scores)
    eps_buf = eps_buf.index_copy(0, c.lane_ids, c.episodes_done)
    order = torch.argsort((~c.active).to(torch.int32), stable=True)  # active first
    sel = order[:new_width]
    narrowed = EpisodesCarry(
        env_states=env.batch_take(c.env_states, sel),
        obs=c.obs.index_select(0, sel),
        policy_states=map_state(lambda leaf: leaf.index_select(0, sel), c.policy_states),
        lane_ids=c.lane_ids.index_select(0, sel),
        params=c.params.index_select(0, sel),
        lane_score=c.lane_score.index_select(0, sel),
        scores=c.scores.index_select(0, sel),
        episodes_done=c.episodes_done.index_select(0, sel),
        steps_in_episode=c.steps_in_episode.index_select(0, sel),
        active=c.active.index_select(0, sel),
        stats=c.stats,
        total_steps=c.total_steps,
        t_global=c.t_global,
        capacity=c.capacity,
        work_left=c.work_left,
    )
    return narrowed, scores_buf, eps_buf


def run_vectorized_rollout_compacting(
    env,
    policy: FlatParamsPolicy,
    params_batch,
    generator: torch.Generator,
    stats: CollectedStats,
    *,
    num_episodes: int = 1,
    episode_length: Optional[int] = None,
    observation_normalization: bool = False,
    alive_bonus_schedule: Optional[tuple] = None,
    decrease_rewards_by: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    action_noise_stdev: Optional[float] = None,
    chunk_size: int = 25,
    min_width: Optional[int] = None,
    allowed_widths: Optional[tuple] = None,
    telemetry: bool = True,
    health: bool = True,
    nonfinite_quarantine: bool = False,
    nonfinite_penalty: Optional[float] = None,
    reset_noise: Optional[torch.Tensor] = None,
    action_noise: Optional[torch.Tensor] = None,
    loop_stats: Optional[dict] = None,
    **unported,
) -> RolloutResult:
    """The ``episodes`` contract with lane compaction (counterpart of the
    JAX ``run_vectorized_rollout_compacting``; ``eval_mode
    "episodes_compact"`` in the benchmarks).

    The loop runs in chunks of ``chunk_size`` steps. After each chunk the
    count of active lanes is copied to the host without blocking, and the
    decision is taken one chunk behind, on the previous chunk's count
    (waiting on that copy's event, so the chunk just launched keeps the card
    busy): when the survivors fit a narrower width of the menu the active
    lanes are gathered to the front and the loop goes on at the TIGHTEST
    width that holds them. The menu (``allowed_widths``; default the powers
    of two from ``max(256, pow2(N/64))``, or ``min_width``, up to ``N/2``)
    is the JAX package's. Results are flushed into full-width buffers keyed
    by solution, so scores come back in the caller's order.

    Scores equal ``run_vectorized_rollout(eval_mode="episodes")``'s bit for
    bit on the CPU with observation normalization off: a lane's reset rows,
    action noise and policy state travel with its solution. A factored
    population's coefficient rows are gathered with the lanes. The JAX
    ``prewarm`` option compiles XLA programs ahead of time and has no
    meaning here; it is not taken, nor is ``trunk_block`` (the JAX engine
    does not take it here either).
    ``loop_stats`` also receives ``widths``, the working width of each
    chunk."""
    _check_inputs(env, params_batch, stats, unported)
    n = _params_popsize(params_batch)
    num_episodes = int(num_episodes)
    max_t = _max_t(env, episode_length)
    options = _make_options(
        observation_normalization, alive_bonus_schedule, decrease_rewards_by, compute_dtype, action_noise_stdev
    )
    ctx, store = _forward_ctx(policy, _params_cast(params_batch, options))
    forward = functools.partial(_batched_forward, policy, ctx)
    if allowed_widths is None:
        if min_width is None:
            min_width = max(256, _pow2_at_least(max(1, n // 64)))
        widths = []
        w = _pow2_at_least(min_width)
        while w <= n // 2:
            widths.append(w)
            w *= 2
        allowed_widths = tuple(sorted(widths))
    else:
        allowed_widths = tuple(sorted(int(w) for w in allowed_widths if w < n))

    table = _reset_table(env, reset_noise, n * num_episodes, generator)
    noise_table = _noise_table(env, action_noise, n * num_episodes, max_t, generator, options)
    carry = _episodes_init(env, policy, store, table, stats, options)
    step = _make_episodes_step(
        env, policy, table, noise_table, popsize=n, num_episodes=num_episodes, max_t=max_t, options=options,
        forward=forward,
    )  # fmt: skip
    scores_buf = torch.zeros(n, dtype=torch.float32, device=store.device)
    eps_buf = torch.zeros(n, dtype=torch.int32, device=store.device)

    hard_cap = max_t * num_episodes + 1
    max_chunks = -(-hard_cap // int(chunk_size)) + 1
    poll = _EndPoll(store.device)
    issued = 0
    visited = []
    pending_count = None
    done = False
    for _ in range(max_chunks):
        visited.append(carry.active.shape[0])
        for _ in range(int(chunk_size)):
            carry = step(carry)
            issued += 1
            if poll.finished(carry.work_left):
                done = True
                break
        if done:
            break
        count = _host_int_later(carry.active.sum())
        if pending_count is not None:
            # the PREVIOUS chunk's count: already computed, while the chunk
            # just launched keeps the card busy during the wait
            n_active = pending_count()
            if n_active == 0:
                break
            width = carry.active.shape[0]
            fits = [w for w in allowed_widths if w < width and n_active <= w]
            if fits:
                carry, scores_buf, eps_buf = _compact(env, carry, scores_buf, eps_buf, min(fits))
        pending_count = count
    _note(loop_stats, steps_issued=issued, steps=carry.t_global, widths=visited)

    scores_buf = scores_buf.index_copy(0, carry.lane_ids, carry.scores)
    eps_buf = eps_buf.index_copy(0, carry.lane_ids, carry.episodes_done)
    mean_scores = scores_buf / torch.clamp(eps_buf, min=1)
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        torch.sum(eps_buf),
        capacity=carry.capacity,
        lane_width=n,
        telemetry=telemetry,
        health=health,
        quarantine=nonfinite_quarantine,
        penalty=nonfinite_penalty,
    )
