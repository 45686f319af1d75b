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

A rollout can be one rank's block of an evaluation sharded over a process
group (``parallel/evaluate.py``): its lanes are global lanes ``lane_ids``
of a population of ``seed_stride`` solutions, lanes at or past
``num_valid`` are padding (first-row copies that start finished and earn no
credit in the scores, counters or wire), and every random table is drawn
at its global size from a generator seeded alike on every rank, each lane
taking its global row. So a shard draws what one rank would, and its lanes
compute from the rows and draws one rank's lanes would (how they round on
the card: ``parallel/evaluate.py``). ``stats_sync_axis`` (a ``Mesh`` or
process group) merges the observation-statistic deltas over the ranks
every step; ``nonfinite_sync_axis`` takes the quarantine's worst finite
score over them.

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
    sum_over_ranks,
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
from .runningnorm import CollectedStats, stats_normalize, stats_psum, stats_update

__all__ = [
    "Policy",
    "RolloutResult",
    "reset_tensors",
    "run_vectorized_rollout",
    "run_vectorized_rollout_compacting",
    "run_vectorized_rollout_compacting_sharded",
]

#: options of the JAX engine left out of the port, with their ROADMAP.md item
_UNPORTED = {
    "groups": "A.12, per-group telemetry and the serving substrate",
    "num_groups": "A.12, per-group telemetry and the serving substrate",
    "solution_keys": "A.12, per-group telemetry and the serving substrate",
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


def _noise_table(env, action_noise, num_items: int, max_t: int, generator: torch.Generator, options: _Options, item_rows=None):
    """The action noise of every (item, step of its episode), as ``(items *
    max_t, act)`` rows (row ``item * max_t + t``): injected, or drawn in one
    call as ``action_noise_stdev * N(0, 1)``. None without noise, and for a
    discrete action space, whose actions take no noise. With ``item_rows``
    the table is drawn at its global size and item ``i`` of the result is
    global item ``item_rows[i]``."""
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
    table = _take_rows(table, item_rows)
    return table.reshape(table.shape[0] * max_t, env.action_size)


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


def _quarantine_nonfinite(scores: torch.Tensor, *, penalty: Optional[float] = None, valid=None, sync=None):
    """Replace non-finite scores by the worst finite score (or ``penalty``);
    returns the scores and the mask of the replacements to count. An
    all-non-finite batch gets 0.0. Padding lanes (``valid`` False) are
    scrubbed too but neither counted nor considered for the worst; with a
    ``sync`` mesh the worst is taken over every rank."""
    finite = torch.isfinite(scores)
    bad = ~finite
    consider, counted = (finite, bad) if valid is None else (finite & valid, bad & valid)
    if penalty is not None:
        repl = torch.full((), float(penalty), dtype=scores.dtype, device=scores.device)
    else:
        big = torch.finfo(scores.dtype).max
        worst = torch.where(consider, scores, big).min()
        if sync is not None:
            worst = sync.all_min(worst)
        repl = torch.where(worst >= big, 0.0, worst).to(scores.dtype)
    return torch.where(bad, repl, scores), counted


def _finish(
    scores, stats, total_steps, episodes, *, capacity, lane_width, telemetry, health, quarantine, penalty,
    refill_events=0, queue_wait=0, hist=None, valid=None, n_valid=None, nonfinite_sync=None,
):  # fmt: skip
    """Quarantine the mean scores, pack the telemetry wire and build the
    result (the one sync: ``total_steps`` as a Python int). Padding lanes
    (``valid`` False, the last ``len(scores) - n_valid``) stay out of the
    quarantine's counts and the health block."""
    bad = None
    if quarantine:
        scores, bad = _quarantine_nonfinite(scores, penalty=penalty, valid=valid, sync=nonfinite_sync)
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
            wire = append_health_block(wire, compute_health_block(scores if n_valid is None else scores[:n_valid]))
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
    steps are no-ops. On the CPU the flag is read directly.

    ``exact`` (a loop whose steps hold collectives, which every rank must
    issue alike): the flag of the step ``lag`` steps back is always waited
    on, so the loop stops exactly ``lag`` steps after its end on every
    rank, whatever each host saw. The flag must then be the same on every
    rank."""

    def __init__(self, device: torch.device, lag: int = 8, exact: bool = False):
        self.cuda = device.type == "cuda"
        self.exact = bool(exact)
        self.lag = 2 if self.exact else int(lag)
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
            if len(self.pending) <= self.lag and (self.exact or not event.query()):
                return False
            event.synchronize()
            self.pending.popleft()
            if not bool(slot):
                return True
        return False


def _drive(step, carry, *, hard_cap: int, loop_stats: Optional[dict], exact: bool = False):
    """Step ``carry`` until its ``work_left`` flag is seen false (or
    ``hard_cap`` steps, the JAX engine's safety net, have run); ``exact``:
    see ``_EndPoll``."""
    poll = _EndPoll(carry.active.device, exact=exact)
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


# ------------------------- a rollout as a shard of one evaluation -------------------------


@dataclasses.dataclass(frozen=True)
class _Lanes:
    """Where a rollout's lanes sit in one global evaluation: ``rows`` are
    their rows of the global per-episode tables (padding lanes read row 0;
    None: lane ``i`` is row ``i``), ``valid`` masks the lanes that are not
    padding (None: all are), ``n_valid`` counts them (padding comes last),
    and the global tables hold ``stride`` rows per episode."""

    rows: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    n_valid: int
    stride: int


def _lane_view(n: int, lane_ids, num_valid, seed_stride, device) -> _Lanes:
    if lane_ids is None and num_valid is None and seed_stride is None:
        return _Lanes(None, None, n, n)
    ids = torch.arange(n) if lane_ids is None else torch.as_tensor(lane_ids).to("cpu", torch.int64)
    if tuple(ids.shape) != (n,):
        raise ValueError(f"lane_ids has shape {tuple(ids.shape)}; one id per lane, ({n},), is needed")
    valid = ids < int(num_valid) if num_valid is not None else torch.ones(n, dtype=torch.bool)
    n_valid = int(valid.sum())
    if not bool(valid[:n_valid].all()):
        raise ValueError("padding lanes (lane_ids >= num_valid) must come after the valid ones")
    stride = int(seed_stride) if seed_stride is not None else (int(num_valid) if num_valid is not None else n)
    if n_valid and int(ids[:n_valid].max()) >= stride:
        raise ValueError(f"lane ids reach {int(ids[:n_valid].max())}, past the {stride} rows per episode (seed_stride)")
    if n_valid == n == stride and bool((ids == torch.arange(n)).all()):
        return _Lanes(None, None, n, n)  # the whole evaluation, in order (one rank)
    rows = torch.where(valid, ids, 0).to(device)
    return _Lanes(rows, None if n_valid == n else valid.to(device), n_valid, stride)


def _take_rows(table: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    return table if rows is None else table.index_select(0, rows)


def _episode_rows(lanes: _Lanes, num_episodes: int, device) -> Optional[torch.Tensor]:
    """The global row of each local item ``episode * n + lane``."""
    if lanes.rows is None:
        return None
    first = torch.arange(num_episodes, device=device)[:, None] * lanes.stride
    return (first + lanes.rows[None, :]).reshape(-1)


def _valid_sum(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.sum(x) if valid is None else torch.sum(torch.where(valid, x, 0))


@dataclasses.dataclass(frozen=True)
class _Sync:
    """How a rollout's lanes meet the other ranks'. ``"alone"``: not at all
    (a caller may merge afterwards). ``"step"`` (``stats_sync_axis``): the
    statistics' deltas are summed over the ranks every step, and the loop
    runs while any rank has work. ``"global"``: the rollout is the block of
    lanes ``[lo, lo + n)`` of a one-rank evaluation over ``width`` lanes, of
    which the first ``valid`` are real: every statistics update takes every
    rank's observations, and the scores and counters are gathered at the
    end, so every rank returns the one-rank result."""

    mode: str = "alone"
    mesh: Any = None
    lo: int = 0
    width: int = 0
    valid: int = 0


_ALONE = _Sync()


def _stats_psum_merge(old: CollectedStats, new: CollectedStats, mesh, work=None):
    """Every rank absorbs every rank's statistics delta (the accumulators
    are linear, so the merge is exact), in one ``all_reduce`` that also
    sums ``work`` (a local count; None: not carried)."""
    parts = [(new.count - old.count).reshape(1), new.sum - old.sum, new.sum_of_squares - old.sum_of_squares]
    if work is not None:
        parts.append(work.reshape(1).to(old.sum.dtype))
    flat = mesh.all_sum(torch.cat(parts))
    k = old.sum.shape[0]
    merged = CollectedStats(
        count=old.count + flat[0], sum=old.sum + flat[1 : 1 + k], sum_of_squares=old.sum_of_squares + flat[1 + k : 1 + 2 * k]
    )
    return merged, None if work is None else flat[-1]


def _stats_fn(sync: _Sync, options: _Options, lanes: _Lanes):
    """``fn(stats, obs, active=None, work=None) -> (stats, work over every
    rank or None)``: the statistics update of one step (None without
    normalization). ``active`` masks the lanes still running (None: every
    lane but padding); ``work``, this rank's "work left" flag, comes back
    summed over the ranks where the update is collective."""
    if not options.observation_normalization:
        return None
    valid = lanes.valid
    if sync.mode == "global":

        def gathered(stats, obs, active=None, work=None):
            mask = torch.ones_like(obs[:, 0]) if active is None else active.to(obs.dtype)
            rows = sync.mesh.gather_rows(torch.cat([obs, mask[:, None]], dim=1), sync.width, sync.lo)[: sync.valid]
            running = rows[:, -1] > 0
            # contiguous, as the one-rank observations are: a reduction over
            # a strided view may take another order on the card
            every = rows[:, :-1].contiguous()
            return stats_update(stats, every, None if active is None else running), running.any()

        return gathered

    def mask_of(active):
        if active is None or valid is None:
            return valid if active is None else active
        return active & valid

    if sync.mode == "step":

        def merged(stats, obs, active=None, work=None):
            mask = mask_of(active)
            new = stats_update(stats, obs, mask)
            out, work_all = _stats_psum_merge(stats, new, sync.mesh, None if work is None else work.to(torch.float32))
            return out, None if work_all is None else work_all > 0

        return merged
    return lambda stats, obs, active=None, work=None: (stats_update(stats, obs, mask_of(active)), None)


def _finish_global(sync: _Sync, scores, stats, *, total_steps, episodes, capacity=None, t_global=None, **finish_kw):
    """``_finish`` of a ``"global"`` block: the scores gathered, the counters
    summed (the capacity from the longest rank's steps), so every rank
    finishes the one-rank evaluation. A Python int ``total_steps`` is
    already the evaluation's (``budget`` knows it without a collective or
    a read)."""
    mesh = sync.mesh
    scores = mesh.gather_rows(scores, sync.width, sync.lo)[: sync.valid]
    if isinstance(total_steps, int):
        episodes = mesh.all_sum(episodes.to(torch.int64))
    else:
        total_steps, episodes = mesh.all_sum(torch.stack([total_steps, episodes.to(torch.int64)]))
    if capacity is None:
        capacity = mesh.all_max(t_global) * sync.width
    return _finish(scores, stats, total_steps, episodes, capacity=capacity, lane_width=sync.width, **finish_kw)


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


def _budget_init(
    env, policy, store: torch.Tensor, generator: torch.Generator, stats, options: _Options, lanes=None, stats_fn=None
) -> BudgetCarry:
    """Reset every lane (from its row of a global draw); the reset
    observations are the policy's first input, so they enter the
    normalization statistics."""
    n = store.shape[0]
    device = store.device
    lanes = _Lanes(None, None, n, n) if lanes is None else lanes
    stats_fn = _stats_fn(_ALONE, options, lanes) if stats_fn is None else stats_fn
    env_states, obs = env.batch_reset_from(_take_rows(env.reset_noise(lanes.stride, generator), lanes.rows))
    if stats_fn is not None:
        stats, _ = stats_fn(stats, obs)
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


def _make_budget_step(
    env, policy, store: torch.Tensor, generator, *, max_t: int, options: _Options, forward=None, lanes=None, stats_fn=None
):  # fmt: skip
    """One control step of the whole population under the budget contract,
    ``step(carry) -> carry``: every lane is active on every step, its action
    noise drawn from ``generator``, and finished lanes restart from a fresh
    reset drawn from ``generator`` and zeroed policy states. Both draws are
    made at the global width (``lanes.stride``), each lane taking its row.
    Lane ``i`` acts from row ``i`` of ``store`` through ``forward``
    (``_batched_forward`` bound to a rollout's context; the dense ``policy``
    when None)."""
    forward = policy if forward is None else forward
    noisy = _draws_noise(env, options)
    n = store.shape[0]
    lanes = _Lanes(None, None, n, n) if lanes is None else lanes
    stats_fn = _stats_fn(_ALONE, options, lanes) if stats_fn is None else stats_fn

    def step(c: BudgetCarry) -> BudgetCarry:
        noise = None
        if noisy:
            noise = options.action_noise_stdev * torch.randn(
                (lanes.stride, env.action_size), generator=generator, device=c.obs.device
            )
            noise = _take_rows(noise, lanes.rows)
        new_env_states, new_obs, rewards, finished, steps_in_episode, policy_states = _act_and_step(
            env, forward, store, c.obs, c.stats, c.env_states, c.steps_in_episode, c.policy_states, noise,
            max_t=max_t, options=options,
        )  # fmt: skip
        scores = c.scores + rewards
        episodes_done = c.episodes_done + finished.to(torch.int32)

        fresh_states, fresh_obs = env.batch_reset_from(_take_rows(env.reset_noise(lanes.stride, generator), lanes.rows))
        env_states_next = env.batch_where(finished, fresh_states, new_env_states)
        obs_next = torch.where(finished[:, None], fresh_obs, new_obs)
        steps_in_episode = torch.where(finished, 0, steps_in_episode)
        # normalization statistics come from the observations the policy
        # consumes next step: after the reset selection
        new_stats = c.stats if stats_fn is None else stats_fn(c.stats, obs_next)[0]
        return BudgetCarry(
            env_states=env_states_next,
            obs=obs_next,
            policy_states=reset_tensors(policy_states, finished),
            scores=scores,
            episodes_done=episodes_done,
            steps_in_episode=steps_in_episode,
            stats=new_stats,
            total_steps=c.total_steps + lanes.n_valid,
        )

    return step


def _run_budget(
    env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, finish_kw, loop_stats, lanes, sync
):  # fmt: skip
    stats_fn = _stats_fn(sync, options, lanes)
    carry = _budget_init(env, policy, store, generator, stats, options, lanes, stats_fn)
    step = _make_budget_step(
        env, policy, store, generator, max_t=max_t, options=options, forward=forward, lanes=lanes, stats_fn=stats_fn
    )
    budget = max_t * int(num_episodes)
    for _ in range(budget):
        carry = step(carry)
    _note(loop_stats, steps_issued=budget, steps=budget)

    n = store.shape[0]
    max_t_f = torch.full((), float(max_t), device=store.device)
    episodes_frac = carry.episodes_done + carry.steps_in_episode.to(torch.float32) / max_t_f
    mean_scores = carry.scores / torch.clamp(episodes_frac, min=1.0 / max_t)
    episodes = _valid_sum(carry.episodes_done, lanes.valid)
    if sync.mode == "global":
        return _finish_global(
            sync, mean_scores, carry.stats, total_steps=sync.valid * budget, episodes=episodes,
            capacity=sync.width * budget, **finish_kw,
        )  # fmt: skip
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        episodes,
        capacity=n * budget,
        lane_width=n,
        valid=lanes.valid,
        n_valid=lanes.n_valid,
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


def _episodes_init(env, policy, store, table, stats, options, *, lanes=None, stats_fn=None, num_episodes=1) -> EpisodesCarry:
    """Every lane starts episode 0 of its solution from reset row ``s`` and
    the policy's initial state; the reset observations enter the
    normalization statistics. Padding lanes start finished."""
    n = store.shape[0]
    device = store.device
    lane_ids = torch.arange(n, device=device)
    env_states, obs = env.batch_reset_from(table[:n])
    if stats_fn is not None:
        stats, _ = stats_fn(stats, obs)
    elif options.observation_normalization:
        stats = stats_update(stats, obs)
    valid = None if lanes is None else lanes.valid
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return EpisodesCarry(
        env_states=env_states,
        obs=obs,
        policy_states=_broadcast_states(_state_proto(policy, device, options), n),
        lane_ids=lane_ids,
        params=store,
        lane_score=torch.zeros(n, device=device),
        scores=torch.zeros(n, device=device),
        episodes_done=(
            torch.zeros(n, dtype=torch.int32, device=device)
            if valid is None
            else torch.where(valid, 0, num_episodes).to(torch.int32)
        ),
        steps_in_episode=torch.zeros(n, dtype=torch.int32, device=device),
        active=torch.ones(n, dtype=torch.bool, device=device) if valid is None else valid.clone(),
        stats=stats,
        total_steps=zero,
        t_global=zero,
        capacity=zero,
        work_left=torch.ones((), dtype=torch.bool, device=device) if valid is None else valid.any(),
    )


def _make_episodes_step(
    env, policy, table, noise_table, *, popsize: int, num_episodes: int, max_t: int, options: _Options, forward=None,
    stats_fn=None,
):  # fmt: skip
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
        work_left = active.any()
        stats = c.stats
        if stats_fn is not None:
            stats, work_all = stats_fn(c.stats, obs, active, work_left)
            work_left = work_left if work_all is None else work_all
        elif options.observation_normalization:
            stats = stats_update(c.stats, obs, mask=active)
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
            work_left=work_left,
        )

    return step


def _local_tables(env, reset_noise, action_noise, generator, options, lanes, *, num_episodes, max_t, device):
    """The reset and action-noise tables of a rollout's own items (``episode
    * n + lane``), drawn (or injected) at their global size."""
    rows = _episode_rows(lanes, num_episodes, device)
    num_items = lanes.stride * num_episodes
    table = _take_rows(_reset_table(env, reset_noise, num_items, generator), rows)
    return table, _noise_table(env, action_noise, num_items, max_t, generator, options, rows)


def _run_episodes(
    env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, reset_noise, action_noise, finish_kw,
    loop_stats, lanes, sync,
):  # fmt: skip
    n = store.shape[0]
    table, noise_table = _local_tables(
        env, reset_noise, action_noise, generator, options, lanes, num_episodes=num_episodes, max_t=max_t,
        device=store.device,
    )  # fmt: skip
    stats_fn = _stats_fn(sync, options, lanes)
    carry = _episodes_init(env, policy, store, table, stats, options, lanes=lanes, stats_fn=stats_fn, num_episodes=num_episodes)
    step = _make_episodes_step(
        env, policy, table, noise_table, popsize=n, num_episodes=num_episodes, max_t=max_t, options=options,
        forward=forward, stats_fn=stats_fn,
    )  # fmt: skip
    exact = sync.mode != "alone" and stats_fn is not None
    carry = _drive(step, carry, hard_cap=max_t * num_episodes + 1, loop_stats=loop_stats, exact=exact)
    mean_scores = carry.scores / torch.clamp(carry.episodes_done, min=1)
    # padding lanes started with num_episodes done: they are not counted
    episodes = _valid_sum(carry.episodes_done, lanes.valid)
    if sync.mode == "global":
        return _finish_global(
            sync, mean_scores, carry.stats, total_steps=carry.total_steps, episodes=episodes, t_global=carry.t_global,
            **finish_kw,
        )  # fmt: skip
    return _finish(
        mean_scores,
        carry.stats,
        carry.total_steps,
        episodes,
        capacity=carry.capacity,
        lane_width=n,
        valid=lanes.valid,
        n_valid=lanes.n_valid,
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


@dataclasses.dataclass(frozen=True)
class _RefillBlock:
    """A rank's block of the lanes of one refill evaluation (the
    ``"global"`` form): lanes ``[lo, lo + n)`` of ``width`` (a multiple of
    the ranks), the first ``valid_width`` of them real; ``valid`` masks
    this rank's real lanes (None: all are). Every rank runs the one queue:
    the idle lanes of every rank are gathered each step, and each rank
    takes its own lanes' share of the one refill decision."""

    mesh: Any
    lo: int
    width: int
    valid_width: int
    valid: Optional[torch.Tensor]


def _refill_init(env, policy, store, table, stats, options, *, width: int, block=None, stats_fn=None) -> RefillCarry:
    """Lanes ``0..W-1`` start items ``0..W-1`` (solution ``item % N``,
    episode 0 when ``W <= N``) from the policy's initial state; the queue
    head is ``W``. A ``block`` holds ``width`` of those lanes, from its
    ``lo`` on; its padding lanes start idle and never take an item."""
    n = store.shape[0]
    device = store.device
    items = torch.arange(width, device=device)
    head = width
    active = torch.ones(width, dtype=torch.bool, device=device)
    if block is not None:
        items = items + block.lo
        head = block.valid_width
        if block.valid is not None:
            items = torch.where(block.valid, items, 0)
            active = block.valid.clone()
    env_states, obs = env.batch_reset_from(table[:width] if block is None else table.index_select(0, items))
    if stats_fn is not None:
        stats, _ = stats_fn(stats, obs)
    elif options.observation_normalization:
        stats = stats_update(stats, obs)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return RefillCarry(
        env_states=env_states,
        obs=obs,
        policy_states=_broadcast_states(_state_proto(policy, device, options), width),
        lane_item=items,
        lane_sol=items % n,
        lane_score=torch.zeros(width, device=device),
        steps_in_episode=torch.zeros(width, dtype=torch.int32, device=device),
        active=active,
        scores_buf=torch.zeros(n, dtype=torch.float32, device=device),
        eps_buf=torch.zeros(n, dtype=torch.int32, device=device),
        next_item=torch.full((), head, dtype=torch.int64, device=device),
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
    env, policy, store, table, noise_table, *, num_episodes: int, period: int, max_t: int, options: _Options, forward=None,
    block=None, stats_fn=None,
):  # fmt: skip
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
        if block is not None and block.valid is not None:
            idle = idle & block.valid
        # the one queue's decision over every rank's lanes (a block's idle
        # mask gathered), each rank taking its own lanes' part
        idle_all = idle if block is None else block.mesh.gather_rows(idle.to(torch.int32), block.width, block.lo) > 0
        gate = idle_all.any() & (c.next_item < total_items)
        if period > 1:
            gate = gate & (((c.t_global + 1) % period) == 0)
        # ranks among idle lanes -> candidate items; lanes past the queue's
        # end stay idle
        cand_all = c.next_item + torch.cumsum(idle_all.to(torch.int64), 0) - 1
        take_all = idle_all & (cand_all < total_items) & gate
        take, cand = take_all, cand_all
        if block is not None:
            take, cand = take_all[block.lo : block.lo + idle.shape[0]], cand_all[block.lo : block.lo + idle.shape[0]]
        items = torch.where(take, cand, 0)
        fresh_states, fresh_obs = env.batch_reset_from(table.index_select(0, items))
        env_states = env.batch_where(take, fresh_states, env_base)
        obs = torch.where(take[:, None], fresh_obs, obs_base)
        lane_item = torch.where(take, items, c.lane_item)
        lane_sol = torch.where(take, items % n, c.lane_sol)
        active = running | take
        next_item = c.next_item + take_all.sum()
        if block is None:
            inactive, any_active = (~active).sum(), active.any()
        else:
            inactive = idle_all.sum() - take_all.sum()
            any_active = inactive < block.valid_width

        # telemetry: W lane-step slots per step that did work; lanes idle
        # after this step's refill while items remain are waiting; a
        # refilled item waited (now - the step its lane went idle)
        work = c.work_left.to(torch.int64)
        tcur = c.t_global + 1
        idle_since = torch.where(finished, tcur, c.idle_since)
        waits = torch.where(take, tcur - idle_since, 0)
        work_left = any_active | (next_item < total_items)
        stats = c.stats
        if stats_fn is not None:
            stats, work_all = stats_fn(c.stats, obs, active, work_left)
            if block is None and work_all is not None:
                work_left = work_all
        elif options.observation_normalization:
            stats = stats_update(c.stats, obs, mask=active)
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
            wait_sum=c.wait_sum + torch.where(next_item < total_items, inactive, 0),
            idle_since=idle_since,
            hist=c.hist.index_add(0, queue_wait_bucket_index(waits, edges), take.to(torch.int64)),
            work_left=work_left,
        )

    return step


def _run_refill(
    env, policy, forward, store, generator, stats, *, num_episodes, max_t, options, reset_noise, action_noise,
    refill_width, refill_period, finish_kw, loop_stats, lanes, sync,
):  # fmt: skip
    """The ``episodes_refill`` evaluation: each solution is scored by the
    mean return of exactly ``num_episodes`` episodes, run on a fixed width
    of lanes fed from the item queue. Under a ``"global"`` sync ``store``
    is the whole population and this rank holds a block of the lanes of
    the one queue (``_RefillBlock``)."""
    n = store.shape[0]
    total_items = n * num_episodes
    width = refill_width if refill_width is not None else _default_refill_width(total_items)
    width = int(min(max(1, int(width)), total_items))
    period = max(1, int(refill_period))
    table, noise_table = _local_tables(
        env, reset_noise, action_noise, generator, options, lanes, num_episodes=num_episodes, max_t=max_t,
        device=store.device,
    )  # fmt: skip
    block, full_width = None, width
    if sync.mode == "global":
        mesh = sync.mesh
        per = -(-width // mesh.size)
        lo = mesh.rank * per
        valid = torch.arange(lo, lo + per, device=store.device) < width
        block = _RefillBlock(mesh, lo, per * mesh.size, width, None if lo + per <= width else valid)
        # the statistics gather this block of lanes
        sync = dataclasses.replace(sync, lo=lo, width=per * mesh.size, valid=width)
        width, full_width = per, per * mesh.size
    stats_fn = _stats_fn(sync, options, lanes)
    carry = _refill_init(env, policy, store, table, stats, options, width=width, block=block, stats_fn=stats_fn)
    step = _make_refill_step(
        env, policy, store, table, noise_table, num_episodes=num_episodes, period=period, max_t=max_t, options=options,
        forward=forward, block=block, stats_fn=stats_fn,
    )  # fmt: skip
    # greedy-scheduling makespan bound plus the refill-period slack (the
    # JAX engine's safety net)
    valid_width = width if block is None else block.valid_width
    hard_cap = (total_items * max_t) // valid_width + max_t + period * (total_items // valid_width + 1) + 2
    exact = block is not None or (sync.mode != "alone" and stats_fn is not None)
    carry = _drive(step, carry, hard_cap=hard_cap, loop_stats=loop_stats, exact=exact)
    scores_buf, eps_buf, hist, capacity, total_steps = carry.scores_buf, carry.eps_buf, carry.hist, carry.capacity, carry.total_steps
    if block is not None:
        scores_buf, eps_buf, hist = (sync.mesh.all_sum(x) for x in (scores_buf, eps_buf, hist))
        capacity, total_steps = sync.mesh.all_sum(torch.stack([capacity, total_steps]))
    mean_scores = scores_buf / torch.clamp(eps_buf, min=1).to(torch.float32)
    return _finish(
        mean_scores,
        carry.stats,
        total_steps,
        torch.sum(eps_buf),
        capacity=capacity,
        lane_width=full_width,
        # items 0..W-1 seeded the lanes; every later one was a refill
        refill_events=carry.next_item - valid_width,
        queue_wait=carry.wait_sum,
        hist=hist,
        **finish_kw,
    )


# ------------------------------- entry points -------------------------------


def _as_mesh(mesh_or_group):
    from ...parallel.mesh import as_mesh  # the parallel package imports this module

    return as_mesh(mesh_or_group)


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
    lane_ids=None,
    num_valid: Optional[int] = None,
    seed_stride: Optional[int] = None,
    stats_sync_axis=None,
    nonfinite_sync_axis=None,
    _sync: _Sync = _ALONE,
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
    - ``lane_ids`` (host integers, one per lane), ``num_valid`` and
      ``seed_stride``: the lanes are global lanes ``lane_ids`` of an
      evaluation of ``seed_stride`` solutions (default ``num_valid``, else
      ``N``); lanes at or past ``num_valid`` are padding, last, started
      finished and left out of the scores' credit, the counters, the
      quarantine and the health block (``capacity`` and ``lane_width``
      count them: they are lanes paid for). The random tables are drawn
      for all ``seed_stride`` solutions and each lane takes its rows, so a
      shard of an evaluation draws what the whole evaluation would.
      ``episodes_refill`` runs its queue over the valid solutions only.
    - ``stats_sync_axis`` (a ``parallel.Mesh`` or process group): with
      observation normalization, the statistics' deltas are summed over
      its ranks every step (``VecNE(obs_norm_sync="step")``), and the loop
      runs on every rank while any has work. ``nonfinite_sync_axis``: the
      quarantine's worst finite score is taken over its ranks.

    ``generator`` draws the reset and action noise (the tables, or every
    step's under ``budget``). The options of the JAX engine that the port
    does not take yet (groups, solution keys) raise ``NotImplementedError``
    naming their item in ``ROADMAP.md``."""
    if eval_mode not in ("episodes", "budget", "episodes_refill"):
        raise ValueError(f"eval_mode must be 'episodes', 'budget' or 'episodes_refill', got {eval_mode!r}")
    _check_inputs(env, params_batch, stats, unported)
    max_t = _max_t(env, episode_length)
    num_episodes = int(num_episodes)
    options = _make_options(
        observation_normalization, alive_bonus_schedule, decrease_rewards_by, compute_dtype, action_noise_stdev
    )
    n = _params_popsize(params_batch)
    lanes = _lane_view(n, lane_ids, num_valid, seed_stride, env.device)
    sync = _sync
    if stats_sync_axis is not None and sync.mode == "alone":
        sync = _Sync("step", _as_mesh(stats_sync_axis))
    finish_kw = dict(telemetry=telemetry, health=health, quarantine=nonfinite_quarantine, penalty=nonfinite_penalty)
    if nonfinite_sync_axis is not None and sync.mode != "global":
        finish_kw["nonfinite_sync"] = _as_mesh(nonfinite_sync_axis)
    if eval_mode == "budget" and (reset_noise is not None or action_noise is not None):
        raise ValueError(
            "reset_noise= and action_noise= apply to the episodes contracts; budget draws its resets and noise every step"
        )
    if eval_mode == "episodes_refill" and lanes.valid is not None:
        # the queue enumerates the valid solutions only; padding scores 0
        valid_rows = _params_take(params_batch, slice(0, lanes.n_valid))
        result = run_vectorized_rollout(
            env, policy, valid_rows, generator, stats, num_episodes=num_episodes, episode_length=episode_length,
            observation_normalization=observation_normalization, alive_bonus_schedule=alive_bonus_schedule,
            decrease_rewards_by=decrease_rewards_by, compute_dtype=compute_dtype, action_noise_stdev=action_noise_stdev,
            eval_mode=eval_mode, refill_width=refill_width, refill_period=refill_period, trunk_block=trunk_block,
            telemetry=telemetry, health=health, nonfinite_quarantine=nonfinite_quarantine,
            nonfinite_penalty=nonfinite_penalty, reset_noise=reset_noise, action_noise=action_noise,
            loop_stats=loop_stats, lane_ids=lanes.rows[: lanes.n_valid].cpu(), seed_stride=lanes.stride,
            stats_sync_axis=stats_sync_axis, nonfinite_sync_axis=nonfinite_sync_axis, _sync=_sync,
        )  # fmt: skip
        padding = torch.zeros(n - lanes.n_valid, dtype=result.scores.dtype, device=result.scores.device)
        return result._replace(scores=torch.cat([result.scores, padding]))
    ctx, store = _forward_ctx(policy, _params_cast(params_batch, options), trunk_block=int(trunk_block))
    forward = functools.partial(_batched_forward, policy, ctx)
    common = dict(
        num_episodes=num_episodes, max_t=max_t, options=options, finish_kw=finish_kw, loop_stats=loop_stats, lanes=lanes,
        sync=sync,
    )  # fmt: skip
    if eval_mode == "budget":
        return _run_budget(env, policy, forward, store, generator, stats, **common)
    if eval_mode == "episodes_refill":
        return _run_refill(
            env, policy, forward, store, generator, stats, reset_noise=reset_noise, action_noise=action_noise,
            refill_width=refill_width, refill_period=refill_period, **common,
        )  # fmt: skip
    return _run_episodes(
        env, policy, forward, store, generator, stats, reset_noise=reset_noise, action_noise=action_noise, **common
    )


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
    lane_ids=None,
    num_valid: Optional[int] = None,
    seed_stride: Optional[int] = None,
    stats_sync_axis=None,
    nonfinite_sync_axis=None,
    _width_sync=None,
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
    chunk. ``lane_ids``, ``num_valid``, ``seed_stride``, ``stats_sync_axis``
    and ``nonfinite_sync_axis`` are ``run_vectorized_rollout``'s.
    ``_width_sync`` (a mesh; ``run_vectorized_rollout_compacting_sharded``)
    makes the width descent uniform over its ranks, driven by the largest
    active count, and ends the loop on every rank at once, on that count,
    at a chunk's end."""
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

    lanes = _lane_view(n, lane_ids, num_valid, seed_stride, env.device)
    sync = _ALONE if stats_sync_axis is None else _Sync("step", _as_mesh(stats_sync_axis))
    table, noise_table = _local_tables(
        env, reset_noise, action_noise, generator, options, lanes, num_episodes=num_episodes, max_t=max_t,
        device=store.device,
    )  # fmt: skip
    stats_fn = _stats_fn(sync, options, lanes)
    carry = _episodes_init(env, policy, store, table, stats, options, lanes=lanes, stats_fn=stats_fn, num_episodes=num_episodes)
    step = _make_episodes_step(
        env, policy, table, noise_table, popsize=n, num_episodes=num_episodes, max_t=max_t, options=options,
        forward=forward, stats_fn=stats_fn,
    )  # fmt: skip
    scores_buf = torch.zeros(n, dtype=torch.float32, device=store.device)
    eps_buf = torch.zeros(n, dtype=torch.int32, device=store.device)

    hard_cap = max_t * num_episodes + 1
    max_chunks = -(-hard_cap // int(chunk_size)) + 1
    poll = _EndPoll(store.device, exact=stats_fn is not None and sync.mode != "alone")
    issued = 0
    visited = []
    pending_count = None
    done = False
    for _ in range(max_chunks):
        visited.append(carry.active.shape[0])
        for _ in range(int(chunk_size)):
            carry = step(carry)
            issued += 1
            if _width_sync is None and poll.finished(carry.work_left):
                done = True
                break
        if done:
            break
        active_count = carry.active.sum()
        count = _host_int_later(active_count if _width_sync is None else _width_sync.all_max(active_count))
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
        _valid_sum(eps_buf, lanes.valid),
        capacity=carry.capacity,
        lane_width=n,
        telemetry=telemetry,
        health=health,
        quarantine=nonfinite_quarantine,
        penalty=nonfinite_penalty,
        valid=lanes.valid,
        n_valid=lanes.n_valid,
        nonfinite_sync=None if nonfinite_sync_axis is None else _as_mesh(nonfinite_sync_axis),
    )


def _merge_shard_results(result: RolloutResult, mesh, *, stats0: CollectedStats, popsize: int, start: int, per_rank: int, stats_synced: bool, health: bool) -> RolloutResult:
    """One rank's result of a rollout run on its block of lanes ``[start,
    start + per_rank)`` (with ``health=False``), made the evaluation's: the
    scores gathered into the ``(popsize,)`` order, the statistics' deltas
    summed over the ranks (unless they were every step), the counters
    summed, and the health block computed on the gathered scores."""
    scores = mesh.gather_rows(result.scores, per_rank * mesh.size, start)[:popsize]
    stats = result.stats
    if not stats_synced:
        delta = CollectedStats(
            count=stats.count - stats0.count, sum=stats.sum - stats0.sum, sum_of_squares=stats.sum_of_squares - stats0.sum_of_squares
        )
        stats = stats_psum(delta, mesh)
        stats = CollectedStats(stats0.count + stats.count, stats0.sum + stats.sum, stats0.sum_of_squares + stats.sum_of_squares)
    counts = mesh.all_sum(
        torch.stack([torch.as_tensor(result.total_steps, device=scores.device), result.total_episodes.to(torch.int64)])
    )
    telemetry = None
    if result.telemetry is not None:
        telemetry = sum_over_ranks(result.telemetry, mesh, scores if health else None)
    return RolloutResult(scores=scores, stats=stats, total_steps=int(counts[0]), total_episodes=counts[1], telemetry=telemetry)


def run_vectorized_rollout_compacting_sharded(
    env,
    policy: FlatParamsPolicy,
    params_batch,
    generator: torch.Generator,
    stats: CollectedStats,
    *,
    mesh,
    stats_sync: bool = False,
    health: bool = True,
    nonfinite_quarantine: bool = False,
    nonfinite_penalty: Optional[float] = None,
    min_width: Optional[int] = None,
    allowed_widths: Optional[tuple] = None,
    **kwargs,
) -> RolloutResult:
    """``run_vectorized_rollout_compacting`` with the population's rows
    sharded over ``mesh``'s ranks (counterpart of the JAX
    ``run_vectorized_rollout_compacting_sharded``): every rank runs its block
    of lanes, with global lane ids and the global tables, and narrows it as
    its lanes finish. ``allowed_widths``/``min_width`` are per-rank widths;
    the width descent is the same on every rank, driven by the largest
    active count, and the loop ends on every rank at once. Without
    observation normalization the scores and counters equal the unsharded
    ``episodes`` evaluation's; with it, each rank normalizes by its own
    lanes' statistics until they are merged at the end (cohort semantics),
    or, with ``stats_sync``, by every rank's, merged each step. The
    population size must divide over the ranks. Returns the evaluation's
    result on every rank: the ``(N,)`` scores, the merged statistics and
    summed counters."""
    n = _params_popsize(params_batch)
    mesh = _as_mesh(mesh)
    if n % mesh.size != 0:
        raise ValueError(f"Population size {n} must divide the mesh's {mesh.size} ranks")
    start, stop, per = mesh.block(n)
    if allowed_widths is None and min_width is None:
        min_width = max(256, _pow2_at_least(max(1, per // 64)))
    result = run_vectorized_rollout_compacting(
        env,
        policy,
        _params_take(params_batch, slice(start, stop)),
        generator,
        stats,
        lane_ids=torch.arange(start, stop),
        seed_stride=n,
        stats_sync_axis=mesh if stats_sync else None,
        nonfinite_sync_axis=mesh if nonfinite_quarantine and nonfinite_penalty is None else None,
        nonfinite_quarantine=nonfinite_quarantine,
        nonfinite_penalty=nonfinite_penalty,
        health=False,
        min_width=min_width,
        allowed_widths=allowed_widths,
        _width_sync=mesh,
        **kwargs,
    )
    return _merge_shard_results(
        result, mesh, stats0=stats, popsize=n, start=start, per_rank=per, stats_synced=stats_sync, health=health
    )
