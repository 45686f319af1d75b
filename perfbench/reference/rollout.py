"""Frozen copy of the rollout engine, the policy forward and the observation
statistics, for the benchmark's plain reference.

The three evaluation contracts that the benchmark's traffic uses
(``budget``, ``episodes`` and ``episodes_refill`` with one episode per
solution, no action noise, float32) and the running observation
statistics, copied operation for operation from the port
(``evotorch_tpu_torch/neuroevolution/net/vecrl.py`` and
``runningnorm.py``) as they stood when the benchmark was written; the
policy is the configuration's plain one (``policies.py``). It imports
nothing of the port. Why a copy and not a formula: see
``physics.py``. The reset noise is drawn from a generator that the caller
puts in the state the program's generator had, in the program's order, so
the reference reads back the noise the program drew.

A recurrent policy's state rides in every loop by the port's rule: it
starts from the policy's initial state; a ``budget`` lane that ends an
episode restarts from zeros; an ``episodes`` lane keeps it once frozen; an
``episodes_refill`` lane that is not running takes the initial state (so
a lane that takes a new item starts from it).

The loops check their end flag every ``_POLL`` steps; the steps past the
end are exact no-ops, as they are in the program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .physics import Humanoid

__all__ = ["RolloutOut", "Stats", "Tally", "act_and_step", "reset_draws", "rollout", "stats_init", "stats_update", "tally"]

_POLL = 16


class Stats(NamedTuple):
    count: torch.Tensor  # scalar
    sum: torch.Tensor  # (n,)
    sum_of_squares: torch.Tensor  # (n,)


def stats_init(n: int, device) -> Stats:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return Stats(torch.zeros((), dtype=torch.float32, device=device), z, z.clone())


def stats_update(stats: Stats, obs: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Stats:
    obs = torch.atleast_2d(obs)
    if mask is not None:
        m = mask.to(obs.dtype)
        obs = obs * m[:, None]
        n_new = torch.sum(m)
    else:
        n_new = obs.shape[0]
    return Stats(
        count=stats.count + n_new,
        sum=stats.sum + torch.sum(obs, dim=0),
        sum_of_squares=stats.sum_of_squares + torch.sum(obs**2, dim=0),
    )


def stats_normalize(stats: Stats, obs: torch.Tensor) -> torch.Tensor:
    mean = stats.sum / torch.clamp(stats.count, min=1.0)
    c = torch.clamp(stats.count, min=2.0)
    var = (stats.sum_of_squares - (stats.sum**2) / c) / (c - 1.0)
    stdev = torch.sqrt(torch.clamp(var, min=1e-8))
    normalized = (obs - mean) / stdev
    return torch.where(stats.count >= 2, normalized, obs)


def zero_rows(state, mask: torch.Tensor):
    """A policy state (a tuple of ``(n, k)`` tensors, or None) with the rows
    where ``mask`` is True zeroed."""
    return None if state is None else tuple(torch.where(mask[:, None], 0.0, x) for x in state)


def where_state(mask: torch.Tensor, a, b):
    """Per row, ``a``'s state where ``mask`` is True, else ``b``'s."""
    return None if a is None else tuple(torch.where(mask[:, None], x, y) for x, y in zip(a, b))


class RolloutOut(NamedTuple):
    scores: torch.Tensor  # (N,) float32
    stats: Stats
    env_steps: int
    episodes: int
    control_steps: int


def act_and_step(env: Humanoid, policy, params, obs, stats, env_states, steps_in_episode, policy_state, *, max_t, shift, normalize):
    """One control step of every lane: the policy on the normalized
    observations from its state, the clip, the env's step, truncation at
    ``max_t`` and the rewards' shift; the policy's new state last."""
    policy_in = stats_normalize(stats, obs) if normalize else obs
    raw, policy_state = policy(params, policy_in, policy_state)
    actions = torch.clamp(raw, env.act_lb, env.act_ub)
    new_states, new_obs, rewards, dones = env.batch_step(env_states, actions)
    steps = steps_in_episode + 1
    dones = dones | (steps >= max_t)
    if shift is not None:
        rewards = rewards - shift
    return new_states, new_obs, rewards, dones, steps, policy_state


def _quarantine(scores: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(scores)
    big = torch.finfo(scores.dtype).max
    worst = torch.where(finite, scores, big).min()
    repl = torch.where(worst >= big, 0.0, worst).to(scores.dtype)
    return torch.where(~finite, repl, scores)


def _budget(env, policy, store, generator, stats, *, max_t, shift, normalize) -> RolloutOut:
    n = store.shape[0]
    device = store.device
    env_states, obs = env.batch_reset_from(env.reset_noise(n, generator))
    if normalize:
        stats = stats_update(stats, obs)
    scores = torch.zeros(n, device=device)
    episodes_done = torch.zeros(n, dtype=torch.int32, device=device)
    steps_in_episode = torch.zeros(n, dtype=torch.int32, device=device)
    policy_state = policy.initial_state(n, device)
    for _ in range(max_t):
        new_states, new_obs, rewards, finished, steps, policy_state = act_and_step(
            env, policy, store, obs, stats, env_states, steps_in_episode, policy_state, max_t=max_t, shift=shift,
            normalize=normalize,
        )  # fmt: skip
        policy_state = zero_rows(policy_state, finished)
        scores = scores + rewards
        episodes_done = episodes_done + finished.to(torch.int32)
        fresh_states, fresh_obs = env.batch_reset_from(env.reset_noise(n, generator))
        env_states = env.batch_where(finished, fresh_states, new_states)
        obs = torch.where(finished[:, None], fresh_obs, new_obs)
        steps_in_episode = torch.where(finished, 0, steps)
        if normalize:
            stats = stats_update(stats, obs)
    max_t_f = torch.full((), float(max_t), device=device)
    episodes_frac = episodes_done + steps_in_episode.to(torch.float32) / max_t_f
    mean_scores = scores / torch.clamp(episodes_frac, min=1.0 / max_t)
    return RolloutOut(_quarantine(mean_scores), stats, n * max_t, int(episodes_done.sum()), max_t)


def _episodes(env, policy, store, generator, stats, *, max_t, shift, normalize) -> RolloutOut:
    n = store.shape[0]
    device = store.device
    table = env.reset_noise(n, generator)
    env_states, obs = env.batch_reset_from(table[:n])
    if normalize:
        stats = stats_update(stats, obs, None)
    lane_score = torch.zeros(n, device=device)
    scores = torch.zeros(n, device=device)
    episodes_done = torch.zeros(n, dtype=torch.int32, device=device)
    steps_in_episode = torch.zeros(n, dtype=torch.int32, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    total_steps = torch.zeros((), dtype=torch.int64, device=device)
    t_global = torch.zeros((), dtype=torch.int64, device=device)
    work_left = torch.ones((), dtype=torch.bool, device=device)
    policy_state = policy.initial_state(n, device)
    issued = 0
    while issued < max_t + 1:
        new_states, new_obs, rewards, dones, steps, new_policy_state = act_and_step(
            env, policy, store, obs, stats, env_states, steps_in_episode, policy_state, max_t=max_t, shift=shift,
            normalize=normalize,
        )  # fmt: skip
        lane_score = lane_score + torch.where(active, rewards, 0.0)
        finished = dones & active
        episodes_done = episodes_done + finished.to(torch.int32)
        scores = scores + torch.where(finished, lane_score, 0.0)
        new_active = episodes_done < 1
        running = active & ~finished
        policy_state = where_state(running, new_policy_state, policy_state)
        env_states = env.batch_where(new_active, new_states, env_states)
        obs = torch.where(new_active[:, None], new_obs, obs)
        steps_in_episode = torch.where(running, steps, 0)
        lane_score = torch.where(running, lane_score, 0.0)
        if normalize:
            stats = stats_update(stats, obs, mask=new_active)
        total_steps = total_steps + active.sum()
        t_global = t_global + work_left.to(torch.int64)
        work_left = new_active.any()
        active = new_active
        issued += 1
        if issued % _POLL == 0 and not bool(work_left):
            break
    mean_scores = scores / torch.clamp(episodes_done, min=1)
    return RolloutOut(_quarantine(mean_scores), stats, int(total_steps), int(episodes_done.sum()), int(t_global))


def _refill(env, policy, store, generator, stats, *, max_t, shift, normalize, width: int, period: int) -> RolloutOut:
    n = store.shape[0]
    device = store.device
    total_items = n
    width = int(min(max(1, int(width)), total_items))
    table = env.reset_noise(n, generator)
    items = torch.arange(width, device=device)
    env_states, obs = env.batch_reset_from(table[:width])
    if normalize:
        stats = stats_update(stats, obs, None)
    lane_item = items
    lane_sol = items % n
    lane_score = torch.zeros(width, device=device)
    steps_in_episode = torch.zeros(width, dtype=torch.int32, device=device)
    active = torch.ones(width, dtype=torch.bool, device=device)
    scores_buf = torch.zeros(n, dtype=torch.float32, device=device)
    eps_buf = torch.zeros(n, dtype=torch.int32, device=device)
    next_item = torch.full((), width, dtype=torch.int64, device=device)
    total_steps = torch.zeros((), dtype=torch.int64, device=device)
    t_global = torch.zeros((), dtype=torch.int64, device=device)
    work_left = torch.ones((), dtype=torch.bool, device=device)
    hard_cap = (total_items * max_t) // width + max_t + period * (total_items // width + 1) + 2
    fresh_policy_state = policy.initial_state(width, device)
    policy_state = fresh_policy_state
    issued = 0
    while issued < hard_cap:
        params = store.index_select(0, lane_sol)
        new_states, new_obs, rewards, dones, steps, policy_state = act_and_step(
            env, policy, params, obs, stats, env_states, steps_in_episode, policy_state, max_t=max_t, shift=shift,
            normalize=normalize,
        )  # fmt: skip
        lane_score = lane_score + torch.where(active, rewards, 0.0)
        finished = dones & active
        scores_buf = scores_buf.index_add(0, lane_sol, torch.where(finished, lane_score, 0.0))
        eps_buf = eps_buf.index_add(0, lane_sol, finished.to(torch.int32))
        running = active & ~finished
        policy_state = where_state(running, policy_state, fresh_policy_state)
        env_base = env.batch_where(running, new_states, env_states)
        obs_base = torch.where(running[:, None], new_obs, obs)
        steps_in_episode = torch.where(running, steps, 0)
        lane_score = torch.where(running, lane_score, 0.0)
        idle = ~running
        gate = idle.any() & (next_item < total_items)
        if period > 1:
            gate = gate & (((t_global + 1) % period) == 0)
        cand = next_item + torch.cumsum(idle.to(torch.int64), 0) - 1
        take = idle & (cand < total_items) & gate
        items = torch.where(take, cand, 0)
        fresh_states, fresh_obs = env.batch_reset_from(table.index_select(0, items))
        env_states = env.batch_where(take, fresh_states, env_base)
        obs = torch.where(take[:, None], fresh_obs, obs_base)
        lane_item = torch.where(take, items, lane_item)
        lane_sol = torch.where(take, items % n, lane_sol)
        new_active = running | take
        next_item = next_item + take.sum()
        if normalize:
            stats = stats_update(stats, obs, mask=new_active)
        total_steps = total_steps + active.sum()
        t_global = t_global + work_left.to(torch.int64)
        work_left = new_active.any() | (next_item < total_items)
        active = new_active
        issued += 1
        if issued % _POLL == 0 and not bool(work_left):
            break
    mean_scores = scores_buf / torch.clamp(eps_buf, min=1).to(torch.float32)
    return RolloutOut(_quarantine(mean_scores), stats, int(total_steps), int(eps_buf.sum()), int(t_global))


def rollout(
    env: Humanoid,
    policy,
    params: torch.Tensor,
    generator: torch.Generator,
    stats: Stats,
    *,
    contract: str,
    episode_length: int,
    decrease_rewards_by: Optional[float],
    observation_normalization: bool,
    refill_width: Optional[int] = None,
    refill_period: int = 1,
) -> RolloutOut:
    """One evaluation of the ``(N, L)`` population ``params`` under
    ``contract``, every random draw taken from ``generator``."""
    max_t = min(env.max_episode_steps, int(episode_length))
    kw = dict(max_t=max_t, shift=decrease_rewards_by, normalize=bool(observation_normalization))
    if contract == "budget":
        return _budget(env, policy, params, generator, stats, **kw)
    if contract == "episodes":
        return _episodes(env, policy, params, generator, stats, **kw)
    if contract == "episodes_refill":
        return _refill(env, policy, params, generator, stats, width=int(refill_width), period=int(refill_period), **kw)
    raise ValueError(f"unknown contract {contract!r}")


def reset_draws(env: Humanoid, generator: torch.Generator, *, contract: str, n: int, steps: int, refill_width=None) -> torch.Tensor:
    """The reset noise that an evaluation of ``n`` solutions under
    ``contract`` draws from ``generator``, drawn in the program's order
    (``budget`` draws fresh noise for every lane after each of its ``steps``
    steps), and the observations of the lanes' first states."""
    table = env.reset_noise(n, generator)
    width = n if contract != "episodes_refill" else int(min(max(1, int(refill_width)), n))
    _, obs = env.batch_reset_from(table[:width])
    if contract == "budget":
        for _ in range(int(steps)):
            env.reset_noise(n, generator)
    return obs


class Tally(NamedTuple):
    scores: torch.Tensor  # (n,) float64
    env_steps: int
    masks: Optional[torch.Tensor]  # (T, W) bool: the lanes whose observations enter the statistics after each step; None for all
    lane_sol: Optional[torch.Tensor]  # (T, W) int64: the solution each lane runs at each step; None for lane i = solution i
    complete: bool  # the steps hold every solution's whole evaluation
    starts: torch.Tensor  # (T, W) bool: the lanes whose episode starts at each step (fed a fresh policy state)


def tally(
    contract: str, rewards: torch.Tensor, dones: torch.Tensor, *, n: int, max_t: int, refill_width=None, refill_period: int = 1,
    dtype=torch.float64,
) -> Tally:
    """The contract's bookkeeping replayed, in float64 (in ``dtype`` for the
    control), from the ``(T, W)`` rewards and dones of every control step
    of an evaluation of ``n`` solutions on ``W`` lanes: the scores, the
    interaction count, which lanes feed the statistics after each step,
    which solution each lane runs and which lanes start an episode at each
    step. No physics: the program's own steps go in, so rounding does not
    grow."""
    steps, width = rewards.shape
    r = rewards.to(dtype)
    device = r.device
    first = torch.ones((1, width), dtype=torch.bool, device=device)
    if contract == "budget":
        done_any = dones.any(0)
        last = steps - 1 - torch.argmax(dones.flip(0).to(torch.int32), dim=0)
        in_episode = torch.where(done_any, steps - 1 - last, steps).to(dtype)
        frac = dones.sum(0).to(dtype) + in_episode / float(max_t)
        scores = r.sum(0) / torch.clamp(frac, min=1.0 / max_t)
        starts = torch.cat([first, dones[:-1]])
        return Tally(_quarantine(scores), width * steps, None, None, width == n and steps == max_t, starts)
    active = torch.ones(width, dtype=torch.bool, device=device)
    lane_score = torch.zeros(width, dtype=dtype, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    masks, sols = [], []
    if contract == "episodes":
        scores = torch.zeros(width, dtype=dtype, device=device)
        episodes = torch.zeros(width, dtype=torch.int64, device=device)
        for t in range(steps):
            lane_score = lane_score + torch.where(active, r[t], 0.0)
            finished = dones[t] & active
            episodes = episodes + finished.to(torch.int64)
            scores = scores + torch.where(finished, lane_score, 0.0)
            new_active = episodes < 1
            lane_score = torch.where(active & ~finished, lane_score, 0.0)
            count = count + active.sum()
            masks.append(new_active)
            active = new_active
        complete = width == n and not bool(active.any())
        mean = scores / torch.clamp(episodes, min=1).to(dtype)
        starts = torch.cat([first, torch.zeros((steps - 1, width), dtype=torch.bool, device=device)])
        return Tally(_quarantine(mean), int(count), torch.stack(masks) if masks else None, None, complete, starts)
    if contract != "episodes_refill":
        raise ValueError(f"unknown contract {contract!r}")
    lanes = int(min(max(1, int(refill_width)), n))
    period = int(refill_period)
    lane_sol = torch.arange(width, device=device) % n
    scores = torch.zeros(n, dtype=dtype, device=device)
    episodes = torch.zeros(n, dtype=torch.int64, device=device)
    next_item = torch.full((), width, dtype=torch.int64, device=device)
    t_global = torch.zeros((), dtype=torch.int64, device=device)
    work_left = torch.ones((), dtype=torch.bool, device=device)
    starts = [first[0]]
    for t in range(steps):
        sols.append(lane_sol)
        lane_score = lane_score + torch.where(active, r[t], 0.0)
        finished = dones[t] & active
        scores = scores.index_add(0, lane_sol, torch.where(finished, lane_score, 0.0))
        episodes = episodes.index_add(0, lane_sol, finished.to(torch.int64))
        running = active & ~finished
        lane_score = torch.where(running, lane_score, 0.0)
        idle = ~running
        gate = idle.any() & (next_item < n)
        if period > 1:
            gate = gate & (((t_global + 1) % period) == 0)
        cand = next_item + torch.cumsum(idle.to(torch.int64), 0) - 1
        take = idle & (cand < n) & gate
        lane_sol = torch.where(take, cand % n, lane_sol)
        starts.append(take)
        new_active = running | take
        next_item = next_item + take.sum()
        count = count + active.sum()
        t_global = t_global + work_left.to(torch.int64)
        work_left = new_active.any() | (next_item < n)
        masks.append(new_active)
        active = new_active
    complete = width == lanes and not bool(work_left) and bool((episodes == 1).all())
    mean = scores / torch.clamp(episodes, min=1).to(dtype)
    stack = (lambda xs: torch.stack(xs) if xs else None)
    return Tally(_quarantine(mean), int(count), stack(masks), stack(sols), complete, torch.stack(starts[:steps]))
