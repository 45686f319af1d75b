"""The vectorized rollout engine (counterpart of the ``budget`` contract of
``evotorch_tpu/neuroevolution/net/vecrl.py``).

``run_vectorized_rollout`` evaluates ``N`` policies on ``N`` lanes of a
batched env, all on the device: each lane consumes a fixed budget of
``num_episodes * max_t`` control steps, auto-resets whenever an episode ends
(or is truncated at ``max_t``), and scores the average episodic return over
the budget. The loop is eager PyTorch and makes no host sync; on the card it
is bound by launch overhead (about 2,800 small launches per control step
at the flagship Humanoid), which a CUDA graph of the step would remove.

The other contracts (``episodes``, ``episodes_refill``, ``episodes_compact``),
telemetry, groups and the non-finite quarantine are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .functional import FlatParamsPolicy
from .runningnorm import CollectedStats, stats_normalize, stats_update

__all__ = ["RolloutResult", "run_vectorized_rollout"]


class RolloutResult(NamedTuple):
    scores: torch.Tensor  # (N,) mean episodic return per solution
    stats: CollectedStats  # obs-norm statistics after the rollout
    total_steps: int  # env interactions
    total_episodes: torch.Tensor  # scalar: episodes finished


@dataclasses.dataclass(frozen=True)
class RolloutCarry:
    """Loop state; per-lane tensors are population-leading except
    ``env_states``, whose layout belongs to the env. Every lane is active on
    every step of the budget contract, so there is no activity mask."""

    env_states: Any
    obs: torch.Tensor
    scores: torch.Tensor
    episodes_done: torch.Tensor
    steps_in_episode: torch.Tensor
    stats: CollectedStats
    total_steps: int


def _policy_to_action(raw: torch.Tensor, action_space) -> torch.Tensor:
    if action_space.is_discrete:
        return torch.argmax(raw, dim=-1)
    if action_space.lb is not None:
        return torch.clamp(raw, action_space.lb, action_space.ub)
    return raw


def _rollout_init(
    env,
    policy: FlatParamsPolicy,
    params_batch: torch.Tensor,
    generator: torch.Generator,
    stats: CollectedStats,
    *,
    observation_normalization: bool,
) -> RolloutCarry:
    """Reset every lane; the reset observations are the policy's first
    input, so they enter the normalization statistics."""
    n = params_batch.shape[0]
    device = params_batch.device
    env_states, obs = env.batch_reset(n, generator)
    if observation_normalization:
        stats = stats_update(stats, obs)
    return RolloutCarry(
        env_states=env_states,
        obs=obs,
        scores=torch.zeros(n, device=device),
        episodes_done=torch.zeros(n, dtype=torch.int32, device=device),
        steps_in_episode=torch.zeros(n, dtype=torch.int32, device=device),
        stats=stats,
        total_steps=0,
    )


def _make_step(env, policy: FlatParamsPolicy, *, max_t: int, observation_normalization: bool):
    """One control step of the whole population under the budget contract,
    ``step(params_batch, carry, generator) -> carry``: every lane is active
    on every step and finished lanes restart from a fresh reset."""

    def step(params_batch: torch.Tensor, c: RolloutCarry, generator: torch.Generator) -> RolloutCarry:
        n = c.scores.shape[0]
        policy_in = stats_normalize(c.stats, c.obs) if observation_normalization else c.obs
        actions = _policy_to_action(policy(params_batch, policy_in), env.action_space)
        new_env_states, new_obs, rewards, dones = env.batch_step(c.env_states, actions)

        steps_in_episode = c.steps_in_episode + 1
        # truncation at max_t (gym TimeLimit semantics)
        finished = dones | (steps_in_episode >= max_t)
        scores = c.scores + rewards
        episodes_done = c.episodes_done + finished.to(torch.int32)

        fresh_states, fresh_obs = env.batch_reset(n, generator)
        env_states_next = env.batch_where(finished, fresh_states, new_env_states)
        obs_next = torch.where(finished[:, None], fresh_obs, new_obs)
        steps_in_episode = torch.where(finished, 0, steps_in_episode)
        # normalization statistics come from the observations the policy
        # consumes next step: after the reset selection
        new_stats = stats_update(c.stats, obs_next) if observation_normalization else c.stats
        return RolloutCarry(
            env_states=env_states_next,
            obs=obs_next,
            scores=scores,
            episodes_done=episodes_done,
            steps_in_episode=steps_in_episode,
            stats=new_stats,
            total_steps=c.total_steps + n,
        )

    return step


def run_vectorized_rollout(
    env,
    policy: FlatParamsPolicy,
    params_batch: torch.Tensor,
    generator: torch.Generator,
    stats: CollectedStats,
    *,
    num_episodes: int = 1,
    episode_length: Optional[int] = None,
    observation_normalization: bool = False,
    eval_mode: str = "episodes",
) -> RolloutResult:
    """Evaluate the ``N`` solutions of ``params_batch`` (``(N, L)``, on the
    env's device) on ``N`` lanes. Only ``eval_mode="budget"`` is ported:
    each lane runs ``num_episodes * max_t`` steps, and its score is its
    return over the budget divided by the episodes it covered (completed
    ones plus the fraction of the trailing one)."""
    if eval_mode != "budget":
        raise NotImplementedError(
            f"eval_mode={eval_mode!r} is not ported to evotorch_tpu_torch yet; use eval_mode='budget'"
        )
    if params_batch.device != env.device:
        raise ValueError(f"the population lies on {params_batch.device} and the env on {env.device}")
    max_t = env.max_episode_steps if env.max_episode_steps is not None else 1000
    if episode_length is not None:
        max_t = min(max_t, int(episode_length))

    carry = _rollout_init(
        env, policy, params_batch, generator, stats, observation_normalization=observation_normalization
    )
    step = _make_step(env, policy, max_t=max_t, observation_normalization=observation_normalization)
    for _ in range(max_t * int(num_episodes)):
        carry = step(params_batch, carry, generator)

    max_t_f = torch.full((), float(max_t), device=params_batch.device)
    episodes_frac = carry.episodes_done + carry.steps_in_episode.to(torch.float32) / max_t_f
    mean_scores = carry.scores / torch.clamp(episodes_frac, min=1.0 / max_t)
    return RolloutResult(
        scores=mean_scores,
        stats=carry.stats,
        total_steps=carry.total_steps,
        total_episodes=torch.sum(carry.episodes_done),
    )
