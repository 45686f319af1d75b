"""Environment protocol for batched rollouts (counterpart of
``evotorch_tpu/envs/base.py``).

An env holds its constants on one device and steps a whole population at
once (the ``batched_native`` protocol of the JAX package):

- ``reset_noise(num_items, generator) -> rows``: the random draws of
  ``num_items`` resets, one row per item (leading axis);
- ``batch_reset_from(rows) -> (state, obs)``: the states and observations
  those rows give, ``obs`` ``(B, obs_dim)``;
- ``batch_reset(num_lanes, generator)``, which is
  ``batch_reset_from(reset_noise(num_lanes, generator))``;
- ``batch_step(state, actions) -> (state, obs, rewards, dones)``;
- ``batch_where(mask, a, b)``: lane ``i`` takes ``a`` where ``mask[i]``;
- ``batch_take(state, idx)``: the lanes ``idx``, in that order.

The single-env ``reset(generator) -> (state, obs)`` and ``step(state,
action) -> (state, obs, reward, done)`` are the B=1 case of the batched
forms, as in the JAX package: one row of ``reset_noise``, one lane of
``batch_step``, the lane axis dropped. ``state_lane_axis`` says where the
lane axis of the dynamics state lies (``t`` is always lane-leading).

Reset noise comes from the ``torch.Generator`` the caller passes, so there
is no per-lane key in the state. Drawing and applying are split so that a
rollout can draw the noise of every (solution, episode) item once, in item
order, and give each item its own row whatever lane runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

__all__ = ["Env", "EnvState", "Space"]


class Space(NamedTuple):
    """Box or Discrete space description."""

    shape: tuple
    lb: Optional[torch.Tensor] = None  # None for discrete
    ub: Optional[torch.Tensor] = None
    n: Optional[int] = None  # number of actions when discrete

    @property
    def is_discrete(self) -> bool:
        return self.n is not None


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Generic batched env state: dynamics state + per-lane step counter."""

    obs_state: Any
    t: torch.Tensor


class Env:
    observation_space: Space
    action_space: Space
    max_episode_steps: Optional[int] = None
    device: torch.device
    #: the lane axis of the dynamics state: 0 (population-leading) or -1
    state_lane_axis: int = 0

    @property
    def observation_size(self) -> int:
        return int(self.observation_space.shape[0])

    @property
    def action_size(self) -> int:
        if self.action_space.is_discrete:
            return int(self.action_space.n)
        return int(self.action_space.shape[0])

    def reset_noise(self, num_items: int, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def batch_reset_from(self, noise_rows: torch.Tensor):
        raise NotImplementedError

    def batch_reset(self, num_lanes: int, generator: torch.Generator):
        return self.batch_reset_from(self.reset_noise(num_lanes, generator))

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        raise NotImplementedError

    def batch_where(self, mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
        raise NotImplementedError

    def batch_take(self, state: EnvState, idx: torch.Tensor) -> EnvState:
        raise NotImplementedError

    # -- single-env API: the B=1 case -----------------------------------------
    def _map_state(self, fn, obs_state):
        if isinstance(obs_state, torch.Tensor):
            return fn(obs_state)
        return type(obs_state)(*(fn(x) for x in obs_state))

    def _to_single(self, state: EnvState) -> EnvState:
        axis = self.state_lane_axis
        return EnvState(obs_state=self._map_state(lambda x: x.select(axis, 0), state.obs_state), t=state.t[0])

    def _to_batched(self, state: EnvState) -> EnvState:
        axis = self.state_lane_axis
        return EnvState(obs_state=self._map_state(lambda x: x.unsqueeze(axis), state.obs_state), t=state.t.reshape(1))

    def reset(self, generator: torch.Generator):
        """One env's ``(state, obs)``, from one row of ``reset_noise``."""
        state, obs = self.batch_reset_from(self.reset_noise(1, generator))
        return self._to_single(state), obs[0]

    def step(self, state: EnvState, action):
        """One env's ``(state, obs, reward, done)`` after ``action`` (of the
        action space's shape: a scalar for a discrete space)."""
        action = torch.as_tensor(action, device=self.device)
        actions = action.reshape((1,) + tuple(self.action_space.shape))
        bstate, obs, reward, done = self.batch_step(self._to_batched(state), actions)
        return self._to_single(bstate), obs[0], reward[0], done[0]
