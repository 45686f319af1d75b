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
