"""RL helpers (counterpart of ``evotorch_tpu/neuroevolution/net/rl.py``):
the frozen observation-normalization and action-clipping layers of policy
exports and their wrappers, the scheduled alive bonus of the rollout
contracts (as a tensor function and as host float math), and the host
shims that reset and step a gym(nasium) env under either API
generation."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .layers import Module

__all__ = [
    "ActClipLayer",
    "ActClipWrapperModule",
    "ObsNormLayer",
    "ObsNormWrapperModule",
    "alive_bonus_for_step",
    "alive_bonus_for_step_host",
    "reset_env",
    "take_step_in_env",
]


class ObsNormLayer(Module):
    """Frozen observation normalization ``(x - mean) / stdev``, optionally
    clipped (what ``RunningNorm.to_layer`` gives)."""

    def __init__(self, *, mean, stdev, clip: Optional[Tuple[float, float]] = None):
        self.mean = torch.as_tensor(mean)
        self.stdev = torch.as_tensor(stdev)
        self.clip = clip

    def apply(self, params, x, state=None):
        y = (x - self.mean) / self.stdev
        if self.clip is not None:
            y = torch.clamp(y, self.clip[0], self.clip[1])
        return y, state

    def __repr__(self):
        return f"ObsNormLayer(n={self.mean.shape[-1]})"


class ActClipLayer(Module):
    """Clip actions into the action space's bounds."""

    def __init__(self, lb, ub):
        self.lb = torch.as_tensor(lb)
        self.ub = torch.as_tensor(ub)

    def apply(self, params, x, state=None):
        return torch.clamp(x, self.lb, self.ub), state

    def __repr__(self):
        return "ActClipLayer()"


def alive_bonus_for_step(t: torch.Tensor, alive_bonus_schedule) -> torch.Tensor:
    """Scheduled alive bonus at per-lane timestep ``t`` (int tensor):
    ``(t0, b)`` gives bonus ``b`` from timestep ``t0`` on; ``(t0, t1, b)``
    ramps linearly from 0 at ``t0`` to ``b`` at ``t1``. Float32, shaped
    like ``t``; zeros for ``None``."""
    if alive_bonus_schedule is None:
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    if len(alive_bonus_schedule) == 2:
        t0, bonus = alive_bonus_schedule
        return torch.where(t >= t0, float(bonus), 0.0).to(torch.float32)
    t0, t1, bonus = alive_bonus_schedule
    ramp = float(bonus) * (t - t0) / max(t1 - t0, 1)
    return torch.clamp(ramp, 0.0, float(bonus)) * (t >= t0)


def ObsNormWrapperModule(module: Module, obs_norm) -> Module:
    """Prepend frozen observation normalization to a policy (``obs_norm``
    a ``RunningNorm``, or a layer)."""
    layer = obs_norm.to_layer() if hasattr(obs_norm, "to_layer") else obs_norm
    return layer >> module


def ActClipWrapperModule(module: Module, lb, ub) -> Module:
    """Append action clipping to a policy."""
    return module >> ActClipLayer(lb, ub)


def alive_bonus_for_step_host(t: int, alive_bonus_schedule) -> float:
    """:func:`alive_bonus_for_step` as float math on a host ``t``, for the
    host rollout loops (a tensor per lane per step would be a launch and a
    sync each)."""
    if alive_bonus_schedule is None:
        return 0.0
    if len(alive_bonus_schedule) == 2:
        t0, bonus = alive_bonus_schedule
        return float(bonus) if t >= t0 else 0.0
    t0, t1, bonus = alive_bonus_schedule
    if t < t0:
        return 0.0
    ramp = float(bonus) * (t - t0) / max(t1 - t0, 1)
    return min(max(ramp, 0.0), float(bonus))


def reset_env(env) -> np.ndarray:
    """Reset a gym(nasium) env under either API generation; the
    observation."""
    result = env.reset()
    if isinstance(result, tuple) and len(result) == 2:
        obs, _info = result
        return np.asarray(obs)
    return np.asarray(result)


def take_step_in_env(env, action) -> Tuple[np.ndarray, float, bool]:
    """Step a gym(nasium) env under either API generation; returns
    ``(obs, reward, done)``."""
    result = env.step(np.asarray(action))
    if len(result) == 5:
        obs, reward, terminated, truncated, _info = result
        done = bool(terminated) or bool(truncated)
    else:
        obs, reward, done, _info = result
        done = bool(done)
    return np.asarray(obs), float(reward), done
