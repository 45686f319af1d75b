"""RL helpers (counterpart of ``evotorch_tpu/neuroevolution/net/rl.py``):
the frozen observation-normalization and action-clipping layers of policy
exports, and the scheduled alive bonus of the rollout contracts."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layers import Module

__all__ = ["ActClipLayer", "ObsNormLayer", "alive_bonus_for_step"]


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
