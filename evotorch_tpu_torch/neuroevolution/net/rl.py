"""RL helpers (counterpart of ``evotorch_tpu/neuroevolution/net/rl.py``):
the scheduled alive bonus of the rollout contracts so far."""

from __future__ import annotations

import torch

__all__ = ["alive_bonus_for_step"]


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
