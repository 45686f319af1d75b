"""Online observation normalization with mergeable statistics (counterpart
of ``evotorch_tpu/neuroevolution/net/runningnorm.py``).

The statistics are ``(count, sum, sum_of_squares)`` tensors on the device,
updated inside the rollout loop with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["CollectedStats", "stats_init", "stats_normalize", "stats_update"]


@dataclasses.dataclass(frozen=True)
class CollectedStats:
    count: torch.Tensor  # scalar
    sum: torch.Tensor  # (n,)
    sum_of_squares: torch.Tensor  # (n,)

    @property
    def mean(self) -> torch.Tensor:
        return self.sum / torch.clamp(self.count, min=1.0)

    @property
    def stdev(self) -> torch.Tensor:
        c = torch.clamp(self.count, min=2.0)
        var = (self.sum_of_squares - (self.sum**2) / c) / (c - 1.0)
        return torch.sqrt(torch.clamp(var, min=1e-8))


def stats_init(n: int, *, device, dtype=torch.float32) -> CollectedStats:
    """Empty statistics for ``n``-dim observations."""
    return CollectedStats(
        count=torch.zeros((), dtype=dtype, device=device),
        sum=torch.zeros(n, dtype=dtype, device=device),
        sum_of_squares=torch.zeros(n, dtype=dtype, device=device),
    )


def stats_update(stats: CollectedStats, obs: torch.Tensor, mask: Optional[torch.Tensor] = None) -> CollectedStats:
    """Accumulate a batch of observations ``(B, n)``; rows where ``mask``
    is False are left out (the masked contracts pass the lanes still
    running). As in the JAX package the masked rows are multiplied by 0."""
    obs = torch.atleast_2d(obs)
    if mask is not None:
        m = mask.to(obs.dtype)
        obs = obs * m[:, None]
        n_new = torch.sum(m)
    else:
        n_new = obs.shape[0]
    return CollectedStats(
        count=stats.count + n_new,
        sum=stats.sum + torch.sum(obs, dim=0),
        sum_of_squares=stats.sum_of_squares + torch.sum(obs**2, dim=0),
    )


def stats_normalize(stats: CollectedStats, obs: torch.Tensor) -> torch.Tensor:
    """Normalize observations by the collected stats; identity while count < 2."""
    return torch.where(stats.count >= 2, (obs - stats.mean) / stats.stdev, obs)
