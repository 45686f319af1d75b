"""Online observation normalization with mergeable statistics (counterpart
of ``evotorch_tpu/neuroevolution/net/runningnorm.py``).

The statistics are ``(count, sum, sum_of_squares)`` tensors on the device,
updated inside the rollout loop with no host sync. ``RunningNorm`` is the
stateful wrapper a ``VecNE`` problem keeps them in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .rl import ObsNormLayer

__all__ = ["CollectedStats", "RunningNorm", "stats_init", "stats_merge", "stats_normalize", "stats_psum", "stats_update"]


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


def stats_merge(a: CollectedStats, b: CollectedStats) -> CollectedStats:
    """The statistics of both collections (elementwise sums)."""
    return CollectedStats(count=a.count + b.count, sum=a.sum + b.sum, sum_of_squares=a.sum_of_squares + b.sum_of_squares)


def stats_psum(stats: CollectedStats, mesh) -> CollectedStats:
    """The statistics summed over the ranks of ``mesh`` (a
    ``parallel.Mesh``): the merge of every rank's collection, in one
    ``all_reduce``."""
    k = stats.sum.shape[0]
    flat = mesh.all_sum(torch.cat([stats.count.reshape(1), stats.sum, stats.sum_of_squares]))
    return CollectedStats(count=flat[0], sum=flat[1 : 1 + k], sum_of_squares=flat[1 + k :])


def stats_normalize(stats: CollectedStats, obs: torch.Tensor, *, clip: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Normalize observations by the collected stats, clipped to ``clip``
    when given; identity while count < 2."""
    normalized = (obs - stats.mean) / stats.stdev
    if clip is not None:
        normalized = torch.clamp(normalized, clip[0], clip[1])
    return torch.where(stats.count >= 2, normalized, obs)


class RunningNorm:
    """Stateful running normalization over :class:`CollectedStats`
    (``stats``), on one device."""

    def __init__(
        self,
        shape,
        dtype=torch.float32,
        *,
        device,
        min_variance: float = 1e-8,
        clip: Optional[Tuple[float, float]] = None,
    ):
        """``min_variance`` is kept for the JAX package's signature; as
        there, the statistics' own floor (a variance of at least 1e-8)
        applies and this value is only stored."""
        if isinstance(shape, int):
            shape = (shape,)
        (self._n,) = tuple(shape)
        self._dtype = dtype
        self._device = torch.device(device)
        self._min_variance = float(min_variance)
        self._clip = clip
        self.stats = stats_init(self._n, device=self._device, dtype=dtype)

    @property
    def shape(self):
        return (self._n,)

    @property
    def count(self) -> float:
        """The number of observations (a host float: reading it syncs)."""
        return float(self.stats.count)

    @property
    def mean(self) -> torch.Tensor:
        return self.stats.mean

    @property
    def stdev(self) -> torch.Tensor:
        return self.stats.stdev

    def update(self, x, mask=None):
        """Accumulate an observation (1-D) or a batch (2-D), or merge another
        RunningNorm or CollectedStats."""
        if isinstance(x, RunningNorm):
            self.stats = stats_merge(self.stats, x.stats)
        elif isinstance(x, CollectedStats):
            self.stats = stats_merge(self.stats, x)
        else:
            x = torch.as_tensor(x, dtype=self._dtype, device=self._device)
            self.stats = stats_update(self.stats, torch.atleast_2d(x), mask)

    def normalize(self, x) -> torch.Tensor:
        return stats_normalize(self.stats, torch.as_tensor(x, dtype=self._dtype, device=self._device), clip=self._clip)

    def __call__(self, x) -> torch.Tensor:
        return self.normalize(x)

    def update_and_normalize(self, x, mask=None) -> torch.Tensor:
        self.update(x, mask)
        return self.normalize(x)

    def to_layer(self):
        """The current statistics frozen into an ``ObsNormLayer``."""
        return ObsNormLayer(mean=self.mean, stdev=self.stdev, clip=self._clip)

    def reset(self):
        self.stats = stats_init(self._n, device=self._device, dtype=self._dtype)

    def __repr__(self):
        return f"RunningNorm(shape={self.shape}, count={self.count})"
