"""Online observation normalization with mergeable statistics (counterpart
of ``evotorch_tpu/neuroevolution/net/runningnorm.py``).

The statistics are ``(count, sum, sum_of_squares)`` tensors on the device,
updated inside the rollout loop with no host sync; stacked statistics hold
one such slot per accounting group (``group_stats_*``, ``stats_slot``). ``RunningNorm`` is the
stateful wrapper a ``VecNE`` problem keeps them in. ``RunningStat`` is the
host (numpy) counterpart the gym-API rollouts of ``GymNE`` and
``net/hostvecenv.py`` keep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .rl import ObsNormLayer

__all__ = [
    "CollectedStats",
    "RunningNorm",
    "RunningStat",
    "group_stats_init",
    "group_stats_normalize",
    "group_stats_update",
    "stats_init",
    "stats_merge",
    "stats_normalize",
    "stats_psum",
    "stats_slot",
    "stats_update",
]


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


# -------------------- per-group (stacked) statistics ------------------------
# A stacked CollectedStats (count (G,), sum (G, n), sum_of_squares (G, n))
# holds one normalization slot per accounting group (a tenant of the
# evaluation server). The refill engine recognizes the stacked form by the
# count's rank: each lane normalizes by its group's slot and updates only
# that slot.


def group_stats_init(num_groups: int, n: int, *, device, dtype=torch.float32) -> CollectedStats:
    """Stacked statistics with ``num_groups`` empty slots of ``n``-dim
    observations."""
    g = int(num_groups)
    return CollectedStats(
        count=torch.zeros(g, dtype=dtype, device=device),
        sum=torch.zeros((g, n), dtype=dtype, device=device),
        sum_of_squares=torch.zeros((g, n), dtype=dtype, device=device),
    )


def group_stats_update(
    stats: CollectedStats, obs: torch.Tensor, groups: torch.Tensor, mask: Optional[torch.Tensor], num_groups: int
) -> CollectedStats:
    """Accumulate a batch of observations ``(B, n)`` into stacked
    statistics, row ``i`` into slot ``groups[i]``; rows where ``mask`` is
    False are left out (``stats_update``'s contract). The sums are taken
    through a ``(G, B)`` one-hot mask, every slot a masked reduction over
    the whole batch, not a float ``index_add_``, whose order on the card is
    not fixed: the same inputs give the same bits on every run."""
    obs = torch.atleast_2d(obs)
    ids = torch.arange(int(num_groups), device=obs.device)
    onehot = groups.to(device=obs.device, dtype=torch.int64)[None, :] == ids[:, None]
    if mask is not None:
        onehot = onehot & mask[None, :]
    m = onehot.to(obs.dtype)  # (G, B)
    masked = m[:, :, None] * obs[None, :, :]  # (G, B, n)
    return CollectedStats(
        count=stats.count + m.sum(dim=1),
        sum=stats.sum + masked.sum(dim=1),
        sum_of_squares=stats.sum_of_squares + (masked * obs[None, :, :]).sum(dim=1),
    )


def group_stats_normalize(stats: CollectedStats, obs: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """Normalize each observation row by its group's slot (identity while
    that slot's count is below 2)."""
    groups = groups.to(device=obs.device, dtype=torch.int64)
    mean = stats.sum / torch.clamp(stats.count, min=1.0)[:, None]
    c2 = torch.clamp(stats.count, min=2.0)[:, None]
    var = (stats.sum_of_squares - (stats.sum**2) / c2) / (c2 - 1.0)
    stdev = torch.sqrt(torch.clamp(var, min=1e-8))
    safe = (stats.count >= 2.0)[groups]
    normalized = (obs - mean[groups]) / stdev[groups]
    return torch.where(safe[:, None], normalized, obs)


def stats_slot(stats: CollectedStats, g: int) -> CollectedStats:
    """One group's slot of stacked statistics as plain statistics: what a
    tenant sees as its own."""
    return CollectedStats(count=stats.count[g], sum=stats.sum[g], sum_of_squares=stats.sum_of_squares[g])


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


class RunningStat:
    """Host-side numpy running statistics (count, sum, sum of squares, in
    float64) for host rollouts; mergeable with ``update`` and split into
    the delta since a baseline with ``to_delta`` (the host pool's sync)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._count = 0
        self._sum: Optional[np.ndarray] = None
        self._sum_of_squares: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> np.ndarray:
        return self._sum

    @property
    def sum_of_squares(self) -> np.ndarray:
        return self._sum_of_squares

    @property
    def mean(self) -> np.ndarray:
        return self._sum / self._count

    @property
    def stdev(self) -> np.ndarray:
        c = max(self._count, 2)
        var = (self._sum_of_squares - (self._sum**2) / c) / (c - 1)
        return np.sqrt(np.maximum(var, 1e-8))

    def update(self, x):
        """Add observations (a vector or a batch of rows), or merge another
        ``RunningStat``."""
        if isinstance(x, RunningStat):
            if x._count == 0:
                return
            if self._count == 0:
                self._count = x._count
                self._sum = x._sum.copy()
                self._sum_of_squares = x._sum_of_squares.copy()
            else:
                self._count += x._count
                self._sum = self._sum + x._sum
                self._sum_of_squares = self._sum_of_squares + x._sum_of_squares
            return
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[None, :]
        if self._count == 0:
            self._sum = np.zeros(x.shape[-1], dtype=np.float64)
            self._sum_of_squares = np.zeros(x.shape[-1], dtype=np.float64)
        self._count += x.shape[0]
        self._sum += x.sum(axis=0)
        self._sum_of_squares += (x**2).sum(axis=0)

    def normalize(self, x) -> np.ndarray:
        if self._count < 2:
            return np.asarray(x)
        return (np.asarray(x) - self.mean) / self.stdev

    def to_delta(self, since: "RunningStat") -> "RunningStat":
        """The statistics collected since ``since``."""
        delta = RunningStat()
        if self._count > since._count:
            delta._count = self._count - since._count
            delta._sum = self._sum - (since._sum if since._sum is not None else 0.0)
            delta._sum_of_squares = self._sum_of_squares - (
                since._sum_of_squares if since._sum_of_squares is not None else 0.0
            )
        return delta

    def __repr__(self):
        return f"RunningStat(count={self._count})"
