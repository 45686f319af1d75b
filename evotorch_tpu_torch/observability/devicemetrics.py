"""On-device eval telemetry: the packed int32 wire and its host decoders
(counterpart of ``evotorch_tpu/observability/devicemetrics.py``).

Every rollout contract accumulates its counters as int32 scalars on the
device inside the loop it already runs, and packs them at the end into one
int32 matrix that rides out in ``RolloutResult.telemetry`` beside the
scores. The wire is the JAX package's, value for value:

* a ``(G, TELEMETRY_WIDTH)`` counter block (the slots below, one row per
  group; the port evaluates one group, ``G = 1``);
* a ``(G, QUEUE_WAIT_BUCKETS)`` queue-wait histogram (``episodes_refill``;
  zeros elsewhere): bucket 0 counts refills that waited no step, bucket
  ``b`` waits in ``[2^(b-1), 2^b - 1]`` steps, the last one 64 or more;
* with the health plane on, ``HEALTH_WIDTH`` columns of per-group float32
  score statistics (``count, sum, sumsq, min, max`` of the final mean
  scores) bit-cast to int32, giving ``(G, HEALTH_TELEMETRY_WIDTH)`` =
  ``(1, 20)``.

Slots (column order is the wire format):

===================  =======================================================
``env_steps``        counted env interactions (active lanes x steps)
``episodes``         episodes finished
``capacity``         lane-step slots the loop executed (working width summed
                     over the steps that did work); occupancy's denominator
``lane_width``       lanes at evaluation start
``refill_events``    items loaded into a recycled lane (``episodes_refill``)
``queue_wait``       lane-steps spent idle while pending work existed
``nonfinite``        solutions whose non-finite score was quarantined
===================  =======================================================

The device side (``pack_*``, ``compute_health_block``,
``append_health_block``, ``queue_wait_bucket_index``,
``device_episode_total``) is torch; the host
decoders (``EvalTelemetry``, ``GroupTelemetry``) are numpy and also read
the older widths: the 6-slot vector and the ``(G, 14)`` matrix written
before the ``nonfinite`` slot existed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "GROUP_TELEMETRY_WIDTH",
    "HEALTH_TELEMETRY_WIDTH",
    "HEALTH_WIDTH",
    "QUEUE_WAIT_BUCKETS",
    "QUEUE_WAIT_BUCKET_EDGES",
    "TELEMETRY_SCHEMA_VERSION",
    "TELEMETRY_WIDTH",
    "EvalTelemetry",
    "GroupTelemetry",
    "append_health_block",
    "compute_health_block",
    "device_episode_total",
    "pack_eval_telemetry",
    "pack_group_telemetry",
    "sum_over_ranks",
    "queue_wait_bucket_index",
]

#: packed vector layout (order is the wire format; append only)
_SLOTS = (
    "env_steps",
    "episodes",
    "capacity",
    "lane_width",
    "refill_events",
    "queue_wait",
    "nonfinite",
)
TELEMETRY_WIDTH = len(_SLOTS)

#: lower edges of the queue-wait buckets 1..7; bucket 0 is a zero wait
QUEUE_WAIT_BUCKET_EDGES = (1, 2, 4, 8, 16, 32, 64)
QUEUE_WAIT_BUCKETS = len(QUEUE_WAIT_BUCKET_EDGES) + 1

#: counter block + histogram block
GROUP_TELEMETRY_WIDTH = TELEMETRY_WIDTH + QUEUE_WAIT_BUCKETS

_HEALTH_SLOTS = ("score_count", "score_sum", "score_sumsq", "score_min", "score_max")
HEALTH_WIDTH = len(_HEALTH_SLOTS)

#: counter block + histogram block + bit-cast health block
HEALTH_TELEMETRY_WIDTH = GROUP_TELEMETRY_WIDTH + HEALTH_WIDTH

TELEMETRY_SCHEMA_VERSION = 4

#: widths from before the ``nonfinite`` slot, still decoded (the slot reads 0)
_LEGACY_TELEMETRY_WIDTH = 6
_LEGACY_GROUP_TELEMETRY_WIDTH = _LEGACY_TELEMETRY_WIDTH + QUEUE_WAIT_BUCKETS

#: inclusive upper edge of each bucket for the quantile decode; the overflow
#: bucket reports its lower edge
_BUCKET_UPPER_EDGES = (0, 1, 3, 7, 15, 31, 63, 64)


def _lift_legacy(values: np.ndarray) -> Optional[np.ndarray]:
    """A wire of the older widths widened to the current layout, or None."""
    if values.shape == (_LEGACY_TELEMETRY_WIDTH,):
        out = np.zeros((TELEMETRY_WIDTH,), dtype=np.int64)
        out[:_LEGACY_TELEMETRY_WIDTH] = values
        return out
    if values.ndim == 2 and values.shape[1] == _LEGACY_GROUP_TELEMETRY_WIDTH:
        out = np.zeros((values.shape[0], GROUP_TELEMETRY_WIDTH), dtype=np.int64)
        out[:, :_LEGACY_TELEMETRY_WIDTH] = values[:, :_LEGACY_TELEMETRY_WIDTH]
        out[:, TELEMETRY_WIDTH:] = values[:, _LEGACY_TELEMETRY_WIDTH:]
        return out
    return None


def _as_int32(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).reshape(())
    # a fill, not a copy from the host: no sync on the card
    return torch.full((), int(value), dtype=torch.int32, device=device)


def pack_eval_telemetry(
    *,
    env_steps,
    episodes,
    capacity,
    lane_width,
    refill_events=0,
    queue_wait=0,
    nonfinite=0,
    device=None,
) -> torch.Tensor:
    """Stack the counters (device scalars or Python ints) into the
    ``(TELEMETRY_WIDTH,)`` int32 vector, on ``device`` or on the device of
    the first tensor among them. Every slot is cast to int32: a sum of a
    bool tensor is int64 in torch."""
    values = (env_steps, episodes, capacity, lane_width, refill_events, queue_wait, nonfinite)
    if device is None:
        device = next((v.device for v in values if isinstance(v, torch.Tensor)), torch.device("cpu"))
    return torch.stack([_as_int32(v, device) for v in values])


def pack_group_telemetry(group_counts: torch.Tensor, hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(G, TELEMETRY_WIDTH)`` counters and a ``(G, QUEUE_WAIT_BUCKETS)``
    histogram (all zero when ``hist`` is None) -> the
    ``(G, GROUP_TELEMETRY_WIDTH)`` int32 matrix."""
    group_counts = group_counts.to(torch.int32)
    if hist is None:
        hist = torch.zeros((group_counts.shape[0], QUEUE_WAIT_BUCKETS), dtype=torch.int32, device=group_counts.device)
    return torch.cat([group_counts, hist.to(torch.int32)], dim=1)


def compute_health_block(scores: torch.Tensor) -> torch.Tensor:
    """The ``(1, HEALTH_WIDTH)`` float32 block ``count, sum, sumsq, min,
    max`` of the final per-solution mean scores (one group). An empty
    score vector reads 0 in every slot."""
    scores = scores.to(torch.float32).reshape(-1)
    count = torch.full((), float(scores.numel()), dtype=torch.float32, device=scores.device)
    if scores.numel() == 0:
        return torch.zeros((1, HEALTH_WIDTH), dtype=torch.float32, device=scores.device)
    block = torch.stack([count, scores.sum(), (scores * scores).sum(), scores.min(), scores.max()])
    return block[None]


def append_health_block(telemetry: torch.Tensor, health: torch.Tensor) -> torch.Tensor:
    """Bit-cast the float32 health block to int32 (``Tensor.view`` on a
    contiguous float32 tensor) and append it to the counter matrix:
    ``(G, GROUP_TELEMETRY_WIDTH)`` -> ``(G, HEALTH_TELEMETRY_WIDTH)``."""
    as_int = health.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([telemetry.to(torch.int32), as_int], dim=1)


def sum_over_ranks(telemetry: torch.Tensor, mesh, scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wire of an evaluation sharded over ``mesh``'s ranks from each
    rank's ``(G, GROUP_TELEMETRY_WIDTH)`` counters: the counters (every
    slot is additive, the histogram included) summed over the ranks, and,
    given the global ``scores``, the health block computed on them (the same
    on every rank), appended."""
    wire = mesh.all_sum(telemetry[:, :GROUP_TELEMETRY_WIDTH].to(torch.int32))
    return wire if scores is None else append_health_block(wire, compute_health_block(scores))


def device_episode_total(telemetry) -> torch.Tensor:
    """The ``episodes`` slot of a wire summed on its device, with no host
    read: a ``(TELEMETRY_WIDTH,)`` vector, a ``(G, C)`` matrix or a stacked
    ``(K, G, C)`` span. An int32 scalar tensor, 0 for an empty
    (telemetry-off) wire."""
    t = torch.as_tensor(telemetry)
    if t.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=t.device)
    col = _SLOTS.index("episodes")
    if t.ndim == 1:
        return t[col].to(torch.int32)
    return t[..., col].sum().to(torch.int32)


def queue_wait_bucket_index(waits: torch.Tensor, edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram bucket of each int wait: the number of lower edges it
    reaches (branch-free, integer-exact). Returns int64 indices. A loop
    passes ``edges`` (``QUEUE_WAIT_BUCKET_EDGES`` as a tensor on the
    waits' device, made once) so that no step copies them to the card."""
    if edges is None:
        edges = torch.tensor(QUEUE_WAIT_BUCKET_EDGES, dtype=waits.dtype, device=waits.device)
    return (waits[..., None] >= edges).sum(dim=-1)


def _split_health(values: np.ndarray):
    counter = np.asarray(values[:, :GROUP_TELEMETRY_WIDTH], dtype=np.int64)
    health_bits = np.ascontiguousarray(values[:, GROUP_TELEMETRY_WIDTH:], dtype=np.int32)
    return counter, health_bits.view(np.float32).astype(np.float64)


def _to_numpy(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


@dataclass(frozen=True)
class EvalTelemetry:
    """Host-side decode of one telemetry vector or matrix (summed over
    groups)."""

    env_steps: int = 0
    episodes: int = 0
    capacity: int = 0
    lane_width: int = 0
    refill_events: int = 0
    queue_wait: int = 0
    nonfinite: int = 0

    @classmethod
    def from_array(cls, array) -> "EvalTelemetry":
        """Decode a ``(TELEMETRY_WIDTH,)`` vector or a ``(G, 14 | 15 | 20)``
        matrix (column-summed), older widths included."""
        values = _to_numpy(array)
        legacy = _lift_legacy(values)
        if legacy is not None:
            values = legacy
        if values.shape == (TELEMETRY_WIDTH,):
            return cls(**{name: int(values[i]) for i, name in enumerate(_SLOTS)})
        if values.ndim == 2 and values.shape[1] in (GROUP_TELEMETRY_WIDTH, HEALTH_TELEMETRY_WIDTH):
            totals = np.asarray(values[:, :TELEMETRY_WIDTH], dtype=np.int64).sum(axis=0)
            return cls(**{name: int(totals[i]) for i, name in enumerate(_SLOTS)})
        raise ValueError(
            f"expected a ({TELEMETRY_WIDTH},) telemetry vector or a (G, {GROUP_TELEMETRY_WIDTH}) /"
            f" (G, {HEALTH_TELEMETRY_WIDTH}) per-group matrix, got shape {values.shape}"
        )

    def __add__(self, other: "EvalTelemetry") -> "EvalTelemetry":
        if not isinstance(other, EvalTelemetry):
            return NotImplemented
        return EvalTelemetry(**{name: getattr(self, name) + getattr(other, name) for name in _SLOTS})

    @property
    def occupancy(self) -> float:
        """Share of executed lane-step slots that were counted env steps."""
        return self.env_steps / self.capacity if self.capacity else 0.0

    @property
    def mean_item_wait(self) -> float:
        """Mean idle lane-steps per refilled item."""
        return self.queue_wait / self.refill_events if self.refill_events else 0.0

    def as_status(self, prefix: str = "eval_") -> dict:
        return {
            f"{prefix}occupancy": round(self.occupancy, 6),
            f"{prefix}refill_events": self.refill_events,
            f"{prefix}queue_wait": self.queue_wait,
            f"{prefix}nonfinite": self.nonfinite,
        }

    def summary(self) -> str:
        return (
            f"env_steps={self.env_steps} episodes={self.episodes} "
            f"occupancy={self.occupancy:.4f} lane_width={self.lane_width} "
            f"refill_events={self.refill_events} queue_wait={self.queue_wait} "
            f"nonfinite={self.nonfinite}"
        )


@dataclass(frozen=True)
class GroupTelemetry:
    """Host-side decode of a per-group matrix: counters, queue-wait
    histograms and, on the 20-column wire, the health block re-viewed as
    float (``health``, ``(G, HEALTH_WIDTH)``). Rows add (``__add__``;
    count/sum/sumsq add, min/max combine over the non-empty rows)."""

    data: np.ndarray = field(default_factory=lambda: np.zeros((1, GROUP_TELEMETRY_WIDTH), dtype=np.int64))
    health: Optional[np.ndarray] = None

    @classmethod
    def from_array(cls, array) -> "GroupTelemetry":
        """Decode a ``(G, 14 | 15 | 20)`` matrix, or lift a 6- or 7-slot
        vector into one group with empty histogram buckets."""
        values = _to_numpy(array)
        legacy = _lift_legacy(values)
        if legacy is not None:
            values = legacy
        if values.shape == (TELEMETRY_WIDTH,):
            row = np.zeros((1, GROUP_TELEMETRY_WIDTH), dtype=np.int64)
            row[0, :TELEMETRY_WIDTH] = values
            return cls(data=row)
        if values.ndim == 2 and values.shape[1] == HEALTH_TELEMETRY_WIDTH:
            counter, health = _split_health(values)
            return cls(data=counter, health=health)
        if values.ndim == 2 and values.shape[1] == GROUP_TELEMETRY_WIDTH:
            return cls(data=np.asarray(values, dtype=np.int64).copy())
        raise ValueError(
            f"expected a (G, {GROUP_TELEMETRY_WIDTH}) or (G, {HEALTH_TELEMETRY_WIDTH}) per-group telemetry"
            f" matrix or a ({TELEMETRY_WIDTH},) vector, got shape {values.shape}"
        )

    @property
    def num_groups(self) -> int:
        return int(self.data.shape[0])

    @property
    def hist(self) -> np.ndarray:
        """The ``(G, QUEUE_WAIT_BUCKETS)`` queue-wait histogram block."""
        return self.data[:, TELEMETRY_WIDTH:]

    def group(self, g: int) -> EvalTelemetry:
        row = self.data[g]
        return EvalTelemetry(**{name: int(row[i]) for i, name in enumerate(_SLOTS)})

    def total(self) -> EvalTelemetry:
        totals = self.data[:, :TELEMETRY_WIDTH].sum(axis=0)
        return EvalTelemetry(**{name: int(totals[i]) for i, name in enumerate(_SLOTS)})

    def __add__(self, other: "GroupTelemetry") -> "GroupTelemetry":
        if not isinstance(other, GroupTelemetry):
            return NotImplemented
        a, b = self.data, other.data
        ha, hb = self.health, other.health
        g = max(a.shape[0], b.shape[0])
        if a.shape[0] != b.shape[0]:
            pa = np.zeros((g, GROUP_TELEMETRY_WIDTH), dtype=np.int64)
            pb = np.zeros((g, GROUP_TELEMETRY_WIDTH), dtype=np.int64)
            pa[: a.shape[0]] = a
            pb[: b.shape[0]] = b
            a, b = pa, pb
        health = None
        if ha is not None and hb is not None:
            pa = np.zeros((g, HEALTH_WIDTH), dtype=np.float64)
            pb = np.zeros((g, HEALTH_WIDTH), dtype=np.float64)
            pa[: ha.shape[0]] = ha
            pb[: hb.shape[0]] = hb
            health = pa + pb
            a_has, b_has = pa[:, 0] > 0, pb[:, 0] > 0
            health[:, 3] = np.where(a_has & b_has, np.minimum(pa[:, 3], pb[:, 3]), np.where(a_has, pa[:, 3], pb[:, 3]))
            health[:, 4] = np.where(a_has & b_has, np.maximum(pa[:, 4], pb[:, 4]), np.where(a_has, pa[:, 4], pb[:, 4]))
        return GroupTelemetry(data=a + b, health=health)

    def queue_wait_quantile(self, q: float, group: Optional[int] = None) -> float:
        """Wait quantile in loop steps off the buckets: the inclusive upper
        edge of the bucket that holds it (64 for the overflow bucket); 0.0
        without refills."""
        hist = self.hist if group is None else self.hist[group : group + 1]
        hist = np.asarray(hist, dtype=np.int64).sum(axis=0)
        total = int(hist.sum())
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for b in range(QUEUE_WAIT_BUCKETS):
            cum += int(hist[b])
            if cum >= target:
                return float(_BUCKET_UPPER_EDGES[b])
        return float(_BUCKET_UPPER_EDGES[-1])

    def nonfinite_share(self, group: Optional[int] = None) -> float:
        """Quarantined solutions per finished episode (exact at one episode
        per solution)."""
        rows = self.data if group is None else self.data[group : group + 1]
        episodes = int(rows[:, _SLOTS.index("episodes")].sum())
        nonfinite = int(rows[:, _SLOTS.index("nonfinite")].sum())
        return (nonfinite / episodes) if episodes else 0.0

    def starvation_share(self, group: Optional[int] = None) -> float:
        """Share of refilled items that waited 64 steps or more."""
        hist = self.hist if group is None else self.hist[group : group + 1]
        hist = np.asarray(hist, dtype=np.int64).sum(axis=0)
        total = int(hist.sum())
        return (int(hist[-1]) / total) if total else 0.0

    @property
    def has_health(self) -> bool:
        return self.health is not None

    def score_stats(self, group: Optional[int] = None) -> Optional[dict]:
        """``count``, ``mean``, ``std`` (population), ``min``, ``max`` from
        the health block; None without one."""
        if self.health is None:
            return None
        rows = self.health if group is None else self.health[group : group + 1]
        count = float(rows[:, 0].sum())
        if count <= 0:
            return {"count": 0.0, "mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0}
        mean = float(rows[:, 1].sum()) / count
        var = max(float(rows[:, 2].sum()) / count - mean * mean, 0.0)
        nz = rows[rows[:, 0] > 0]
        return {"count": count, "mean": mean, "std": var**0.5, "min": float(nz[:, 3].min()), "max": float(nz[:, 4].max())}

    def score_mean(self, group: Optional[int] = None) -> Optional[float]:
        stats = self.score_stats(group)
        return None if stats is None else stats["mean"]

    def score_std(self, group: Optional[int] = None) -> Optional[float]:
        stats = self.score_stats(group)
        return None if stats is None else stats["std"]

    def as_status(self, prefix: str = "eval_") -> dict:
        """Per-group status keys, emitted only for more than one group."""
        out = {}
        if self.num_groups > 1:
            for g in range(self.num_groups):
                row = self.group(g)
                out[f"{prefix}g{g}_occupancy"] = round(row.occupancy, 6)
                out[f"{prefix}g{g}_env_steps"] = row.env_steps
                out[f"{prefix}g{g}_episodes"] = row.episodes
                out[f"{prefix}g{g}_queue_wait"] = row.queue_wait
                out[f"{prefix}g{g}_nonfinite"] = row.nonfinite
                if self.health is not None:
                    stats = self.score_stats(g)
                    out[f"{prefix}g{g}_score_mean"] = round(stats["mean"], 6)
                    out[f"{prefix}g{g}_score_std"] = round(stats["std"], 6)
        return out

    def summary(self) -> str:
        tot = self.total()
        parts = [f"groups={self.num_groups}", tot.summary()]
        if int(self.hist.sum()):
            parts.append(f"queue_wait_p50={self.queue_wait_quantile(0.5):g} p99={self.queue_wait_quantile(0.99):g}")
        if self.health is not None:
            stats = self.score_stats()
            parts.append(f"score_mean={stats['mean']:g} score_std={stats['std']:g}")
        return " ".join(parts)

    def to_wire(self) -> np.ndarray:
        """Re-pack into the int32 wire (with the health block bit-cast back
        when this decode carried one)."""
        counter = np.asarray(self.data, dtype=np.int64)
        if np.any(counter > np.iinfo(np.int32).max) or np.any(counter < np.iinfo(np.int32).min):
            raise OverflowError("accumulated telemetry counters exceed the int32 wire range")
        wire = counter.astype(np.int32)
        if self.health is None:
            return wire
        bits = np.asarray(self.health, dtype=np.float32).view(np.int32).reshape(self.num_groups, HEALTH_WIDTH)
        return np.concatenate([wire, bits], axis=1)

    def to_rows(self) -> Tuple[dict, ...]:
        """JSON-safe per-group rows."""
        rows = []
        for g in range(self.num_groups):
            row = self.group(g)
            entry = {
                "group": g,
                **{name: getattr(row, name) for name in _SLOTS},
                "occupancy": round(row.occupancy, 6),
                "queue_wait_hist": [int(v) for v in self.hist[g]],
            }
            if self.health is not None:
                stats = self.score_stats(g)
                entry.update({f"score_{k}": stats[k] for k in ("count", "mean", "std", "min", "max")})
            rows.append(entry)
        return tuple(rows)
