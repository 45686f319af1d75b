"""Windowed, variance-aware trend detection over the search-health plane
(counterpart of ``evotorch_tpu/observability/health.py``, host-side and
ported whole).

The device side of the health plane
(``devicemetrics.compute_health_block``) ships per-group score statistics
in the telemetry wire; the gaussian searchers publish algorithm scalars
(``stdev_norm`` and others) as status keys. This module turns those streams
into verdicts, each trend test gated on a noise floor estimated from the
stream's own residual variance.

:class:`EWMATrend`
    one scalar stream: an EWMA of the per-step deltas and an EWMA of the
    residual variance around it. The trend is significant only when
    ``|delta_ewma|`` clears ``noise_scale`` standard errors
    (``sqrt(var / eff_n)``, ``eff_n = (2 - alpha) / alpha``).
    ``stall_streak`` counts the observations, after a warm-up of 3 deltas,
    whose trend stayed inside the noise floor: the plateau signal.

:class:`HealthMonitor`
    keyed detectors plus first-seen baselines, with ``state_dict()`` /
    ``load_state_dict()`` of plain floats, so checkpoints carry the window
    state and a resume gives the same verdicts.

The SLO rule kinds built on them (``plateau``, ``stdev_collapse``,
``score_snr_floor``) live in :mod:`~evotorch_tpu_torch.observability.slo`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

__all__ = ["EWMATrend", "HealthMonitor"]

#: deltas required before stall_streak starts counting
_WARMUP_DELTAS = 3


class EWMATrend:
    """EWMA slope detector with a residual-variance noise floor. ``alpha``
    smooths both the delta trend and the residual variance;
    ``noise_scale`` is the number of standard errors the trend must clear
    to count as significant (3.0: a false plateau verdict on a noisy but
    progressing run is worse than a late true one)."""

    def __init__(self, alpha: float = 0.2, noise_scale: float = 3.0):
        alpha = float(alpha)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.noise_scale = float(noise_scale)
        self.n = 0
        self.value: Optional[float] = None
        self.delta_ewma = 0.0
        self.var_ewma = 0.0
        self.stall_streak = 0

    @property
    def eff_n(self) -> float:
        """Effective sample size of the exponential window."""
        return (2.0 - self.alpha) / self.alpha

    @property
    def noise_floor(self) -> float:
        """The least |trend| distinguishable from the stream's own noise."""
        return self.noise_scale * math.sqrt(max(self.var_ewma, 0.0) / self.eff_n)

    @property
    def warmed_up(self) -> bool:
        return self.n > _WARMUP_DELTAS  # n observations are n - 1 deltas

    @property
    def significant(self) -> bool:
        """The trend clears the noise floor (either direction)."""
        return self.warmed_up and abs(self.delta_ewma) > self.noise_floor

    def observe(self, value: float) -> "EWMATrend":
        """Fold one observation in (a non-finite one is ignored); returns
        self."""
        value = float(value)
        if not math.isfinite(value):
            return self
        if self.value is not None:
            delta = value - self.value
            residual = delta - self.delta_ewma
            a = self.alpha
            self.delta_ewma += a * residual
            self.var_ewma = (1.0 - a) * (self.var_ewma + a * residual * residual)
        self.value = value
        self.n += 1
        if self.warmed_up:
            if abs(self.delta_ewma) > self.noise_floor:
                self.stall_streak = 0
            else:
                self.stall_streak += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        return {
            "alpha": self.alpha,
            "noise_scale": self.noise_scale,
            "n": self.n,
            "value": self.value,
            "delta_ewma": self.delta_ewma,
            "var_ewma": self.var_ewma,
            "stall_streak": self.stall_streak,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "EWMATrend":
        self.alpha = float(state["alpha"])
        self.noise_scale = float(state["noise_scale"])
        self.n = int(state["n"])
        self.value = None if state["value"] is None else float(state["value"])
        self.delta_ewma = float(state["delta_ewma"])
        self.var_ewma = float(state["var_ewma"])
        self.stall_streak = int(state["stall_streak"])
        return self

    def __repr__(self):
        return (
            f"EWMATrend(n={self.n}, value={self.value}, delta_ewma={self.delta_ewma:.4g},"
            f" noise_floor={self.noise_floor:.4g}, stall_streak={self.stall_streak})"
        )


def _key(name: str, group: Optional[int]) -> str:
    # string keys, so that a state_dict goes through JSON untouched
    return str(name) if group is None else f"{name}@g{int(group)}"


class HealthMonitor:
    """Keyed :class:`EWMATrend` detectors plus first-seen baselines."""

    def __init__(self, alpha: float = 0.2, noise_scale: float = 3.0):
        self.alpha = float(alpha)
        self.noise_scale = float(noise_scale)
        self._trends: Dict[str, EWMATrend] = {}
        self._baselines: Dict[str, float] = {}

    def observe(self, name: str, value: float, *, group: Optional[int] = None) -> EWMATrend:
        """Fold one sample into the stream's detector (made on first use);
        the first finite sample is the stream's baseline (the
        ``stdev_collapse`` reference)."""
        key = _key(name, group)
        trend = self._trends.get(key)
        if trend is None:
            trend = self._trends[key] = EWMATrend(self.alpha, self.noise_scale)
        if key not in self._baselines and math.isfinite(float(value)):
            self._baselines[key] = float(value)
        return trend.observe(value)

    def trend(self, name: str, *, group: Optional[int] = None) -> Optional[EWMATrend]:
        return self._trends.get(_key(name, group))

    def baseline(self, name: str, *, group: Optional[int] = None) -> Optional[float]:
        return self._baselines.get(_key(name, group))

    def keys(self) -> Tuple[str, ...]:
        return tuple(sorted(self._trends))

    def state_dict(self) -> Dict[str, Any]:
        return {
            "alpha": self.alpha,
            "noise_scale": self.noise_scale,
            "trends": {k: t.state_dict() for k, t in sorted(self._trends.items())},
            "baselines": dict(sorted(self._baselines.items())),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "HealthMonitor":
        self.alpha = float(state.get("alpha", self.alpha))
        self.noise_scale = float(state.get("noise_scale", self.noise_scale))
        self._trends = {k: EWMATrend(self.alpha, self.noise_scale).load_state_dict(s) for k, s in state.get("trends", {}).items()}
        self._baselines = {k: float(v) for k, v in state.get("baselines", {}).items()}
        return self

    def __repr__(self):
        return f"HealthMonitor(streams={list(self.keys())!r})"
