"""MetricsHub: streaming export of decoded telemetry and host counters
(counterpart of ``evotorch_tpu/observability/metricshub.py``).

One hub is one output file, in one of two formats chosen by its suffix:

* anything but ``.prom`` (conventionally ``.jsonl``): append-only JSONL.
  The first line is a schema-versioned run manifest (``{"manifest":
  {...}}``: the telemetry schema version, the git sha where there is one,
  ``runtime: "torch"``, the device's name, and what the caller adds); each
  later line is one ``{"row": N, ...}`` record, flushed and fsync'd, so a
  killed run keeps every row already written.
* ``.prom``: the Prometheus text exposition format, rewritten whole on each
  emit (the textfile-collector contract): numeric row fields become
  ``evotorch_<key>`` gauges, per-group figures
  ``evotorch_eval_<col>{group="g"}`` series, each family with its
  ``# HELP``/``# TYPE`` pair.

The hub decodes no device tensor itself: callers hand it a decoded
:class:`GroupTelemetry` (or plain scalars), so exporting costs no device
sync. Writes go through ``resilience.retry_call`` (site
``metricshub.write``, fault-injectable). ``MetricsHub.from_env()`` reads
``EVOTORCH_METRICS=path``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .devicemetrics import (
    GROUP_TELEMETRY_WIDTH,
    TELEMETRY_SCHEMA_VERSION,
    TELEMETRY_WIDTH,
    EvalTelemetry,
    GroupTelemetry,
    _SLOTS,
)
from .registry import counters
from ..resilience.retry import retry_call

__all__ = ["MetricsHub"]

_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: per-group columns exported as labelled Prometheus series (the score_*
#: columns appear only on schema-v4 wires carrying the health plane)
_GROUP_EXPORT_COLS = (
    "env_steps",
    "episodes",
    "capacity",
    "lane_width",
    "refill_events",
    "queue_wait",
    "nonfinite",
    "occupancy",
    "score_count",
    "score_mean",
    "score_std",
    "score_min",
    "score_max",
)


def _git_sha() -> Optional[str]:
    """Best-effort short sha of the working tree; None outside a repo."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _runtime_fields() -> Dict[str, Any]:
    """The manifest's runtime fields: the port's runtime and the device its
    rows describe (the card's name, or ``cpu`` without one)."""
    import torch

    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return {"runtime": "torch", "torch_version": torch.__version__, "device": device}


def _json_safe(value):
    """Coerce numpy scalars / odd types so json.dumps never raises."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    for cast in (int, float):
        try:
            return cast(value)
        except (TypeError, ValueError):
            continue
    return str(value)


class MetricsHub:
    """Streams per-generation metric rows to a JSONL or ``.prom`` file."""

    def __init__(self, path: str, *, manifest: Optional[Dict[str, Any]] = None):
        self._path = str(path)
        self._prom = self._path.endswith(".prom")
        self._lock = threading.Lock()
        self._rows = 0
        self._manifest = {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "git_sha": _git_sha(),
            "created_unix": round(time.time(), 3),
            **_runtime_fields(),
            **_json_safe(dict(manifest or {})),
        }
        if not self._prom:
            # manifest is the FIRST line, written eagerly so even a run
            # killed before its first generation leaves a parseable stream
            parent = os.path.dirname(os.path.abspath(self._path))
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self._path, "w", encoding="utf-8") as fh:
                fh.write(json.dumps({"manifest": self._manifest}, sort_keys=True))
                fh.write("\n")

    @classmethod
    def from_env(
        cls, *, manifest: Optional[Dict[str, Any]] = None
    ) -> Optional["MetricsHub"]:
        """Build a hub from ``EVOTORCH_METRICS=path``; None when unset."""
        path = os.environ.get("EVOTORCH_METRICS")
        if not path:
            return None
        return cls(path, manifest=manifest)

    @property
    def path(self) -> str:
        return self._path

    @property
    def manifest(self) -> Dict[str, Any]:
        return dict(self._manifest)

    # ------------------------------------------------------------------ emit
    def emit(
        self,
        row: Optional[Dict[str, Any]] = None,
        *,
        telemetry=None,
        include_counters: bool = True,
    ) -> Dict[str, Any]:
        """Write one record; returns the record as emitted.

        ``telemetry`` may be a decoded :class:`GroupTelemetry`, an
        :class:`EvalTelemetry`, or None.  Its global figures land as
        top-level fields and (at G > 1) the per-group breakdown under
        ``groups``.
        """
        record: Dict[str, Any] = {}
        if telemetry is not None:
            record.update(self._telemetry_fields(telemetry))
        if row:
            record.update(_json_safe(dict(row)))
        if include_counters:
            record["counters"] = {
                k: _json_safe(v) for k, v in counters.snapshot().items()
            }
        with self._lock:
            record["row"] = self._rows
            self._rows += 1
            # writes retry with bounded backoff (resilience.retry): a
            # transient IO blip must not kill the run its metrics describe;
            # the site name makes the path fault-injectable (EVOTORCH_FAULTS
            # "metricshub.write:raise@N")
            if self._prom:
                retry_call(self._write_prom, record, site="metricshub.write")
            else:
                retry_call(self._append_jsonl, record, site="metricshub.write")
        return record

    def _append_jsonl(self, record: Dict[str, Any]) -> None:
        # crash-safe rows: flush + fsync per line, so a SIGKILL'd run keeps
        # every row already emitted (readers skip at most the partial
        # trailing line — slo._last_json_line tolerates one)
        with open(self._path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record, sort_keys=True))
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())

    @staticmethod
    def _telemetry_fields(telemetry) -> Dict[str, Any]:
        if isinstance(telemetry, EvalTelemetry):
            row = np.zeros((1, GROUP_TELEMETRY_WIDTH), dtype=np.int64)
            row[0, :TELEMETRY_WIDTH] = [
                getattr(telemetry, name) for name in _SLOTS
            ]
            telemetry = GroupTelemetry(data=row)
        if not isinstance(telemetry, GroupTelemetry):
            raise TypeError(
                "telemetry must be GroupTelemetry or EvalTelemetry, got "
                f"{type(telemetry).__name__}"
            )
        total = telemetry.total()
        fields: Dict[str, Any] = {
            "eval_occupancy": round(total.occupancy, 6),
            "eval_env_steps": int(total.env_steps),
            "eval_episodes": int(total.episodes),
            "eval_refill_events": int(total.refill_events),
            "eval_queue_wait": int(total.queue_wait),
            "eval_nonfinite": int(total.nonfinite),
            "queue_wait_p50": telemetry.queue_wait_quantile(0.5),
            "queue_wait_p99": telemetry.queue_wait_quantile(0.99),
        }
        if telemetry.has_health:
            # search-health plane (schema v4): global score statistics
            stats = telemetry.score_stats()
            if stats["count"] > 0:
                fields["score_mean"] = round(stats["mean"], 6)
                fields["score_std"] = round(stats["std"], 6)
                fields["score_min"] = round(stats["min"], 6)
                fields["score_max"] = round(stats["max"], 6)
        if telemetry.num_groups > 1:
            fields["groups"] = telemetry.to_rows()
        return fields

    # ------------------------------------------------------------ prometheus
    def _write_prom(self, record: Dict[str, Any]) -> None:
        # strict textfile-collector format: every metric family gets its
        # `# HELP` / `# TYPE` comment pair before its samples (bare samples
        # trip strict scrapers); labelled per-group series share ONE
        # family header
        families: Dict[str, Dict[str, Any]] = {}

        def add(name, sample, *, mtype, help_text):
            fam = families.setdefault(
                name, {"type": mtype, "help": help_text, "samples": []}
            )
            fam["samples"].append(sample)

        for key, value in sorted(record.items()):
            if key == "groups":
                continue
            if key == "counters" and isinstance(value, dict):
                for cname, cval in sorted(value.items()):
                    if isinstance(cval, (int, float)) and not isinstance(cval, bool):
                        metric = f"evotorch_counter_{_metric_name(cname)}"
                        add(
                            metric,
                            f"{metric} {cval}",
                            mtype="counter",
                            help_text=f"process-lifetime counter {cname}",
                        )
                continue
            if isinstance(value, bool):
                value = int(value)
            elif not isinstance(value, (int, float)):
                continue
            metric = f"evotorch_{_metric_name(key)}"
            add(
                metric,
                f"{metric} {value}",
                mtype="gauge",
                help_text=f"per-generation row field {key}",
            )
        for group_row in record.get("groups", ()):  # labelled per-group series
            gid = group_row.get("group")
            for col in _GROUP_EXPORT_COLS:
                if col in group_row:
                    metric = f"evotorch_eval_{_metric_name(col)}"
                    add(
                        metric,
                        f'{metric}{{group="{gid}"}} {group_row[col]}',
                        mtype="gauge",
                        help_text=f"per-group telemetry column {col}",
                    )
        lines = [
            "# evotorch_tpu metrics (textfile-collector format; "
            f"schema_version={self._manifest['schema_version']})"
        ]
        for name, fam in families.items():
            lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            lines.extend(fam["samples"])
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines))
            fh.write("\n")
        os.replace(tmp, self._path)  # atomic: scrapers never see a torn file


def _metric_name(name: str) -> str:
    return _METRIC_NAME_RE.sub("_", str(name))
