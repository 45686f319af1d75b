"""Measured-timing ledger and the persisted tuned-config cache
(counterpart of ``evotorch_tpu/observability/timings.py``, ported whole).

What a program *measured* on a concrete machine (median steps/s,
occupancy, compile wall-time), keyed per ``(program, shape, machine)``, and
the **tuned-config cache**, a JSON file of measured winners the eval setup
consults, so measured telemetry and not hand-picked defaults chooses a
schedule. Three pieces:

- :func:`machine_fingerprint`: the identity a measurement is valid on. The
  port's reads torch: the backend (``cuda`` or ``cpu``), the device kind
  (``torch.cuda.get_device_name``), the host's core count and
  ``runtime="torch"``. Timings never transfer across fingerprints, so an
  entry the JAX package measured (which has no ``runtime`` key) never
  matches the port.
- :class:`TimingLedger` / :class:`TimingRecord`: the process-wide
  measured-timing registry (module singleton :data:`timings`).
- the tuned-config cache: :func:`load_tuned_cache` / :func:`lookup_tuned` /
  :func:`save_tuned_entry` over ``tuned_configs.json`` (beside this module,
  or ``EVOTORCH_TUNED_CACHE``), in the JAX package's file format, plus
  :func:`resolve_knobs`, the one precedence rule every consumer shares:
  **explicit knobs override the cache; a cache hit overrides the built-in
  fallback**, reported as ``tuned_config_source`` (``"override"`` /
  ``"cache"`` / ``"fallback"``).

``VecNE``, ``GymNE``, the host rollout engines and the sharded rollout
evaluator consult the cache; :mod:`~evotorch_tpu_torch.observability.autotune`
writes its entries.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _write_json_once(path: Path, payload: dict) -> None:
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _atomic_write_json(path: Path, payload: dict) -> None:
    """Durable atomic JSON write: temp file in the target directory, flush,
    fsync, ``os.replace``, retried on transient IO errors by
    ``resilience.retry_call`` (site ``timings.write``, fault-injectable). A
    reader only ever sees a complete old or new file, never a truncation."""
    from ..resilience.retry import retry_call

    retry_call(_write_json_once, path, payload, site="timings.write")


__all__ = [
    "SOURCE_CACHE",
    "SOURCE_FALLBACK",
    "SOURCE_OVERRIDE",
    "TimingLedger",
    "TimingRecord",
    "TunedEntry",
    "canonical_env_label",
    "default_tuned_cache_path",
    "dtype_label",
    "load_tuned_cache",
    "lookup_tuned",
    "machine_fingerprint",
    "resolve_knobs",
    "save_tuned_entry",
    "timing_key",
    "timings",
]

#: tuned_config_source provenance values (the order is the precedence)
SOURCE_OVERRIDE = "override"  # an explicit knob was passed — cache not consulted
SOURCE_CACHE = "cache"  # the tuned-config cache had a matching entry
SOURCE_FALLBACK = "fallback"  # no knob, no entry: the built-in default


def machine_fingerprint(device=None) -> Dict[str, Any]:
    """The machine identity a measurement is valid on: the torch backend of
    ``device`` (by default the card when there is one, else the CPU), its
    device kind, the host's core count and the runtime. Deliberately
    excludes the device count."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    return {
        "backend": device.type,
        "device_kind": kind,
        "core_count": int(os.cpu_count() or 1),
        "runtime": "torch",
    }


def dtype_label(compute_dtype) -> str:
    """The cache-key label of an engine ``compute_dtype`` knob (``None``
    is the f32 default). Part of the tuned-config shape key: a schedule
    tuned under bf16 compute says nothing about the f32 program."""
    if compute_dtype is None:
        return "float32"
    import torch

    if isinstance(compute_dtype, torch.dtype):
        # the JAX package's names ("bfloat16", not "torch.bfloat16"), so
        # that both packages key one dtype alike in the one file format
        return str(compute_dtype).removeprefix("torch.")
    return getattr(compute_dtype, "__name__", str(compute_dtype))


def _fmt_dict(d: Dict[str, Any]) -> str:
    return ",".join(f"{k}={d[k]}" for k in sorted(d))


def timing_key(
    program: str, shape: Dict[str, Any], machine: Dict[str, Any]
) -> str:
    """The stable ledger/cache key:
    ``program@shape|backend=...,core_count=...,device_kind=...`` —
    human-readable, insensitive to dict order, and machine-scoped (the
    same program+shape measured on another box is a different row)."""
    parts = [program]
    if shape:
        parts.append("@" + _fmt_dict(shape))
    parts.append("|" + _fmt_dict(machine))
    return "".join(parts)


def _median(values: Sequence[float]) -> float:
    ordered = sorted(float(v) for v in values)
    n = len(ordered)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


@dataclass
class TimingRecord:
    """One measured configuration of one program on one machine.

    ``samples`` holds every timed trial's steps/s; the headline
    ``steps_per_sec`` is their MEDIAN (host times move run to run, so
    single trials are never trusted). ``occupancy`` / ``refill_events`` /
    ``queue_wait`` come from the device telemetry of the timed trials;
    ``compile_seconds`` and ``steady_compiles`` are the JAX package's
    compile accounting, kept so both packages read and write one file
    format."""

    program: str
    shape: Dict[str, Any] = field(default_factory=dict)
    machine: Dict[str, Any] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    samples: Tuple[float, ...] = ()
    occupancy: Optional[float] = None
    refill_events: Optional[int] = None
    queue_wait: Optional[int] = None
    compile_seconds: Optional[float] = None
    steady_compiles: int = 0
    pruned: Optional[str] = None  # analytic-pruning reason; None = timed

    @property
    def key(self) -> str:
        return timing_key(self.program, self.shape, self.machine)

    @property
    def steps_per_sec(self) -> float:
        return _median(self.samples)

    @property
    def timed(self) -> bool:
        return self.pruned is None and bool(self.samples)

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "program": self.program,
            "shape": dict(self.shape),
            "machine": dict(self.machine),
            "config": dict(self.config),
            "samples": [round(float(s), 2) for s in self.samples],
            "steps_per_sec": round(self.steps_per_sec, 2),
            "occupancy": (
                None if self.occupancy is None else round(self.occupancy, 4)
            ),
            "refill_events": self.refill_events,
            "queue_wait": self.queue_wait,
            "compile_seconds": (
                None
                if self.compile_seconds is None
                else round(self.compile_seconds, 4)
            ),
            "steady_compiles": self.steady_compiles,
            "pruned": self.pruned,
        }

    @classmethod
    def from_json(cls, data: dict) -> "TimingRecord":
        return cls(
            program=data["program"],
            shape=dict(data.get("shape") or {}),
            machine=dict(data.get("machine") or {}),
            config=dict(data.get("config") or {}),
            samples=tuple(data.get("samples") or ()),
            occupancy=data.get("occupancy"),
            refill_events=data.get("refill_events"),
            queue_wait=data.get("queue_wait"),
            compile_seconds=data.get("compile_seconds"),
            steady_compiles=int(data.get("steady_compiles") or 0),
            pruned=data.get("pruned"),
        )


class TimingLedger:
    """Process-wide registry of measured timings. Records
    append under ``(key, config)`` (one program+shape+machine holds MANY
    candidate configs — that is the whole point: the autotuner compares
    them); :meth:`best` ranks a key's timed configs by median steps/s."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: List[TimingRecord] = []

    def add(self, record: TimingRecord) -> TimingRecord:
        with self._lock:
            self._records.append(record)
        return record

    def records(
        self, program: Optional[str] = None, shape: Optional[Dict[str, Any]] = None
    ) -> List[TimingRecord]:
        with self._lock:
            out = list(self._records)
        if program is not None:
            out = [r for r in out if r.program == program]
        if shape is not None:
            out = [r for r in out if r.shape == shape]
        return out

    def best(
        self,
        program: str,
        shape: Optional[Dict[str, Any]] = None,
        *,
        min_occupancy: Optional[float] = None,
    ) -> Optional[TimingRecord]:
        """The highest-median-throughput TIMED record for a program (and
        optionally an exact shape), among candidates meeting
        ``min_occupancy`` — falling back to the unconstrained winner when
        none do (an occupancy floor must never select nothing)."""
        candidates = [r for r in self.records(program, shape) if r.timed]
        if not candidates:
            return None
        if min_occupancy is not None:
            eligible = [
                r
                for r in candidates
                if r.occupancy is not None and r.occupancy >= min_occupancy
            ]
            if eligible:
                candidates = eligible
        return max(candidates, key=lambda r: r.steps_per_sec)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def to_json(self) -> dict:
        return {"timings": [r.to_json() for r in self.records()]}

    def save(self, path) -> Path:
        path = Path(path)
        # atomic (temp + fsync + replace): a --timings-out dump killed
        # mid-write must not leave a truncated ledger
        _atomic_write_json(path, self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "TimingLedger":
        led = cls()
        with open(path) as f:
            data = json.load(f)
        for entry in data.get("timings", []):
            led.add(TimingRecord.from_json(entry))
        return led


#: the process-wide measured-timing ledger the autotuner feeds
timings = TimingLedger()


# ---------------------------------------------------------------------------
# the tuned-config cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TunedEntry:
    """One persisted winner: the knob values to use for ``group`` at
    ``shape`` on ``machine``, with the measurement evidence that chose
    them (so a later reader can judge whether the entry is still
    credible)."""

    group: str  # knob group: "refill", "compact", "host_pipeline", "mj"
    shape: Dict[str, Any]
    machine: Dict[str, Any]
    config: Dict[str, Any]
    evidence: Dict[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return timing_key(self.group, self.shape, self.machine)

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "group": self.group,
            "shape": dict(self.shape),
            "machine": dict(self.machine),
            "config": dict(self.config),
            "evidence": dict(self.evidence),
        }

    @classmethod
    def from_json(cls, data: dict) -> "TunedEntry":
        return cls(
            group=data["group"],
            shape=dict(data.get("shape") or {}),
            machine=dict(data.get("machine") or {}),
            config=dict(data.get("config") or {}),
            evidence=dict(data.get("evidence") or {}),
        )


def default_tuned_cache_path() -> Path:
    """``EVOTORCH_TUNED_CACHE`` overrides the cache file beside this
    module (the hook tests and multi-checkout setups use to isolate
    tuning)."""
    override = os.environ.get("EVOTORCH_TUNED_CACHE")
    if override:
        return Path(override)
    return Path(__file__).resolve().parent / "tuned_configs.json"


def canonical_env_label(env) -> str:
    """The env identity used in cache-entry shapes: the registry's own
    normalization for strings (``"Humanoid-v5"`` -> ``"humanoid"``, via
    ``envs.registry.canonical_env_key``), the class name folded the same
    way for live instances, so either spelling hits the same entry."""
    from ..envs.registry import canonical_env_key

    if not isinstance(env, str):
        return canonical_env_key(type(env).__name__)
    name = env
    if name.startswith("gym::"):
        name = name[len("gym::") :]
    return canonical_env_key(name)


_CACHE_LOCK = threading.Lock()
_CACHE: Optional[Dict[str, TunedEntry]] = None
_CACHE_PATH: Optional[Path] = None


def load_tuned_cache(path=None, *, force: bool = False) -> Dict[str, TunedEntry]:
    """The tuned-config cache as ``{key: TunedEntry}``. The DEFAULT path
    (``tuned_configs.json`` / ``EVOTORCH_TUNED_CACHE``) is memoized per
    process — eval setup consults it every construction, the file is
    checked in and small, and this process's own :func:`save_tuned_entry`
    calls refresh the memo; an external writer needs ``force=True`` (or a
    restart) to be seen. A path passed EXPLICITLY always reads the file
    fresh and never touches the memo."""
    global _CACHE, _CACHE_PATH
    target = Path(path) if path is not None else default_tuned_cache_path()
    memoizable = target == default_tuned_cache_path()
    with _CACHE_LOCK:
        if not force and memoizable and _CACHE is not None and _CACHE_PATH == target:
            return _CACHE
        entries: Dict[str, TunedEntry] = {}
        if target.exists():
            try:
                with open(target) as f:
                    data = json.load(f)
                for raw in data.get("entries", []):
                    entry = TunedEntry.from_json(raw)
                    entries[entry.key] = entry
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                # a corrupt cache must degrade to "no cache" (fallback
                # provenance), never break eval setup
                entries = {}
        if memoizable:
            _CACHE, _CACHE_PATH = entries, target
        return entries


def lookup_tuned(
    group: str,
    shape: Dict[str, Any],
    *,
    machine: Optional[Dict[str, Any]] = None,
    path=None,
) -> Optional[TunedEntry]:
    """The cache hit for ``(group, shape)`` on this machine (exact key
    match), or ``None``. A miss is normal — it just means the built-in
    fallback default applies (``tuned_config_source="fallback"``).

    Backward-compatible read of pre-mesh (version-1) caches: when the
    lookup shape says ``"mesh": "none"`` (an UNSHARDED evaluation) and the
    exact key misses, the lookup retries without the ``mesh`` field —
    legacy entries were all measured unsharded, so they keep serving
    unsharded consumers; a sharded lookup (any other mesh label) never
    falls back to them (a width tuned without a mesh says nothing about a
    sharded layout — ``parallel.mesh.mesh_label``)."""
    machine = machine if machine is not None else machine_fingerprint()
    cache = load_tuned_cache(path)
    entry = cache.get(timing_key(group, shape, machine))
    if entry is None and shape.get("mesh") == "none":
        legacy_shape = {k: v for k, v in shape.items() if k != "mesh"}
        entry = cache.get(timing_key(group, legacy_shape, machine))
    return entry


def save_tuned_entry(entry: TunedEntry, path=None) -> Path:
    """Persist one winner (last write per key wins) and refresh the
    in-process memo so the running process sees its own tuning. The write
    is ATOMIC AND DURABLE (per-pid temp file + fsync + rename, retried on
    transient IO errors): a writer killed mid-write, or two writers
    racing the read-modify-write, must not leave a truncated cache that
    silently downgrades every consumer to fallback."""
    target = Path(path) if path is not None else default_tuned_cache_path()
    entries = dict(load_tuned_cache(target, force=True))
    entries[entry.key] = entry
    payload = {
        # version 2: entry shapes carry a "mesh" label (parallel.mesh
        # .mesh_label). Version-1 entries (no mesh key) remain readable —
        # lookup_tuned serves them to unsharded ("mesh": "none") consumers
        "version": 2,
        "entries": [entries[k].to_json() for k in sorted(entries)],
    }
    _atomic_write_json(target, payload)
    load_tuned_cache(target, force=True)
    return target


def resolve_knobs(
    explicit: Dict[str, Any],
    group: str,
    shape: Dict[str, Any],
    *,
    machine: Optional[Dict[str, Any]] = None,
    path=None,
    use_cache: bool = True,
) -> Tuple[Dict[str, Any], str]:
    """THE precedence rule, shared by every consumer: returns
    ``(config, tuned_config_source)``.

    - any explicit knob (a non-``None`` value in ``explicit``) wins and
      the cache is not consulted at all — ``"override"``;
    - else a cache hit supplies the tuned config — ``"cache"``;
    - else the empty config: the caller's built-in default applies —
      ``"fallback"`` (also the forced branch under ``use_cache=False``)."""
    passed = {k: v for k, v in explicit.items() if v is not None}
    if passed:
        return passed, SOURCE_OVERRIDE
    if use_cache:
        entry = lookup_tuned(group, shape, machine=machine, path=path)
        if entry is not None:
            return dict(entry.config), SOURCE_CACHE
    return {}, SOURCE_FALLBACK
