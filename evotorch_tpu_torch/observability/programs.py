"""Program ledger: what one run of a program costs, and whether it leaves its
inputs alone (counterpart of ``evotorch_tpu/observability/programs.py``).

The JAX ledger lowers a jitted program once, without running it, and
records what XLA's analyses say: FLOPs, bytes accessed, peak bytes, compile
seconds and the donation map. Eager PyTorch has no program to lower, so the
port's ledger runs the program once on real inputs and records, per
``name@shape``:

- **dispatched ATen ops**, in all and per control step, counted by a
  ``TorchDispatchMode``: the port's proxy for kernel launches, since every
  op below autograd launches at least one kernel on the card (an eager
  control step launches ~2,700-2,900 at the flagship);
- **FLOPs**, by ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products; elementwise work counts 0);
- **peak bytes**: ``torch.cuda.max_memory_allocated`` over the run, after
  a garbage collection and a reset, less the bytes held before it
  (``None`` on the CPU);
- **launches of each port kernel** during the run, for the kernels that
  launched (the registry's ``kernel.<name>.launches`` counters);
- **capture seconds**: the run's wall time, with both counters on (they
  slow it down: never time through a capture);
- **first-use work** inside the run (kernel libraries built or loaded,
  allocator segments: :mod:`~evotorch_tpu_torch.analysis.retrace_sentinel`).

The JAX donation check becomes the port's own contract: a functional
program never changes its inputs in place (it returns new states, as the
JAX programs do under donation). :func:`verify_no_input_mutation` compares
the ``_version`` of every input tensor before and after a call, and a
:class:`DonationReport` names the inputs that were written. The JAX
``abstract_like`` has no counterpart: a capture needs real inputs.

The baseline workflow is the JAX package's, over ops per control step and
FLOPs: :func:`save_ledger_baseline` / :func:`load_ledger_baseline` /
:func:`compare_to_baseline`. Growth past the band is a violation;
shrinkage past it, or an entry whose program is no longer captured, is
stale; a program missing from the baseline is a violation; a partial
capture is refused. On the CPU both counts are deterministic, so the
checked-in ``ledger_baseline.json`` beside this module holds them exactly
(tolerance 0): ``python -m evotorch_tpu_torch.observability.report
--device cpu --write-baseline`` refreshes it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .registry import counters

__all__ = [
    "DEFAULT_TOLERANCE",
    "DonationReport",
    "GATED_FIELDS",
    "ProgramLedger",
    "ProgramRecord",
    "compare_to_baseline",
    "default_ledger_baseline_path",
    "kernel_launches",
    "ledger",
    "load_ledger_baseline",
    "program_key",
    "save_ledger_baseline",
    "verify_no_input_mutation",
]


class _OpCounter(TorchDispatchMode):
    """Counts every ATen op dispatched below autograd while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def kernel_launches() -> Dict[str, int]:
    """The port kernels' launches so far, by kernel: every
    ``kernel.<name>.launches`` counter of the registry, which each kernel's
    wrapper adds to at its launch (a kernel never launched has none). These
    are the wrapper's calls: a launch captured in a CUDA graph counts once,
    at the capture, and never at a replay of the graph."""
    prefix, suffix = "kernel.", ".launches"
    return {
        key[len(prefix) : -len(suffix)]: count
        for key, count in counters.snapshot().items()
        if key.startswith(prefix) and key.endswith(suffix)
    }


# ---------------------------------------------------------------------------
# the input-mutation check (the port's donation contract)
# ---------------------------------------------------------------------------


def _input_tensors(tree, path: str) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor in ``tree`` (tuples, lists, dicts, named tuples and
    dataclasses, walked), with its path. Other objects (an env, a policy, a
    generator) are not inputs a program could return anew, and are not
    walked."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = [(f"{path}[{k!r}]", v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f"{path}.{k}", getattr(tree, k)) for k in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"{path}[{i}]", v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f"{path}.{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        return []
    out = []
    for sub, value in items:
        out.extend(_input_tensors(value, sub))
    return out


@dataclass(frozen=True)
class DonationReport:
    """The input-mutation check of one run: how many input tensors were
    watched and the paths of those written in place."""

    inputs: int
    written: Tuple[str, ...]

    @property
    def verified(self) -> Optional[bool]:
        """True when no input was written; None when the program took no
        tensor (nothing to verify)."""
        if not self.inputs:
            return None
        return not self.written

    def to_json(self) -> dict:
        return {"inputs": self.inputs, "written": list(self.written), "verified": self.verified}


class _Watch:
    """The ``_version`` of every input tensor at the start of a run."""

    def __init__(self, args, kwargs):
        self.tensors = _input_tensors(tuple(args), "args") + _input_tensors(dict(kwargs), "kwargs")
        self.versions = [t._version for _, t in self.tensors]

    def report(self) -> DonationReport:
        written = tuple(p for (p, t), v in zip(self.tensors, self.versions) if t._version != v)
        return DonationReport(inputs=len(self.tensors), written=written)


def verify_no_input_mutation(fn: Callable, args: Sequence[Any] = (), kwargs: Optional[dict] = None):
    """Call ``fn(*args, **kwargs)`` and report which input tensors it wrote
    in place (their version counters moved). Returns ``(outputs,
    DonationReport)``."""
    kwargs = kwargs or {}
    watch = _Watch(args, kwargs)
    out = fn(*args, **kwargs)
    return out, watch.report()


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


@dataclass
class ProgramRecord:
    """What one run of one (program, shape) pair cost. ``peak_bytes`` is
    None on the CPU (no allocator to read); ``control_steps`` is the
    program's loop iterations (1 for a program without a loop);
    ``compile_seconds`` the seconds of the kernel libraries built or loaded
    during the run (0 in a warm process)."""

    name: str
    shape: Dict[str, Any] = field(default_factory=dict)
    platform: str = ""
    ops: int = 0
    control_steps: int = 1
    flops: Optional[float] = None
    peak_bytes: Optional[int] = None
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    capture_seconds: float = 0.0
    compile_seconds: float = 0.0
    first_use: int = 0
    donation: Optional[DonationReport] = None

    @property
    def key(self) -> str:
        return program_key(self.name, self.shape)

    @property
    def ops_per_step(self) -> float:
        return self.ops / max(1, self.control_steps)

    @property
    def flops_per_step(self) -> Optional[float]:
        return None if self.flops is None else self.flops / max(1, self.control_steps)

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "name": self.name,
            "shape": dict(self.shape),
            "platform": self.platform,
            "ops": self.ops,
            "control_steps": self.control_steps,
            "ops_per_step": self.ops_per_step,
            "flops": self.flops,
            "flops_per_step": self.flops_per_step,
            "peak_bytes": self.peak_bytes,
            "kernel_launches": dict(self.kernel_launches),
            "capture_seconds": round(self.capture_seconds, 4),
            "compile_seconds": round(self.compile_seconds, 4),
            "first_use": self.first_use,
            "donation": None if self.donation is None else self.donation.to_json(),
        }


def program_key(name: str, shape: Dict[str, Any]) -> str:
    """The stable ledger and baseline key: ``name@k1=v1,k2=v2`` with the
    shape sorted."""
    if not shape:
        return name
    return name + "@" + ",".join(f"{k}={shape[k]}" for k in sorted(shape))


def _device_of(tree) -> torch.device:
    tensors = _input_tensors(tree, "")
    return tensors[0][1].device if tensors else torch.device("cpu")


class ProgramLedger:
    """Registry of captured :class:`ProgramRecord`\\ s, keyed ``name@shape``.

    :meth:`capture` is the one entry point: run ``fn(*args, **kwargs)``
    once under the op and FLOP counters and the first-use sentinel, with
    the allocator's peak reset on the card, and record what it cost."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, ProgramRecord] = {}

    def capture(
        self,
        name: str,
        fn: Callable,
        *args,
        shape: Optional[Dict[str, Any]] = None,
        control_steps: Union[int, Callable[[Any], int]] = 1,
        device=None,
        **kwargs,
    ) -> ProgramRecord:
        """Run and record ``fn``. ``control_steps``: the program's loop
        iterations, an int or a function of its output (a rollout passes
        ``loop_stats`` and reads ``steps_issued`` back). ``device``: where
        it runs (default: that of its first input tensor)."""
        from torch.utils.flop_counter import FlopCounterMode

        from ..analysis.retrace_sentinel import track_first_use

        device = torch.device(device) if device is not None else _device_of((args, kwargs))
        cuda = device.type == "cuda"
        watch = _Watch(args, kwargs)
        held = 0
        if cuda:
            # garbage that a collection frees inside the run would take its
            # bytes off the memory held, and hide the run's own peak
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            # read after the reset: a block freed between the two reads
            # lowers this, never the peak, so the difference is >= 0
            held = torch.cuda.memory_allocated(device)
        launches0 = kernel_launches()
        built0 = counters.get("compile_seconds")
        flop_counter = FlopCounterMode(display=False)
        ops = _OpCounter()
        t0 = time.perf_counter()
        with track_first_use() as first_use:
            # the op counter innermost: it sees the ops as the program
            # issues them, before the FLOP counter decomposes any
            with flop_counter, ops:
                out = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches1 = kernel_launches()
        steps = control_steps(out) if callable(control_steps) else control_steps
        record = ProgramRecord(
            name=name,
            shape=dict(shape or {}),
            platform=device.type,
            ops=ops.count,
            control_steps=int(steps),
            flops=float(flop_counter.get_total_flops()),
            peak_bytes=int(torch.cuda.max_memory_allocated(device) - held) if cuda else None,
            kernel_launches={k: n - launches0.get(k, 0) for k, n in launches1.items() if n != launches0.get(k, 0)},
            capture_seconds=seconds,
            compile_seconds=counters.get("compile_seconds") - built0,
            first_use=first_use.count,
            donation=watch.report(),
        )
        with self._lock:
            self._records[record.key] = record
        return record

    def records(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records.values())

    def get(self, name: str, shape: Optional[Dict[str, Any]] = None) -> Optional[ProgramRecord]:
        with self._lock:
            return self._records.get(program_key(name, shape or {}))

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def to_json(self) -> dict:
        return {"programs": [r.to_json() for r in self.records()]}


#: the process-wide ledger
ledger = ProgramLedger()


# ---------------------------------------------------------------------------
# the regression baseline
# ---------------------------------------------------------------------------

#: fields the gate holds, when both sides have a number
GATED_FIELDS = ("ops_per_step", "flops")

#: the band: within [base * (1 - tol), base * (1 + tol)] passes; above is a
#: violation, below a stale entry. The CPU counts are deterministic, so the
#: port's gate is exact
DEFAULT_TOLERANCE = 0.0


def default_ledger_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "ledger_baseline.json"


def load_ledger_baseline(path=None) -> dict:
    path = Path(path) if path is not None else default_ledger_baseline_path()
    if not path.exists():
        return {"tolerance": DEFAULT_TOLERANCE, "platform": None, "programs": []}
    with open(path) as f:
        return json.load(f)


def save_ledger_baseline(
    records: Sequence[ProgramRecord],
    path=None,
    *,
    expected_keys: Optional[Sequence[str]] = None,
    tolerance: float = DEFAULT_TOLERANCE,
) -> Path:
    """Write the baseline from a capture run. With ``expected_keys`` (the
    whole inventory) every expected program must have been captured with
    every gated field: a baseline from a half-failed capture would shrink
    the gate's coverage unseen, so it is refused."""
    records = list(records)
    by_key = {r.key: r for r in records}
    if expected_keys is not None:
        missing = sorted(set(expected_keys) - set(by_key))
        if missing:
            raise ValueError(f"refusing to write a partial ledger baseline: programs not captured: {missing}")
        incomplete = sorted(k for k in expected_keys if any(getattr(by_key[k], f) is None for f in GATED_FIELDS))
        if incomplete:
            raise ValueError(
                f"refusing to write a partial ledger baseline: programs missing gated fields {GATED_FIELDS}: {incomplete}"
            )
    path = Path(path) if path is not None else default_ledger_baseline_path()
    platforms = sorted({r.platform for r in records})
    payload = {
        "tolerance": tolerance,
        "platform": platforms[0] if len(platforms) == 1 else platforms,
        "programs": [
            {"key": r.key, "ops": r.ops, "control_steps": r.control_steps, "ops_per_step": r.ops_per_step, "flops": r.flops}
            for r in sorted(records, key=lambda r: r.key)
        ],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def compare_to_baseline(records: Sequence[ProgramRecord], baseline: dict) -> Tuple[List[str], List[str]]:
    """The regression gate: ``(violations, stale)`` messages.

    - a captured program missing from the baseline, or a gated field that
      grew past the band, is a **violation**;
    - a baseline entry whose program is no longer captured, or a gated
      field that shrank past the band, is **stale**: the improvement
      refreshes the baseline in the same change."""
    tolerance = float(baseline.get("tolerance", DEFAULT_TOLERANCE))
    base_by_key = {e["key"]: e for e in baseline.get("programs", [])}
    rec_by_key = {r.key: r for r in records}
    violations: List[str] = []
    stale: List[str] = []
    for key, record in sorted(rec_by_key.items()):
        entry = base_by_key.get(key)
        if entry is None:
            violations.append(f"{key}: not in ledger_baseline.json (a new program); refresh the baseline (report --write-baseline)")
            continue
        for fieldname in GATED_FIELDS:
            base_value = entry.get(fieldname)
            if base_value is None:
                continue
            measured = getattr(record, fieldname)
            if measured is None:
                violations.append(f"{key}: {fieldname} regressed to unavailable (baseline {base_value:g})")
            elif measured > base_value * (1.0 + tolerance):
                violations.append(f"{key}: {fieldname} {measured:g} exceeds baseline {base_value:g} by more than {tolerance:.0%}")
            elif measured < base_value * (1.0 - tolerance):
                stale.append(
                    f"{key}: {fieldname} {measured:g} fell below baseline {base_value:g} by more than {tolerance:.0%};"
                    " refresh the baseline (report --write-baseline)"
                )
    for key in sorted(set(base_by_key) - set(rec_by_key)):
        stale.append(f"{key}: baseline entry for a program no longer captured")
    return violations, stale
