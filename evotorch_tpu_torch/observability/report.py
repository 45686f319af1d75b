"""Program-ledger report CLI (counterpart of
``evotorch_tpu/observability/report.py``).

``python -m evotorch_tpu_torch.observability.report`` captures the
registered programs (:mod:`~evotorch_tpu_torch.observability.inventory`)
and prints one row a program: ATen ops a control step and in all, control
steps, FLOPs, peak bytes, the port kernels' launches, capture seconds and
the input-mutation check; for the rollout contracts, measured env-steps/s
beside the FLOP-rate ceiling (the env-steps/s the program's FLOPs would
allow at the card's peak) and their ratio.

Modes:

- (default) capture at the gate shapes and print the table;
- ``--flagship``: the benchmark's shapes (Humanoid, ``BENCH_POPSIZE``,
  ``BENCH_EPISODE_LENGTH``; ``--episode-length`` cuts the steps);
- ``--check``: hold the capture against ``ledger_baseline.json`` (exit 1
  on violations or stale entries: the CLI form of the gate in
  ``tests/test_torch_program_ledger.py``);
- ``--write-baseline``: refresh the checked-in baseline (refuses partial
  captures). Run it with ``--device cpu``: the gate's counts are the
  CPU's.

It runs on the card unless given ``--device cpu``, and exits non-zero
without one. The ceiling's peak is the H100 SXM's published float32 rate
outside the tensor cores (67 TFLOP/s, NVIDIA's data sheet), for a run on
the card; ``EVOTORCH_PEAK_FLOPS`` overrides it, and a CPU run has none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace
from typing import Optional

from .inventory import GateConfig, capture_inventory, inventory_keys
from .programs import ProgramLedger, compare_to_baseline, load_ledger_baseline, save_ledger_baseline

#: the peak FLOP/s of the ceiling, by device type: the H100 SXM's float32
#: rate outside the tensor cores (NVIDIA's data sheet; the port's policy
#: forward runs in float32 unless given compute_dtype)
NOMINAL_PEAK_FLOPS = {"cuda": 67e12}


def peak_flops(platform: str) -> Optional[float]:
    override = os.environ.get("EVOTORCH_PEAK_FLOPS")
    if override:
        return float(override)
    return NOMINAL_PEAK_FLOPS.get(platform)


def gate_config(
    *, flagship: bool = False, env: Optional[str] = None, popsize: Optional[int] = None,
    episode_length: Optional[int] = None, hidden: Optional[str] = None,
) -> GateConfig:  # fmt: skip
    """The capture's shapes: the gate's, or with ``flagship`` the
    benchmark's (the ``BENCH_*`` knobs honored), then the overrides."""
    if flagship:
        base = GateConfig(
            env_name="humanoid",
            popsize=int(os.environ.get("BENCH_POPSIZE", 10_000)),
            episode_length=int(os.environ.get("BENCH_EPISODE_LENGTH", 200)),
            hidden=(64, 64),
            chunk_size=25,
        )
    else:
        base = GateConfig()
    overrides = {}
    if env is not None:
        overrides["env_name"] = env
    if popsize is not None:
        overrides["popsize"] = popsize
    if episode_length is not None:
        overrides["episode_length"] = episode_length
    if hidden is not None:
        overrides["hidden"] = tuple(int(h) for h in hidden.split(",") if h)
    cfg = replace(base, **overrides)
    if flagship:
        # the width of the effective popsize, so that the refill record's
        # width= label is the width it ran at
        cfg = replace(cfg, refill_width=max(1, cfg.popsize // 8))
    return cfg


def measure_rollouts(cfg: GateConfig, device, calls: int = 2) -> dict:
    """Measured env-steps/s of the ``budget``, ``episodes`` and
    ``episodes_refill`` rollouts at ``cfg``'s shapes: one warm-up call,
    then ``calls`` timed from a drained card to a drained card."""
    import torch

    from ..neuroevolution.net.runningnorm import RunningNorm
    from ..neuroevolution.net.vecrl import run_vectorized_rollout
    from .inventory import _env_policy

    env, policy = _env_policy(cfg.env_name, cfg.hidden, device)
    stats = RunningNorm(env.observation_size, device=device).stats
    params = torch.zeros((cfg.popsize, policy.parameter_count), dtype=torch.float32, device=device)
    measured = {}
    for mode, extra in (("budget", {}), ("episodes", {}), ("episodes_refill", {"refill_width": cfg.refill_width})):

        def once(seed):
            result = run_vectorized_rollout(
                env, policy, params, torch.Generator(device=device).manual_seed(seed), stats, num_episodes=1,
                episode_length=cfg.episode_length, eval_mode=mode, **extra,
            )  # fmt: skip
            return int(result.total_steps)

        once(0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        steps = sum(once(seed + 1) for seed in range(calls))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
        measured[f"rollout.{mode}"] = {
            "steps_per_call": steps / calls,
            "steps_per_sec": steps / elapsed,
            "calls_per_sec": calls / elapsed,
        }
    return measured


def _fmt(value, spec="{:g}") -> str:
    return "-" if value is None else spec.format(value)


def _mutation_cell(record) -> str:
    if record.donation is None or record.donation.verified is None:
        return "-"
    if record.donation.verified:
        return f"ok({record.donation.inputs})"
    return f"WRITTEN{list(record.donation.written)}"


def ceiling(record, measured: Optional[dict], peak: Optional[float]):
    """``(env-steps/s, ceiling, efficiency)`` of a measured rollout: the
    ceiling is the env-steps/s that the program's FLOPs a call allow at
    ``peak`` FLOP/s (None where any input is missing)."""
    if measured is None:
        return None, None, None
    rate = measured["steps_per_sec"]
    if peak is None or not record.flops:
        return rate, None, None
    limit = peak * measured["steps_per_call"] / record.flops
    return rate, limit, rate / limit


def print_table(records, measured: dict, peak: Optional[float], file=None) -> None:
    cols = (
        f"{'program':72s} {'ops/step':>9s} {'ops':>9s} {'steps':>6s} {'flops':>11s} {'peak_bytes':>11s}"
        f" {'launches':>9s} {'capture_s':>9s} {'inputs':>9s} {'steps/s':>11s} {'ceiling':>11s} {'eff':>8s}"
    )
    print(cols, file=file)
    print("-" * len(cols), file=file)
    for record in sorted(records, key=lambda r: r.key):
        rate, limit, eff = ceiling(record, measured.get(record.name), peak)
        launches = sum(record.kernel_launches.values())
        print(
            f"{record.key:72s} {record.ops_per_step:9.1f} {record.ops:9d} {record.control_steps:6d}"
            f" {_fmt(record.flops):>11s} {_fmt(record.peak_bytes):>11s} {launches:9d} {record.capture_seconds:9.3f}"
            f" {_mutation_cell(record):>9s} {_fmt(rate, '{:.1f}'):>11s} {_fmt(limit, '{:.4g}'):>11s}"
            f" {_fmt(eff, '{:.2e}'):>8s}",
            file=file,
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m evotorch_tpu_torch.observability.report",
        description="Program-ledger capture: ops, FLOPs, peak memory, kernel launches and the input-mutation check"
        " of every registered program, and the regression-baseline workflow.",
    )
    parser.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card; exits without one)")
    parser.add_argument("--flagship", action="store_true", help="benchmark shapes (Humanoid, BENCH_POPSIZE)")
    parser.add_argument("--env", default=None)
    parser.add_argument("--popsize", type=int, default=None)
    parser.add_argument("--episode-length", type=int, default=None)
    parser.add_argument("--hidden", default=None, help="comma list, e.g. 64,64")
    parser.add_argument("--json", action="store_true", help="print one JSON line instead of the table")
    parser.add_argument("--check", action="store_true", help="hold the capture against ledger_baseline.json; exit 1 on violations or stale entries")
    parser.add_argument("--write-baseline", action="store_true", help="refresh ledger_baseline.json (refuses partial captures)")
    parser.add_argument("--baseline", default=None, help="another baseline path")
    parser.add_argument("--no-measure", action="store_true", help="skip the timed rollouts (no steps/s or ceiling)")
    args = parser.parse_args(argv)

    from .._device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"report: {exc}", file=sys.stderr)
        return 2
    cfg = gate_config(
        flagship=args.flagship, env=args.env, popsize=args.popsize, episode_length=args.episode_length,
        hidden=args.hidden,
    )  # fmt: skip
    led = ProgramLedger()
    expected = inventory_keys(cfg, device=device)
    records, errors = capture_inventory(cfg, led, device=device, strict=False)
    for key, err in sorted(errors.items()):
        print(f"capture failed: {key}: {err}", file=sys.stderr)
    measured = measure_rollouts(cfg, device) if not (args.no_measure or args.flagship) else {}
    peak = peak_flops(device.type)
    if args.json:
        payload = led.to_json()
        payload.update(measured=measured, peak_flops=peak, device=str(device))
        print(json.dumps(payload))
    else:
        print_table(records, measured, peak)

    rc = 0
    if args.write_baseline:
        path = save_ledger_baseline(records, args.baseline, expected_keys=expected)
        print(f"wrote {len(records)} programs to {path}", file=sys.stderr)
    if args.check:
        baseline = load_ledger_baseline(args.baseline)
        if baseline.get("platform") not in (None, device.type):
            print(f"warning: the baseline's platform {baseline.get('platform')!r} is not this run's {device.type!r}", file=sys.stderr)
        violations, stale = compare_to_baseline(records, baseline)
        for message in violations:
            print(f"VIOLATION: {message}", file=sys.stderr)
        for message in stale:
            print(f"STALE: {message}", file=sys.stderr)
        if violations or stale:
            rc = 1
    if errors:
        rc = max(rc, 2)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
