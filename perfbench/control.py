"""Readings of the correctness numbers on several seeds in one process: the
sound program's (the lower readings) or the control's (the upper ones).

    python3 perfbench/control.py --workload <name> --seeds <a,b,...> --seconds <s> [--control bf16]

Without ``--control`` each seed is a sound run of the cell at its own size.
With ``--control bf16`` the program's own lower precision is switched on
(``VecNE(compute_dtype=torch.bfloat16)``: the policy forward in bfloat16),
and each run also reads the numbers with the reference computed in
bfloat16 in the program's place: the ask, the bookkeeping, the
statistics' update and the tells. Every run also reads the tells of a
program whose tell leaves the distribution unchanged, planted in its own
data (``*.fault_unchanged_tell``); a sound run reads the kept round
replayed whole besides (``replay_*``, a diagnostic: bit for bit on the
CPU, chaotic on the card, whose physics kernel rounds otherwise).
``step_gap.policy_state`` and ``step_gap.policy_state_fed`` are
``step_gap``'s policy-state terms apart (0 for a stateless policy). One
JSON line per seed (with the run's set-up, rate and peak memory), then a
summary line with the largest and the smallest reading of each number.
The benchmark's own runs never run this; it needs a CUDA card.
``readings`` takes a cell's spec, as ``harness.cell_spec`` gives it, so a
spec made in memory is read the same way.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", choices=("bf16",), default=None)
    args = p.parse_args(argv)
    sys.path[:] = [q for q in sys.path if Path(q or ".").resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench: needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    readings(spec, [int(s) for s in args.seeds.split(",")], seconds=args.seconds, control=args.control)
    return 0


def readings(spec: dict, seeds, *, seconds: float, control=None) -> dict:
    """One JSON line per seed, then the summary line, for the cell
    ``spec``; returns the summary."""
    import torch

    from perfbench import check, harness

    config, traffic = spec["config"], spec["traffic"]
    dtype = torch.bfloat16 if control == "bf16" else None
    read = {}
    for seed in seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(spec, seed=seed, seconds=seconds, trace=False, t_start=t0, control=dtype)
        kept, gens, center0 = result["kept"], result["generations"], result["center0"]
        row = {name: item["value"] for name, item in result["checks"].items()}
        row.update({f"step_gap.{name}": v for name, v in result["step_parts"].items()})
        faults = check.unchanged_tell_readings(config, generations=gens, center0=center0)
        row.update({f"{name}.fault_unchanged_tell": v for name, v in faults.items()})
        if dtype is not None:
            controls = check.control_readings(config, traffic, kept=kept, generations=gens, center0=center0, dtype=dtype, seed=seed)
            row.update({f"{name}.reference_{control}": v for name, v in controls.items()})
        else:
            row.update(check.replay_round(kept, config, traffic, center0.device))
        for name, value in row.items():
            read.setdefault(name, []).append(value)
        summary = result["summary"]
        info = {
            "tells": summary["tells_checked"], "rounds": summary["rounds"], "run_s": time.perf_counter() - t0,
            "setup_s": summary["setup_s"], "env_steps_per_s": summary["env_steps"] / summary["window_s"],
            "memory_peak_bytes": summary["memory_peak_bytes"],
        }  # fmt: skip
        print(json.dumps({"seed": seed, "control": control, **info, "readings": row}), flush=True)
    summary = {name: {"max": max(v), "min": min(v), "n": len(v)} for name, v in read.items()}
    print(json.dumps({"workload": spec["name"], "control": control, "summary": summary}), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(main())
