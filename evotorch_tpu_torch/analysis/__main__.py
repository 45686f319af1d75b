"""``python -m evotorch_tpu_torch.analysis``: run graftlint over the port
(counterpart of ``python -m evotorch_tpu.analysis``, with its flags and
exit codes).

Exit status: 0 when every finding is baselined (and no baseline entry is
stale), 1 otherwise, 2 for ``--write-baseline`` on a partial run.
``--write-baseline`` rewrites ``baseline.json`` from the current findings,
keeping the reasons of the entries it already had (burning the baseline
down is the intended direction).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .graftlint import (
    apply_baseline,
    default_baseline_path,
    load_baseline,
    run_lint,
    save_baseline,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m evotorch_tpu_torch.analysis",
        description="graftlint: static analysis of the port's eager PyTorch code",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to lint (default: the gated surface of the port)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help=f"baseline file (default: {default_baseline_path()})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from the current findings and exit 0",
    )
    parser.add_argument(
        "--checkers", type=str, default=None,
        help="comma-separated subset of checkers to run",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    checkers = args.checkers.split(",") if args.checkers else None
    findings = run_lint(args.paths or None, checkers=checkers)

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        if args.paths or checkers:
            # a restricted run sees only part of the linted surface; writing
            # it out would erase every baseline entry (and reason) outside it
            print(
                "--write-baseline requires a full run (no explicit paths, "
                "no --checkers): a partial rewrite would drop the rest of "
                "the baseline",
                file=sys.stderr,
            )
            return 2
        reasons = {}
        if baseline_path.exists():
            reasons = {e["signature"]: e.get("reason", "") for e in load_baseline(baseline_path)}
        save_baseline(baseline_path, findings, reasons=reasons)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    if args.no_baseline or not baseline_path.exists():
        new, stale = list(findings), []
    else:
        new, stale = apply_baseline(findings, load_baseline(baseline_path))
        if args.paths or checkers:
            # a restricted run cannot see the whole baselined surface, so
            # "stale" would be meaningless: only the full run enforces it
            stale = []

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.to_json() for f in new],
                    "baselined": len(findings) - len(new),
                    "stale_baseline": [e["signature"] for e in stale],
                }
            )
        )
    else:
        for f in new:
            print(f.format())
        for e in stale:
            print(f"STALE baseline entry (no longer found — remove it): {e['signature']}")
        n_base = len(findings) - len(new)
        print(
            f"graftlint: {len(new)} finding(s)"
            + (f", {n_base} baselined" if n_base else "")
            + (f", {len(stale)} stale baseline entr(y/ies)" if stale else ""),
            file=sys.stderr,
        )
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
