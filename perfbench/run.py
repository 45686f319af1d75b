"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs a CUDA card (``torch.cuda``); it
exits with code 2 and prints no result without one. The last line of
standard output is the result (JSON); the numbers compared against the
reference, each beside its limit, are the last lines of standard error.
Exit codes: 0 a result was printed (``correct`` true or false), 2 no card or
a wrong argument, 3 a forbidden module was loaded (JAX, or the JAX package
``evotorch_tpu``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own kernels build into ``build/kernels``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    _cache_dirs(ROOT)
    # the checkout's root, not this folder, on the path: its module names
    # are the package's (perfbench.check, ...), never top-level ones
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness
    from perfbench.output import emit

    try:
        spec = harness.cell_spec(args.workload)
    except KeyError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {spec['chips']} CUDA device(s), found {have}; no result", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t_start=T_START)
    return emit(spec, result, trace=bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
