"""What nvcc made of the port's CUDA kernels: registers, spills and the SASS
instruction mix of each kernel.

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python3 -m evotorch_tpu_torch.ops.sass [--csrc DIR] [--out FILE]

Builds each ``DIR/*.cu`` (default: the port's ``csrc``) with the port's nvcc
flags and ``-Xptxas -v`` into a temporary directory, runs ``cuobjdump -sass``
on it and prints, per kernel, the ptxas report and the count of each SASS
opcode (the static instruction mix: a loop body counts once). ``--out`` also
writes the full SASS listing there, where the instructions of a loop body can
be counted per iteration. ``--csrc`` can point at another tree's sources, so
that two versions are compared in one run.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from . import _build

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?")
_FUNCTION = re.compile(r"Function : (\S+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return found


def sass_mix(listing: str):
    """{kernel: Counter(opcode -> count)} from a ``cuobjdump -sass`` listing."""
    mixes, current = {}, None
    for line in listing.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = mixes.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTRUCTION.search(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return mixes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(_build.CSRC_DIR))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    cuobjdump = _cuobjdump()
    listings = []
    with tempfile.TemporaryDirectory() as tmp:
        for source in sorted(Path(args.csrc).glob("*.cu")):
            lib = Path(tmp) / f"{source.stem}.so"
            cmd = _build.nvcc_command(source, lib, ("-Xptxas", "-v"))
            report = subprocess.run(cmd, capture_output=True, text=True, check=True)
            print(f"== {source} (ptxas -v)\n{(report.stdout + report.stderr).strip()}")
            listing = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
            listings.append(f"== {source}\n{listing}")
            for kernel, mix in sass_mix(listing).items():
                top = ", ".join(f"{op} {n}" for op, n in mix.most_common(16))
                print(f"-- {kernel}: {sum(mix.values())} SASS instructions: {top}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text("\n".join(listings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
