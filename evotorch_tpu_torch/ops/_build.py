"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds into ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``). A library is named by a hash of
its source and the flags, so an edited source is rebuilt and an unchanged one
is reused. ``build()`` starts one ``nvcc`` per source, all at once.

Every C entry point takes its pointers and the stream as ``void*`` (bound as
``ctypes.c_void_p``, so no pointer is cut to 32 bits) and returns
``cudaGetLastError()`` after its launch; :func:`check` raises when that is
not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "check", "library", "nvcc_command"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# The root of the checkout. An installed copy (the package data ships
# csrc/*.cu) would build beside the package in site-packages instead; only
# the checkout layout is exercised so far.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("symmetric_gaussian", "centered_rank")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of evotorch_tpu_torch need the CUDA toolkit")


def nvcc_command(source: Path, target: Path, extra: Iterable[str] = ()) -> list:
    """The ``nvcc`` command that builds ``source`` into the shared library
    ``target`` with the port's flags and ``extra`` ones."""
    return [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(target), str(source)]


def _library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None, *, verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, started together. With ``verbose`` every
    named source is compiled anew with ``-Xptxas -v`` and the compiler's
    report is returned per name. Raises ``RuntimeError`` if any build fails."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _library_path(name)
        if target.exists() and not verbose:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC_DIR / f"{name}.cu", tmp, ("-Xptxas", "-v") if verbose else ())
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    reports, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        reports[name] = output
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to its ``argtypes``; every function
    returns a ``cudaError_t`` as ``int``."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {status}")
