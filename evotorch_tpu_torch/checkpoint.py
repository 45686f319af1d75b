"""Checkpoint and resume (counterpart of ``evotorch_tpu/checkpoint.py``).

- ``save_state`` / ``load_state``: a functional state (``PGPEState`` with
  its ClipUp, Adam or SGD state, the optimizer states alone,
  ``CollectedStats``) through ``torch.save``. The JAX package stores
  through orbax, which is JAX-only. The file holds a flat dict of tensors
  named by their path in the state, nothing else, so ``torch.load`` reads
  it with ``weights_only=True`` and a loaded file runs no pickle code; the
  tensors are grafted into the fields of a template state, which gives
  the structure and the static fields (optimizer name, ranking method,
  ...), as the JAX package grafts restored leaves into its template.
- ``save_searcher`` / ``load_searcher``: a pickle of a whole OO searcher
  (problem, distribution, optimizer, counters, generators).

Both writers are crash-safe: the bytes go to a sibling tmp file, are
fsync'd and renamed into place, so a crash mid-write leaves the previous
checkpoint or none, never a truncated one.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Dict

import torch

__all__ = ["load_searcher", "load_state", "save_searcher", "save_state"]


def _tensors(state: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensor leaves of a (nested) dataclass state by their dotted path;
    other fields are static and ride in the template."""
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    if not dataclasses.is_dataclass(state):
        return {}
    out = {}
    for f in dataclasses.fields(state):
        out.update(_tensors(getattr(state, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    return out


def _graft(template: Any, leaf: Callable[[str, torch.Tensor], torch.Tensor], prefix: str = "") -> Any:
    """``template`` with each tensor leaf replaced by ``leaf(path, old)``."""
    if isinstance(template, torch.Tensor):
        return leaf(prefix, template)
    if not dataclasses.is_dataclass(template):
        return template
    return dataclasses.replace(
        template,
        **{
            f.name: _graft(getattr(template, f.name), leaf, f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(template)
        },
    )


def _write_atomically(path: str, write: Callable) -> str:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def save_state(path: str, state: Any) -> str:
    """Save a functional state's tensors (moved to the host) to ``path``."""
    flat = {name: t.detach().cpu() for name, t in _tensors(state).items()}
    return _write_atomically(os.path.abspath(path), lambda f: torch.save(flat, f))


def load_state(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_state` into ``template`` (a
    state of the same structure, e.g. a fresh one): every tensor must match
    the template's path, shape and dtype, and lands on the device of the
    template's tensor."""
    flat = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    expected = _tensors(template)
    if set(flat) != set(expected):
        raise ValueError(
            f"checkpoint {path!r} does not fit the template: it holds {sorted(flat)}, the template {sorted(expected)}"
        )

    def leaf(name: str, old: torch.Tensor) -> torch.Tensor:
        new = flat[name]
        if new.shape != old.shape or new.dtype != old.dtype:
            raise ValueError(
                f"checkpoint {path!r}: {name} is {new.dtype}{tuple(new.shape)}, the template's {old.dtype}{tuple(old.shape)}"
            )
        return new.to(old.device)

    return _graft(template, leaf)


def save_searcher(path: str, searcher) -> str:
    """Pickle a whole OO searcher to ``path``, crash-safe."""
    return _write_atomically(path, lambda f: pickle.dump(searcher, f))


def load_searcher(path: str):
    """A searcher saved by :func:`save_searcher`; its tensors and generators
    come back on the devices they were saved from."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError) as exc:
        raise RuntimeError(
            f"checkpoint {path!r} is corrupt or truncated ({exc}); it likely predates the crash-safe writer:"
            " delete it, or resume from an earlier checkpoint"
        ) from exc
