"""Durable run checkpoints: versioned bundles a SIGKILL cannot corrupt
(counterpart of ``evotorch_tpu/resilience/runstate.py``).

:mod:`evotorch_tpu_torch.checkpoint` pickles a whole searcher (its problem,
its state and its generators' states). A long run needs one durable
*bundle* per checkpoint interval carrying everything a resume needs (by
convention ``{"searcher": searcher, ...}``), the generation number, the
counter registry's snapshot, the git sha and a schema version, written so
that a crash at any instant leaves the directory loadable:

- **atomic**: the payload goes to a temporary file, is fsync'd, then
  moved into place with ``os.replace``;
- **self-verifying**: a fixed magic and the payload's SHA-256 lead the
  file, so a truncated or corrupted bundle is detected at load;
- **redundant**: keep-last-K retention (default 3), and
  :meth:`RunCheckpointer.load_latest` walks the bundles newest first,
  skipping invalid ones (counter ``checkpoint.corrupt_skipped``).

A searcher's pickle holds its generators' states, and every draw of a run
comes from them, so a killed and resumed run replays the uninterrupted one
bit for bit on the CPU (``tests/test_torch_resilience_services.py`` kills
one with SIGKILL).
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["BUNDLE_SCHEMA_VERSION", "CorruptBundleError", "RunCheckpointer"]

#: bumped when the payload layout changes incompatibly; loaders refuse
#: bundles of a newer schema
BUNDLE_SCHEMA_VERSION = 1

_MAGIC = b"EVTRUNB1"  # 8 bytes: format id and container version (the JAX package's)
_BUNDLE_RE = re.compile(r"^bundle_(\d{8})\.ckpt$")


class CorruptBundleError(RuntimeError):
    """A bundle failed its magic, digest or schema check."""


class RunCheckpointer:
    """Write and read durable run bundles in a directory.

    ``save(generation, state)`` persists one bundle (``state`` is any
    picklable dict); ``load_latest()`` returns ``(generation, state)`` of the
    newest valid bundle, or None. ``maybe_save`` saves on the ``every``
    cadence."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 1):
        if int(keep) < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if int(every) < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.every = int(every)
        os.makedirs(self.directory, exist_ok=True)

    def maybe_save(self, generation: int, state: Dict[str, Any]) -> Optional[str]:
        """``save`` when ``generation`` lands on the cadence, else None."""
        if int(generation) % self.every != 0:
            return None
        return self.save(generation, state)

    def save(self, generation: int, state: Dict[str, Any]) -> str:
        """Atomically persist one bundle; returns its path."""
        from ..observability.metricshub import _git_sha
        from ..observability.registry import counters

        payload = pickle.dumps(
            {
                "schema": BUNDLE_SCHEMA_VERSION,
                "generation": int(generation),
                "git_sha": _git_sha(),
                "registry": counters.snapshot(),
                "state": state,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        digest = hashlib.sha256(payload).digest()
        path = os.path.join(self.directory, f"bundle_{int(generation):08d}.ckpt")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(_MAGIC)
            fh.write(digest)
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        counters.increment("checkpoint.bundles_written")
        self._prune()
        return path

    def _prune(self) -> None:
        paths = self.bundle_paths()
        for path in paths[: max(0, len(paths) - self.keep)]:
            try:
                os.remove(path)
            except OSError:  # retention is best effort: an old bundle left behind is harmless
                pass

    def bundle_paths(self) -> List[str]:
        """The bundles present, oldest first (by generation)."""
        entries = []
        for name in os.listdir(self.directory):
            m = _BUNDLE_RE.match(name)
            if m:
                entries.append((int(m.group(1)), os.path.join(self.directory, name)))
        return [path for _, path in sorted(entries)]

    @staticmethod
    def read_bundle(path: str) -> Tuple[int, Dict[str, Any]]:
        """Verify and decode one bundle; raises :class:`CorruptBundleError`."""
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as exc:
            raise CorruptBundleError(f"unreadable bundle {path}: {exc}") from exc
        if len(blob) < len(_MAGIC) + 32 or not blob.startswith(_MAGIC):
            raise CorruptBundleError(f"{path} is not a run bundle (bad magic or truncated header)")
        digest = blob[len(_MAGIC) : len(_MAGIC) + 32]
        payload = blob[len(_MAGIC) + 32 :]
        if hashlib.sha256(payload).digest() != digest:
            raise CorruptBundleError(
                f"{path} failed its SHA-256 check (a truncated or corrupted write); an older bundle is safe to use"
            )
        try:
            record = pickle.load(io.BytesIO(payload))
        except Exception as exc:
            raise CorruptBundleError(f"{path} payload does not unpickle: {exc}") from exc
        schema = record.get("schema")
        if not isinstance(schema, int) or schema > BUNDLE_SCHEMA_VERSION:
            raise CorruptBundleError(f"{path} has bundle schema {schema!r}; this build reads <= {BUNDLE_SCHEMA_VERSION}")
        return int(record["generation"]), record["state"]

    def load_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The newest valid bundle's ``(generation, state)``, else None.
        Invalid bundles are skipped, newest first, each counted in
        ``checkpoint.corrupt_skipped``: a partial write by the crash that
        made the resume necessary is the expected case."""
        from ..observability.registry import counters

        for path in reversed(self.bundle_paths()):
            try:
                return self.read_bundle(path)
            except CorruptBundleError:  # counted; the next-newest bundle is the fallback
                counters.increment("checkpoint.corrupt_skipped")
        return None
