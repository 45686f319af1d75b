"""Deterministic fault injection (``EVOTORCH_FAULTS``; counterpart of
``evotorch_tpu/resilience/faults.py``, the same grammar and counting).

Recovery code that is never exercised is recovery code that does not work:
this module turns "hope the retry path is right" into tier-1 tests by
injecting *seeded, reproducible* faults at named host-side sites. The spec
grammar is a semicolon-separated list of entries::

    EVOTORCH_FAULTS="metricshub.write:raise@2;hostpool.worker:kill@1"

Each entry is ``site:kind@N[:arg]``:

``site``
    a dotted fault-site name; code declares sites by calling
    :func:`fault_point` (retry wrappers do it automatically, so every
    retried op is injectable for free).
``kind``
    ``raise``  — raise :class:`InjectedFault` (an ``OSError``, so IO retry
    paths catch it like a real one) at the matching invocation;
    ``sigkill`` — ``SIGKILL`` the current process (the subprocess
    crash-resume harness; nothing survives, by design);
    ``kill`` / ``nonfinite`` / any other word — *advisory*: the fired rule
    is RETURNED to the instrumented site, which interprets it (hostpool
    kills a worker, VecNE corrupts a seeded share of scores, ...).
``@N``
    fire at the N-th invocation of the site (1-based, counted per rule).
    ``@N+`` fires at every invocation from the N-th on.
``arg``
    optional payload (e.g. the score share for ``nonfinite``), kept as a
    string; :meth:`FaultRule.float_arg` parses the common case.

Counting is per-rule and process-local, so a spec fires at the same
invocation in every run — determinism is the point. Tests use
:func:`configure` directly instead of the environment variable.
"""

from __future__ import annotations

import os
import signal
import threading
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = [
    "InjectedFault",
    "FaultRule",
    "parse_spec",
    "configure",
    "active_spec",
    "fault_point",
]

_ENV_VAR = "EVOTORCH_FAULTS"


class InjectedFault(OSError):
    """A fault raised by the injection harness (never by real code)."""


@dataclass
class FaultRule:
    """One parsed ``site:kind@N[:arg]`` entry."""

    site: str
    kind: str
    at: int
    arg: Optional[str] = None
    sticky: bool = False  # "@N+": keep firing from the N-th invocation on
    count: int = field(default=0, repr=False)

    def float_arg(self, default: float) -> float:
        return default if self.arg is None else float(self.arg)


def parse_spec(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            head, at = entry.rsplit("@", 1)
            site, _, kind = head.rpartition(":")
            arg: Optional[str] = None
            if ":" in at:
                at, arg = at.split(":", 1)
            sticky = at.endswith("+")
            if sticky:
                at = at[:-1]
            if not site or not kind:
                raise ValueError(entry)
            rules.append(
                FaultRule(site=site, kind=kind, at=int(at), arg=arg, sticky=sticky)
            )
        except (ValueError, TypeError):
            raise ValueError(
                f"bad {_ENV_VAR} entry {entry!r}; expected 'site:kind@N[:arg]'"
            ) from None
    return rules


_lock = threading.Lock()
_rules: Optional[List[FaultRule]] = None  # None = not yet parsed from env


def configure(spec: Optional[str]) -> None:
    """(Re)configure injection from a spec string (tests), or None to
    re-read ``EVOTORCH_FAULTS`` lazily. Resets all per-rule counters."""
    global _rules
    with _lock:
        _rules = None if spec is None else parse_spec(spec)


def active_spec() -> List[FaultRule]:
    global _rules
    with _lock:
        if _rules is None:
            _rules = parse_spec(os.environ.get(_ENV_VAR, ""))
        return _rules


def fault_point(site: str) -> Optional[FaultRule]:
    """Declare one invocation of a named fault site.

    Counts the invocation against every rule for ``site``; a matching
    ``raise`` rule raises :class:`InjectedFault`, ``sigkill`` kills the
    process, and any other fired rule is returned for the caller to
    interpret (None otherwise — the overwhelmingly common, near-free path:
    no spec means one dict-free loop over an empty list).
    """
    rules = active_spec()
    if not rules:
        return None
    fired: Optional[FaultRule] = None
    with _lock:
        for rule in rules:
            if rule.site != site:
                continue
            rule.count += 1
            if rule.count == rule.at or (rule.sticky and rule.count > rule.at):
                fired = rule
                break
    if fired is None:
        return None
    from ..observability.registry import counters

    counters.increment(f"faults.fired.{site}.{fired.kind}")
    if fired.kind == "raise":
        raise InjectedFault(f"injected fault at {site} (invocation {fired.count})")
    if fired.kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    return fired
