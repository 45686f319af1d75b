"""The six readers of the program's span counters (``perfbench/spans.py``):
None where no control step was counted (a program without the spans), and
ms per control step on a registry filled by hand. Run:
``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import evotorch_tpu_torch.observability as observability  # noqa: E402
from evotorch_tpu_torch.observability import CounterRegistry  # noqa: E402
from perfbench import harness  # noqa: E402

CTRL = "span.rollout.ctrl_step"

#: each reader's counter of seconds and the span whose count divides it
READS = {
    "ctrl_step_host_ms": ("span.rollout.ctrl_step.seconds", CTRL),
    "policy_host_ms": ("span.rollout.policy.seconds", "span.rollout.policy"),
    "env_host_ms": ("span.rollout.env_step.seconds", "span.rollout.env_step"),
    "physics_host_ms": ("span.env.physics.seconds", "span.env.physics"),
    "contract_host_ms": ("span.rollout.ctrl_step.self_seconds", CTRL),
    "host_wait_ms": ("span.rollout.host_wait.seconds", CTRL),
}


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place."""
    reg = CounterRegistry()
    monkeypatch.setattr(observability, "counters", reg)
    return reg


def test_every_reader_is_a_metric_of_both_cells():
    names = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for name in READS:
        m = names[name]
        assert (m["source"], m["unit"], m["better"], m["moves"]) == ("program_counter", "ms", "lower", "env_steps_per_s")
        assert m["workloads"] == ["tinytraj_budget", "tinytraj_refill"]


@pytest.mark.parametrize("name", sorted(READS))
def test_no_control_step_reads_none(name, registry):
    read = harness.reader(name)
    assert read({}) is None
    seconds, per = READS[name]
    registry.accumulate(seconds, 1.5)
    registry.increment(per + ".count", 3)
    if per != CTRL:
        assert read({}) is None  # the span, but no control step


@pytest.mark.parametrize("name", sorted(READS))
def test_ms_per_control_step(name, registry):
    """40 control steps, of which the one where the profiler stopped is
    left out of the control step's and the env step's counts."""
    counts = {CTRL: 39, "span.rollout.policy": 40, "span.rollout.env_step": 39, "span.env.physics": 40}
    for span, n in counts.items():
        registry.increment(span + ".count", n)
    seconds, per = READS[name]
    registry.accumulate(seconds, 1.8)
    registry.accumulate("span.unrelated.seconds", 7.0)
    assert harness.reader(name)({}) == pytest.approx(1000.0 * 1.8 / counts[per])
