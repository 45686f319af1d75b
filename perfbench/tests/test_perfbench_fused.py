"""The reader of the program's env-step counters (``fused_env_step_share``:
the rigid-body env steps whose observation, reward and done the physics
kernel's epilogue produced): None where nothing was counted (a program
without the counters), and the share on a registry filled by hand. Run:
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

FUSED, EAGER = "env.step.fused", "env.step.eager"


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place."""
    reg = CounterRegistry()
    monkeypatch.setattr(observability, "counters", reg)
    return reg


def test_fused_reader_is_a_metric_of_the_linear_cells():
    """The two linear cells only: ``test_perfbench_lstm.py`` holds that the
    LSTM cell reports its own two metrics alone."""
    m = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}["fused_env_step_share"]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == ("program_counter", "ratio", "higher", "env_steps_per_s")
    assert m["layer"] == "control step: policy forward and Humanoid physics"
    assert m["workloads"] == ["tinytraj_budget", "tinytraj_refill"]


@pytest.mark.parametrize(
    "fused, eager, share",
    [(0, 0, None), (0, 200, 0.0), (197, 3, 0.985), (2_000_000, 1, 2_000_000 / 2_000_001), (40, 0, 1.0)],
)
def test_share_of_fused_env_steps(registry, fused, eager, share):
    registry.increment(FUSED, fused)
    registry.increment(EAGER, eager)
    registry.increment("kernel.rigid_body_step.launches", fused)
    read = harness.reader("fused_env_step_share")({})
    assert read == (None if share is None else pytest.approx(share))
