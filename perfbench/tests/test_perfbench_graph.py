"""The reader of the program's CUDA-graph counters (``graphed_step_share``):
None where no budget step was counted (a program without the counters),
and the replayed steps' share on a registry filled by hand. Run:
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

REPLAYED, EAGER = "rollout.graph.replayed_steps", "rollout.graph.eager_steps"


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place."""
    reg = CounterRegistry()
    monkeypatch.setattr(observability, "counters", reg)
    return reg


def test_reader_is_a_metric_of_the_linear_budget_cell():
    """The linear cell only: ``test_perfbench_lstm.py`` holds that the LSTM
    cell reports its own two metrics alone."""
    m = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}["graphed_step_share"]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == ("program_counter", "ratio", "higher", "env_steps_per_s")
    assert m["layer"] == "rollout scheduler: VecNE and vecrl contracts"
    assert m["workloads"] == ["tinytraj_budget"]


@pytest.mark.parametrize(
    "replayed, eager, share",
    [(0, 0, None), (0, 200, 0.0), (197, 3, 0.985), (7_997, 3, 0.999625), (40, 0, 1.0)],
)
def test_share_of_replayed_steps(registry, replayed, eager, share):
    registry.increment(REPLAYED, replayed)
    registry.increment(EAGER, eager)
    registry.increment("rollout.graph.captures", 1)
    read = harness.reader("graphed_step_share")({})
    assert read == (None if share is None else pytest.approx(share))
