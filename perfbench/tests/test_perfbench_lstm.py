"""The LSTM configuration (``configs/humanoid_tinytraj_lstm64.json``), its
plain policy (``reference/lstm_policy.py``), the cell ``tinytraj_lstm_budget``
and the cell's two metrics, on the CPU.

(a) The plain policy's parameters are ``VecNE``'s at the Humanoid's widths,
and its output bias is the port's slot. (b) Its forward, state included,
is the port's over 3 steps. (c) The configuration, its cell shrunk to a
tiny size in a checkout under ``tmp_path`` (``lstm_hidden`` 6), runs
through ``run_cell`` and reads ``correct``. (d) Planted faults each read
``correct`` false. (e) The metrics read None where the program counted
nothing, and the byte count is the cell's. Run:
``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import evotorch_tpu_torch.observability as observability  # noqa: E402
from evotorch_tpu_torch.observability import CounterRegistry  # noqa: E402
from perfbench import capture, harness, lstm_cell, output  # noqa: E402
from perfbench.reference import policies  # noqa: E402
from perfbench.tests.test_perfbench_harness import tiny, tiny_run  # noqa: E402

CELL = "tinytraj_lstm_budget"
CONFIG = ROOT / "perfbench" / "configs" / "humanoid_tinytraj_lstm64.json"
STEPS = 40
#: the Humanoid's observation and action sizes
OBS, ACT = 109, 17
#: the port takes one sigmoid over the four quarters of the pre-activation
#: and ``addcmul`` for ``f * c + i * g``, the reference a sigmoid per quarter
#: and a multiply and an add: the same arithmetic through other vector
#: paths of the CPU's kernels, which round apart by an ulp or two (2.4e-7
#: seen on values of order 1); the recurrence carries that over 3 steps.
#: 2e-6 is 16 ulps at 1, far under any fault of the cell's arithmetic.
ATOL = 2e-6


def _config(hidden: int = 64) -> dict:
    config = json.loads(CONFIG.read_text())
    config = dict(config, lstm_hidden=hidden, network=f"LSTM(obs_length, {hidden}) >> Linear({hidden}, act_length)")
    return policies.check_config(config)


def test_the_plain_policy_has_the_ports_parameters():
    """(a) 45,905 parameters at the Humanoid's widths, as ``VecNE`` counts
    them; the output layer's bias where the port's flat layout has it."""
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net

    config = _config()
    problem = VecNE("humanoid", config["network"], device="cpu", seed=1)
    policy = policies.make(config, OBS, ACT)
    assert (problem.env.observation_size, problem.env.action_size) == (OBS, ACT)
    assert policy.parameter_count == problem.solution_length == 45_905
    assert policy.macs() == 4 * 64 * (OBS + 64) + ACT * 64
    port = FlatParamsPolicy(str_to_net(config["network"], obs_length=OBS, act_length=ACT))
    (name, shape, offset), = [entry for entry in port.layout if entry[0].endswith("bias") and entry[1] == (ACT,)]
    assert policy.output_bias() == (offset, ACT) == (44_800, 17)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("hidden", [6, 64])
def test_the_plain_policy_is_the_ports_forward(hidden):
    """(b) On seeded random rows, the reference's ``(raw, (h, c))`` over 3
    steps, each fed the state the step before returned, against the port's
    ``str_to_net`` + ``FlatParamsPolicy`` forward (``ATOL``)."""
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net

    config = _config(hidden)
    policy = policies.make(config, OBS, ACT)
    port = FlatParamsPolicy(str_to_net(config["network"], obs_length=OBS, act_length=ACT))
    assert port.parameter_count == policy.parameter_count
    gen = torch.Generator().manual_seed(hidden)
    n = 8
    params = 0.3 * torch.randn((n, policy.parameter_count), generator=gen)
    port_state, state = None, policy.initial_state(n, "cpu")
    lanes = torch.arange(n)
    for _ in range(3):
        obs = torch.randn((n, OBS), generator=gen)
        y_port, port_state = port(params, obs, port_state)
        y, state = policy(params, obs, state)
        torch.testing.assert_close(y, y_port, rtol=0, atol=ATOL)
        got = capture._take_state(port_state, lanes)
        assert len(got) == len(state) == 2
        for a, b in zip(got, state):
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL)
        assert float(state[1].abs().max()) > 0.1


# ------------------------------------------------------------------ the cell


@pytest.fixture(scope="module")
def lstm_root(tmp_path_factory) -> Path:
    """A checkout of the benchmark whose LSTM configuration has a hidden
    size of 6 (the CPU's size; every other key as committed)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    config = json.loads(CONFIG.read_text())
    config.update(lstm_hidden=6, network="LSTM(obs_length, 6) >> Linear(6, act_length)")
    (root / "perfbench/configs" / CONFIG.name).write_text(json.dumps(config))
    return root


def _lstm_run(root: Path, *, trace=False, **kw):
    """A tiny run of the cell: 16 lanes of 40-step episodes, every step of
    the kept round compared; the search starts wide (radius 15), so that
    lanes fall and start again inside the round."""
    spec = tiny(harness.cell_spec(CELL, root=root), popsize=16, steps=STEPS)
    spec["config"]["radius_init"] = 15.0
    spec["min_rounds"] = 2
    result = tiny_run(spec, seconds=0.2, trace=trace, **kw)
    return output.result_line(spec, result, trace=trace), result


def _failing(line) -> set:
    return {name for name, item in line["checks"].items() if not item["value"] <= item["limit"]}


def test_the_cell_is_found_and_correct(lstm_root, monkeypatch):
    """(c) The cell under ``budget`` through ``run_cell``: ``correct``; the
    fed state exactly the contract's, some lane restarted inside the round."""
    monkeypatch.setattr(capture, "STEPS", 10_000)
    spec = harness.cell_spec(CELL, root=lstm_root)
    assert spec["traffic"]["eval_mode"] == "budget" and spec["config"]["lstm_hidden"] == 6
    assert [m["name"] for m in spec["per_layer"]] == ["lstm_cell_roofline", "lstm_cell_host_ms"]
    line, result = _lstm_run(lstm_root)
    assert line["correct"] is True, line["checks"]
    steps = result["kept"]["steps"]
    assert any(bool(d.any()) for d in steps["dones"][:-1])
    assert all(len(c["policy_states"]) == 2 for c in steps["captures"])
    assert result["step_parts"]["policy_state_fed"] == 0.0
    assert result["step_parts"]["policy_state"] <= 1e-5


def _c_not_reset(monkeypatch):
    """Where a lane's episode ends, ``h`` is zeroed and ``c`` kept."""
    from evotorch_tpu_torch.neuroevolution.net import vecrl

    original = vecrl.reset_tensors

    def reset_h_only(states, mask):
        (h, _), *rest = original(states, mask)
        return ((h, states[0][1]), *rest)

    monkeypatch.setattr(vecrl, "reset_tensors", reset_h_only)
    return "policy_state_fed"


def _i_f_swapped(monkeypatch):
    """The port's cell reads the input gate's quarter as the forget gate's
    and the other way round."""
    from evotorch_tpu_torch.neuroevolution.net.layers import LSTM

    original = LSTM._from_pre

    def swapped(self, pre, state):
        i, f, g, o = pre.chunk(4, dim=-1)
        return original(self, torch.cat([f, i, g, o], dim=-1), state)

    monkeypatch.setattr(LSTM, "_from_pre", swapped)
    return "policy_state"


FAULTS = {"c_not_reset": _c_not_reset, "i_f_swapped": _i_f_swapped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(lstm_root, fault, monkeypatch):
    """(d) ``c`` left unreset where an episode ends, and ``i`` and ``f``
    swapped, each read ``correct`` false on ``step_gap``'s state terms."""
    monkeypatch.setattr(capture, "STEPS", 10_000)
    part = FAULTS[fault](monkeypatch)
    line, result = _lstm_run(lstm_root)
    assert line["correct"] is False
    assert "step_gap" in _failing(line), line["checks"]
    assert result["step_parts"][part] > line["checks"]["step_gap"]["limit"]


def test_the_bf16_control_is_not_correct(lstm_root):
    """(d) The program's bfloat16 policy, its state in bfloat16 too."""
    line, result = _lstm_run(lstm_root, control=torch.bfloat16)
    assert line["correct"] is False
    assert "step_gap" in _failing(line)
    assert result["kept"]["steps"]["captures"][0]["new_policy_states"][0].dtype == torch.bfloat16


def test_a_traced_run_reads_the_cells_host_time(lstm_root):
    """A traced run on the CPU: the cell's span counted once a control step
    and its lanes, so ``lstm_cell_host_ms`` reads; the CPU has no card's
    clock, so ``lstm_cell_roofline`` is left out."""
    before = observability.counters.snapshot()
    line, _ = _lstm_run(lstm_root, trace=True)
    after = observability.counters.snapshot()

    def moved(key):
        return after.get(key, 0) - before.get(key, 0)

    assert line["correct"] is True
    calls = moved("span.policy.lstm_cell.count")
    assert calls == moved("span.rollout.policy.count") > 0
    assert moved("lstm.cell.lanes") == 16 * calls
    assert moved("span.policy.lstm_cell.device_seconds") == 0
    assert line["metrics"]["lstm_cell_host_ms"]["value"] > 0
    assert "lstm_cell_roofline" not in line["metrics"]


# ---------------------------------------------------------------- the metrics


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place."""
    reg = CounterRegistry()
    monkeypatch.setattr(observability, "counters", reg)
    return reg


def test_the_cells_bytes():
    """(e) 10,000 lanes at I = 109, H = 64: 44,800 float32 of gate weights
    and biases a lane, ``x``, ``h``, ``c`` read and ``h'``, ``c'``
    written."""
    assert lstm_cell.cell_bytes(10_000, OBS, 64) == 1_806_600_000
    assert lstm_cell.cell_bytes(1, OBS, 64) == 4 * (4 * 64 * (OBS + 64) + 8 * 64 + OBS + 4 * 64)


@pytest.mark.parametrize("name", ["lstm_cell_roofline", "lstm_cell_host_ms"])
def test_nothing_counted_reads_none(name, registry):
    """(e) Both metrics read None while the counters are 0."""
    assert harness.reader(name)({"trace": {"device_ops": {}}}) is None


def test_the_roofline_of_counted_work(registry):
    """The share from counters filled by hand: 10,000 lanes in 1.0786 ms of
    the card's time is half of the 0.5393 ms bound."""
    registry.accumulate(lstm_cell.DEVICE_SECONDS, 1.0786e-3)
    registry.increment(lstm_cell.LANES, 10_000)
    registry.observe_max(lstm_cell.INPUT_SIZE, OBS)
    registry.observe_max(lstm_cell.HIDDEN_SIZE, 64)
    read = harness.reader("lstm_cell_roofline")
    assert read({"trace": {"device_ops": {}}}) == pytest.approx(100.0 * 1_806_600_000 / 3.35e12 / 1.0786e-3)


def test_a_program_without_device_times_reads_none(registry, monkeypatch):
    """A program whose tracer has no ``resolve_device_seconds`` (the
    parent of these metrics) reads None and does not raise."""
    from evotorch_tpu_torch.observability import tracer

    registry.increment(lstm_cell.LANES, 10)
    monkeypatch.delattr(tracer, "resolve_device_seconds")
    assert lstm_cell.read_counters() is None
    assert harness.reader("lstm_cell_roofline")({"trace": {"device_ops": {}}}) is None


def test_the_metrics_are_the_new_cells_alone():
    """The two metrics list the new cell alone; no earlier metric lists it."""
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        mine = m["name"] in ("lstm_cell_roofline", "lstm_cell_host_ms")
        assert (CELL in m.get("workloads", [])) == mine, m["name"]
        if mine:
            assert (m["source"], m["moves"], m["workloads"]) == ("program_counter", "env_steps_per_s", [CELL])
