"""The harness on the CPU at a tiny size: arguments, the result line, no
fallback without a card, and cells found by name from data files.

These drive ``harness.run_cell`` with ``device="cpu"``, which the command
line never does (it refuses to run without a card). The test marked
``cuda`` runs the command itself and skips without a card. Run:
``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, output  # noqa: E402
from perfbench import run as run_cli  # noqa: E402


#: every traffic mix, each under the flagship configuration: the two cells
#: and the ``episodes`` contract that no cell runs yet
MIXES = ["budget", "episodes", "episodes_refill"]


def mix_spec(traffic: str) -> dict:
    """The ``tinytraj_budget`` cell's spec under the traffic mix ``traffic``."""
    spec = harness.cell_spec("tinytraj_budget")
    with open(ROOT / "perfbench" / "traffic" / f"{traffic}.json") as f:
        spec["traffic"] = json.load(f)
    return spec


def tiny(spec, popsize: int = 8, steps: int = 10):
    """The cell at a size a test can hold: ``popsize`` solutions of
    ``steps``-step episodes, a refill width of a quarter of them."""
    spec = copy.deepcopy(spec)
    c = spec["config"]
    c.update(popsize=popsize, episode_length=steps, num_interactions=int(0.75 * popsize * steps), popsize_max=4 * popsize)
    if "refill_width" in spec["traffic"]:
        spec["traffic"]["refill_width"] = max(2, popsize // 4)
    return spec


def tiny_run(spec, *, trace=False, seconds=0.5, seed=2**31 + 7, **kw):
    return harness.run_cell(spec, seed=seed, seconds=seconds, trace=trace, t_start=time.perf_counter(), device="cpu", **kw)


def test_arguments():
    args = run_cli.parse_args(["--workload", "tinytraj_budget", "--seed", str(2**31 + 5), "--seconds", "40", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == ("tinytraj_budget", 2**31 + 5, 40.0, 1)
    for bad in (
        ["--workload", "tinytraj_budget", "--seconds", "40"],
        ["--workload", "tinytraj_budget", "--seed", "1", "--seconds", "0"],
        ["--workload", "tinytraj_budget", "--seed", "1", "--seconds", "4", "--trace", "2"],
    ):
        with pytest.raises(SystemExit):
            run_cli.parse_args(bad)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run_cli.main(["--workload", "tinytraj_budget", "--seed", "3", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_unknown_workload_is_refused(capsys):
    assert run_cli.main(["--workload", "no_such_cell", "--seed", "3", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("traffic", MIXES)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(traffic, trace):
    spec = tiny(mix_spec(traffic))
    result = tiny_run(spec, trace=trace)
    line = output.result_line(spec, result, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in spec["per_layer"]}
    else:
        names = {m["name"] for m in spec["end_to_end"]}
    # the CPU has no device trace: the trace's readers find nothing and are left out
    assert set(line["metrics"]) <= names
    assert set(line["metrics"]) >= ({"setup_s", "env_steps_per_s"} if not trace else {"searcher_share", "ctrl_step_ms"})
    for item in line["checks"].values():
        assert set(item) == {"value", "limit"}
    json.dumps(line)


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A new configuration, traffic mix and metric are new files and new
    entries in ``BENCHMARK.json``; no existing file changes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    config = json.loads((tmp_path / "perfbench/configs/humanoid_tinytraj_linear.json").read_text())
    config.update(name="humanoid_tinytraj_mlp32", hidden=[32, 32])
    (tmp_path / "perfbench/configs/humanoid_tinytraj_mlp32.json").write_text(json.dumps(config))
    (tmp_path / "perfbench/traffic/budget_short.json").write_text(json.dumps({"eval_mode": "budget", "why": "short"}))
    (tmp_path / "perfbench/metrics/rounds_in_window.py").write_text("def read(summary):\n    return float(summary['rounds'])\n")
    bench["configs"].append({"name": "humanoid_tinytraj_mlp32", "source": "x", "file": "perfbench/configs/humanoid_tinytraj_mlp32.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tinytraj_budget_mlp32", "config": "humanoid_tinytraj_mlp32", "traffic": "budget_short", "chips": 1, "why": "x"})
    bench["per_layer"].append(
        {"name": "rounds_in_window", "unit": "rounds", "better": "higher", "source": "program_counter", "layer": "search",
         "moves": "env_steps_per_s", "workloads": ["tinytraj_budget_mlp32"]}
    )  # fmt: skip
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.cell_spec("tinytraj_budget_mlp32", root=tmp_path)
    assert spec["config"]["hidden"] == [32, 32] and spec["traffic"]["eval_mode"] == "budget"
    assert [m["name"] for m in spec["per_layer"] if m["name"] == "rounds_in_window"]
    spec = tiny(spec)
    result = tiny_run(spec, trace=True)
    line = output.result_line(spec, result, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["rounds_in_window"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.cuda
def test_the_command_on_the_card(tmp_path):
    """The command as the benchmark runs it, a short window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "tinytraj_budget", "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
