"""The port's program ledger, inventory and report
(``evotorch_tpu_torch/observability/{programs,inventory,report}.py``; the
counterpart of ``tests/test_program_ledger.py``).

On the CPU a capture's counts are deterministic: ATen ops and FLOPs equal
run to run, so the gate against the checked-in ``ledger_baseline.json`` is
exact (tolerance 0), where the JAX package's rests on XLA's analyses.
"""

import copy
import json

import pytest
import torch

from evotorch_tpu_torch.envs import make_env
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
from evotorch_tpu_torch.neuroevolution.net.runningnorm import RunningNorm
from evotorch_tpu_torch.neuroevolution.net.vecrl import run_vectorized_rollout
from evotorch_tpu_torch.observability import report
from evotorch_tpu_torch.observability.inventory import GateConfig, capture_inventory, inventory_keys
from evotorch_tpu_torch.observability.programs import (
    GATED_FIELDS,
    ProgramLedger,
    compare_to_baseline,
    load_ledger_baseline,
    save_ledger_baseline,
    verify_no_input_mutation,
)


@pytest.fixture(scope="module")
def captured():
    """The whole inventory at the gate shapes, captured twice."""
    runs = []
    for _ in range(2):
        records, errors = capture_inventory(GateConfig(), ProgramLedger(), device="cpu")
        assert not errors
        runs.append(records)
    return runs


def test_op_counts_and_flops_repeat_exactly(captured):
    first, second = captured
    assert [r.key for r in first] == [r.key for r in second]
    for a, b in zip(first, second):
        assert (a.ops, a.control_steps, a.flops) == (b.ops, b.control_steps, b.flops), a.key
        assert a.peak_bytes is None and a.platform == "cpu"


def test_inventory_keys_match_the_capture(captured):
    keys = inventory_keys(GateConfig(), device="cpu")
    assert keys == [r.key for r in captured[0]] and len(set(keys)) == len(keys)
    names = {r.name for r in captured[0]}
    assert {"rollout.budget", "rollout.episodes", "rollout.episodes_refill", "rollout.episodes_compact.chunk"} <= names
    assert {"generation_step", "generation_step.trunk_delta", "training_span", "resident_program", "gaussian.tell"} <= names
    # no process group here: the sharded evaluator is not in the gate's inventory
    assert "sharded_evaluator" not in names


def test_no_registered_program_writes_its_inputs(captured):
    for record in captured[0]:
        assert record.donation.inputs > 0 and record.donation.verified is True, record.key
        assert record.first_use == 0 and record.compile_seconds == 0


@pytest.mark.parametrize("steps", [4, 8])
@pytest.mark.parametrize("hidden", [(8,), (16, 8)])
def test_mlp_rollout_flops_per_step(steps, hidden):
    """FLOPs a control step of the ``budget`` rollout are the policy's
    products: ``2 * lanes * sum(in * out)`` over its Linears."""
    env = make_env("cartpole", device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, list(hidden)))
    lanes = 8
    widths = [env.observation_size, *hidden, env.action_size]
    loop_stats = {}
    record = ProgramLedger().capture(
        "rollout.budget", run_vectorized_rollout, env, policy, torch.zeros((lanes, policy.parameter_count)),
        torch.Generator().manual_seed(0), RunningNorm(env.observation_size, device="cpu").stats,
        control_steps=lambda _: loop_stats["steps_issued"], eval_mode="budget", episode_length=steps, loop_stats=loop_stats,
    )  # fmt: skip
    assert record.control_steps == steps
    assert record.flops_per_step == 2 * lanes * sum(a * b for a, b in zip(widths, widths[1:]))


def test_input_mutation_check_flags_a_program_that_writes_its_input():
    x, y = torch.zeros(3), torch.ones(2)

    def writes(a, *, b):
        a.add_(1.0)
        return a + b.sum()

    out, report_ = verify_no_input_mutation(writes, (x,), {"b": y})
    assert report_.written == ("args[0]",) and report_.inputs == 2 and report_.verified is False
    _, clean = verify_no_input_mutation(lambda a, *, b: a + b.sum(), (x,), {"b": y})
    assert clean.written == () and clean.verified is True
    record = ProgramLedger().capture("writes", writes, x, b=y)
    assert record.donation.written == ("args[0]",)
    assert verify_no_input_mutation(lambda: 1.0)[1].verified is None


def test_gate_passes_against_the_checked_in_baseline(captured):
    violations, stale = compare_to_baseline(captured[0], load_ledger_baseline())
    assert violations == [] and stale == []
    assert load_ledger_baseline()["tolerance"] == 0.0


def test_gate_flags_growth_shrinkage_orphans_and_new_programs(captured):
    baseline = load_ledger_baseline()
    records = copy.deepcopy(captured[0])
    grown, shrunk = records[0], records[1]
    grown.ops += 1
    shrunk.flops = shrunk.flops * 0.5 if shrunk.flops else -1.0
    violations, stale = compare_to_baseline(records, baseline)
    assert len(violations) == 1 and grown.key in violations[0] and "ops_per_step" in violations[0]
    assert len(stale) == 1 and shrunk.key in stale[0] and "flops" in stale[0]
    # an orphaned baseline entry is stale; an unbaselined program a violation
    violations, stale = compare_to_baseline(captured[0][1:], baseline)
    assert violations == [] and stale == [f"{captured[0][0].key}: baseline entry for a program no longer captured"]
    unbaselined = dict(baseline, programs=baseline["programs"][1:])
    violations, stale = compare_to_baseline(captured[0], unbaselined)
    assert len(violations) == 1 and "not in ledger_baseline.json" in violations[0] and stale == []


def test_write_baseline_refuses_partial_captures(captured, tmp_path):
    keys = [r.key for r in captured[0]]
    with pytest.raises(ValueError, match="not captured"):
        save_ledger_baseline(captured[0][1:], tmp_path / "b.json", expected_keys=keys)
    incomplete = copy.deepcopy(captured[0])
    incomplete[2].flops = None
    with pytest.raises(ValueError, match="gated fields"):
        save_ledger_baseline(incomplete, tmp_path / "b.json", expected_keys=keys)
    path = save_ledger_baseline(captured[0], tmp_path / "b.json", expected_keys=keys)
    written = json.loads(path.read_text())
    assert written == load_ledger_baseline()  # the checked-in file is this capture's
    assert all(set(GATED_FIELDS) <= set(e) for e in written["programs"])


def test_report_cli(tmp_path, capsys, monkeypatch):
    assert report.main(["--device", "cpu", "--check", "--no-measure"]) == 0
    table = capsys.readouterr().out
    assert "rollout.budget@" in table and "ok(" in table
    baseline = tmp_path / "baseline.json"
    assert report.main(["--device", "cpu", "--write-baseline", "--baseline", str(baseline), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["device"] == "cpu" and payload["peak_flops"] is None
    assert set(payload["measured"]) == {"rollout.budget", "rollout.episodes", "rollout.episodes_refill"}
    assert json.loads(baseline.read_text()) == load_ledger_baseline()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert report.main(["--no-measure"]) != 0


def test_flagship_config_and_the_ceiling(monkeypatch):
    cfg = report.gate_config(flagship=True, episode_length=4)
    assert (cfg.env_name, cfg.popsize, cfg.episode_length, cfg.hidden, cfg.refill_width) == ("humanoid", 10_000, 4, (64, 64), 1_250)
    assert report.peak_flops("cuda") == 67e12 and report.peak_flops("cpu") is None
    monkeypatch.setenv("EVOTORCH_PEAK_FLOPS", "1e12")
    assert report.peak_flops("cpu") == 1e12
    record = ProgramLedger().capture("x", lambda a: a @ a, torch.ones(4, 4))
    rate, limit, eff = report.ceiling(record, {"steps_per_sec": 10.0, "steps_per_call": 4.0}, 128.0 * 100)
    assert (rate, limit, eff) == (10.0, 128.0 * 100 * 4.0 / 128.0, 10.0 / 400.0)
