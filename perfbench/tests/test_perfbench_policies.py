"""A configuration that brings its own plain policy, added as files alone,
on the CPU at a tiny size.

The stateful policy here is the fixture ``fixtures/rnn_policy.py`` (an
Elman ``RNN(obs_length, 64) >> Linear(64, act_length)``, not the LSTM a
cell would run), with its configuration ``fixtures/humanoid_tinytraj_rnn64.json``,
both copied into a checkout made under ``tmp_path`` with cells of their own
in its ``BENCHMARK.json``. The tests hold the fixture to the port's
forward, run its cells under each contract, plant faults of the recurrent
state that each read ``correct`` false, and keep the linear
configuration's arguments, bias slot and operations as they were. The
state faults tap every step of the round (``capture.STEPS`` raised), so
that a step where an episode starts is always among those compared.
Run: ``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import json
import math
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import capture, harness, output  # noqa: E402
from perfbench.reference import policies  # noqa: E402
from perfbench.reference import rollout as ref_rollout  # noqa: E402
from perfbench.reference.mlp_policy import MLP  # noqa: E402
from perfbench.reference.physics import Humanoid  # noqa: E402
from perfbench.tests.test_perfbench_harness import MIXES, tiny, tiny_run  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
CONFIG = "humanoid_tinytraj_rnn64"
STEPS = 40


def _fixture_config() -> dict:
    config = json.loads((FIXTURES / f"{CONFIG}.json").read_text())
    return dict(config, reference_policy=str(FIXTURES / "rnn_policy.py"))


def _checkout(root: Path) -> dict:
    """A copy of the benchmark under ``root``; returns its spec."""
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def rnn_root(tmp_path_factory) -> Path:
    """A checkout with the recurrent configuration added as files: its
    policy under ``reference/``, its configuration, and a cell a mix."""
    root = tmp_path_factory.mktemp("bench")
    bench = _checkout(root)
    shutil.copy(FIXTURES / "rnn_policy.py", root / "perfbench/reference/rnn_policy.py")
    shutil.copy(FIXTURES / f"{CONFIG}.json", root / f"perfbench/configs/{CONFIG}.json")
    bench["configs"].append({"name": CONFIG, "source": "x", "file": f"perfbench/configs/{CONFIG}.json", "reduced": [], "why": "x"})
    for mix in MIXES:
        bench["workloads"].append({"name": f"rnn_{mix}", "config": CONFIG, "traffic": mix, "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _rnn_run(root: Path, traffic: str, **kw):
    """A tiny run of the fixture's cell; the search starts wide (radius 15,
    not 2.25), so that lanes fall and episodes start again inside the
    40-step round: with 2.25 the recurrent policy's Humanoid stands for 70
    steps or more."""
    spec = tiny(harness.cell_spec(f"rnn_{traffic}", root=root), popsize=16, steps=STEPS)
    spec["config"]["radius_init"] = 15.0
    spec["min_rounds"] = 2
    result = tiny_run(spec, seconds=0.2, **kw)
    return output.result_line(spec, result, trace=False), result


def _failing(line) -> set:
    return {name for name, item in line["checks"].items() if not item["value"] <= item["limit"]}


def test_the_fixture_is_the_ports_forward():
    """(a) The fixture's parameters are ``VecNE``'s, and its forward, state
    included, is the port's bit for bit over 3 steps."""
    from evotorch_tpu_torch.neuroevolution import VecNE

    config = _fixture_config()
    problem = VecNE("humanoid", config["network"], device="cpu", seed=1)
    env = Humanoid("cpu")
    policy = policies.make(config, env.observation_size, env.action_size)
    assert policy.parameter_count == problem.solution_length == 12_305
    assert policy.macs() == 64 * (109 + 64) + 17 * 64
    gen = torch.Generator().manual_seed(3)
    n = 8
    params = 0.3 * torch.randn((n, policy.parameter_count), generator=gen)
    port_state, state = None, policy.initial_state(n, "cpu")
    lanes = torch.arange(n)
    for _ in range(3):
        obs = torch.randn((n, env.observation_size), generator=gen)
        y_port, port_state = problem._policy(params, obs, port_state)
        y, state = policy(params, obs, state)
        assert torch.equal(y, y_port)
        got = capture._take_state(port_state, lanes)
        assert len(got) == len(state) == 1 and torch.equal(got[0], state[0])
        assert float(state[0].abs().max()) > 0


@pytest.mark.parametrize("eval_mode, refill", [("budget", None), ("episodes", None), ("episodes_refill", {"width": 4, "period": 1})])
def test_the_recurrent_rollout_equals_the_program_bit_for_bit(eval_mode, refill):
    """The reference's contract loops carry the state by the port's rule:
    a whole evaluation replays bit for bit."""
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.neuroevolution import VecNE

    config = _fixture_config()
    problem = VecNE(
        "humanoid", config["network"], observation_normalization=True, decrease_rewards_by=5.0, episode_length=STEPS,
        eval_mode=eval_mode, refill_config=refill, device="cpu", seed=5,
    )  # fmt: skip
    torch.manual_seed(0)
    values = 2.25 / math.sqrt(problem.solution_length) * torch.randn(8, problem.solution_length)
    batch = SolutionBatch(problem, values=values)
    state = problem.generator.get_state()
    stats = problem.obs_norm.stats
    problem.evaluate(batch)
    env = Humanoid("cpu")
    gen = torch.Generator()
    gen.set_state(state)
    out = ref_rollout.rollout(
        env, policies.make(config, env.observation_size, env.action_size), batch.values, gen,
        ref_rollout.Stats(stats.count, stats.sum, stats.sum_of_squares), contract=eval_mode, episode_length=STEPS,
        decrease_rewards_by=5.0, observation_normalization=True,
        refill_width=None if refill is None else refill["width"], refill_period=1,
    )  # fmt: skip
    assert torch.equal(batch.evals[:, 0], out.scores)
    assert torch.equal(problem.obs_norm.stats.sum, out.stats.sum)


@pytest.mark.parametrize("traffic", MIXES)
def test_a_recurrent_cell_added_as_files_is_correct(rnn_root, traffic, monkeypatch):
    """(b) The fixture's cell under each contract, every step of the kept
    round compared: ``correct``, and the fed state exactly the contract's."""
    monkeypatch.setattr(capture, "STEPS", 10_000)
    line, result = _rnn_run(rnn_root, traffic)
    assert line["correct"] is True, line["checks"]
    caps = result["kept"]["steps"]["captures"]
    assert len(caps) == len(result["kept"]["steps"]["rewards"]) > 1
    assert all(len(c["policy_states"]) == 1 and c["policy_states"][0].shape[1] == 64 for c in caps)
    assert result["step_parts"]["policy_state_fed"] == 0.0
    assert result["step_parts"]["policy_state"] <= 1e-5


def _state_not_reset(monkeypatch, traffic):
    """Where a lane starts an episode it keeps a stale state: ``budget``'s
    restarts keep the ended episode's, a refilled lane the last item's; one
    episode a solution starts only at the first step, from a stale 0.5."""
    from evotorch_tpu_torch.neuroevolution.net import vecrl

    if traffic == "budget":
        monkeypatch.setattr(vecrl, "reset_tensors", lambda states, mask: states)
    elif traffic == "episodes_refill":
        monkeypatch.setattr(vecrl, "_select_states", lambda mask, a, b: a)
    else:
        proto = vecrl._state_proto
        monkeypatch.setattr(vecrl, "_state_proto", lambda *a: vecrl.map_state(lambda x: x + 0.5, proto(*a)))


def _state_zeroed(monkeypatch, traffic):
    """The carry drops the state: every lane is fed zeros on every step."""
    from evotorch_tpu_torch.neuroevolution.net import vecrl

    monkeypatch.setattr(vecrl, "reset_tensors", lambda states, mask: vecrl.map_state(torch.zeros_like, states))
    monkeypatch.setattr(vecrl, "_select_states", lambda mask, a, b: vecrl.map_state(torch.zeros_like, a))


STATE_FAULTS = {"state_not_reset": _state_not_reset, "state_zeroed": _state_zeroed}


@pytest.mark.parametrize("fault", sorted(STATE_FAULTS))
@pytest.mark.parametrize("traffic", MIXES)
def test_a_planted_state_fault_is_not_correct(rnn_root, traffic, fault, monkeypatch):
    """(c) Each fault of the recurrent state reads ``correct`` false under
    each contract, on the fed state's term of ``step_gap``."""
    monkeypatch.setattr(capture, "STEPS", 10_000)
    STATE_FAULTS[fault](monkeypatch, traffic)
    line, result = _rnn_run(rnn_root, traffic)
    assert line["correct"] is False
    assert "step_gap" in _failing(line), line["checks"]
    assert result["step_parts"]["policy_state_fed"] == 1.0


@pytest.mark.parametrize("traffic", MIXES)
def test_the_recurrent_bf16_control_is_not_correct(rnn_root, traffic):
    """(c) The program's bfloat16 policy, its state in bfloat16 too."""
    line, result = _rnn_run(rnn_root, traffic, control=torch.bfloat16)
    assert line["correct"] is False
    assert "step_gap" in _failing(line)
    assert result["kept"]["steps"]["captures"][0]["new_policy_states"][0].dtype == torch.bfloat16
    assert result["step_parts"]["policy_state"] > 0


def test_the_linear_configuration_is_as_it_was():
    """(d) The linear configuration's network string, the warm-up's bias
    slot and the FLOPs ``gen_mfu`` counts, as before the loader; the MLP's
    string and slot at hidden widths too."""
    spec = harness.cell_spec("tinytraj_budget")
    config = spec["config"]
    assert "network" not in config and "reference_policy" not in config
    assert harness.program_kwargs(config, spec["traffic"])["problem"]["network"] == "Linear(obs_length, act_length)"
    policy = policies.make(config, 109, 17)
    assert isinstance(policy, MLP) and policy.layout == MLP([109, 17]).layout
    assert policy.parameter_count == 1_870
    assert policy.output_bias() == (0, 17)
    assert 2 * policy.macs() == 2 * 1_853
    assert policy.initial_state(4, "cpu") is None
    mlp = dict(config, hidden=[64, 64])
    assert policies.network(mlp) == "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
    assert policies.make(mlp, 109, 17).output_bias() == (109 * 64 + 64 + 64 * 64 + 64, 17)
    read = harness.reader("gen_mfu")
    summary = {"window_s": 40.0, "env_steps": 8_000_000, "policy_flops_per_step": 2 * policy.macs()}
    assert read(summary) == pytest.approx(100.0 * 3_706 * 8_000_000 / 40.0 / 67e12)


def test_a_configuration_the_reference_cannot_hold_is_refused(tmp_path):
    """(e) ``cell_spec`` refuses an env the reference lacks, naming those it
    has, and a policy file outside ``perfbench/reference/``."""
    bench = _checkout(tmp_path)
    config = json.loads((tmp_path / "perfbench/configs/humanoid_tinytraj_linear.json").read_text())
    for name, changes in (("ant", {"env": "ant"}), ("outside", {"reference_policy": "perfbench/tests/fixtures/rnn_policy.py"})):
        (tmp_path / f"perfbench/configs/{name}.json").write_text(json.dumps(dict(config, **changes)))
        bench["configs"].append({"name": name, "source": "x", "file": f"perfbench/configs/{name}.json", "reduced": [], "why": "x"})
        bench["workloads"].append({"name": f"cell_{name}", "config": name, "traffic": "budget", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="'humanoid'"):
        harness.cell_spec("cell_ant", root=tmp_path)
    with pytest.raises(ValueError, match="perfbench/reference/"):
        harness.cell_spec("cell_outside", root=tmp_path)
    assert harness.cell_spec("tinytraj_budget", root=tmp_path)["config"]["env"] == "humanoid"
