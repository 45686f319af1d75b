"""A configuration that holds its population factored (``lowrank_rank``),
added as files alone, on the CPU at a tiny size.

The fixture ``fixtures/humanoid_tinytraj_lowrank.json`` (a tanh MLP of
``[16, 16]`` at rank 4 on the tinytraj recipe) is copied into a checkout
made under ``tmp_path`` with a cell a traffic mix in its ``BENCHMARK.json``.
The tests run its cells, plant faults of the factored path that each read
``correct`` false on their number, refuse a policy with no factored
forward and a rank that is not a whole number, hold the dense
configurations' arguments and compared numbers bit for bit to the values
read before the factored path existed, and count the low-rank yardstick by
hand. Run: ``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import check, factored, harness, output  # noqa: E402
from perfbench.tests.test_perfbench_harness import MIXES, tiny, tiny_run  # noqa: E402
from perfbench.tests.test_perfbench_policies import _checkout  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
CONFIG = "humanoid_tinytraj_lowrank"
POPSIZE, STEPS = 16, 20


@pytest.fixture(scope="module")
def lowrank_root(tmp_path_factory) -> Path:
    """A checkout with the factored configuration added as files: its
    configuration and a cell a mix."""
    root = tmp_path_factory.mktemp("bench")
    bench = _checkout(root)
    (root / f"perfbench/configs/{CONFIG}.json").write_bytes((FIXTURES / f"{CONFIG}.json").read_bytes())
    bench["configs"].append({"name": CONFIG, "source": "x", "file": f"perfbench/configs/{CONFIG}.json", "reduced": [], "why": "x"})
    for mix in MIXES:
        bench["workloads"].append({"name": f"lowrank_{mix}", "config": CONFIG, "traffic": mix, "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _spec(root: Path, traffic: str, *, rounds_a_generation: int = 1) -> dict:
    """The fixture's cell at the tiny size, a window of four rounds; with
    ``rounds_a_generation`` the budget asks for that many rounds a
    generation at least."""
    spec = tiny(harness.cell_spec(f"lowrank_{traffic}", root=root), popsize=POPSIZE, steps=STEPS)
    spec["min_rounds"] = 4
    if rounds_a_generation > 1:
        spec["config"]["num_interactions"] = (rounds_a_generation - 1) * POPSIZE * STEPS
    return spec


def _run(spec, **kw):
    result = tiny_run(spec, seconds=1e-6, **kw)
    return output.result_line(spec, result, trace=kw.get("trace", False)), result


def _failing(line) -> set:
    return {name for name, item in line["checks"].items() if not item["value"] <= item["limit"]}


@pytest.mark.parametrize("traffic", MIXES)
def test_a_factored_cell_added_as_files_is_correct(lowrank_root, traffic, monkeypatch):
    """The fixture's cell under each contract: ``correct``, and the
    population held factored throughout (the program never materializes
    it)."""
    from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch

    densified = []
    materialize = LowRankParamsBatch.materialize
    monkeypatch.setattr(LowRankParamsBatch, "materialize", lambda self: densified.append(self.popsize) or materialize(self))
    spec = _spec(lowrank_root, traffic)
    assert harness.program_kwargs(spec["config"], spec["traffic"])["searcher"]["lowrank_rank"] == 4
    line, result = _run(spec)
    assert line["correct"] is True, line["checks"]
    assert isinstance(result["kept"]["values"], LowRankParamsBatch)
    assert all(isinstance(v, LowRankParamsBatch) for g in result["generations"].values() for v in g["values"])
    assert result["summary"]["tells_checked"] >= 2
    assert not densified


def test_a_factored_trace_counts_no_sampling_kernel(lowrank_root):
    """A factored ask launches no sampling kernel: the traced round records
    no sampler shape, and the operations a step are the low-rank path's."""
    spec = _spec(lowrank_root, "budget")
    line, result = _run(spec, trace=True)
    assert line["correct"] is True
    assert result["summary"]["trace"]["sampling_shapes"] == []
    assert harness.reader("sampling_roofline", lowrank_root)(result["summary"]) is None
    assert result["summary"]["policy_flops_per_step"] == factored.lowrank_forward_flops([109, 16, 16, 17], 4, 1)


def _drop_basis(monkeypatch):
    """The forward keeps the center's product and drops the basis's."""
    from evotorch_tpu_torch.neuroevolution.net import lowrank

    monkeypatch.setattr(lowrank, "_lane_combine", lambda y_aug, z, out: y_aug[:, :out])


def _pair_not_negated(monkeypatch):
    """The last antithetic pair's ``-z`` row is ``+z``."""
    from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian

    original = SymmetricSeparableGaussian._sample_lowrank

    def altered(cls, *args, **kwargs):
        out = original(*args, **kwargs)
        coeffs = out.coeffs.clone()
        coeffs[-1] = -coeffs[-1]
        return out._replace(coeffs=coeffs)

    monkeypatch.setattr(SymmetricSeparableGaussian, "_sample_lowrank", classmethod(altered))


def _basis_redrawn(monkeypatch):
    """A generation's later rounds draw a fresh basis and write it into the
    shared one."""
    from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian

    original = SymmetricSeparableGaussian._sample_lowrank

    def redrawn(cls, generator, parameters, num_solutions, rank, basis=None):
        out = original(generator, parameters, num_solutions, rank, None)
        if basis is None:
            return out
        basis.copy_(out.basis)
        return out._replace(basis=basis)

    monkeypatch.setattr(SymmetricSeparableGaussian, "_sample_lowrank", classmethod(redrawn))


def _gradients(monkeypatch, change):
    from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian

    original = SymmetricSeparableGaussian._compute_gradients_lowrank
    monkeypatch.setattr(SymmetricSeparableGaussian, "_compute_gradients_lowrank", classmethod(lambda cls, *a: change(original, *a)))


def _gradient_doubled(monkeypatch):
    """The tell's gradients doubled. ClipUp steps the center along the
    gradient's direction, whatever its length, so only the stdev moves
    otherwise."""
    _gradients(monkeypatch, lambda original, *a: {k: 2 * v for k, v in original(*a).items()})


def _center_gradient_reversed(monkeypatch):
    """The tell reads each pair's ``-z`` coefficients for its ``+z``."""
    _gradients(monkeypatch, lambda original, params, samples, *a: original(params, samples._replace(coeffs=-samples.coeffs), *a))


#: each fault, the mix it is planted under, and the number that fails it
FAULTS = {
    "drop_basis": (_drop_basis, "budget", "step_gap"),
    "pair_not_negated": (_pair_not_negated, "budget", "ask_gap"),
    "basis_redrawn": (_basis_redrawn, "episodes_refill", "draws_gap"),
    "gradient_doubled": (_gradient_doubled, "budget", "stdev_gap"),
    "center_gradient_reversed": (_center_gradient_reversed, "budget", "center_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_factored_fault_is_not_correct(lowrank_root, fault, monkeypatch):
    plant, traffic, number = FAULTS[fault]
    plant(monkeypatch)
    spec = _spec(lowrank_root, traffic, rounds_a_generation=3)
    line, result = _run(spec)
    assert line["correct"] is False
    assert number in _failing(line), line["checks"]
    assert len(result["generations"][1]["values"]) >= 2  # a generation of several rounds


def test_generations_of_several_rounds_share_one_basis(lowrank_root):
    """With several rounds a generation the later rounds draw coefficients
    only, and a sound run is ``correct``."""
    spec = _spec(lowrank_root, "episodes_refill", rounds_a_generation=3)
    line, result = _run(spec)
    assert line["correct"] is True, line["checks"]
    first = result["generations"][1]["values"]
    assert len(first) >= 2 and all(v.basis is first[0].basis for v in first)


@pytest.mark.parametrize("traffic", MIXES)
def test_the_factored_bf16_control_is_not_correct(lowrank_root, traffic):
    """The program's bfloat16 forward (center, basis and coefficients cast)
    fails ``step_gap``; the reference in bfloat16 in the program's place
    fails the ask's; the kept round replays whole from its rows."""
    spec = _spec(lowrank_root, traffic)
    line, result = _run(spec, control=torch.bfloat16)
    assert line["correct"] is False
    assert "step_gap" in _failing(line), line["checks"]
    kw = dict(kept=result["kept"], generations=result["generations"], center0=result["center0"])
    controls = check.control_readings(spec["config"], spec["traffic"], dtype=torch.bfloat16, seed=5, **kw)
    assert controls["ask_gap"] > spec["config"]["limits"]["ask_gap"]
    replay = check.replay_round(result["kept"], spec["config"], spec["traffic"], "cpu")
    assert replay["replay_steps_gap"] == 0.0


def test_a_policy_without_a_factored_path_is_refused(lowrank_root, monkeypatch):
    """A network with no structured factored forward under ``lowrank_rank``
    falls back to the dense population in the warm-up, which is an error:
    the window never opens."""
    spec = _spec(lowrank_root, "budget")
    spec["config"]["network"] = "FeedForwardNet(obs_length, [[16, Tanh()], [16, Tanh()], [act_length, None]])"
    steps = []
    monkeypatch.setattr(harness.Recorder, "step", lambda self: steps.append(1))
    with pytest.raises(UserWarning, match="fell back to materializing"):
        tiny_run(spec, seconds=1e-6)
    assert not steps


@pytest.mark.parametrize("rank", [0, -2, 2.5, "4", True, None])
def test_lowrank_rank_must_be_a_whole_number(rank):
    config = dict(json.loads((FIXTURES / f"{CONFIG}.json").read_text()), lowrank_rank=rank)
    with pytest.raises(ValueError, match="lowrank_rank"):
        harness.policies.check_config(config)


# ------------------------------------------- the dense configurations, as before

#: ``program_kwargs`` of the dense cells, as they read before ``lowrank_rank``
_SEARCHER = {
    "popsize": 10000, "popsize_max": 80000, "num_interactions": 1500000, "center_learning_rate": 0.1125,
    "stdev_learning_rate": 0.1, "radius_init": 2.25, "stdev_max_change": 0.2, "optimizer": "clipup",
    "optimizer_config": {"max_speed": 0.15, "momentum": 0.9}, "ranking_method": "centered",
}  # fmt: skip
_PROBLEM = {"env": "humanoid", "observation_normalization": True, "decrease_rewards_by": 5.0, "episode_length": 200}
PINNED_KWARGS = {
    "tinytraj_budget": {
        "problem": dict(_PROBLEM, network="Linear(obs_length, act_length)", eval_mode="budget", refill_config=None),
        "searcher": _SEARCHER, "warmup_solutions": 10000,
    },
    "tinytraj_refill": {
        "problem": dict(_PROBLEM, network="Linear(obs_length, act_length)", eval_mode="episodes_refill", refill_config={"width": 2048, "period": 1}),
        "searcher": _SEARCHER, "warmup_solutions": 2048,
    },
    "tinytraj_lstm_budget": {
        "problem": dict(_PROBLEM, network="LSTM(obs_length, 64) >> Linear(64, act_length)", eval_mode="budget", refill_config=None),
        "searcher": _SEARCHER, "warmup_solutions": 10000,
    },
}  # fmt: skip

#: the compared numbers (``float.hex``) of a tiny run (16 solutions, 20
#: steps, four rounds, seed 2**31 + 11) of each dense cell's configuration
#: under a mix, read before ``lowrank_rank``
PINNED_CHECKS = {
    ("tinytraj_budget", "budget"): {
        "start_gap": "0x0.0p+0", "center_gap": "0x1.0f1988ff819f6p-23", "stdev_gap": "0x1.5bcf604fcbbccp-19",
        "ask_gap": "0x1.c68f1432c4b1ep-21", "draws_gap": "0x0.0p+0", "tally_gap": "0x1.413c8dd7b716ap-23",
        "steps_gap": "0x0.0p+0", "step_gap": "0x0.0p+0", "stats_gap": "0x1.cc2c973f8d230p-21", "rounds_gap": "0x0.0p+0",
    },
    ("tinytraj_budget", "episodes"): {
        "start_gap": "0x0.0p+0", "center_gap": "0x1.bad61c4c743c9p-24", "stdev_gap": "0x1.1ef9d2f268f7fp-19",
        "ask_gap": "0x1.10c60ebdaf3efp-20", "draws_gap": "0x0.0p+0", "tally_gap": "0x1.185c6ce1dae2ap-23",
        "steps_gap": "0x0.0p+0", "step_gap": "0x0.0p+0", "stats_gap": "0x1.d000000000000p-19", "rounds_gap": "0x0.0p+0",
    },
    ("tinytraj_budget", "episodes_refill"): {
        "start_gap": "0x0.0p+0", "center_gap": "0x1.bbef49ad70081p-24", "stdev_gap": "0x1.f2a654849fe75p-20",
        "ask_gap": "0x1.e07c7d0b8dc80p-21", "draws_gap": "0x0.0p+0", "tally_gap": "0x1.7e29ab96581e0p-24",
        "steps_gap": "0x0.0p+0", "step_gap": "0x0.0p+0", "stats_gap": "0x1.2ec664a99a135p-21", "rounds_gap": "0x0.0p+0",
    },
    ("tinytraj_lstm_budget", "budget"): {
        "start_gap": "0x0.0p+0", "center_gap": "0x1.3570d1011ad64p-22", "stdev_gap": "0x1.afbf10d9cbf19p-19",
        "ask_gap": "0x1.4fda4f7195d4cp-20", "draws_gap": "0x0.0p+0", "tally_gap": "0x0.0p+0",
        "steps_gap": "0x0.0p+0", "step_gap": "0x1.33fd5341a20e3p-17", "stats_gap": "0x1.1800000000000p-21", "rounds_gap": "0x0.0p+0",
    },
}  # fmt: skip


@pytest.mark.parametrize("cell", sorted(PINNED_KWARGS))
def test_a_dense_configurations_arguments_are_as_before(cell):
    spec = harness.cell_spec(cell)
    assert harness.program_kwargs(spec["config"], spec["traffic"]) == PINNED_KWARGS[cell]


@pytest.mark.parametrize("cell, traffic", sorted(PINNED_CHECKS))
def test_a_dense_configurations_numbers_are_as_before(cell, traffic):
    """The program's calls and draws and every compared number, bit for
    bit; the operations a step are ``2 * macs()``."""
    spec = harness.cell_spec(cell)
    with open(harness.ROOT / "perfbench" / "traffic" / f"{traffic}.json") as f:
        spec["traffic"] = json.load(f)
    spec = tiny(spec, popsize=POPSIZE, steps=STEPS)
    spec["min_rounds"] = 4
    result = harness.run_cell(spec, seed=2**31 + 11, seconds=1e-6, trace=False, t_start=time.perf_counter(), device="cpu")
    assert {k: v["value"].hex() for k, v in result["checks"].items()} == PINNED_CHECKS[(cell, traffic)]
    assert result["summary"]["rounds"] == 4
    assert result["summary"]["policy_flops_per_step"] == {"tinytraj_budget": 3_706, "tinytraj_lstm_budget": 90_752}[cell]


# ----------------------------------------------------------- the yardstick


def test_the_lowrank_yardstick_by_hand():
    """One layer 3 -> 2 at rank 2 on 5 lanes, counted by hand: the product
    ``5 x 3 x (3 x 2)`` and the combination ``5 x (3 x 2)`` multiply-adds;
    the augmented weight ``6 x 3`` and bias ``6`` once, per lane ``x`` 3,
    ``y_aug`` 6 twice, ``z`` 2 and ``y`` 2."""
    assert factored.lowrank_forward_flops([3, 2], 2, 5) == 2 * (5 * 3 * 6 + 5 * 6)
    assert factored.lowrank_forward_bytes([3, 2], 2, 5) == 4 * (6 * 3 + 6 + 5 * (3 + 2 * 6 + 2 + 2))
    two = [3, 2, 4]
    assert factored.lowrank_forward_flops(two, 2, 5) == factored.lowrank_forward_flops([3, 2], 2, 5) + factored.lowrank_forward_flops([2, 4], 2, 5)
    assert factored.lowrank_forward_bytes(two, 2, 5) == factored.lowrank_forward_bytes([3, 2], 2, 5) + factored.lowrank_forward_bytes([2, 4], 2, 5)


def test_the_lowrank_yardstick_of_the_wide_network():
    """The 256x256 network at 109 observations and 17 actions, rank 32,
    10,000 lanes: 3.23e10 multiply-adds in the products (64.5 GFLOP, ~0.96
    ms at 67 TFLOP/s), the combination's ``y_aug`` 1.40 GB a step."""
    sizes, k, lanes = [109, 256, 256, 17], 32, 10_000
    products = lanes * sum(a * (k + 1) * b for a, b in zip(sizes[:-1], sizes[1:]))
    assert products == 32_271_360_000
    assert f"{products:.2e}" == "3.23e+10"
    combination = 2 * lanes * (k + 1) * (256 + 256 + 17)
    assert factored.lowrank_forward_flops(sizes, k, lanes) == 2 * products + combination
    assert 2 * products / 67e12 == pytest.approx(0.963e-3, rel=1e-3)
    y_aug = 2 * 4 * lanes * (k + 1) * (256 + 256 + 17)
    assert y_aug == 1_396_560_000
    weights = 4 * (k + 1) * sum(b * (a + 1) for a, b in zip(sizes[:-1], sizes[1:]))
    per_lane = 4 * lanes * sum(a + k + b for a, b in zip(sizes[:-1], sizes[1:]))
    assert factored.lowrank_forward_bytes(sizes, k, lanes) == weights + y_aug + per_lane
