"""The port's autotuner (``evotorch_tpu_torch/observability/autotune.py``)
against the JAX package's, and the tuned-config cache it writes read back by
the port's consumers.

- The pure search core takes the same synthetic measurement and cost
  functions (seeded numpy noise) in both packages and must reach the same
  outcome exactly: winner, results in order, samples, pruned configs and
  their reasons.
- ``_cache_shape`` gives the JAX package's keys, float32 and bf16 each with
  its own package's dtype.
- ``tune_group`` runs each device harness on the CPU at CartPole, popsize
  64, 20-step episodes, one trial, into a cache under ``tmp_path``; the
  winner is written, a floor-failing winner withheld, and ``VecNE`` and the
  sharded evaluator read the refill entry back as ``"cache"``.
- The host-pipeline harness runs on CartPole-v1 (gymnasium).
- The CLI runs with ``--device cpu`` and exits non-zero without a card.
- Faults C.8 (``VecNE(device="cpu")`` never takes a card's entry) and C.9
  (bf16 keyed ``"bfloat16"`` as in the JAX package).
"""

import importlib
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.observability import autotune as jax_autotune
from evotorch_tpu_torch.observability import autotune
from evotorch_tpu_torch.observability.timings import (
    TimingLedger,
    TunedEntry,
    dtype_label,
    lookup_tuned,
    machine_fingerprint,
    save_tuned_entry,
)

# the package's ``timings`` attribute is its ledger singleton: the module by name
jax_timings_module = importlib.import_module("evotorch_tpu.observability.timings")

SHAPE = autotune.TuneShape(env_name="cartpole", popsize=64, episode_length=20, hidden=(8,))
SMALL_NET = "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)"  # tanh_mlp(4, 2, [8]): 58 parameters
TUNE = dict(trials=1, max_rounds=1, refine=False)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tuned_configs.json"
    monkeypatch.setenv("EVOTORCH_TUNED_CACHE", str(path))
    return path


# ---------------------------------------------------------------------------
# the pure search core against the JAX package's
# ---------------------------------------------------------------------------

#: a planted optimum at width 256, period 1
_TRUE_RATE = {64: 40.0, 128: 60.0, 256: 100.0, 512: 55.0, 96: 45.0, 192: 90.0, 384: 70.0}


def _synthetic(seed):
    """A MeasureFn and a cost function over the planted landscape, with
    multiplicative noise and occupancies from ``default_rng(seed)``, and the
    log of every measured config."""
    rng = np.random.default_rng(seed)
    log = []

    def measure(configs, trials, round_index):
        out = []
        for config in configs:
            log.append((round_index, dict(config)))
            base = _TRUE_RATE.get(config["width"], 50.0) * (0.5 if config.get("period", 1) == 2 else 1.0)
            out.append(
                {
                    "samples": [float(base * rng.uniform(0.8, 1.2)) for _ in range(trials)],
                    "occupancies": [float(rng.uniform(0.85, 1.0)) for _ in range(trials)],
                    "steady_compiles": int(config["width"] == 128),
                    "refill_events": int(rng.integers(100)),
                    "queue_wait": int(rng.integers(100)),
                }
            )
        return out

    def cost(config):
        if config["width"] == 96:
            return None  # no cost: never prunes
        return {"peak_bytes": float(config["width"] * 1e6), "flops": float(config["width"] * 10), "compile_seconds": 0.0}

    return measure, cost, log


def _group(pkg):
    return pkg.KnobGroup(
        "refill", (pkg.KnobSpec("width", (64, 128, 256, 512)), pkg.KnobSpec("period", (1, 2), refine=False))
    )


def _stats(results):
    return [
        (r.config, r.samples, r.occupancies, r.steady_compiles, r.refill_events, r.queue_wait, r.cost) for r in results
    ]


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(hbm_budget_bytes=300e6, min_occupancy=0.9),
        dict(flops_bound=3000.0, trials_per_round=2, max_rounds=3),
        dict(tolerance=0.3, prefer=lambda c: -c["width"], refine=False),
        dict(min_occupancy=0.99, survivor_frac=0.25, min_survivors=1),
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_search_core_outcome_equals_jax(kwargs, seed):
    outcomes, logs = [], []
    for pkg in (jax_autotune, autotune):
        measure, cost, log = _synthetic(seed)
        outcomes.append(pkg.autotune_search(_group(pkg), measure, cost_fn=cost, **kwargs))
        logs.append(log)
    ours, theirs = outcomes[1], outcomes[0]
    assert logs[1] == logs[0]
    assert _stats(ours.results) == _stats(theirs.results)
    assert ours.pruned == theirs.pruned
    assert (ours.winner is None) == (theirs.winner is None)
    if ours.winner is not None:
        assert _stats([ours.winner]) == _stats([theirs.winner])
    assert [r.steps_per_sec for r in ours.results] == [r.steps_per_sec for r in theirs.results]
    assert [r.occupancy for r in ours.results] == [r.occupancy for r in theirs.results]


@pytest.mark.parametrize("seed", [0, 3])
def test_core_pieces_equal_jax(seed):
    groups = {pkg: _group(pkg) for pkg in (jax_autotune, autotune)}
    assert autotune.candidate_grid(groups[autotune]) == jax_autotune.candidate_grid(groups[jax_autotune])
    for config in autotune.candidate_grid(groups[autotune]):
        assert autotune.neighborhood(groups[autotune], config) == jax_autotune.neighborhood(groups[jax_autotune], config)
    grid = autotune.candidate_grid(groups[autotune])
    for budget, bound in ((None, None), (200e6, None), (None, 2000.0), (300e6, 4000.0)):
        ours = autotune.analytic_prune(grid, _synthetic(seed)[1], hbm_budget_bytes=budget, flops_bound=bound)
        theirs = jax_autotune.analytic_prune(grid, _synthetic(seed)[1], hbm_budget_bytes=budget, flops_bound=bound)
        assert ours == theirs
    halved = []
    for pkg in (jax_autotune, autotune):
        measure, _, _ = _synthetic(seed)
        halved.append(pkg.successive_halving(grid, measure, trials_per_round=3, max_rounds=3))
    assert _stats(halved[1]) == _stats(halved[0])
    for floor, tol in ((None, None), (0.95, None), (0.9, 0.2), (1.1, None)):
        picks = []
        for pkg, results in zip((jax_autotune, autotune), halved):
            picks.append(pkg.select_winner(results, min_occupancy=floor, tolerance=tol, prefer=lambda c: c["period"]))
        assert _stats([picks[1]]) == _stats([picks[0]])


@pytest.mark.parametrize("env_name", ["humanoid", "Humanoid-v5", "cartpole"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("popsize, episode_length, num_episodes", [(1024, 100, 1), (10_000, 200, 2)])
def test_cache_shape_equals_jax(env_name, bf16, popsize, episode_length, num_episodes):
    def harness(pkg, dtype):
        shape = pkg.TuneShape(
            env_name=env_name, popsize=popsize, episode_length=episode_length, compute_dtype=dtype, num_episodes=num_episodes
        )
        return types.SimpleNamespace(shape=shape, policy=types.SimpleNamespace(parameter_count=12_305))

    ours = autotune._cache_shape(harness(autotune, torch.bfloat16 if bf16 else None))
    theirs = jax_autotune._cache_shape(harness(jax_autotune, jnp.bfloat16 if bf16 else None))
    assert ours == theirs
    assert ours["dtype"] == ("bfloat16" if bf16 else "float32")


def test_dtype_labels_equal_jax():
    """C.9: the port keys bf16 and f16 by the JAX package's names, not
    ``torch.bfloat16``."""
    assert dtype_label(None) == jax_timings_module.dtype_label(None) == "float32"
    assert dtype_label(torch.bfloat16) == jax_timings_module.dtype_label(jnp.bfloat16) == "bfloat16"
    assert dtype_label(torch.float16) == jax_timings_module.dtype_label(jnp.float16) == "float16"
    assert dtype_label(torch.float32) == jax_timings_module.dtype_label(jnp.float32)


# ---------------------------------------------------------------------------
# tune_group end to end on the CPU
# ---------------------------------------------------------------------------


class _StubHarness:
    """A harness over the synthetic landscape (counterpart of the JAX
    tests'): tune_group's ledger and cache policy with no torch work."""

    group = "refill"
    program = "rollout.episodes_refill"

    def __init__(self, occupancy):
        self._occupancy = occupancy
        self.shape = autotune.TuneShape(env_name="cartpole", popsize=8)
        self.policy = types.SimpleNamespace(parameter_count=7)
        self.device = torch.device("cpu")

    def knob_group(self):
        return autotune.KnobGroup("refill", (autotune.KnobSpec("width", (64, 128, 256)),))

    def default_config(self):
        return {"width": 128}

    def cost(self, config):
        return None

    def measure(self, configs, trials, round_index):
        return [
            {"samples": [_TRUE_RATE[c["width"]]] * trials, "occupancies": [self._occupancy] * trials, "steady_compiles": 0}
            for c in configs
        ]

    def tuned_config(self, config):
        return {"width": config["width"], "period": 1}

    def baseline(self, trials=3):
        return {"steps_per_sec": 50.0, "occupancy": None, "samples": [50.0]}


def _stub_shape():
    return {"env": "cartpole", "popsize": 8, "episode_length": 100, "num_episodes": 1, "params": 7, "dtype": "float32", "mesh": "none"}


def test_tune_group_withholds_floor_failing_winner_from_cache(cache):
    """Counterpart of ``tests/test_autotune.py::
    test_tune_group_withholds_floor_failing_winner_from_cache``."""
    machine = machine_fingerprint("cpu")
    outcome = autotune.tune_group(_StubHarness(occupancy=0.4), min_occupancy=0.9, ledger_out=TimingLedger())
    assert outcome.winner is not None and outcome.cache_written is False
    assert lookup_tuned("refill", _stub_shape(), machine=machine) is None
    outcome = autotune.tune_group(_StubHarness(occupancy=0.95), min_occupancy=0.9, ledger_out=TimingLedger())
    assert outcome.cache_written is True
    hit = lookup_tuned("refill", _stub_shape(), machine=machine)
    assert hit is not None and hit.config["width"] == 256 and hit.machine["runtime"] == "torch"
    # the group's own floor through min_occupancy="auto"
    harness = _StubHarness(occupancy=0.5)
    harness.default_min_occupancy = 0.9
    assert autotune.tune_group(harness, cache_path=cache.parent / "other.json").cache_written is False


def _vecne(**kwargs):
    from evotorch_tpu_torch.neuroevolution import VecNE

    return VecNE("cartpole", SMALL_NET, episode_length=20, eval_mode="episodes_refill", device="cpu", seed=0, **kwargs)


def test_refill_harness_writes_an_entry_that_vecne_and_the_sharded_evaluator_take(cache):
    from evotorch_tpu_torch.observability import EvalTelemetry
    from evotorch_tpu_torch.parallel import make_sharded_rollout_evaluator

    harness = autotune.RefillHarness(SHAPE, widths=(8, 16, 32), device="cpu")
    ledger = TimingLedger()
    outcome = autotune.tune_group(harness, min_occupancy=0.0, ledger_out=ledger, **TUNE)
    assert outcome.cache_written
    assert all(r.steady_compiles == 0 and r.cost["peak_bytes"] is None for r in outcome.results)
    assert {r["label"] for r in harness.trials} == {"refill", "episodes"} and all(t["finite"] for t in harness.trials)
    assert len(ledger.records("rollout.episodes_refill")) == 3
    width = outcome.winner.config["refill_width"]
    entry = json.loads(cache.read_text())["entries"][0]
    assert entry["shape"] == autotune._cache_shape(harness) and entry["machine"] == machine_fingerprint("cpu")
    assert entry["config"] == {"width": width, "period": 1}

    problem = _vecne()
    batch = problem.generate_batch(SHAPE.popsize)
    problem.evaluate(batch)
    assert problem.status["tuned_config_source"] == "cache"
    assert EvalTelemetry.from_array(problem._pending_telemetry).lane_width == width

    evaluator = make_sharded_rollout_evaluator(harness.env, harness.policy, num_episodes=1, episode_length=20, eval_mode="episodes_refill")
    result, _ = evaluator(harness.values, torch.Generator().manual_seed(1), harness.stats)
    assert evaluator.tuned_config_source == "cache"
    assert EvalTelemetry.from_array(result.telemetry).lane_width == width


def test_refill_harness_below_its_floor_leaves_the_cache_unwritten(cache):
    harness = autotune.RefillHarness(SHAPE, widths=(8, 16), device="cpu")
    outcome = autotune.tune_group(harness, min_occupancy=1.01, ledger_out=TimingLedger(), **TUNE)
    assert outcome.winner is not None and not outcome.cache_written and not cache.exists()


@pytest.mark.parametrize(
    "make, group, config_keys",
    [
        (lambda: autotune.CompactHarness(SHAPE, chunks=(5, 10), min_widths=(8, 16), device="cpu"), "compact", {"chunk_size", "min_width"}),
        (lambda: autotune.PolicyHarness(SHAPE, ranks=(2, 4), trunk_blocks=(0, 16), device="cpu"), "policy", {"rank", "trunk_block"}),
        (lambda: autotune.SpanHarness(SHAPE, spans=(1, 2), device="cpu"), "span", {"span"}),
    ],
)
def test_device_harnesses_write_their_group(cache, make, group, config_keys):
    harness = make()
    outcome = autotune.tune_group(harness, ledger_out=TimingLedger(), **TUNE)
    assert outcome.cache_written and all(r.steady_compiles == 0 for r in outcome.results)
    assert all(r.cost is not None and r.cost["flops"] > 0 for r in outcome.results)
    hit = lookup_tuned(group, autotune._cache_shape(harness), machine=machine_fingerprint("cpu"))
    assert hit is not None and set(hit.config) == config_keys
    assert hit.evidence["speedup_vs_baseline"] is not None


def test_host_pipeline_harness_has_tune_group_surface():
    """Counterpart of ``tests/test_autotune.py::
    test_host_pipeline_harness_has_tune_group_surface``."""
    pytest.importorskip("gymnasium")
    harness = autotune.HostPipelineHarness(env_id="CartPole-v1", num_envs=2, popsize=4, device="cpu")
    assert harness.default_config() is None and harness.cost({"num_blocks": 1}) is None
    grid = autotune.candidate_grid(harness.knob_group())
    assert grid and all("num_blocks" in c for c in grid) and "mj_nthread" not in grid[0]
    assert (harness.default_config() or grid[0]) in grid


def test_host_pipeline_harness_entry_reports_tuned_source(cache):
    """Counterpart of ``tests/test_autotune.py::
    test_host_pipeline_reports_tuned_source``: the harness's winner, a
    machine-scoped entry, turns the host engine's fallback into ``cache``."""
    pytest.importorskip("gymnasium")
    import gymnasium as gym

    from evotorch_tpu_torch.neuroevolution.net.hostvecenv import SyncVectorEnv, run_host_pipelined_rollout

    harness = autotune.HostPipelineHarness(env_id="CartPole-v1", num_envs=4, popsize=8, episode_length=10, device="cpu")
    outcome = autotune.tune_group(harness, ledger_out=TimingLedger(), **TUNE)
    assert outcome.cache_written and autotune._cache_shape(harness) == {}
    blocks = outcome.winner.config["num_blocks"]

    def run(**kw):
        vec = SyncVectorEnv(lambda: gym.make("CartPole-v1"), 4)
        try:
            return run_host_pipelined_rollout(
                vec, harness.policy, harness.params, episode_length=10, mode="sync", rng=np.random.default_rng(0),
                device="cpu", **kw,
            )  # fmt: skip
        finally:
            vec.close()

    out = run()
    assert out["tuned_config_source"] == "cache" and len(out["block_iters"]) == blocks
    assert run(num_blocks=1)["tuned_config_source"] == "override"


# ---------------------------------------------------------------------------
# the CLI, and C.8
# ---------------------------------------------------------------------------

CLI_ARGS = [
    "--env", "cartpole", "--popsize", "16", "--episode-length", "8", "--hidden", "4", "--widths", "4,8",
    "--trials", "1", "--max-rounds", "1", "--no-refine",
]  # fmt: skip


def test_cli_on_the_cpu(cache, tmp_path, capsys):
    out_path = tmp_path / "timings.json"
    assert autotune.main(CLI_ARGS + ["--device", "cpu", "--no-write-cache", "--timings-out", str(out_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    winner = [x for x in lines if x["metric"] == "autotune_winner"]
    assert len(winner) == 1 and winner[0]["backend"] == "cpu" and winner[0]["cache_written"] is False
    assert len([x for x in lines if x["metric"] == "autotune_steps_per_sec"]) == 2
    assert not cache.exists() and len(json.loads(out_path.read_text())["timings"]) == 2


def test_cli_without_a_card_exits_non_zero(cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.main(CLI_ARGS) != 0
    assert not cache.exists()


def test_vecne_on_the_cpu_never_takes_a_cards_entry(cache, monkeypatch):
    """C.8: on a machine with a card, ``VecNE(device="cpu")`` looks its
    knobs up under the CPU's fingerprint: an entry tuned on the card is
    not taken (``"fallback"``), one tuned on the CPU is."""
    from evotorch_tpu_torch.observability import timings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "Stand-in H100")
    card = machine_fingerprint()
    assert card["backend"] == "cuda" and card["device_kind"] == "Stand-in H100"
    shape = {"env": "cartpole", "popsize": 16, "episode_length": 20, "num_episodes": 1, "params": 58, "dtype": "float32", "mesh": "none"}
    save_tuned_entry(TunedEntry("refill", shape, card, {"width": 4, "period": 1}))
    problem = _vecne()
    problem.evaluate(problem.generate_batch(16))
    assert problem.status["tuned_config_source"] == "fallback"

    save_tuned_entry(TunedEntry("refill", shape, machine_fingerprint("cpu"), {"width": 4, "period": 1}))
    timings.load_tuned_cache(force=True)
    problem = _vecne()
    problem.evaluate(problem.generate_batch(16))
    assert problem.status["tuned_config_source"] == "cache"
