"""The port's SLO watchdog, health trend detectors and MetricsHub
(``observability/slo.py``, ``health.py``, ``metricshub.py``) against the JAX
package's, on the CPU.

Both sides decode the same int32 wires with their own decoders and run
the same rules on them. Tolerance: none. The modules are host-side Python
over the same float64 arithmetic, so the verdicts, every ``EWMATrend``
float, the ``HealthMonitor`` state dicts, the JSONL rows and the ``.prom``
text are equal; only the manifest's runtime fields (``runtime``,
``torch_version``, ``device``, the creation time) are the port's own.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.observability import devicemetrics as jax_dm
from evotorch_tpu.observability import health as jax_health
from evotorch_tpu.observability import metricshub as jax_hub
from evotorch_tpu.observability import slo as jax_slo
from evotorch_tpu_torch.observability import devicemetrics as dm
from evotorch_tpu_torch.observability import health, metricshub, slo

G = 4


def _wire(rng, scores_scale=1.0, drift=0.0, gen=0):
    """One per-group ``(G, 20)`` wire: random counters, histograms and the
    health block of random scores (computed by the JAX package)."""
    counters = np.zeros((G, dm.GROUP_TELEMETRY_WIDTH), dtype=np.int32)
    counters[:, 2] = rng.integers(50, 200, size=G)  # capacity
    counters[:, 0] = (counters[:, 2] * rng.uniform(0.2, 1.0, size=G)).astype(np.int32)  # env steps
    counters[:, 1] = rng.integers(1, 20, size=G)  # episodes
    counters[:, 3] = rng.integers(1, 8, size=G)
    counters[:, 4] = rng.integers(0, 30, size=G)
    counters[:, 5] = rng.integers(0, 9, size=G)
    counters[:, 6] = rng.integers(0, 2, size=G)
    counters[:, 7:] = rng.integers(0, 5, size=(G, dm.QUEUE_WAIT_BUCKETS))
    counters[0, 2] = 0  # a group with no capacity: skipped by occupancy rules
    scores = (drift * gen + scores_scale * rng.normal(size=24)).astype(np.float32)
    groups = rng.integers(0, G, size=24).astype(np.int32)
    block = np.asarray(jax_dm.compute_health_block(jnp.asarray(scores), jnp.asarray(groups), G))
    return np.asarray(jax_dm.append_health_block(jnp.asarray(counters), jnp.asarray(block)))


RULES = [
    {"kind": "occupancy_floor", "threshold": 0.5},
    {"kind": "occupancy_floor", "threshold": 0.3, "group": 2},
    {"kind": "starvation_ceiling", "threshold": 0.2},
    {"kind": "starvation_ceiling", "threshold": 0.1, "group": 1},
    {"kind": "no_steady_compiles"},
    {"kind": "min_progress", "threshold": 60},
    {"kind": "min_model_efficiency", "threshold": 0.2},
    {"kind": "max_nonfinite_share", "threshold": 0.05},
    {"kind": "max_nonfinite_share", "threshold": 0.05, "group": 3},
    {"kind": "plateau", "threshold": 5},
    {"kind": "plateau", "threshold": 4, "group": 1},
    {"kind": "stdev_collapse", "threshold": 0.3},
    {"kind": "score_snr_floor", "threshold": 0.4},
    {"kind": "score_snr_floor", "threshold": 0.4, "group": 2},
]


@pytest.mark.parametrize("drift", [0.0, 0.5])
def test_watchdog_verdicts_equal_jax(drift):
    """Every rule kind, global and per group, over 40 generations of the same
    decoded telemetry and status: the same reports, and the same health
    windows in the state dicts, at every generation."""
    rng = np.random.default_rng(1 if drift else 0)
    ours, theirs = slo.SLOWatchdog(RULES), jax_slo.SLOWatchdog(RULES)
    violations = 0
    for gen in range(40):
        wire = _wire(rng, drift=drift, gen=gen)
        status = {"stdev_norm": float(np.exp(-gen / 8)), "mean_eval": float(gen)}
        if gen % 3 == 0:
            status.update(steady_compiles=gen % 2, model_efficiency=0.1 * (gen % 4), eval_nonfinite_share=0.02 * (gen % 5))
        a = ours.check(dm.GroupTelemetry.from_array(wire), status=status)
        b = theirs.check(jax_dm.GroupTelemetry.from_array(wire), status=status)
        assert (a.ok, a.violations, a.checked) == (b.ok, b.violations, b.checked), gen
        assert a.as_status() == b.as_status() and a.summary() == b.summary()
        assert ours.state_dict() == theirs.state_dict()
        violations += len(a.violations)
    assert violations > 0
    # telemetry absent: only the status-keyed rules are checked
    a, b = ours.check(None, status={"mean_eval": 1.0}), theirs.check(None, status={"mean_eval": 1.0})
    assert (a.ok, a.violations, a.checked) == (b.ok, b.violations, b.checked)
    # the default rule set
    assert [r.kind for r in slo.SLOWatchdog(True).rules] == [r.kind for r in jax_slo.SLOWatchdog(True).rules]
    with pytest.raises(ValueError, match="unknown SLO rule kind"):
        slo.Rule("nope")


def test_ewma_trend_floats_equal_jax():
    rng = np.random.default_rng(2)
    for stream in (np.cumsum(rng.normal(1.0, 2.0, size=60)), 5.0 + rng.normal(0.0, 2.0, size=60), np.r_[np.arange(10.0), np.nan, np.inf, np.arange(10.0)]):
        for alpha, noise in ((0.2, 3.0), (0.5, 1.0)):
            ours, theirs = health.EWMATrend(alpha, noise), jax_health.EWMATrend(alpha, noise)
            for v in stream:
                ours.observe(v)
                theirs.observe(v)
                assert ours.state_dict() == theirs.state_dict()
                assert (ours.noise_floor, ours.significant, ours.warmed_up) == (theirs.noise_floor, theirs.significant, theirs.warmed_up)
    with pytest.raises(ValueError, match="alpha"):
        health.EWMATrend(alpha=0.0)


def test_health_monitor_state_dicts_equal_jax_and_round_trip():
    rng = np.random.default_rng(3)
    ours, theirs = health.HealthMonitor(), jax_health.HealthMonitor()
    for i in range(30):
        for name, group in (("score_mean", None), ("score_mean", 1), ("stdev_norm", None)):
            value = float(rng.normal()) + i
            ours.observe(name, value, group=group)
            theirs.observe(name, value, group=group)
    assert ours.state_dict() == theirs.state_dict()
    assert ours.keys() == theirs.keys()
    # the JAX package's state loads into the port and continues alike
    resumed = health.HealthMonitor().load_state_dict(json.loads(json.dumps(theirs.state_dict())))
    for v in (1.0, 2.0, 3.0):
        resumed.observe("score_mean", v)
        theirs.observe("score_mean", v)
    assert resumed.state_dict() == theirs.state_dict()
    assert resumed.baseline("stdev_norm") == theirs.baseline("stdev_norm")


BENCH_LINES = [
    {"occupancy": 0.9, "steady_compiles": 0, "score_mean": 100.0, "score_std": 10.0, "modes": {"episodes": {"occupancy": 0.9}}},
    {"occupancy": 0.05, "steady_compiles": 2, "eval_nonfinite_share": 0.4, "model_efficiency": 0.01},
    {"queue_wait_p99": 70.0, "serve_queue_wait_p99": 3.0, "modes": {"episodes_refill": {"queue_wait_p99": 80.0, "score_mean": 1.0, "score_std": 1e-9, "model_efficiency": 0.3}}},
    {"unrelated": 1},
]
FLAGS = dict(min_model_efficiency=0.1, max_nonfinite_share=0.1, max_score_collapse=1e3, min_score_snr=2.0, max_queue_wait_p99=64.0)


@pytest.mark.parametrize("index", range(len(BENCH_LINES)))
def test_check_bench_line_equals_jax(index):
    line = BENCH_LINES[index]
    for flags in ({}, FLAGS):
        a, b = slo.check_bench_line(line, **flags), jax_slo.check_bench_line(line, **flags)
        assert (a.ok, a.violations, a.checked) == (b.ok, b.violations, b.checked)


def test_check_bench_cli_exit_codes(tmp_path, capsys):
    log, verdict = tmp_path / "bench.log", tmp_path / "verdict.txt"
    log.write_text("starting\n" + json.dumps(BENCH_LINES[0]) + "\n")
    assert slo._main(["--check-bench", str(log), "--verdict-out", str(verdict)]) == 0
    assert verdict.read_text() == "pass\n"
    log.write_text(json.dumps(BENCH_LINES[1]) + "\n" + '{"partial": ')  # a crashed writer's last line
    assert slo._main(["--check-bench", str(log), "--verdict-out", str(verdict)]) == 1
    assert verdict.read_text() == "fail\n"
    log.write_text(json.dumps(BENCH_LINES[3]) + "\n")
    assert slo._main(["--check-bench", str(log), "--verdict-out", str(verdict)]) == 2
    assert verdict.read_text() == "insufficient\n"
    log.write_text("no json here\n")
    assert slo._main(["--check-bench", str(log)]) == 2
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [p["slo_verdict"] for p in printed] == ["pass", "fail", "insufficient", "insufficient"]
    for code, line in ((0, BENCH_LINES[0]), (1, BENCH_LINES[1]), (2, BENCH_LINES[3])):
        log.write_text(json.dumps(line) + "\n")
        assert slo._main(["--check-bench", str(log)]) == jax_slo._main(["--check-bench", str(log)]) == code
    capsys.readouterr()


_RUNTIME = ("created_unix", "runtime", "torch_version", "device", "git_sha")


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("suffix", [".jsonl", ".prom"])
def test_metricshub_rows_equal_jax(tmp_path, suffix):
    rng = np.random.default_rng(4)
    ours = metricshub.MetricsHub(str(tmp_path / f"port{suffix}"), manifest={"mesh": "none", "tenant": "a"})
    theirs = jax_hub.MetricsHub(str(tmp_path / f"jax{suffix}"), manifest={"mesh": "none", "tenant": "a"})
    one_group = dm.EvalTelemetry(env_steps=10, episodes=2, capacity=20, lane_width=4, refill_events=1, queue_wait=3, nonfinite=0)
    jax_one_group = jax_dm.EvalTelemetry(**{k: getattr(one_group, k) for k in dm._SLOTS})
    for k in range(3):
        wire = _wire(rng, gen=k)
        row = {"dispatch": k, "served": 10 + k, "flag": True, "name": "x"}
        a = ours.emit(row, telemetry=dm.GroupTelemetry.from_array(wire), include_counters=False)
        b = theirs.emit(row, telemetry=jax_dm.GroupTelemetry.from_array(wire), include_counters=False)
        assert a == b
    assert ours.emit({"g": 1}, telemetry=one_group, include_counters=False) == theirs.emit({"g": 1}, telemetry=jax_one_group, include_counters=False)
    if suffix == ".prom":
        assert (tmp_path / "port.prom").read_text() == (tmp_path / "jax.prom").read_text()
        text = (tmp_path / "port.prom").read_text()
        assert "# HELP evotorch_served" not in text  # the last emit holds only its own fields
        ours.emit({"served": 3}, include_counters=True)
        text = (tmp_path / "port.prom").read_text()
        assert "# TYPE evotorch_served gauge" in text and "# HELP evotorch_served per-generation row field served" in text
        return
    port_rows, jax_rows = _rows(tmp_path / "port.jsonl"), _rows(tmp_path / "jax.jsonl")
    assert len(port_rows) == len(jax_rows) == 5
    assert port_rows[1:] == jax_rows[1:]
    manifest, jax_manifest = port_rows[0]["manifest"], jax_rows[0]["manifest"]
    assert manifest["runtime"] == "torch" and manifest["torch_version"] == torch.__version__
    assert manifest["device"] == (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
    assert {k: v for k, v in manifest.items() if k not in _RUNTIME} == {k: v for k, v in jax_manifest.items() if k not in _RUNTIME}
    # the counters ride along by default, from the port's own registry
    record = ours.emit({"x": 1})
    assert "counters" in record and _rows(tmp_path / "port.jsonl")[-1]["row"] == 4


def test_metricshub_from_env_and_write_retry(tmp_path, monkeypatch):
    from evotorch_tpu_torch.observability.registry import counters
    from evotorch_tpu_torch.resilience import faults

    monkeypatch.delenv("EVOTORCH_METRICS", raising=False)
    assert metricshub.MetricsHub.from_env() is None
    monkeypatch.setenv("EVOTORCH_METRICS", str(tmp_path / "m.jsonl"))
    hub = metricshub.MetricsHub.from_env(manifest={"k": 1})
    assert hub.manifest["k"] == 1 and hub.manifest["schema_version"] == dm.TELEMETRY_SCHEMA_VERSION
    before = counters.get("retry.metricshub.write.retries")
    faults.configure("metricshub.write:raise@1")
    try:
        hub.emit({"a": 1})
    finally:
        faults.configure(None)
    assert counters.get("retry.metricshub.write.retries") == before + 1
    rows = _rows(tmp_path / "m.jsonl")
    assert len(rows) == 2 and rows[1]["a"] == 1
    assert metricshub._git_sha() == jax_hub._git_sha()
