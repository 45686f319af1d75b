"""The port's retries, first-device-use watchdog and durable run bundles
(``evotorch_tpu_torch/resilience``), on the CPU.

They hold the JAX package's contracts: the same counters and fault sites,
the same bundle format (magic, SHA-256 header, schema), and a run killed
by SIGKILL and resumed from its newest bundle replays the uninterrupted
run bit for bit (the searcher's pickle carries its generators' states).
"""

import hashlib
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.observability.registry import counters
from evotorch_tpu_torch.resilience import (
    BUNDLE_SCHEMA_VERSION,
    CorruptBundleError,
    DeviceProbeTimeout,
    RunCheckpointer,
    configure,
    probe_devices,
    retry_call,
    retryable,
)

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_faults():
    configure(None)
    yield
    configure(None)


# ---------------------------------------------------------------- retry


def test_retry_succeeds_after_transient_failures():
    calls = {"n": 0}

    def flaky(value):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return value * 2

    before = counters.snapshot(("retry.t.attempts", "retry.t.retries", "retry.t.giveups"))
    assert retry_call(flaky, 21, site="t", retries=3, base_delay=0.001) == 42 and calls["n"] == 3
    assert counters.delta(before) == {"retry.t.attempts": 3, "retry.t.retries": 2, "retry.t.giveups": 0}


def test_retry_gives_up_and_reraises_the_original():
    def always_fails():
        raise OSError("permanent")

    seen = []
    before = counters.get("retry.g.giveups")
    with pytest.raises(OSError, match="permanent"):
        retry_call(always_fails, site="g", retries=2, base_delay=0.001, on_retry=lambda attempt, exc: seen.append(attempt))
    assert counters.get("retry.g.giveups") == before + 1 and seen == [1, 2]


def test_retry_sites_are_fault_injectable():
    configure("io.op:raise@1")
    assert retry_call(lambda: "ok", site="io.op", retries=2, base_delay=0.001) == "ok"
    configure("io.dead:raise@1+")
    with pytest.raises(OSError):
        retry_call(lambda: "never", site="io.dead", retries=2, base_delay=0.001)


def test_retry_does_not_catch_unlisted_exceptions():
    before = counters.get("retry.u.attempts")
    with pytest.raises(KeyError):
        retry_call(lambda: {}["missing"], site="u", retries=3, base_delay=0.001)
    assert counters.get("retry.u.attempts") == before + 1

    @retryable(site="deco", retries=1, base_delay=0.001)
    def once():
        return "decorated"

    assert once() == "decorated"


def test_retry_span_on_the_tracer(tmp_path):
    from evotorch_tpu_torch.observability import tracer

    tracer.start_tracing(str(tmp_path / "trace.json"))
    try:
        configure("traced:raise@1")
        retry_call(lambda: 1, site="traced", retries=1, base_delay=0.001)
    finally:
        path = tracer.stop_tracing()
    names = [e.get("name") for e in json.loads(Path(path).read_text())["traceEvents"]]
    assert "retry:traced" in names


# ------------------------------------------------------------- watchdog


def test_probe_devices_finds_the_cards_or_refuses_the_cpu():
    """This machine has no card: the probe returns no device, and with
    ``expect_accelerator`` it refuses to let a card workload run on the
    CPU. On a machine with one it returns the cards' names."""
    names = probe_devices(timeout=60)
    assert len(names) == torch.cuda.device_count()
    if torch.cuda.is_available():
        assert probe_devices(timeout=60, expect_accelerator=True) == names
    else:
        with pytest.raises(DeviceProbeTimeout, match="no CUDA device"):
            probe_devices(timeout=60, expect_accelerator=True)


def test_probe_devices_turns_a_hang_into_an_error(monkeypatch):
    from evotorch_tpu_torch.resilience import watchdog

    monkeypatch.setattr(watchdog, "_probe", lambda: time.sleep(5))
    before = counters.get("watchdog.device_probe.timeouts")
    with pytest.raises(DeviceProbeTimeout, match="hanging"):
        probe_devices(timeout=0.2)
    assert counters.get("watchdog.device_probe.timeouts") == before + 1
    monkeypatch.setattr(watchdog, "_probe", lambda: (_ for _ in ()).throw(RuntimeError("driver")))
    with pytest.raises(RuntimeError, match="driver"):
        probe_devices(timeout=5)


# ---------------------------------------------------------- run bundles


def test_bundle_roundtrip_and_registry_snapshot(tmp_path):
    ck = RunCheckpointer(tmp_path)
    ck.save(3, {"x": torch.arange(4), "note": "gen three"})
    ck.save(7, {"x": torch.arange(5), "note": "gen seven"})
    gen, state = ck.load_latest()
    assert gen == 7 and state["note"] == "gen seven" and torch.equal(state["x"], torch.arange(5))
    blob = open(ck.bundle_paths()[-1], "rb").read()
    assert blob[:8] == b"EVTRUNB1" and hashlib.sha256(blob[40:]).digest() == blob[8:40]
    record = pickle.loads(blob[8 + 32 :])
    assert record["schema"] == BUNDLE_SCHEMA_VERSION and isinstance(record["registry"], dict)
    assert record["registry"].get("checkpoint.bundles_written", 0) >= 1
    assert not list(tmp_path.glob("*.tmp"))


def test_bundle_retention_keeps_last_k(tmp_path):
    ck = RunCheckpointer(tmp_path, keep=2)
    for gen in range(1, 6):
        ck.save(gen, {"gen": gen})
    assert [os.path.basename(p) for p in ck.bundle_paths()] == ["bundle_00000004.ckpt", "bundle_00000005.ckpt"]
    with pytest.raises(ValueError, match="keep"):
        RunCheckpointer(tmp_path, keep=0)


def test_bundle_cadence(tmp_path):
    ck = RunCheckpointer(tmp_path, every=3)
    written = [ck.maybe_save(gen, {"gen": gen}) for gen in range(1, 8)]
    assert [w is not None for w in written] == [False, False, True, False, False, True, False]
    assert [os.path.basename(p) for p in ck.bundle_paths()] == ["bundle_00000003.ckpt", "bundle_00000006.ckpt"]
    with pytest.raises(ValueError, match="every"):
        RunCheckpointer(tmp_path, every=0)


def test_bundle_corrupt_fallback(tmp_path):
    ck = RunCheckpointer(tmp_path)
    ck.save(1, {"gen": 1})
    ck.save(2, {"gen": 2})
    newest = ck.bundle_paths()[-1]
    blob = open(newest, "rb").read()
    open(newest, "wb").write(blob[: len(blob) // 2])  # a truncated write
    before = counters.get("checkpoint.corrupt_skipped")
    gen, state = ck.load_latest()
    assert (gen, state["gen"]) == (1, 1)
    assert counters.get("checkpoint.corrupt_skipped") == before + 1
    open(ck.bundle_paths()[0], "wb").write(b"garbage")
    assert ck.load_latest() is None
    assert RunCheckpointer(tmp_path / "empty").load_latest() is None


def test_bundle_verification_errors(tmp_path):
    ck = RunCheckpointer(tmp_path)
    blob = open(ck.save(1, {"gen": 1}), "rb").read()
    bad = tmp_path / "bundle_00000009.ckpt"
    bad.write_bytes(b"NOTMAGIC" + blob[8:])
    with pytest.raises(CorruptBundleError, match="magic|truncated"):
        RunCheckpointer.read_bundle(str(bad))
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    bad.write_bytes(bytes(flipped))
    with pytest.raises(CorruptBundleError, match="SHA-256"):
        RunCheckpointer.read_bundle(str(bad))
    payload = pickle.dumps({"schema": BUNDLE_SCHEMA_VERSION + 1, "generation": 1, "state": {}})
    bad.write_bytes(b"EVTRUNB1" + hashlib.sha256(payload).digest() + payload)
    with pytest.raises(CorruptBundleError, match="schema"):
        RunCheckpointer.read_bundle(str(bad))
    junk = b"not a pickle"
    bad.write_bytes(b"EVTRUNB1" + hashlib.sha256(junk).digest() + junk)
    with pytest.raises(CorruptBundleError, match="unpickle"):
        RunCheckpointer.read_bundle(str(bad))
    with pytest.raises(CorruptBundleError, match="unreadable"):
        RunCheckpointer.read_bundle(str(tmp_path / "missing.ckpt"))


def test_bundle_format_is_the_jax_packages(tmp_path):
    """A bundle the port writes is read by the JAX package's reader, and one
    the JAX package writes by the port's (plain payloads)."""
    from evotorch_tpu.resilience import RunCheckpointer as JaxRunCheckpointer

    ours = RunCheckpointer(tmp_path / "port").save(4, {"values": np.arange(3)})
    gen, state = JaxRunCheckpointer.read_bundle(ours)
    assert gen == 4 and np.array_equal(state["values"], np.arange(3))
    theirs = JaxRunCheckpointer(str(tmp_path / "jax")).save(5, {"values": [1, 2]})
    assert RunCheckpointer.read_bundle(theirs) == (5, {"values": [1, 2]})


# --------------------------------------------------- SIGKILL mid-run resume

_CURVE = r'''
import json, sys, time
import torch
from evotorch_tpu_torch.algorithms import PGPE
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.resilience import RunCheckpointer

ck_dir, rows_path, generations, pause = sys.argv[1], sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
ck = RunCheckpointer(ck_dir, keep=2)
latest = ck.load_latest()
if latest is None:
    problem = VecNE("cartpole", "Linear(obs_length, act_length)", env_config={"continuous_actions": True},
                    episode_length=60, eval_mode="episodes_refill", seed=3, device="cpu")
    searcher = PGPE(problem, popsize=16, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3,
                    optimizer="clipup", ranking_method="centered")
    start = 0
else:
    start, state = latest
    searcher = state["searcher"]
    print("resumed_from_generation", start, flush=True)
with open(rows_path, "a") as out:
    for gen in range(start + 1, generations + 1):
        searcher.step()
        center = searcher.status["center"]
        out.write(json.dumps({"gen": gen, "mean_eval": float(searcher.status["mean_eval"]),
                              "center": center.numpy().tobytes().hex(),
                              "generator": searcher.problem.generator.get_state().numpy().tobytes().hex()}) + "\n")
        out.flush()
        ck.save(gen, {"searcher": searcher})
        time.sleep(pause)
'''


def _curve(tmp_path, tag, generations, *, kill_after=None):
    cmd = [sys.executable, "-c", _CURVE, str(tmp_path / f"ck_{tag}"), str(tmp_path / f"rows_{tag}.jsonl"), str(generations), "0.5" if kill_after else "0"]
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    if kill_after is None:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        marker = tmp_path / f"ck_{tag}" / f"bundle_{kill_after:08d}.ckpt"
        deadline = time.monotonic() + 240
        while not marker.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "the bundle never appeared"
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    return None


def _rows(path):
    rows = {}
    for line in open(path):
        row = json.loads(line)
        rows[row["gen"]] = row  # a generation redone after the resume: the last wins
    return rows


def test_sigkill_mid_run_resume_is_bit_identical(tmp_path):
    """Kill a run with SIGKILL right after its second bundle, relaunch it on
    the same directory: it resumes from the newest bundle and every
    generation's center, mean score and generator state equal the run that
    was never killed, bit for bit."""
    _curve(tmp_path, "ref", 5)
    _curve(tmp_path, "killed", 5, kill_after=2)
    killed_rows = _rows(tmp_path / "rows_killed.jsonl")
    assert max(killed_rows) < 5
    stdout = _curve(tmp_path, "killed", 5)
    assert "resumed_from_generation" in stdout
    ref, resumed = _rows(tmp_path / "rows_ref.jsonl"), _rows(tmp_path / "rows_killed.jsonl")
    assert sorted(ref) == sorted(resumed) == [1, 2, 3, 4, 5]
    for gen in ref:
        assert ref[gen] == resumed[gen], gen
