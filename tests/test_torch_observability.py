"""The host-side observability and fault-injection modules in the port
against the JAX package, on the CPU: the tracer's Chrome-trace events
(names, categories, tracks) for a pipelined host rollout and an OO
generation; the counter registry; ``timings.resolve_knobs`` precedence
and a tuned-config cache written by the JAX package and read by the port;
``resilience.faults`` (``parse_spec`` and ``fault_point``'s firing order,
rule for rule); the ``eval.scores`` nonfinite injection choosing the JAX
package's indices; and the ``hostpool.worker:kill`` site driving a
respawn; the port's spans as profiler ranges and counters inside a
Humanoid rollout's control step, on the profiler's clock. Everything here
is held exactly: names, counts, indices and cache entries."""

import importlib
import json
import time

import numpy as np
import pytest
import torch

import evotorch_tpu.observability.registry as JReg
import evotorch_tpu.observability.tracer as JTr
import evotorch_tpu.resilience.faults as JF
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
import evotorch_tpu.neuroevolution.net.hostvecenv as JH
import evotorch_tpu_torch.observability.registry as PReg
import evotorch_tpu_torch.observability.timings as PT
import evotorch_tpu_torch.observability.tracer as PTr
import evotorch_tpu_torch.resilience.faults as PF
import evotorch_tpu_torch.neuroevolution.net.hostvecenv as PH
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear

from test_torch_hostenv import ProgrammableLengthEnv

# the module (the JAX package's ``observability`` binds the name ``timings``
# to its ledger singleton)
JT = importlib.import_module("evotorch_tpu.observability.timings")


@pytest.fixture
def faults():
    """Fault specs installed by a test are removed after it, in both
    packages."""
    yield
    PF.configure(None)
    JF.configure(None)


def _trace(module_tracer, run, tmp_path, name):
    path = tmp_path / name
    module_tracer.start_tracing(str(path))
    try:
        run()
    finally:
        module_tracer.stop_tracing()
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _names(events, ph="X"):
    return sorted({(e["name"], e.get("cat", "")) for e in events if e["ph"] == ph})


def test_tracer_events_of_a_pipelined_rollout_match_jax(tmp_path):
    params = (np.random.default_rng(0).uniform(0.1, 2.0, size=(6, 2))).astype(np.float32)
    kw = dict(num_episodes=1, episode_length=20, num_blocks=2, mode="pipelined")
    ours = _trace(
        PTr,
        lambda: PH.run_host_pipelined_rollout(
            PH.SyncVectorEnv(ProgrammableLengthEnv, 4), FlatParamsPolicy(Linear(1, 1)), torch.from_numpy(params), device="cpu", **kw
        ),
        tmp_path,
        "port.json",
    )
    theirs = _trace(
        JTr,
        lambda: JH.run_host_pipelined_rollout(JH.SyncVectorEnv(ProgrammableLengthEnv, 4), JaxFlatParamsPolicy(JaxLinear(1, 1)), params, **kw),
        tmp_path,
        "jax.json",
    )
    assert _names(ours) == _names(theirs)
    assert {"s1.forward_dispatch", "s2.actions_sync", "s3.bookkeep_refill", "device_forward", "physics"} <= {n for n, _ in _names(ours)}
    assert {e["args"]["name"] for e in ours if e["ph"] == "M"} == {e["args"]["name"] for e in theirs if e["ph"] == "M"}
    # the physics spans run on the worker's own track
    physics_tids = {e["tid"] for e in ours if e["name"] == "physics"}
    forward_tids = {e["tid"] for e in ours if e["name"] == "s1.forward_dispatch"}
    assert physics_tids and forward_tids and not physics_tids & forward_tids
    assert all(e["dur"] >= 0 and {"ts", "pid", "tid"} <= e.keys() for e in ours if e["ph"] == "X")


def test_tracer_off_is_a_shared_no_op_and_counts_spans():
    assert PTr.span("x") is PTr.span("y") and not PTr.tracing_enabled()
    before = PReg.counters.get("trace_spans")
    tracer = PTr.start_tracing(None)
    try:
        with PTr.span("outer", "algo", n=1):
            PTr.instant("mark", "algo")
        tracer.counter("depth", 3)
    finally:
        PTr.stop_tracing()
    assert PReg.counters.get("trace_spans") == before + 1
    kinds = [e["ph"] for e in tracer.events()]
    assert kinds.count("X") == 1 and kinds.count("i") == 1 and kinds.count("C") == 1


def test_oo_generation_spans(tmp_path):
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import GymNE

    def run():
        problem = GymNE(ProgrammableLengthEnv, "Linear(obs_length, act_length)", device="cpu", num_envs=3, host_pipeline_blocks=1)
        PGPE(problem, popsize=4, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.5).run(2)

    names = {n for n, _ in _names(_trace(PTr, run, tmp_path, "oo.json"))}
    assert {"generation", "ask", "eval", "tell", "s2.actions_sync"} <= names


def test_counter_registry_matches_jax():
    ours, theirs = PReg.CounterRegistry(), JReg.CounterRegistry()
    for reg in (ours, theirs):
        reg.increment("a")
        reg.increment("a", 4)
        reg.accumulate("secs", 0.25)
        reg.observe_max("peak", 10)
        reg.observe_max("peak", 3)
    snap_o, snap_t = ours.snapshot(("a", "peak", "missing")), theirs.snapshot(("a", "peak", "missing"))
    assert snap_o == snap_t == {"a": 5, "peak": 10, "missing": 0}
    for reg in (ours, theirs):
        reg.increment("a", 2)
    assert ours.delta(snap_o) == theirs.delta(snap_t)
    assert ours.snapshot() == theirs.snapshot()


def test_resolve_knobs_precedence_matches_jax(tmp_path):
    machine = {"backend": "cpu", "core_count": 4, "device_kind": "cpu", "runtime": "torch"}
    path = tmp_path / "cache.json"
    entry = dict(group="host_pipeline", shape={}, machine=machine, config={"num_blocks": 3})
    PT.save_tuned_entry(PT.TunedEntry(**entry), path=path)
    cases = [({"num_blocks": None}, True), ({"num_blocks": 2}, True), ({"num_blocks": None, "mj_nthread": 1}, True), ({"num_blocks": None}, False)]
    for explicit, use_cache in cases:
        ours = PT.resolve_knobs(explicit, "host_pipeline", {}, machine=machine, path=path, use_cache=use_cache)
        theirs = JT.resolve_knobs(explicit, "host_pipeline", {}, machine=machine, path=path, use_cache=use_cache)
        assert ours == theirs
    assert PT.resolve_knobs({}, "host_pipeline", {}, machine=machine, path=path) == ({"num_blocks": 3}, "cache")
    other = dict(machine, device_kind="NVIDIA H100 80GB HBM3")
    assert PT.resolve_knobs({}, "host_pipeline", {}, machine=other, path=path) == ({}, "fallback")


def test_a_tuned_cache_written_by_jax_reads_in_the_port(tmp_path):
    path = tmp_path / "jax_cache.json"
    jax_machine = JT.machine_fingerprint()
    JT.save_tuned_entry(JT.TunedEntry("host_pipeline", {}, jax_machine, {"num_blocks": 2, "mj_nthread": 1}, {"steps_per_sec": 5.0}), path=path)
    JT.save_tuned_entry(JT.TunedEntry("refill", {"env": "humanoid", "mesh": "none"}, jax_machine, {"width": 64}), path=path)
    ours, theirs = PT.load_tuned_cache(path), JT.load_tuned_cache(path)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].to_json() == theirs[k].to_json()
    # readable, but measured by the JAX package on its own fingerprint:
    # the port's machine never matches it
    assert "runtime" not in jax_machine and PT.machine_fingerprint("cpu")["runtime"] == "torch"
    assert PT.lookup_tuned("host_pipeline", {}, machine=PT.machine_fingerprint("cpu"), path=path) is None
    assert PT.lookup_tuned("host_pipeline", {}, machine=jax_machine, path=path).config == {"num_blocks": 2, "mj_nthread": 1}
    # an unsharded lookup (mesh "none")
    assert PT.lookup_tuned("refill", {"env": "humanoid", "mesh": "none"}, machine=jax_machine, path=path).config == {"width": 64}
    assert PT.canonical_env_label("gym::Humanoid-v5") == JT.canonical_env_label("gym::Humanoid-v5")
    assert PT.timing_key("p", {"b": 1, "a": 2}, {"z": 0}) == JT.timing_key("p", {"b": 1, "a": 2}, {"z": 0})


def test_timing_ledger_matches_jax(tmp_path):
    records = [dict(program="p", shape={"n": 1}, config={"w": w}, samples=s, occupancy=o) for w, s, o in ((1, (3.0, 1.0, 2.0), 0.9), (2, (5.0, 4.0), 0.4))]
    ours, theirs = PT.TimingLedger(), JT.TimingLedger()
    for r in records:
        ours.add(PT.TimingRecord(**r))
        theirs.add(JT.TimingRecord(**r))
    for floor in (None, 0.5):
        assert ours.best("p", min_occupancy=floor).config == theirs.best("p", min_occupancy=floor).config
    ours.save(tmp_path / "ledger.json")
    assert JT.TimingLedger.load(tmp_path / "ledger.json").to_json() == theirs.to_json()


SPECS = [
    "eval.scores:nonfinite@2:0.5;hostpool.worker:kill@1",
    "a.b:advisory@1+;a.b:raise@3",
    "x:kill@2:7",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_and_firing_order_match_jax(spec, faults):
    parsed = [(r.site, r.kind, r.at, r.arg, r.sticky) for r in PF.parse_spec(spec)]
    assert parsed == [(r.site, r.kind, r.at, r.arg, r.sticky) for r in JF.parse_spec(spec)]
    sites = ["eval.scores", "hostpool.worker", "a.b", "x", "a.b", "x", "eval.scores", "a.b", "a.b"]
    fired = {}
    for name, module in (("port", PF), ("jax", JF)):
        module.configure(spec)
        seen = []
        for site in sites:
            try:
                rule = module.fault_point(site)
                seen.append(None if rule is None else (rule.site, rule.kind, rule.count))
            except OSError as exc:
                seen.append(("raised", type(exc).__name__, str(exc)))
        fired[name] = seen
    assert fired["port"] == fired["jax"]
    with pytest.raises(ValueError):
        PF.parse_spec("no-at-sign")


def test_fault_counters(faults):
    PF.configure("s:advisory@1")
    before = PReg.counters.get("faults.fired.s.advisory")
    assert PF.fault_point("s").kind == "advisory" and PF.fault_point("s") is None
    assert PReg.counters.get("faults.fired.s.advisory") == before + 1


def test_eval_scores_injection_picks_the_jax_indices(faults):
    from evotorch_tpu.neuroevolution import VecNE as JaxVecNE
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.neuroevolution import VecNE

    n = 12
    spec = "eval.scores:nonfinite@2:0.25"
    kw = dict(episode_length=5, nonfinite_quarantine=False)
    masks = {}
    for name, problem, module, reg, zeros in (
        ("port", VecNE("cartpole", "Linear(obs_length, act_length)", device="cpu", **kw), PF, PReg, lambda: torch.zeros(n)),
        ("jax", JaxVecNE("cartpole", "Linear(obs_length, act_length)", **kw), JF, JReg, lambda: np.zeros(n, np.float32)),
    ):
        module.configure(spec)
        before = reg.counters.get("faults.injected_nonfinite")
        first = np.asarray(problem._maybe_inject_nonfinite(zeros()))
        second = np.asarray(problem._maybe_inject_nonfinite(zeros()))
        assert np.isfinite(first).all()  # @2: the first call passes
        masks[name] = np.isnan(second)
        assert reg.counters.get("faults.injected_nonfinite") == before + 3
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    assert masks["port"].sum() == 3
    # through VecNE.evaluate with quarantine on: the injected scores become
    # the worst finite score, so the tell sees none
    PF.configure("eval.scores:nonfinite@1")
    problem = VecNE("cartpole", "Linear(obs_length, act_length)", device="cpu", episode_length=5)
    batch = SolutionBatch(problem, 8, values=torch.randn(8, problem.solution_length, generator=torch.Generator().manual_seed(0)))
    problem.evaluate(batch)
    assert bool(torch.isfinite(batch.evals).all())


def test_hostpool_worker_kill_respawns(faults):
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.parallel import HostEvaluatorPool
    from test_torch_hostpool import _serial, per_solution_sphere

    problem = Problem("min", per_solution_sphere, solution_length=3, initial_bounds=(-1, 1), device="cpu")
    pool = HostEvaluatorPool(problem, 2, seeds=[5, 6])
    keys = ("hostpool.worker_deaths", "hostpool.respawns", "faults.fired.hostpool.worker.kill")
    before = PReg.counters.snapshot(keys)
    try:
        PF.configure("hostpool.worker:kill@1:1")
        pieces = [torch.randn(n, 3, generator=torch.Generator().manual_seed(n)) for n in (3, 2, 4)]
        victim = pool.worker_pids[1]
        evals, _ = pool.evaluate_pieces(pieces, None)
        for piece, got in zip(pieces, evals):
            np.testing.assert_allclose(got[:, 0], _serial(piece).numpy(), rtol=1e-6)
        assert victim not in pool.worker_pids and pool.is_alive()
    finally:
        pool.shutdown()
    delta = PReg.counters.delta(before)
    assert delta["hostpool.worker_deaths"] == delta["hostpool.respawns"] == 1
    assert delta["faults.fired.hostpool.worker.kill"] == 1


# ---------------------------------------------------------------------------
# spans on the profiler's clock, inside the rollout's control step
# ---------------------------------------------------------------------------

#: the rollout's spans and the one of the rigid-body substeps
ROLLOUT_SPANS = ("rollout.ctrl_step", "rollout.policy", "rollout.env_step", "env.physics")


def _span_deltas(before):
    """The ``span.*`` counters that moved since ``before``, by how much."""
    after = PReg.counters.snapshot()
    return {k: v - before.get(k, 0) for k, v in after.items() if k.startswith("span.") and v != before.get(k, 0)}


def _humanoid_rollout(eval_mode, loop_stats, env=None):
    from evotorch_tpu_torch.envs.humanoid import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout

    env = Humanoid(device="cpu") if env is None else env
    policy = FlatParamsPolicy(Linear(env.observation_size, env.action_size))
    params = 0.01 * torch.randn(8, policy.parameter_count, generator=torch.Generator().manual_seed(0))
    refill = {"refill_width": 4} if eval_mode == "episodes_refill" else {}
    return run_vectorized_rollout(
        env, policy, params, torch.Generator().manual_seed(1), None, episode_length=4, eval_mode=eval_mode,
        loop_stats=loop_stats, **refill,
    )  # fmt: skip


def test_span_with_nothing_recording_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled and not PTr.tracing_enabled()
    assert PTr.span("rollout.ctrl_step", "rollout") is PTr._NOOP
    before = PReg.counters.snapshot()
    with PTr.span("x"):
        pass
    _humanoid_rollout("budget", {})
    assert _span_deltas(before) == {}


@pytest.mark.parametrize("eval_mode", ["budget", "episodes_refill"])
def test_rollout_spans_are_profiler_ranges_with_counters(eval_mode):
    from torch.profiler import ProfilerActivity, profile

    before = PReg.counters.snapshot()
    loop_stats = {}
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _humanoid_rollout(eval_mode, loop_stats)
    t1 = time.time_ns()
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name().startswith(PTr.RANGE_PREFIX)]
    assert {PTr.RANGE_PREFIX + n for n in ROLLOUT_SPANS} <= {e.name() for e in ranges}
    assert all(t0 <= e.start_ns() <= t1 for e in ranges)
    d = _span_deltas(before)
    steps = loop_stats["steps_issued"]
    assert steps > 0
    for name in ROLLOUT_SPANS:
        assert d[f"span.{name}.count"] == steps, name
    # the control step is its children (on the CPU the end poll never
    # waits: the one host wait is the round's final read, after the loop)
    # and its own bookkeeping
    ctrl = d["span.rollout.ctrl_step.seconds"]
    parts = d["span.rollout.policy.seconds"] + d["span.rollout.env_step.seconds"] + d["span.rollout.ctrl_step.self_seconds"]
    assert parts == pytest.approx(ctrl, rel=1e-9)
    assert d["span.env.physics.seconds"] <= d["span.rollout.env_step.seconds"]
    assert d.get("span.rollout.host_wait.count", 0) == (0 if eval_mode == "budget" else 1)


def test_a_span_records_through_an_exception_and_not_past_a_profiler_stop():
    from torch.profiler import ProfilerActivity, profile

    before = PReg.counters.snapshot()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with pytest.raises(RuntimeError):
        with PTr.span("probe.raised"):
            raise RuntimeError("passes through")
    with PTr.span("probe.cut"):
        with PTr.span("probe.whole"):
            pass
        prof.stop()  # the harness stops its profiler inside the env's step
    d = _span_deltas(before)
    assert d["span.probe.raised.count"] == d["span.probe.whole.count"] == 1
    assert "span.probe.cut.count" not in d
    assert {"evotorch_tpu_torch.probe.raised", "evotorch_tpu_torch.probe.whole"} <= {e.name() for e in prof.profiler.kineto_results.events()}


def test_span_tracer_events_are_on_the_epoch_clock():
    t0 = time.time_ns() / 1000
    tracer = PTr.start_tracing(None)
    try:
        with PTr.span("outer", "algo"):
            with PTr.span("inner", "algo"):
                pass
        PTr.instant("mark", "algo")
    finally:
        PTr.stop_tracing()
    t1 = time.time_ns() / 1000
    events = [e for e in tracer.events() if e["ph"] in ("X", "i")]
    assert len(events) == 3
    assert all(t0 <= e["ts"] <= e["ts"] + e.get("dur", 0) <= t1 for e in events)


def test_rollout_spans_keep_the_benchmark_wrappers():
    """The benchmark replaces ``vecrl._act_and_step`` (the module global)
    and the env instance's ``batch_step``: both wrappers run every step,
    spans recording or not."""
    from torch.profiler import ProfilerActivity, profile

    from evotorch_tpu_torch.envs.humanoid import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import vecrl

    original = vecrl._act_and_step
    calls = {"act": 0, "env": 0}

    def act(*args, **kwargs):
        calls["act"] += 1
        return original(*args, **kwargs)

    env = Humanoid(device="cpu")
    env_step = env.batch_step

    def batch_step(*args, **kwargs):
        calls["env"] += 1
        return env_step(*args, **kwargs)

    env.batch_step = batch_step
    vecrl._act_and_step = act
    try:
        for recording in (False, True):
            calls.update(act=0, env=0)
            loop_stats = {}
            if recording:
                with profile(activities=[ProfilerActivity.CPU]):
                    _humanoid_rollout("episodes_refill", loop_stats, env=env)
            else:
                _humanoid_rollout("episodes_refill", loop_stats, env=env)
            assert calls["act"] == calls["env"] == loop_stats["steps_issued"] > 0
    finally:
        vecrl._act_and_step = original
