"""The port's multi-tenant evaluation service (``evotorch_tpu_torch.serving``)
on the CPU: the counterpart of ``tests/test_serving.py``, and the port's
server held against the JAX package's.

The acceptance spine: (1) items of two or more tenants packed into one
``episodes_refill`` dispatch score, per tenant, bit for bit what each
tenant's standalone run at the server's refill width scores, from the same
generator state; (2) tenant churn re-dispatches the same resident
configuration: where the JAX tests count compiles, these check the
residency key (``program.key``), the program object and the dispatch
count; (3) the group plane credits steps and episodes to the right tenant.

Against the JAX server (CartPole): the JAX request's per-item reset draws
(``split(fold_in(key, i))[1]`` for request-local item ``i``) are injected
into the port's request as its table rows (``submit(tables=...)``), and each
tenant's scores agree within ``atol=1e-4`` with equal ranks (the contracts
tests' tolerance: the dynamics round their FMAs otherwise), its counters
exactly.
"""

import io
import json
import threading

import jax
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from evotorch_tpu_torch.envs import CartPole
from evotorch_tpu_torch.neuroevolution import VecNE
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, Tanh
from evotorch_tpu_torch.neuroevolution.net.vecrl import SolutionTables, draw_solution_tables, run_vectorized_rollout
from evotorch_tpu_torch.observability import GroupTelemetry
from evotorch_tpu_torch.parallel import make_resident_rollout_program
from evotorch_tpu_torch.serving import EvalServer, FIFOAdmission, RemoteEvalBackend, StarvationAwareAdmission, serve_stdio
from test_torch_contracts import _cartpole_rows


def _env():
    return CartPole(continuous_actions=True, device="cpu")


def _policy(env):
    return FlatParamsPolicy(Linear(env.observation_size, env.action_size) >> Tanh())


def _values(policy, n, seed):
    return np.random.default_rng(seed).normal(size=(n, policy.parameter_count)).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _standalone_refill(env, policy, values, generator, **kw):
    return run_vectorized_rollout(
        env, policy, torch.as_tensor(values), generator, None, eval_mode="episodes_refill", num_episodes=1, **kw
    )


def _server(env=None, policy=None, **kw):
    env = _env() if env is None else env
    return EvalServer(env, _policy(env) if policy is None else policy, device="cpu", **kw)


# ---------------------------------------------------------------- engine level


def test_refill_group_rebinding_credits_and_keeps_the_scores():
    """Lane rebinding A -> B credits steps and episodes to the right groups;
    randomness belongs to the solutions' tables, so the scores do not move."""
    env = _env()
    policy = _policy(env)
    n, width = 8, 3  # width < n: lanes are recycled
    values = torch.from_numpy(_values(policy, n, 0))
    tables = draw_solution_tables(env, n, _gen(5))
    program = make_resident_rollout_program(env, policy, device="cpu", num_groups=3, refill_width=width)
    groups_a = torch.tensor([1, 1, 1, 1, 2, 2, 2, 2])
    groups_b = torch.tensor([2, 2, 1, 1, 1, 1, 2, 2])
    res_a = program(values, _gen(9), None, None, groups_a, tables)
    key = program.key
    res_b = program(values, _gen(9), None, None, groups_b, tables)
    assert program.key == key and program.dispatches == 2
    assert torch.equal(res_a.scores, res_b.scores)
    # CartPole pays 1 a step: a solution's score is its episode's length
    gt = GroupTelemetry.from_array(res_b.telemetry)
    for g in (1, 2):
        mask = groups_b == g
        assert gt.group(g).episodes == int(mask.sum())
        assert gt.group(g).env_steps == int(res_b.scores[mask].sum())
    assert int(res_b.total_steps) == int(res_b.scores.sum())  # a device scalar, read with the scores


def test_resident_program_packs_two_tenants_bit_identical():
    env = _env()
    policy = _policy(env)
    n1, n2 = 3, 5
    v1, v2 = _values(policy, n1, 1), _values(policy, n2, 2)
    ref1 = _standalone_refill(env, policy, v1, _gen(11), refill_width=4)
    ref2 = _standalone_refill(env, policy, v2, _gen(22), refill_width=4)
    program = make_resident_rollout_program(env, policy, device="cpu", num_groups=3, refill_width=4)
    t1, t2 = draw_solution_tables(env, n1, _gen(11)), draw_solution_tables(env, n2, _gen(22))
    slab = torch.from_numpy(np.concatenate([v1, v2]))
    groups = torch.tensor([1] * n1 + [2] * n2)
    out = program(slab, _gen(0), None, None, groups, SolutionTables(torch.cat([t1.reset, t2.reset])))
    assert torch.equal(out.scores[:n1], ref1.scores) and torch.equal(out.scores[n1:], ref2.scores)
    assert program.dispatches == 1 and program.key[2] == "episodes_refill"
    with pytest.raises(ValueError, match="episodes_refill"):
        make_resident_rollout_program(env, policy, device="cpu", eval_mode="budget")
    with pytest.raises(ValueError, match="per-dispatch"):
        make_resident_rollout_program(env, policy, device="cpu", groups=groups)


# ---------------------------------------------------------------- server level


def test_server_packs_two_tenants_one_dispatch_bit_identical():
    env = _env()
    policy = _policy(env)
    n1, n2 = 3, 5
    v1, v2 = _values(policy, n1, 1), _values(policy, n2, 2)
    server = _server(env, policy, slab_size=n1 + n2, max_tenants=2)
    t1, t2 = server.admit("a"), server.admit("b")
    f1, f2 = server.submit(t1, v1, _gen(11)), server.submit(t2, v2, _gen(22))
    assert not f1.done() and not f2.done()
    server.drain()
    assert server.dispatches == 1 and server.occupancy() == 1.0
    r1, r2 = f1.result(), f2.result()
    ref1 = _standalone_refill(env, policy, v1, _gen(11), refill_width=server.refill_width)
    ref2 = _standalone_refill(env, policy, v2, _gen(22), refill_width=server.refill_width)
    assert torch.equal(r1.scores, ref1.scores) and torch.equal(r2.scores, ref2.scores)
    assert r1.total_episodes == n1 and r2.total_episodes == n2
    assert r1.total_steps == int(r1.scores.sum()) and r2.total_steps == int(r2.scores.sum())


def test_server_padding_rows_stay_in_group_zero():
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=8, max_tenants=2)
    tenant = server.admit()
    values = _values(policy, 5, 3)
    future = server.submit(tenant, values, _gen(7))
    server.drain()
    result = future.result()
    assert result.total_episodes == 5 and server.occupancy() == 5 / 8
    ref = _standalone_refill(env, policy, values, _gen(7), refill_width=server.refill_width)
    assert torch.equal(result.scores, ref.scores)
    # the 3 padding rows ran (first-row copies) and were charged to group 0 only
    assert tenant.telemetry.group(0).episodes == 5
    assert server.status()["tenants"]["tenant1"]["episodes"] == 5
    wire = server.last_telemetry
    assert wire.group(0).episodes == 3 and wire.group(0).env_steps > 0
    assert wire.group(1).episodes == 5 and wire.group(1).env_steps == result.total_steps
    assert wire.group(2).episodes == 0 and wire.group(2).env_steps == 0


def test_server_churn_keeps_the_resident_program():
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=6, max_tenants=3)
    program, key = server.program, server.program.key
    t1, t2 = server.admit("a"), server.admit("b")

    def round_trip(tenant, seed):
        future = server.submit(tenant, _values(policy, 3, seed), _gen(seed))
        before = program.dispatches
        served = server.step()
        assert served > 0 and program.dispatches == before + 1
        server.drain()
        return future.result()

    round_trip(t1, 1), round_trip(t2, 2)
    server.depart(t2)
    t3 = server.admit("c")  # reuses t2's group row
    assert t3.group == 2
    round_trip(t1, 5), round_trip(t3, 6)
    fa = server.submit(t1, _values(policy, 2, 7), _gen(7))
    fb = server.submit(t3, _values(policy, 3, 8), _gen(8))
    server.drain()
    fa.result(), fb.result()
    assert server.program is program and program.key == key
    assert program.dispatches == server.dispatches == 5


def test_server_obs_norm_slots_are_isolated():
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=6, max_tenants=2, observation_normalization=True)
    t1, t2 = server.admit("a"), server.admit("b")
    f1 = server.submit(t1, _values(policy, 3, 1), _gen(1))
    f2 = server.submit(t2, _values(policy, 3, 2), _gen(2))
    server.drain()
    f1.result(), f2.result()
    s1, s2 = server.tenant_stats(t1), server.tenant_stats(t2)
    assert float(s1.count) > 0 and float(s2.count) > 0
    assert not torch.equal(s1.sum, s2.sum)
    before = s2.sum.clone()
    server.depart(t1)
    assert torch.equal(server.tenant_stats(t2).sum, before)
    t3 = server.admit("c")
    assert t3.group == t1.group and float(server.tenant_stats(t3).count) == 0.0


def test_server_slo_suspension_gates_submits_but_drains():
    env = _env()
    policy = _policy(env)
    # occupancy is at most 1.0, so a floor of 1.5 trips on the first dispatch
    server = _server(env, policy, slab_size=4, max_tenants=2, slo=[{"kind": "occupancy_floor", "threshold": 1.5}])
    tenant = server.admit("hot")
    f1 = server.submit(tenant, _values(policy, 4, 1), _gen(1))
    f2 = server.submit(tenant, _values(policy, 4, 2), _gen(2))
    assert server.step() == 4 and tenant.suspended
    with pytest.raises(RuntimeError, match="suspended"):
        server.submit(tenant, _values(policy, 4, 3))
    server.drain()
    assert f1.done() and f2.done() and bool(torch.isfinite(f2.result().scores).all())
    status = server.status()["tenants"]["hot"]
    assert status["suspended"] and status["slo_ok"] is False


def test_server_depart_cancel_errors_pending_futures():
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=4, max_tenants=2)
    tenant = server.admit()
    future = server.submit(tenant, _values(policy, 4, 1))
    with pytest.raises(RuntimeError, match="pending work"):
        server.depart(tenant)
    server.depart(tenant, cancel=True)
    with pytest.raises(RuntimeError, match="cancelled"):
        future.result()
    assert server.admit("next") is not None


def test_server_full_and_bad_submit_shapes():
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=4, max_tenants=1)
    tenant = server.admit()
    with pytest.raises(RuntimeError, match="full"):
        server.admit()
    with pytest.raises(ValueError, match="values must be"):
        server.submit(tenant, np.zeros((3, policy.parameter_count + 1), np.float32))
    with pytest.raises(ValueError, match="not admitted"):
        other = _server(env, policy, slab_size=4).admit()
        server.submit(other, _values(policy, 2, 0))
    with pytest.raises(ValueError, match="not both"):
        server.submit(tenant, _values(policy, 2, 0), _gen(0), tables=draw_solution_tables(env, 2, _gen(0)))


def test_default_request_generators_are_reproducible():
    env = _env()
    policy = _policy(env)
    runs = []
    for _ in range(2):
        server = _server(env, policy, slab_size=4, seed=3)
        tenant = server.admit()
        future = server.submit(tenant, _values(policy, 4, 1))
        server.drain()
        runs.append(future.result().scores)
    assert torch.equal(runs[0], runs[1])


def test_server_threads_serve_each_other():
    """Two clients in two threads: each ``result()`` drives the server under
    its lock, one dispatch at a time, and whichever thread runs a dispatch
    serves the other's items too; every tenant's scores stay its
    standalone ones."""
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=6, max_tenants=2)
    tenants = [server.admit("a"), server.admit("b")]
    values = [_values(policy, 5, 10 + k) for k in range(2)]
    out, errors = {}, []

    def client(k):
        try:
            for r in range(3):
                out[(k, r)] = server.submit(tenants[k], values[k], _gen(100 * k + r)).result().scores
        except BaseException as exc:  # re-raised in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(out) == 6
    for (k, r), scores in out.items():
        ref = _standalone_refill(env, policy, values[k], _gen(100 * k + r), refill_width=server.refill_width)
        assert torch.equal(scores, ref.scores)


def test_server_holding_gathers_two_clients_into_one_dispatch():
    """While ``holding()``, a client's ``result()`` waits to dispatch; the
    requests submitted meanwhile share the next dispatch."""
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=10, max_tenants=2)
    tenants = [server.admit("a"), server.admit("b")]
    values = [_values(policy, 5, 20 + k) for k in range(2)]
    out, errors = {}, []

    def client(k):
        try:
            out[k] = server.submit(tenants[k], values[k], _gen(k)).result().scores
        except BaseException as exc:  # re-raised in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    with server.holding():
        for t in threads:
            t.start()
        while not all(t.pending for t in tenants) and not errors:
            threading.Event().wait(0.001)
        assert server.dispatches == 0
    for t in threads:
        t.join(120)
    assert not errors and server.dispatches == 1 and server.occupancy() == 1.0
    for k in range(2):
        ref = _standalone_refill(env, policy, values[k], _gen(k), refill_width=server.refill_width)
        assert torch.equal(out[k], ref.scores)


# ----------------------------------------------------------- admission polices


class _FakeTenant:
    def __init__(self, group, oldest, telemetry=None):
        self.group = group
        self._oldest = oldest
        self.telemetry = telemetry

    def oldest_pending_dispatch(self):
        return self._oldest


class _FakeWaits:
    def __init__(self, starvation, p99):
        self._starvation = starvation
        self._p99 = p99

    def starvation_share(self):
        return self._starvation

    def queue_wait_quantile(self, q):
        return self._p99


def test_admission_fifo_orders_by_oldest_pending():
    a, b, c = _FakeTenant(1, oldest=7), _FakeTenant(2, oldest=3), _FakeTenant(3, oldest=7)
    assert FIFOAdmission().order([a, b, c], None) == [b, a, c]


def test_admission_starvation_prioritizes_starved_tenants():
    fresh = _FakeTenant(1, oldest=0)
    starved = _FakeTenant(2, oldest=5, telemetry=_FakeWaits(0.5, 64.0))
    healthy = _FakeTenant(3, oldest=1, telemetry=_FakeWaits(0.0, 2.0))
    assert StarvationAwareAdmission().order([fresh, healthy, starved], None) == [starved, healthy, fresh]
    assert StarvationAwareAdmission(bias=1.0).order([healthy, fresh], None)[0] is fresh


# -------------------------------------------------------------- VecNE backend


def _vecne(**kw):
    return VecNE(
        "cartpole", "Linear(obs_length, act_length)", env_config={"continuous_actions": True}, seed=13, device="cpu",
        eval_mode="episodes_refill", **kw,
    )  # fmt: skip


def _eval_scores(problem, values):
    batch = problem.generate_batch(len(values))
    batch.set_values(torch.from_numpy(values))
    problem.evaluate(batch)
    return batch.evals[:, 0].clone()


def _serving_server(max_tenants=2, slab=8, **kw):
    env = _env()
    return EvalServer(env, FlatParamsPolicy(Linear(env.observation_size, env.action_size)), slab_size=slab, max_tenants=max_tenants, device="cpu", **kw)


def test_remote_backend_bit_identical_to_standalone_vecne():
    server = _serving_server()
    width = {"width": server.refill_width}
    rng = np.random.default_rng(0)
    ref = _vecne(refill_config=width)
    values = rng.normal(size=(6, ref.solution_length)).astype(np.float32)
    served = _vecne(eval_backend=RemoteEvalBackend(server, name="p1"))
    for _ in range(2):  # generation by generation: the generators stay in step
        assert torch.equal(_eval_scores(served, values), _eval_scores(ref, values))
    assert torch.equal(served.generator.get_state(), ref.generator.get_state())
    assert served.eval_backend is not None and server.dispatches >= 2
    assert served.status["total_interaction_count"] == ref.status["total_interaction_count"]
    served2 = _vecne(eval_backend=server)  # a server is wrapped
    values2 = rng.normal(size=(5, ref.solution_length)).astype(np.float32)
    assert torch.equal(_eval_scores(served2, values2), _eval_scores(_vecne(refill_config=width), values2))
    assert len(server.tenants) == 2


def test_remote_backend_rejects_contract_mismatch_and_groups():
    server = _serving_server()
    problem = _vecne(num_episodes=2)
    backend = RemoteEvalBackend(server, name="bad")
    values = torch.from_numpy(np.random.default_rng(1).normal(size=(4, problem.solution_length)).astype(np.float32))
    with pytest.raises(ValueError, match="num_episodes"):
        backend.evaluate(problem, values, _gen(0))
    backend.close()
    with pytest.raises(ValueError, match="solution_groups"):
        _vecne(eval_backend=_serving_server(), solution_groups=np.zeros(4, dtype=np.int32))
    with pytest.raises(TypeError, match="eval_backend"):
        _vecne(eval_backend=object())
    with pytest.raises(ValueError, match="budget"):
        budget = VecNE("cartpole", "Linear(obs_length, act_length)", env_config={"continuous_actions": True}, device="cpu", eval_mode="budget")
        RemoteEvalBackend(_serving_server()).evaluate(budget, values, _gen(0))


def test_vecne_backend_churn_keeps_the_resident_program():
    server = _serving_server(max_tenants=3)
    program, key = server.program, server.program.key
    rng = np.random.default_rng(2)
    p1 = _vecne(eval_backend=RemoteEvalBackend(server, name="a"))
    p2 = _vecne(eval_backend=RemoteEvalBackend(server, name="b"))
    n = 4
    for problem in (p1, p2):
        _eval_scores(problem, rng.normal(size=(n, p1.solution_length)).astype(np.float32))
    p2.eval_backend.close()
    p3 = _vecne(eval_backend=RemoteEvalBackend(server, name="c"))
    before = program.dispatches
    _eval_scores(p1, rng.normal(size=(n, p1.solution_length)).astype(np.float32))
    _eval_scores(p3, rng.normal(size=(n, p1.solution_length)).astype(np.float32))
    assert server.program is program and program.key == key and program.dispatches == before + 2


# ------------------------------------------------------------------ stdio front


def test_stdio_protocol_roundtrip():
    server = _serving_server(slab=4)
    params = server.policy.parameter_count
    lines = [
        {"op": "admit", "tenant": "cli"},
        {"op": "submit", "tenant": "cli", "id": "s1", "values": [[0.0] * params for _ in range(3)], "seed": 5},
        {"op": "poll", "request_id": 0},
        {"op": "result", "request_id": 0},
        {"op": "status"},
        {"op": "nope"},
        {"op": "depart", "tenant": "cli"},
        {"op": "shutdown"},
        {"op": "never-reached"},
    ]
    infile = io.StringIO("\n".join(json.dumps(l) for l in lines) + "\n")
    outfile = io.StringIO()
    handled = serve_stdio(server, infile, outfile)
    out = [json.loads(l) for l in outfile.getvalue().splitlines()]
    assert handled == 8
    admit, submit, poll, result, status, bogus, depart, shutdown = out
    assert admit == {"ok": True, "op": "admit", "tenant": "cli", "group": 1}
    assert submit["ok"] and submit["request_id"] == 0 and submit["id"] == "s1"
    assert poll["done"] is False
    assert result["ok"] and len(result["scores"]) == 3
    assert result["env_steps"] > 0 and "queue_wait_p99" in result
    assert status["ok"] and status["tenants"]["cli"]["requests_served"] == 1
    assert bogus["ok"] is False and "unknown op" in bogus["error"]
    assert depart["ok"] and shutdown == {"ok": True, "op": "shutdown"}
    # the seed's generator drew the rows: the scores are that standalone run's
    ref = _standalone_refill(server.env, server.policy, np.zeros((3, params), np.float32), _gen(5), refill_width=server.refill_width)
    assert result["scores"] == [float(s) for s in ref.scores]


def test_stdio_errors_do_not_kill_the_server():
    server = _serving_server(slab=4)
    infile = io.StringIO(
        "not json\n"
        + json.dumps({"op": "submit", "tenant": "ghost", "values": [[0.0]]})
        + "\n"
        + json.dumps({"op": "admit", "tenant": "ok"})
        + "\n"
    )
    outfile = io.StringIO()
    serve_stdio(server, infile, outfile)
    out = [json.loads(l) for l in outfile.getvalue().splitlines()]
    assert out[0]["ok"] is False and out[1]["ok"] is False
    assert out[2]["ok"] is True and out[2]["tenant"] == "ok"


# ----------------------------------------------------------------- SLO plumbing


def test_check_bench_max_queue_wait_flag(tmp_path):
    from evotorch_tpu_torch.observability.slo import _main, check_bench_line

    line = {"queue_wait_p99": 2.0, "serve_queue_wait_p99": 70.0, "modes": {"episodes_refill": {"queue_wait_p99": 8.0}}}
    assert check_bench_line(line, max_queue_wait_p99=100.0).ok
    report = check_bench_line(line, max_queue_wait_p99=10.0)
    assert not report.ok and any("serve_queue_wait_p99" in v for v in report.violations)
    log = tmp_path / "bench.log"
    log.write_text(json.dumps(line) + "\n")
    assert _main(["--check-bench", str(log), "--max-queue-wait-p99", "1"]) == 1
    assert _main(["--check-bench", str(log), "--max-queue-wait-p99", "1000"]) == 0
    log.write_text(json.dumps({"unrelated": 1}) + "\n")
    assert _main(["--check-bench", str(log), "--max-queue-wait-p99", "1"]) == 2


def test_tuned_cache_writes_are_atomic(tmp_path):
    import importlib

    from evotorch_tpu_torch.observability.registry import counters
    from evotorch_tpu_torch.resilience import faults

    timings = importlib.import_module("evotorch_tpu_torch.observability.timings")
    cache = tmp_path / "tuned_configs.json"
    machine = {"host": "testbox"}
    entry = timings.TunedEntry(group="refill", shape={"env": "cartpole", "popsize": 8}, machine=machine, config={"width": 4})
    retries = counters.get("retry.timings.write.retries")
    faults.configure("timings.write:raise@1")
    try:
        timings.save_tuned_entry(entry, path=cache)
    finally:
        faults.configure(None)
    assert counters.get("retry.timings.write.retries") == retries + 1
    assert json.loads(cache.read_text())
    assert not list(tmp_path.glob("*.tmp.*")), "tmp residue left behind"
    loaded = timings.lookup_tuned("refill", entry.shape, machine=machine, path=cache)
    assert loaded is not None and loaded.config == {"width": 4}


def test_server_soak_random_churn_stays_resident():
    """Rounds of random admit, depart and submit against one server: every
    future completes, occupancy stays consistent, the program never
    changes."""
    env = _env()
    policy = _policy(env)
    server = _server(env, policy, slab_size=8, max_tenants=3, admission="starvation")
    program, key = server.program, server.program.key
    rng = np.random.default_rng(0)
    tenants = [server.admit(f"t{i}") for i in range(3)]
    seeds = iter(range(1, 1000))

    def submit_random(tenant):
        seed = next(seeds)
        return server.submit(tenant, _values(policy, int(rng.integers(1, 7)), seed), _gen(seed))

    for round_idx in range(12):
        action = rng.integers(0, 4)
        if action == 0 and len(tenants) > 1:
            server.depart(tenants.pop(int(rng.integers(0, len(tenants)))), cancel=True)
        elif action == 1 and len(tenants) < 3:
            tenants.append(server.admit(f"r{round_idx}"))
        futures = [submit_random(t) for t in tenants]
        server.drain()
        assert all(f.done() for f in futures)
    assert server.program is program and program.key == key
    assert 0.0 < server.occupancy() <= 1.0
    assert server.items_served <= server.dispatches * server.slab_size


# -------------------------------------------------------------- against JAX


def test_packed_scores_match_the_jax_server():
    """Two tenants on the JAX ``EvalServer`` and on the port's, the JAX
    requests' reset draws injected as the port's table rows: per tenant the
    scores agree (atol 1e-4, equal ranks) and the counters exactly; and on
    the port each tenant's packed scores equal its standalone run with the
    same rows bit for bit."""
    from evotorch_tpu.envs import CartPole as JaxCartPole
    from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy
    from evotorch_tpu.neuroevolution.net import Linear as JaxLinear
    from evotorch_tpu.neuroevolution.net import Tanh as JaxTanh
    from evotorch_tpu.serving import EvalServer as JaxEvalServer

    env = _env()
    policy = _policy(env)
    jax_server = JaxEvalServer(JaxCartPole(continuous_actions=True), JaxFlatParamsPolicy(JaxLinear(4, 1) >> JaxTanh()), slab_size=12, max_tenants=2)
    server = _server(env, policy, slab_size=12, max_tenants=2)
    assert server.refill_width == 12
    sizes, keys = (7, 9), (jax.random.key(31), jax.random.key(32))
    values = [_values(policy, n, 40 + n) for n in sizes]
    jax_futures, futures = [], []
    for k, (n, key) in enumerate(zip(sizes, keys)):
        jt, t = jax_server.admit(f"t{k}"), server.admit(f"t{k}")
        jax_futures.append(jax_server.submit(jt, values[k], key))
        rows = torch.from_numpy(_cartpole_rows(key, n))[:, None, :]
        futures.append(server.submit(t, values[k], tables=SolutionTables(rows)))
    jax_server.drain()
    server.drain()
    assert server.dispatches == jax_server.dispatches == 2
    for k, (jf, f) in enumerate(zip(jax_futures, futures)):
        theirs, ours = jf.result(), f.result()
        np.testing.assert_allclose(ours.scores.numpy(), np.asarray(theirs.scores), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(rankdata(ours.scores.numpy()), rankdata(np.asarray(theirs.scores)))
        assert ours.total_steps == int(theirs.total_steps) and ours.total_episodes == int(theirs.total_episodes)
        rows = torch.from_numpy(_cartpole_rows(keys[k], sizes[k]))
        ref = run_vectorized_rollout(
            env, policy, torch.from_numpy(values[k]), _gen(0), None, eval_mode="episodes_refill",
            refill_width=server.refill_width, reset_noise=rows,
        )  # fmt: skip
        assert torch.equal(ours.scores, ref.scores)
    assert server.status()["tenants"]["t0"]["env_steps"] == jax_server.status()["tenants"]["t0"]["env_steps"]
