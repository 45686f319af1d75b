"""The first-use sentinel (``evotorch_tpu_torch/analysis/retrace_sentinel.py``)
and the kernel-build cache's counts (``observability/compilecache.py``): the
counterpart of ``tests/test_retrace_sentinel.py``. Where the JAX sentinel
counts XLA compiles, the port's counts kernel libraries built or loaded and,
on the card, new allocator segments (held in ``tests/test_torch_cuda.py``).
"""

import sys
import threading
import types

import pytest
import torch

from evotorch_tpu_torch.analysis import RetraceError, assert_first_use, track_first_use
from evotorch_tpu_torch.observability import compilecache
from evotorch_tpu_torch.observability.registry import counters
from evotorch_tpu_torch.ops import _build


@pytest.fixture
def stub_loader(tmp_path, monkeypatch):
    """``_build.library`` with nothing loaded yet and a loader that opens
    no file: every call of a new name is one load from the build
    directory."""
    library = tmp_path / "stub.so"
    library.write_bytes(b"")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_library_path", lambda name: library)
    monkeypatch.setattr(_build, "_load_library", lambda path: types.SimpleNamespace())
    return library


def test_canary_counts_one_build(stub_loader):
    compilecache.reset_stats()
    before = counters.snapshot(("compiles", "compile_seconds"))
    with track_first_use() as log:
        _build.library("centered_rank", {})
    assert log.builds == 1 and log.count == 1 and log.segments == 0
    with track_first_use() as log:
        _build.library("centered_rank", {})  # loaded: nothing to do
    assert log.count == 0
    stats = compilecache.cache_stats()
    assert (stats["hits"], stats["misses"]) == (1, 0)
    delta = counters.delta(before)
    assert delta["compiles"] == 1 and delta["compile_seconds"] >= 0.0


def test_a_build_counts_as_a_miss(stub_loader, monkeypatch):
    """A library missing from the build directory is built (one ``nvcc``
    run, here stubbed): one miss and one first use, not a hit as well; and
    a library built by ``build()`` before ``library()`` loads it counts once,
    as the miss."""
    missing = stub_loader.with_name("missing.so")
    monkeypatch.setattr(_build, "_library_path", lambda name: missing)
    monkeypatch.setattr(_build, "_built", set())

    def fake_build(names):
        for name in names:
            _build._built.add(name)
            compilecache.record_load(built=True, seconds=0.25)

    monkeypatch.setattr(_build, "build", fake_build)
    compilecache.reset_stats()
    with track_first_use() as log:
        _build.library("symmetric_gaussian", {})
    stats = compilecache.cache_stats()
    assert log.builds == 1 and (stats["hits"], stats["misses"], stats["seconds"]) == (0, 1, 0.25)

    monkeypatch.setattr(_build, "_library_path", lambda name: stub_loader)
    with track_first_use() as log:
        _build.build(("centered_rank",))  # a build of this process, then its load
        _build.library("centered_rank", {})
    stats = compilecache.cache_stats()
    assert log.builds == 1 and (stats["hits"], stats["misses"]) == (0, 2)


def test_each_build_is_charged_its_own_seconds(monkeypatch, tmp_path):
    """``build()`` runs its ``nvcc`` processes together, and charges each
    its own seconds, not the time since the first started."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_built", set())
    monkeypatch.setattr(_build, "_library_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build, "nvcc_command", lambda source, target, extra=(): [name_of(target), str(target)])
    waits = {"fast": 0.0, "slow": 0.6}

    def name_of(target):
        return "fast" if "fast" in str(target) else "slow"

    def fake_run(cmd, **kw):
        import time

        time.sleep(waits[cmd[0]])
        open(cmd[1], "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    before = counters.snapshot(("compiles", "compile_seconds"))
    _build.build(("slow", "fast"))
    delta = counters.delta(before)
    assert delta["compiles"] == 2 and 0.6 <= delta["compile_seconds"] < 0.9
    assert _build._built == {"slow", "fast"}


def test_tracking_nests(stub_loader):
    """Counterpart of ``tests/test_retrace_sentinel.py::test_nested``: every
    active block sees every build; an inner block only its own."""
    with track_first_use() as outer:
        _build.library("a", {})
        with track_first_use() as inner:
            _build.library("b", {})
        _build.library("c", {})
    assert outer.builds == 3 and inner.builds == 1


def test_tracking_is_thread_safe():
    """Counterpart of ``tests/test_retrace_sentinel.py``'s threaded test:
    builds reported from many threads (more than the cores, a short switch
    interval) while blocks open and close are all seen by the block that
    spans them, none lost."""
    threads, per_thread = 16, 200
    seen = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with track_first_use() as log:

            def work(k):
                for i in range(per_thread):
                    with track_first_use() as inner:
                        compilecache.record_load(built=False, seconds=0.0)
                    seen.append(inner.builds)

            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert log.count == log.builds == threads * per_thread
    assert len(seen) == threads * per_thread and min(seen) >= 1


def test_assert_first_use_raises_over_its_budget(stub_loader):
    with assert_first_use(0):
        pass
    with pytest.raises(RetraceError, match="observed 1"):
        with assert_first_use(0):
            _build.library("x", {})
    with assert_first_use(1):
        _build.library("y", {})
    with pytest.raises(RetraceError, match="observed 2: 2 kernel libraries"):
        with assert_first_use(1):
            _build.library("z", {})
            _build.library("w", {})


@pytest.mark.parametrize("contract", ["budget", "episodes", "episodes_refill", "episodes_compact"])
def test_each_contract_second_call_does_no_first_use_work(contract):
    from evotorch_tpu_torch.envs import make_env
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
    from evotorch_tpu_torch.neuroevolution.net.runningnorm import RunningNorm
    from evotorch_tpu_torch.neuroevolution.net.vecrl import run_vectorized_rollout, run_vectorized_rollout_compacting

    env = make_env("cartpole", device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [8]))
    values = 0.1 * torch.randn((16, policy.parameter_count), generator=torch.Generator().manual_seed(0))
    stats = RunningNorm(env.observation_size, device="cpu").stats

    def call(seed):
        generator = torch.Generator().manual_seed(seed)
        if contract == "episodes_compact":
            return run_vectorized_rollout_compacting(env, policy, values, generator, stats, episode_length=20, chunk_size=4, allowed_widths=(4, 8))
        extra = {"refill_width": 4} if contract == "episodes_refill" else {}
        return run_vectorized_rollout(env, policy, values, generator, stats, episode_length=20, eval_mode=contract, **extra)

    call(0)
    with assert_first_use(0):
        call(1)


def test_search_step_publishes_compile_deltas(stub_loader):
    """``SearchAlgorithm.step`` publishes the step's ``compiles`` and
    ``compile_seconds`` deltas, as the JAX package does: a kernel library
    loaded inside a step counts there."""
    from evotorch_tpu_torch.algorithms import SNES
    from evotorch_tpu_torch.core import Problem

    loads = []

    def fitness(x):
        for name in loads:
            _build.library(name, {})
        return (x**2).sum(dim=-1)

    problem = Problem("min", fitness, solution_length=4, initial_bounds=(-1, 1), vectorized=True, device="cpu")
    searcher = SNES(problem, stdev_init=0.5, popsize=8)
    searcher.step()
    assert searcher.status["compiles"] == 0 and searcher.status["compile_seconds"] == 0
    loads.append("in_a_step")
    searcher.step()
    assert searcher.status["compiles"] == 1
    searcher.step()  # loaded: nothing more
    assert searcher.status["compiles"] == 0


def test_assert_first_use_match_counts_and_names_the_matching_loads(stub_loader):
    """C.16, the counterpart of ``tests/test_retrace_sentinel.py::
    test_sentinel_assert_compiles_raises``: the log keeps the names it is
    given; ``assert_first_use(1, match=...)`` counts only the matching
    libraries and passes where ``assert_first_use(0)`` raises; the raise
    names what it counted."""
    with pytest.raises(RetraceError, match="centered_rank"):
        with assert_first_use(0):
            _build.library("centered_rank", {})
    _build._loaded.clear()
    with assert_first_use(1, match="centered") as log:
        _build.library("centered_rank", {})
        _build.library("symmetric_gaussian", {})
    assert log.names == ["centered_rank", "symmetric_gaussian"] and log.builds == 2
    assert log.count_matching("centered") == 1 and log.count_matching("rank") == 1
    _build._loaded.clear()
    with pytest.raises(RetraceError, match=r"matching 'symmetric', observed 1: \['symmetric_gaussian'\]"):
        with assert_first_use(0, match="symmetric"):
            _build.library("centered_rank", {})
            _build.library("symmetric_gaussian", {})
    _build._loaded.clear()
    with assert_first_use(0, match="nothing_of_that_name"):
        _build.library("centered_rank", {})


def test_a_log_sees_only_the_loads_of_its_block(stub_loader):
    """Nested blocks: each log names the libraries loaded while it was
    open, and no log stays a sink after its block."""
    from evotorch_tpu_torch.analysis import retrace_sentinel

    with track_first_use() as outer:
        _build.library("centered_rank", {})
        with track_first_use() as inner:
            _build.library("symmetric_gaussian", {})
    assert outer.names == ["centered_rank", "symmetric_gaussian"] and inner.names == ["symmetric_gaussian"]
    assert not any(sink is outer or sink is inner for sink in retrace_sentinel._SINKS)
