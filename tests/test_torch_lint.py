"""graftlint of the port (``evotorch_tpu_torch/analysis``): a flag case and an
accept case for every rule of every checker on synthetic sources, the
scoped allow-comments and the multiset baseline run through the port, the
gate over the port's linted surface, parity with the JAX package's lint on
its own snippets (``tests/test_lint.py``), and the CLI's exit codes.

Rules that hold in package code only are linted under a path inside
``evotorch_tpu_torch/``; the hot-path rules under one of the hot modules
(``checkers.HOT_MODULES``)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from evotorch_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    default_baseline_path,
    lint_sources,
    load_baseline,
    run_lint,
    save_baseline,
)
from evotorch_tpu_torch.analysis import __main__ as cli
from evotorch_tpu_torch.analysis import checkers, graftlint

REPO_ROOT = Path(__file__).resolve().parents[1]
PKG = "evotorch_tpu_torch/somewhere.py"
HOT = "evotorch_tpu_torch/ops/ranking.py"
FUNCTIONAL = "evotorch_tpu_torch/algorithms/functional/funcdemo.py"


def _lint(src, path=PKG, checkers=None):
    return lint_sources({path: textwrap.dedent(src)}, checkers=checkers)


def _details(findings):
    return sorted(f.detail for f in findings)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


def test_generator_flags_global_draws_in_package_code():
    src = """
        import torch

        def ask(n):
            a = torch.randn(n, 3)
            b = torch.empty(n).normal_()
            c = torch.randint(0, 5, (n,))
            return a, b, c
        """
    assert _details(_lint(src, checkers=["generator"])) == [
        "global-draw:normal_", "global-draw:randint", "global-draw:randn",
    ]


def test_generator_accepts_explicit_generators_and_harness_code():
    src = """
        import torch

        def ask(n, generator):
            a = torch.randn(n, 3, generator=generator)
            b = torch.empty(n).normal_(generator=generator)
            return a, b
        """
    assert _lint(src, checkers=["generator"]) == []
    harness = """
        import torch

        x = torch.randn(4)
        torch.manual_seed(0)
        """
    assert _lint(harness, path="chip_smoke.py", checkers=["generator"]) == []


def test_generator_flags_global_seeding_in_package_code():
    src = """
        import torch

        def setup(seed):
            torch.manual_seed(seed)
            torch.cuda.manual_seed_all(seed)
        """
    assert _details(_lint(src, checkers=["generator"])) == ["global-seed:manual_seed", "global-seed:manual_seed_all"]


def test_generator_accepts_seeding_a_generator_of_ones_own():
    src = """
        import torch

        def setup(seed):
            g = torch.Generator().manual_seed(seed)
            g.manual_seed(seed + 1)
            return g
        """
    assert _lint(src, checkers=["generator"]) == []


def test_generator_flags_the_same_stream_replayed_every_iteration():
    src = """
        import torch

        def draws(n, state):
            g = torch.Generator()
            out = []
            for i in range(n):
                g.manual_seed(0)
                out.append(torch.randn(3, generator=g))
            while len(out) < 2 * n:
                g.set_state(state)
                out.append(torch.randn(3, generator=g))
            return out
        """
    findings = _lint(src, path="scripts/anything.py", checkers=["generator"])
    assert _details(findings) == ["loop-reseed:g", "loop-reseed:g"]


def test_generator_accepts_seeds_that_vary_and_generators_made_in_the_loop():
    src = """
        import torch

        def draws(n):
            g = torch.Generator()
            out = []
            for i in range(n):
                g.manual_seed(i)
                h = torch.Generator()
                h.manual_seed(0)
                out.append(torch.randn(3, generator=g) + torch.randn(3, generator=h))
            return out
        """
    assert _lint(src, checkers=["generator"]) == []


# ---------------------------------------------------------------------------
# first-use
# ---------------------------------------------------------------------------


def test_first_use_flags_compiled_plain_versions():
    src = """
        import torch

        @torch.compile
        def plain(x):
            return x * 2

        scripted = torch.jit.script(plain)
        """
    assert _details(_lint(src, checkers=["first-use"])) == ["compiled:torch.compile", "compiled:torch.jit.script"]


def test_first_use_accepts_the_builtin_compile():
    src = """
        code = compile("x = 1", "<string>", "exec")
        """
    assert _lint(src, checkers=["first-use"]) == []


def test_first_use_flags_unmemoized_builds_and_loads_in_loops():
    src = """
        from torch.utils import cpp_extension

        from evotorch_tpu_torch.ops import _build

        def launch(x):
            _build.build(("centered_rank",))
            return x

        def load_all(names):
            for name in names:
                _build.library(name, {})

        def extension():
            return cpp_extension.load(name="k", sources=["k.cu"])
        """
    assert _details(_lint(src, checkers=["first-use"])) == [
        "build-in-loop:library", "build-unmemoized:build", "build-unmemoized:load",
    ]


def test_first_use_accepts_memoized_builds():
    src = """
        import functools

        from torch.utils import cpp_extension

        from evotorch_tpu_torch.ops import _build

        _CACHE = {}

        def launch(x):
            lib = _build.library("centered_rank", {})  # memoized by name inside _build
            return lib

        @functools.cache
        def extension():
            return cpp_extension.load(name="k", sources=["k.cu"])

        def cached(name):
            lib = cpp_extension.load_inline(name=name, cpp_sources="")
            _CACHE[name] = lib
            return lib

        _build.build(("symmetric_gaussian",))
        """
    assert _lint(src, checkers=["first-use"]) == []


def test_first_use_flags_a_graph_captured_in_a_loop():
    src = """
        import torch

        def run(step, x, n):
            for _ in range(n):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = step(x)
                g.replay()
        """
    assert _details(_lint(src, checkers=["first-use"])) == ["capture-in-loop"]


def test_first_use_accepts_one_capture_replayed_in_a_loop():
    src = """
        import torch

        def run(step, x, n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x)
            for _ in range(n):
                g.replay()
            return y
        """
    assert _lint(src, checkers=["first-use"]) == []


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


def test_host_sync_flags_syncs_in_loop_bodies_of_package_code():
    src = """
        import torch

        def run(xs, mask):
            out = []
            for x in xs:
                out.append(x.item())
                out.append(x.cpu().numpy())
                out.append(x.to("cpu"))
                out.append(float(x.sum()))
                torch.cuda.synchronize()
            return out
        """
    assert _details(_lint(src, checkers=["host-sync"])) == [
        "sync:cpu", "sync:float-of-tensor", "sync:item", "sync:synchronize", "sync:to-cpu",
    ]


def test_host_sync_accepts_syncs_outside_loops_and_outside_the_package():
    src = """
        import torch

        def result(x):
            return x.item(), x.cpu()

        def run(xs, n):
            for x in xs:
                y = int(n)
            return y
        """
    assert _lint(src, checkers=["host-sync"]) == []
    harness = """
        import torch

        for x in range(3):
            torch.cuda.synchronize()
            t = torch.ones(1).item()
        """
    assert _lint(harness, path="chip_smoke.py", checkers=["host-sync"]) == []


def test_host_sync_flags_data_dependent_shapes_and_branches_on_the_hot_path():
    src = """
        import numpy as np
        import torch

        def rank(x, mask):
            idx = torch.nonzero(mask)
            kept = torch.where(mask)
            picked = x.masked_select(mask)
            if torch.any(x < 0):
                x = x.abs()
            return idx, kept, picked, torch.unique(x)

        def drain(x):
            while x.any():
                x = x - 1
        """
    assert _details(_lint(src, path=HOT, checkers=["host-sync"])) == [
        "branch-on-tensor:if", "branch-on-tensor:while", "sync:masked_select", "sync:nonzero", "sync:unique",
        "sync:where-1arg",
    ]


def test_host_sync_accepts_device_only_code_on_the_hot_path():
    src = """
        import math

        import numpy as np
        import torch

        def rank(x, mask, n):
            y = torch.where(mask, x, 0.0)
            scale = float(np.sqrt(n)) + math.sqrt(n)
            if n > 2:
                y = y * scale
            return y
        """
    assert _lint(src, path=HOT, checkers=["host-sync"]) == []


def test_host_sync_holds_in_an_envs_batch_step_only():
    src = """
        def batch_step(state, actions):
            return state, actions.sum().item()

        def reset(state):
            return state.sum().item()
        """
    findings = _lint(src, path="evotorch_tpu_torch/envs/demo.py", checkers=["host-sync"])
    assert [(f.symbol, f.detail) for f in findings] == [("batch_step", "sync:item")]


def test_host_sync_flags_a_syncing_helper_called_in_a_loop():
    src = """
        def _to_host(x):
            return x.detach().cpu()

        def _scale(x):
            return x * 2

        def run(xs):
            return [(_to_host(x), _scale(x)) for x in xs] + [_to_host(x) for x in xs[:1]]

        def loop(xs):
            for x in xs:
                y = _to_host(x)
                z = _scale(x)
            return y, z
        """
    findings = _lint(src, checkers=["host-sync"])
    assert [(f.symbol, f.detail) for f in findings] == [("loop", "sync:via:_to_host")]


def test_host_sync_allow_comment_names_the_count():
    src = """
        def poll(xs):
            for x in xs:
                done = x.item()  # graftlint: allow(host-sync): the episodes contracts' one host sync a generation
            return done
        """
    assert _lint(src, checkers=["host-sync"]) == []


# ---------------------------------------------------------------------------
# input-mutation
# ---------------------------------------------------------------------------


def test_input_mutation_flags_writes_to_inputs_of_functional_programs():
    src = """
        import torch

        def tell(state, grad, *, out=None, lr: float = 0.1, n=3):
            state.center.add_(grad)
            grad[0] = 1.0
            state.velocity += grad
            torch.mul(grad, 2.0, out=state.scratch)
            lr += 1.0
            n += 1
            out.copy_(grad)
            return state
        """
    findings = _lint(src, path=FUNCTIONAL, checkers=["input-mutation"])
    assert _details(findings) == ["writes-input:grad", "writes-input:state", "writes-input:state", "writes-input:state"]


def test_input_mutation_accepts_fresh_tensors_self_and_other_modules():
    src = """
        import torch

        def tell(state, grad):
            grad = grad.clone()
            grad.add_(1.0)
            center = state.center + grad
            center.mul_(0.5)
            return center

        class Wrapper:
            def step(self, grad, **kwargs):
                self.center.add_(grad)
                kwargs["seen"] = True
                return self.center
        """
    assert _lint(src, path=FUNCTIONAL, checkers=["input-mutation"]) == []
    writer = """
        def modify(original, target):
            return original.copy_(target)
        """
    assert _lint(writer, path="evotorch_tpu_torch/tools/misc.py", checkers=["input-mutation"]) == []


# ---------------------------------------------------------------------------
# process-group
# ---------------------------------------------------------------------------


def test_process_group_flags_world_collectives():
    src = """
        import torch.distributed as dist

        def merge(t, objs):
            dist.all_reduce(t)
            dist.broadcast(t, 0)
            dist.all_gather_object(objs, t)
            dist.barrier()
        """
    assert _details(_lint(src, checkers=["process-group"])) == [
        "world-collective:all_gather_object", "world-collective:all_reduce", "world-collective:barrier",
        "world-collective:broadcast",
    ]


def test_process_group_accepts_a_group_and_the_mesh_module():
    src = """
        import torch.distributed as dist

        def merge(t, mesh):
            dist.all_reduce(t, group=mesh.group)
            dist.all_reduce(t, dist.ReduceOp.SUM, mesh.group)
            dist.barrier(group=mesh.group)
        """
    assert _lint(src, checkers=["process-group"]) == []
    world = """
        import torch.distributed as dist

        def world_sum(t):
            dist.all_reduce(t)
        """
    assert _lint(world, path="evotorch_tpu_torch/parallel/mesh.py", checkers=["process-group"]) == []


# ---------------------------------------------------------------------------
# dtype
# ---------------------------------------------------------------------------


def test_dtype_flags_global_default_and_float64_on_the_hot_path():
    assert _details(_lint("import torch\ntorch.set_default_dtype(torch.float64)\n", path="chip_smoke.py", checkers=["dtype"])) == [
        "set-default-dtype"
    ]
    src = """
        import torch

        def rank(x):
            return x.to(torch.float64), x.double(), torch.zeros(3, dtype=torch.double)
        """
    assert _details(_lint(src, path=HOT, checkers=["dtype"])) == ["x64:double", "x64:double()", "x64:float64"]


def test_dtype_accepts_float64_off_the_hot_path_and_float32_on_it():
    src = """
        import torch

        def reference(x):
            return x.double().sum(dtype=torch.float64)
        """
    assert _lint(src, path="evotorch_tpu_torch/testing.py", checkers=["dtype"]) == []
    assert _lint("import torch\ndef f(x):\n    return x.to(torch.float32)\n", path=HOT, checkers=["dtype"]) == []


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def test_timing_flags_unsynced_regions_around_torch_and_port_calls():
    src = """
        import time

        import torch

        from evotorch_tpu_torch.ops import centered_rank

        def bench(x):
            t0 = time.perf_counter()
            y = torch.mm(x, x)
            return time.perf_counter() - t0

        def bench_rank(x):
            t0 = time.perf_counter()
            centered_rank(x)
            return time.perf_counter() - t0
        """
    findings = _lint(src, path="chip_smoke.py", checkers=["timing"])
    assert [(f.symbol, f.detail) for f in findings] == [
        ("bench", "unsynced-timing:torch.mm"), ("bench_rank", "unsynced-timing:centered_rank"),
    ]
    relative = """
        import time

        from ..ops import centered_rank

        def bench(x):
            t0 = time.perf_counter()
            centered_rank(x)
            return time.perf_counter() - t0
        """
    assert _details(_lint(relative, checkers=["timing"])) == ["unsynced-timing:centered_rank"]


def test_timing_accepts_synced_regions_helpers_and_host_only_timing():
    src = """
        import time

        import torch

        def synced(x):
            t0 = time.perf_counter()
            y = torch.mm(x, x)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        def read_back(x):
            t0 = time.perf_counter()
            total = torch.sum(x).item()
            return time.perf_counter() - t0, total

        def with_helper(x):
            def once():
                y = torch.mm(x, x)
                torch.cuda.synchronize()
                return y

            t0 = time.perf_counter()
            once()
            return time.perf_counter() - t0

        def events(x, start, end):
            t0 = time.perf_counter()
            y = torch.mm(x, x)
            ms = start.elapsed_time(end)
            return time.perf_counter() - t0, ms

        def host_only(items):
            t0 = time.perf_counter()
            total = sum(items)
            return time.perf_counter() - t0, total
        """
    assert _lint(src, path="chip_smoke.py", checkers=["timing"]) == []


# ---------------------------------------------------------------------------
# swallow and telemetry-schema (also held to the JAX package below)
# ---------------------------------------------------------------------------


def test_swallow_flags_a_silent_handler_around_a_kernel_launch():
    src = """
        from evotorch_tpu_torch.ops import _build

        def launch():
            try:
                return _build.library("centered_rank", {})
            except Exception:
                return None
        """
    assert _details(_lint(src, checkers=["swallow"])) == ["swallow:except Exception"]


def test_swallow_accepts_a_reraised_failure():
    src = """
        def launch(lib):
            try:
                return lib()
            except Exception:
                raise RuntimeError("the kernel failed")
        """
    assert _lint(src, checkers=["swallow"]) == []


def test_telemetry_schema_flags_literal_columns_outside_the_owner():
    src = """
        def read(telemetry, group_counts):
            return telemetry[0, 5], group_counts[:, 3]
        """
    assert _details(_lint(src, checkers=["telemetry-schema"])) == [
        "telemetry-index:group_counts:[3]", "telemetry-index:telemetry:[0,5]",
    ]


def test_telemetry_schema_accepts_the_owner_and_named_columns():
    src = """
        def read(telemetry, col):
            return telemetry[:, col]
        """
    assert _lint(src, checkers=["telemetry-schema"]) == []
    owner = "def read(telemetry):\n    return telemetry[0, 5]\n"
    assert _lint(owner, path="evotorch_tpu_torch/observability/devicemetrics.py", checkers=["telemetry-schema"]) == []


# ---------------------------------------------------------------------------
# scoped allow-comments (the cases of tests/test_lint.py, through the port)
# ---------------------------------------------------------------------------


def test_scoped_allow_suppresses_named_checker_only():
    src = """
        def f(xs):
            for x in xs:
                # graftlint: allow(host-sync): the swap point is this test's point
                a = x.item()
                b = float(x.sum())  # not covered by the allow above
            return a + b
        """
    assert _details(_lint(src, checkers=["host-sync"])) == ["sync:float-of-tensor"]


def test_scoped_allow_trailing_same_line():
    src = """
        def f(xs):
            for x in xs:
                y = x.item()  # graftlint: allow(host-sync): intentional demo
            return y
        """
    assert _lint(src, checkers=["host-sync"]) == []


def test_scoped_allow_requires_reason():
    src = """
        def f(xs):
            for x in xs:
                y = x.item()  # graftlint: allow(host-sync)
            return y
        """
    assert _details(_lint(src, checkers=["host-sync"])) == ["missing-reason", "sync:item"]


def test_scoped_allow_trailing_does_not_cover_next_line():
    src = """
        def f(xs):
            for x in xs:
                a = x.item()  # graftlint: allow(host-sync): intentional demo
                b = x.tolist()
            return a, b
        """
    findings = _lint(src, checkers=["host-sync"])
    assert [f.detail for f in findings] == ["sync:tolist"] and findings[0].line == 5


def test_scoped_allow_inside_string_literal_is_inert():
    src = """
        HELP = "# graftlint: allow(host-sync)"

        def f(xs):
            for x in xs:
                doc = "# graftlint: allow(host-sync): not a comment"
                y = x.item()
            return y, doc
        """
    assert _details(_lint(src, checkers=["host-sync"])) == ["sync:item"]


def test_scoped_allow_multiple_checkers():
    src = """
        def rank(x):
            # graftlint: allow(host-sync, dtype): a float64 host read is deliberate here
            return x.double().item()
        """
    assert _lint(src, path=HOT, checkers=["host-sync", "dtype"]) == []


def test_baseline_is_multiset_matched():
    src = """
        import torch

        def ask(n):
            a = torch.randn(n)
            b = torch.randn(n)
            return a, b
        """
    findings = _lint(src, checkers=["generator"])
    assert len(findings) == 2 and findings[0].signature == findings[1].signature
    new, stale = apply_baseline(findings, [{"signature": findings[0].signature}])
    assert len(new) == 1 and stale == []
    new, stale = apply_baseline(findings[:1], [{"signature": findings[0].signature}] * 2)
    assert new == [] and len(stale) == 1


def test_checkers_registry_and_docstrings():
    assert list(checkers.CHECKERS) == [
        "generator", "first-use", "host-sync", "input-mutation", "process-group", "dtype", "timing", "swallow",
        "telemetry-schema",
    ]
    for fn in checkers.CHECKERS.values():
        assert "Rule" in fn.__doc__, fn.__name__


# ---------------------------------------------------------------------------
# the gate over the port
# ---------------------------------------------------------------------------


def test_port_is_clean_modulo_baseline():
    """No finding outside the baseline on the port's linted surface, no
    stale baseline entry, and a reason on every entry (a reasonless allow
    comment is itself a finding)."""
    findings = run_lint()
    baseline = load_baseline(default_baseline_path())
    new, stale = apply_baseline(findings, baseline)
    assert new == [], "findings outside the baseline:\n" + "\n".join(f.format() for f in new)
    assert stale == [], "stale baseline entries (remove them):\n" + "\n".join(e["signature"] for e in stale)
    assert all(e.get("reason", "").strip() for e in baseline)
    targets = {t.relative_to(REPO_ROOT).as_posix() for t in graftlint.default_targets()}
    assert targets == {"evotorch_tpu_torch", "chip_smoke.py", "scripts/packing_width.py", "scripts/shape_rounding.py"}


# ---------------------------------------------------------------------------
# parity with the JAX package on its own snippets
# ---------------------------------------------------------------------------


def _jax_snippets(first, last):
    """The source snippets of the JAX package's lint tests between lines
    ``first`` and ``last`` of ``tests/test_lint.py``: every string constant
    in a test function there that holds code."""
    tree = ast.parse((REPO_ROOT / "tests" / "test_lint.py").read_text())
    out = []
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and first <= fn.lineno <= last:
            for node in ast.walk(fn):
                if isinstance(node, ast.Constant) and isinstance(node.value, str) and "\n" in node.value:
                    if "def " in node.value or "import" in node.value:
                        out.append(textwrap.dedent(node.value))
    return out


def _as_tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


def test_swallow_and_telemetry_schema_equal_jax():
    from evotorch_tpu.analysis import lint_sources as jax_lint_sources

    snippets = _jax_snippets(620, 713)
    assert len(snippets) >= 4
    snippets.append(
        "def read(telemetry, group_counts, lane_counts, col):\n"
        "    a = telemetry[0, 5] + telemetry[g][15] + telemetry[:, col]\n"
        "    return a + group_counts[:, 3] + lane_counts[2] + state.telemetry[1]\n"
    )
    for src in snippets:
        for checker in ("swallow", "telemetry-schema"):
            ours = lint_sources({"mod.py": src}, checkers=[checker])
            theirs = jax_lint_sources({"mod.py": src}, checkers=[checker])
            assert _as_tuples(ours) == _as_tuples(theirs), (checker, src)
    assert any(lint_sources({"mod.py": s}, checkers=["swallow"]) for s in snippets)
    assert len(lint_sources({"mod.py": snippets[-1]}, checkers=["telemetry-schema"])) == 5


def test_scoped_allows_signatures_and_baselines_equal_jax(tmp_path):
    from evotorch_tpu.analysis import graftlint as jax_graftlint

    snippets = _jax_snippets(688, 806)
    assert len(snippets) >= 7
    for src in snippets:
        ours, ours_problems = graftlint.scoped_allows("mod.py", src)
        theirs, their_problems = jax_graftlint.scoped_allows("mod.py", src)
        assert ours == theirs and _as_tuples(ours_problems) == _as_tuples(their_problems)

    # findings of the JAX package's multiset-baseline snippet, in both classes
    jax_findings = jax_graftlint.lint_sources({"mod.py": _jax_snippets(823, 839)[0]}, checkers=["prng"])
    assert len(jax_findings) == 2
    ours = [Finding(*dataclasses.astuple(f)) for f in jax_findings]
    assert [f.signature for f in ours] == [f.signature for f in jax_findings]
    assert [f.format() for f in ours] == [f.format() for f in jax_findings]
    assert [f.to_json() for f in ours] == [f.to_json() for f in jax_findings]
    for baseline in ([], [{"signature": ours[0].signature}], [{"signature": ours[0].signature}] * 3):
        new, stale = apply_baseline(ours, baseline)
        jnew, jstale = jax_graftlint.apply_baseline(jax_findings, baseline)
        assert _as_tuples(new) == _as_tuples(jnew) and stale == jstale

    reasons = {ours[0].signature: "a reason"}
    save_baseline(tmp_path / "ours.json", ours, reasons=reasons)
    jax_graftlint.save_baseline(tmp_path / "theirs.json", jax_findings, reasons=reasons)
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert load_baseline(tmp_path / "ours.json") == jax_graftlint.load_baseline(tmp_path / "theirs.json")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "evotorch_tpu_torch.analysis", *map(str, args)],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
    )  # fmt: skip


def test_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("import torch\n\n\ndef f(x, generator):\n    return x + torch.randn(3, generator=generator)\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\n\ntorch.set_default_dtype(torch.float64)\n")
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"findings": []}))

    ok = _cli(clean, "--baseline", baseline, cwd=tmp_path)
    assert ok.returncode == 0, ok.stderr
    bad = _cli(clean, dirty, "--baseline", baseline, "--json", cwd=tmp_path)
    assert bad.returncode == 1
    report = json.loads(bad.stdout)
    assert [f["detail"] for f in report["findings"]] == ["set-default-dtype"] and report["stale_baseline"] == []
    partial = _cli(dirty, "--write-baseline", "--baseline", baseline, cwd=tmp_path)
    assert partial.returncode == 2 and json.loads(baseline.read_text()) == {"findings": []}
    assert _cli(dirty, "--no-baseline", "--checkers", "swallow", cwd=tmp_path).returncode == 0


def test_cli_writes_and_enforces_a_baseline(tmp_path, monkeypatch):
    """A full run (no paths) writes every finding with the reasons the old
    baseline had, and a stale entry fails the next full run."""
    findings = _lint("import torch\ntorch.set_default_dtype(torch.float64)\n", path="chip_smoke.py")
    monkeypatch.setattr(cli, "run_lint", lambda paths, checkers=None: list(findings))
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"findings": [{"signature": findings[0].signature, "reason": "kept"}]}))
    assert cli.main(["--write-baseline", "--baseline", str(path)]) == 0
    assert [e["reason"] for e in load_baseline(path)] == ["kept"]
    assert cli.main(["--baseline", str(path)]) == 0
    monkeypatch.setattr(cli, "run_lint", lambda paths, checkers=None: [])
    assert cli.main(["--baseline", str(path)]) == 1
