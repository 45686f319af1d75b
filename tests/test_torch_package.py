"""Package rules of ``evotorch_tpu_torch``: it imports neither JAX nor the JAX
package, and its entry points default to the card and refuse to carry on
quietly on the CPU when there is none."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import evotorch_tpu_torch
from evotorch_tpu_torch import resolve_device
from evotorch_tpu_torch.algorithms.functional import pgpe_ask, pgpe_tell
from evotorch_tpu_torch.envs import Humanoid
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
from evotorch_tpu_torch.ops import _build
from evotorch_tpu_torch.parallel import make_generation_step

PACKAGE_DIR = Path(evotorch_tpu_torch.__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent


def test_no_module_imports_jax_or_the_jax_package():
    modules = sorted(
        ".".join(("evotorch_tpu_torch",) + p.relative_to(PACKAGE_DIR).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE_DIR.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'evotorch_tpu.'))"
        " or m == 'evotorch_tpu')\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert len(modules) >= 20


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    import ast

    script = REPO_ROOT / "chip_smoke.py"
    imported = set()
    for node in ast.walk(ast.parse(script.read_text())):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert not imported & {"jax", "jaxlib", "evotorch_tpu"}, imported
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run(
        [sys.executable, str(script)], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_generation_step(
            env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=4), tell=pgpe_tell, popsize=4, eval_mode="budget"
        )
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Humanoid()


def test_resolve_device_pins_full_float32():
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_and_build_flags():
    for name in _build.SOURCES:
        source = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert "extern \"C\"" in source and "cudaGetLastError" in source and "torch/" not in source
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == REPO_ROOT / "build" / "kernels"


def test_unported_rollout_contracts_raise():
    """The episodes contracts are ported; the engine's options that are not
    (groups, multi-GPU arguments) raise NotImplementedError
    naming ROADMAP.md (action noise is ported and runs), and the
    compaction contract is its own entry point, as in the JAX package."""
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout, stats_init

    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    params = torch.zeros(2, policy.parameter_count)
    for option in (dict(num_groups=2, groups=torch.zeros(2)), dict(solution_keys=torch.zeros(2))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run_vectorized_rollout(env, policy, params, torch.Generator(), stats_init(109, device="cpu"), **option)
    noisy = run_vectorized_rollout(
        env, policy, params, torch.Generator(), stats_init(109, device="cpu"), action_noise_stdev=0.1, episode_length=3
    )
    assert bool(torch.isfinite(noisy.scores).all())
    with pytest.raises(ValueError, match="eval_mode"):
        run_vectorized_rollout(
            env, policy, params, torch.Generator(), stats_init(109, device="cpu"), eval_mode="episodes_compact"
        )


def test_new_modules_import_without_jax():
    """The modules of the episodes contracts and the telemetry wire import
    neither JAX nor the JAX package (the whole-package check above covers
    them too; this one names them)."""
    names = [
        "evotorch_tpu_torch.observability",
        "evotorch_tpu_torch.observability.devicemetrics",
        "evotorch_tpu_torch.envs.classic",
        "evotorch_tpu_torch.envs.registry",
        "evotorch_tpu_torch.neuroevolution.net.rl",
        "evotorch_tpu_torch.neuroevolution.net.vecrl",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu')]\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_oo_modules_import_without_jax():
    """The object layer's modules (core, searchers, optimizers, problems,
    loggers, the small tools, the OO timing script) import neither JAX, the
    JAX package, nor any experiment tracker."""
    names = [
        "evotorch_tpu_torch.core",
        "evotorch_tpu_torch.distributions",
        "evotorch_tpu_torch.optimizers",
        "evotorch_tpu_torch.logging",
        "evotorch_tpu_torch.oo_times",
        "evotorch_tpu_torch.algorithms",
        "evotorch_tpu_torch.algorithms.searchalgorithm",
        "evotorch_tpu_torch.algorithms.gaussian",
        "evotorch_tpu_torch.algorithms.functional.funcadam",
        "evotorch_tpu_torch.algorithms.functional.funcsgd",
        "evotorch_tpu_torch.neuroevolution.neproblem",
        "evotorch_tpu_torch.neuroevolution.vecneproblem",
        "evotorch_tpu_torch.neuroevolution.net.parser",
        "evotorch_tpu_torch.tools.cloning",
        "evotorch_tpu_torch.tools.hook",
        "evotorch_tpu_torch.tools.lazyreporter",
        "evotorch_tpu_torch.tools.recursiveprintable",
        "evotorch_tpu_torch.tools.tensormaker",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "roots = ('jax', 'jaxlib', 'evotorch_tpu', 'pandas', 'mlflow', 'neptune', 'sacred', 'wandb')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_oo_entry_points_raise_without_cuda(monkeypatch):
    """``Problem``, ``VecNE``, the searchers' optimizers and the loggers'
    searchers default to the card and raise without one."""
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.optimizers import ClipUp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: Problem("min", solution_length=3),
        lambda: VecNE("cartpole", "Linear(obs_length, act_length)"),
        lambda: ClipUp(solution_length=3, stepsize=0.1),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_locomotion_supervised_and_checkpoint_modules_import_without_jax():
    """The locomotion envs, ``SupervisedNE`` and ``checkpoint`` import
    neither JAX nor the JAX package (nor orbax, which the JAX package's
    checkpoints go through)."""
    names = [
        "evotorch_tpu_torch.envs.ant",
        "evotorch_tpu_torch.envs.halfcheetah",
        "evotorch_tpu_torch.envs.hopper",
        "evotorch_tpu_torch.envs.walker2d",
        "evotorch_tpu_torch.neuroevolution.supervisedne",
        "evotorch_tpu_torch.checkpoint",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu', 'orbax')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


@pytest.mark.parametrize("name", ["ant", "halfcheetah", "half_cheetah", "walker2d", "walker", "hopper"])
def test_locomotion_envs_default_to_the_card(name, monkeypatch):
    """``make_env`` builds each locomotion env on the card by default (and
    raises without one), and on the CPU when asked."""
    from evotorch_tpu_torch.envs import make_env

    assert make_env(name, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_env(name)


def test_supervised_ne_defaults_to_the_card(monkeypatch):
    import numpy as np

    from evotorch_tpu_torch.neuroevolution import SupervisedNE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SupervisedNE((np.zeros((4, 2), np.float32), np.zeros((4, 1), np.float32)), "Linear(2, 1)")


def test_searcher_and_operator_modules_import_without_jax():
    """The other searchers, the operators, the decorators and the batched
    functional search import neither JAX nor the JAX package (nor ``cma``,
    which only ``PyCMAES`` imports, when it is built)."""
    names = [
        "evotorch_tpu_torch.decorators",
        "evotorch_tpu_torch.operators",
        "evotorch_tpu_torch.operators.base",
        "evotorch_tpu_torch.operators.functional",
        "evotorch_tpu_torch.operators.real",
        "evotorch_tpu_torch.algorithms.cmaes",
        "evotorch_tpu_torch.algorithms.ga",
        "evotorch_tpu_torch.algorithms.mapelites",
        "evotorch_tpu_torch.algorithms.restarter",
        "evotorch_tpu_torch.algorithms.functional.funccem",
        "evotorch_tpu_torch.algorithms.functional.funccmaes",
        "evotorch_tpu_torch.algorithms.functional.funcga",
        "evotorch_tpu_torch.algorithms.functional.funcmapelites",
        "evotorch_tpu_torch.algorithms.functional.funcsnes",
        "evotorch_tpu_torch.algorithms.functional.funcxnes",
        "evotorch_tpu_torch.algorithms.functional.span",
        "evotorch_tpu_torch.interop",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu', 'cma')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_no_module_names_a_ported_roadmap_item():
    """Nothing in the port still raises for item A.8: it is ported."""
    for path in PACKAGE_DIR.rglob("*.py"):
        assert "A.8" not in path.read_text(), path


def test_no_module_names_the_factored_populations_item():
    """Nothing in the port, its chip check or its scripts still raises for
    item A.9 (factored populations): it is ported."""
    paths = list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"] + list((REPO_ROOT / "scripts").glob("*torch*.py"))
    for path in paths:
        assert "A.9" not in path.read_text(), path


def test_factored_modules_import_without_jax():
    """The factored populations' modules import neither JAX nor the JAX
    package."""
    names = [
        "evotorch_tpu_torch.tools.lowrank",
        "evotorch_tpu_torch.neuroevolution.net.lowrank",
        "evotorch_tpu_torch.algorithms.functional.funcpgpe",
        "evotorch_tpu_torch.interop",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_factored_entry_points_default_to_the_card(monkeypatch):
    """The factored batches carried in from numpy default to the card and
    raise without one; the factored samplers draw on their generator's
    device."""
    import numpy as np

    from evotorch_tpu_torch import interop
    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask_lowrank

    arrays = {"center": np.zeros(3, np.float32), "basis": np.zeros((3, 2), np.float32), "coeffs": np.zeros((4, 2), np.float32)}
    state = pgpe(center_init=torch.zeros(3), center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1)
    assert pgpe_ask_lowrank(torch.Generator(), state, popsize=4, rank=2).coeffs.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: interop.lowrank_batch_from_numpy(arrays),
        lambda: interop.trunk_delta_batch_from_numpy(dict(arrays, factors=[])),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_new_entry_points_default_to_the_card(monkeypatch):
    """The functional searchers given a non-tensor center, the feature grid
    and the batched estimator place their tensors on the card by default
    and raise without one; ``PyCMAES`` raises ``ImportError`` without
    ``cma``."""
    import numpy as np

    from evotorch_tpu_torch.algorithms import MAPElites, PyCMAES
    from evotorch_tpu_torch.algorithms.functional import cem, cmaes, snes, xnes
    from evotorch_tpu_torch.core import Problem

    try:
        import cma  # noqa: F401
    except ImportError:
        problem = Problem("min", lambda x: x.sum(-1), solution_length=3, initial_bounds=(-1, 1), device="cpu")
        with pytest.raises(ImportError):
            PyCMAES(problem, stdev_init=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    center = np.zeros(3, np.float32)
    for make in (
        lambda: snes(center_init=center, objective_sense="min", stdev_init=1.0),
        lambda: xnes(center_init=center, objective_sense="min", stdev_init=1.0),
        lambda: cem(center_init=center, objective_sense="min", stdev_init=1.0, parenthood_ratio=0.5),
        lambda: cmaes(center_init=center, objective_sense="min", stdev_init=1.0),
        lambda: MAPElites.make_feature_grid([0.0], [1.0], num_bins=3),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    state = snes(center_init=torch.zeros(3), objective_sense="min", stdev_init=1.0)
    assert state.center.device == torch.device("cpu")


def test_no_module_names_the_multi_gpu_item():
    """Nothing in the port (nor ``chip_smoke.py``) still raises for or cites
    item A.10 (multi-GPU): it is ported."""
    for path in list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]:
        assert "A.10" not in path.read_text(), path


def test_parallel_modules_import_without_jax():
    """The parallel layer imports neither JAX nor the JAX package: its
    retry of the rendezvous is the port's own (``distributed._retry_call``),
    not the JAX package's ``resilience.retry``."""
    names = [
        "evotorch_tpu_torch.parallel",
        "evotorch_tpu_torch.parallel.mesh",
        "evotorch_tpu_torch.parallel.evaluate",
        "evotorch_tpu_torch.parallel.distributed",
        "evotorch_tpu_torch.parallel.grad",
        "evotorch_tpu_torch.parallel.hostpool",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu')]\n"
        "assert not bad, bad\n"
        "from evotorch_tpu_torch.parallel import distributed\n"
        "assert callable(distributed._retry_call)\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_rendezvous_retry_is_bounded():
    """The rendezvous retry: transient failures retried with doubling
    sleeps, the last one raised unchanged; others raised at once."""
    from evotorch_tpu_torch.parallel.distributed import _retry_call

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("the store is not up yet")
        return "joined"

    assert _retry_call(flaky, retries=5, base_delay=0.0, max_delay=0.0, exceptions=(OSError,)) == "joined"
    assert len(calls) == 3
    with pytest.raises(OSError, match="down"):
        _retry_call(lambda: (_ for _ in ()).throw(OSError("down")), retries=2, base_delay=0.0, max_delay=0.0, exceptions=(OSError,))
    with pytest.raises(ValueError):
        _retry_call(lambda: (_ for _ in ()).throw(ValueError("config")), retries=5, base_delay=0.0, max_delay=0.0, exceptions=(OSError,))


def test_multi_gpu_entry_points_default_to_the_card(monkeypatch):
    """The sharded evaluators, the generation step over a mesh, the sharded
    gradient path and ``VecNE(num_actors=)`` default to the card and raise
    without one, as ``init_distributed`` does."""
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.parallel import default_mesh, init_distributed, make_sharded_evaluator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: make_sharded_evaluator(lambda x: x.sum(-1)),
        lambda: init_distributed("file:///nonexistent", world_size=1, rank=0),
        lambda: Problem("min", lambda x: x.sum(-1), solution_length=3, num_actors="max"),
        lambda: VecNE("cartpole", "Linear(obs_length, act_length)", num_actors="max"),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [8]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_generation_step(env, policy, ask=None, tell=None, popsize=4, mesh=default_mesh())


def test_no_module_names_the_fused_span_item():
    """Nothing in the port (nor ``chip_smoke.py``) still raises for or cites
    item A.11 (fused training spans): it is ported."""
    for path in list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]:
        assert "A.11" not in path.read_text(), path


def test_object_typed_refusals_are_gone():
    """The three "A.13, ObjectArray" refusals (``core.Problem``,
    ``tools.misc.to_torch_dtype``, ``TensorMakerMixin.make_tensor``) are
    lifted: each now takes ``dtype=object``."""
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.tools import ObjectArray
    from evotorch_tpu_torch.tools.misc import to_torch_dtype

    for path in PACKAGE_DIR.rglob("*.py"):
        assert "A.13, ObjectArray" not in path.read_text(), path
    problem = Problem("max", dtype=object, device="cpu")
    assert problem.dtype is object and to_torch_dtype("object") is object
    assert isinstance(problem.make_tensor([[1, 2], "x"], dtype=object), ObjectArray)


def test_span_and_object_modules_import_without_jax():
    names = [
        "evotorch_tpu_torch.parallel.evaluate",
        "evotorch_tpu_torch.observability.devicemetrics",
        "evotorch_tpu_torch.neuroevolution.vecneproblem",
        "evotorch_tpu_torch.tools.objectarray",
        "evotorch_tpu_torch.tools.immutable",
        "evotorch_tpu_torch.tools.readonlytensor",
        "evotorch_tpu_torch.tools.constraints",
        "evotorch_tpu_torch.tools.misc",
        "evotorch_tpu_torch.operators.sequence",
        "evotorch_tpu_torch.testing",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
