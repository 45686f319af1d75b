"""Package rules of ``evotorch_tpu_torch``: it imports neither JAX nor the JAX
package, and its entry points default to the card and refuse to carry on
quietly on the CPU when there is none."""

import json
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
    """The episodes contracts are ported, and so are the engine's groups
    (a per-group wire) and action noise; the JAX engine's solution keys are
    refused naming the port's per-solution tables, and the compaction
    contract is its own entry point, as in the JAX package."""
    from evotorch_tpu_torch.neuroevolution.net import run_vectorized_rollout, stats_init

    env = Humanoid(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    params = torch.zeros(2, policy.parameter_count)
    grouped = run_vectorized_rollout(
        env, policy, params, torch.Generator(), stats_init(109, device="cpu"), num_groups=2,
        groups=torch.tensor([0, 1]), episode_length=3,
    )  # fmt: skip
    assert grouped.telemetry.shape == (2, 20)
    with pytest.raises(TypeError, match="solution_tables"):
        run_vectorized_rollout(env, policy, params, torch.Generator(), stats_init(109, device="cpu"), solution_keys=torch.zeros(2))
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
    """Nothing in the port still raises for items A.8 or A.14: they are
    ported."""
    for path in PACKAGE_DIR.rglob("*.py"):
        text = path.read_text()
        assert "A.8" not in text and "A.14" not in text, path


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
    retry of the rendezvous is the port's own ``resilience.retry_call``,
    not the JAX package's."""
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
        "from evotorch_tpu_torch.resilience import retry\n"
        "assert distributed.retry_call is retry.retry_call\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_rendezvous_retry_is_bounded():
    """The rendezvous retry: transient failures retried with doubling
    sleeps, the last one raised unchanged; others raised at once."""
    from evotorch_tpu_torch.parallel.distributed import retry_call

    def _retry_call(fn, **kw):
        return retry_call(fn, site="distributed.initialize", **kw)

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


def test_host_backend_and_tool_modules_import_without_jax():
    names = [
        "evotorch_tpu_torch.utils",
        "evotorch_tpu_torch.tools.pytree",
        "evotorch_tpu_torch.tools.structures",
        "evotorch_tpu_torch.tools.tensorframe",
        "evotorch_tpu_torch.models",
        "evotorch_tpu_torch.models.policies",
        "evotorch_tpu_torch.observability.registry",
        "evotorch_tpu_torch.observability.tracer",
        "evotorch_tpu_torch.observability.timings",
        "evotorch_tpu_torch.resilience",
        "evotorch_tpu_torch.resilience.faults",
        "evotorch_tpu_torch.neuroevolution.gymne",
        "evotorch_tpu_torch.neuroevolution.net.hostvecenv",
        "evotorch_tpu_torch.envs.mujoco",
        "evotorch_tpu_torch.envs.mujoco.fidelity",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu', 'gymnasium', 'mujoco')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_fault_injection_refusal_is_gone_and_nothing_names_a13(monkeypatch):
    """The "A.13, tools" refusal of ``EVOTORCH_FAULTS`` is lifted, and
    nothing in the port (nor ``chip_smoke.py``) still cites item A.13: the
    tensor-side tools and the host backends are ported, ``fidelity`` too."""
    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution import VecNE

    for path in list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]:
        assert "A.13" not in path.read_text(), path
    monkeypatch.setenv("EVOTORCH_FAULTS", "eval.scores:nonfinite@1")
    VecNE(CartPole(device="cpu"), "Linear(obs_length, act_length)", device="cpu")


def test_host_backends_default_to_the_card(monkeypatch):
    from evotorch_tpu_torch.envs.mujoco.fidelity import run_fidelity
    from evotorch_tpu_torch.neuroevolution import GymNE
    from evotorch_tpu_torch.tools import CList, TensorFrame

    class Env:
        class _Box:
            low, high, shape = -1.0, 1.0, (1,)

        observation_space = action_space = _Box()

    assert TensorFrame.create(a=[1.0, 2.0], b=3.0, device="cpu").b.device == torch.device("cpu")
    assert TensorFrame.create(a=torch.zeros(2)).with_columns(b=[1, 2]).b.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: GymNE(Env, "Linear(obs_length, act_length)"),
        lambda: CList.create(4),
        lambda: TensorFrame.create(a=[1.0, 2.0]),
        lambda: TensorFrame(columns=(), data=()).with_columns(a=[0.0, 0.0]),
        lambda: run_fidelity(["halfcheetah"], n_seqs=1, n_steps=1),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_service_modules_import_without_jax():
    """The services import neither JAX nor the JAX package, not even its
    host-only modules: the port keeps its own copies of them."""
    names = [
        "evotorch_tpu_torch.serving",
        "evotorch_tpu_torch.serving.server",
        "evotorch_tpu_torch.serving.backend",
        "evotorch_tpu_torch.serving.stdio",
        "evotorch_tpu_torch.serving.admission",
        "evotorch_tpu_torch.serving.requests",
        "evotorch_tpu_torch.serving.__main__",
        "evotorch_tpu_torch.observability.health",
        "evotorch_tpu_torch.observability.slo",
        "evotorch_tpu_torch.observability.metricshub",
        "evotorch_tpu_torch.resilience.retry",
        "evotorch_tpu_torch.resilience.watchdog",
        "evotorch_tpu_torch.resilience.runstate",
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
    import re

    for path in (PACKAGE_DIR / "serving").glob("*.py"):
        assert not re.search(r"^\s*(from|import)\s+(jax|evotorch_tpu)\b(?!_torch)", path.read_text(), re.M), path


def test_service_entry_points_default_to_the_card(monkeypatch):
    """``EvalServer``, ``make_resident_rollout_program`` and the serving CLI
    run on the card unless given ``device="cpu"`` (``--device cpu``), and
    raise without one; with the CPU asked for they run."""
    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.parallel import make_resident_rollout_program
    from evotorch_tpu_torch.serving import EvalServer
    from evotorch_tpu_torch.serving.__main__ import _main

    env = CartPole(device="cpu")
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [4]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: EvalServer(env, policy, slab_size=4),
        lambda: EvalServer("cartpole", policy, slab_size=4),
        lambda: make_resident_rollout_program(env, policy),
        lambda: _main(["--env", "cartpole", "--slab", "4"]),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert EvalServer(env, policy, slab_size=4, device="cpu").device == torch.device("cpu")
    assert make_resident_rollout_program(env, policy, device="cpu").device == torch.device("cpu")
    script = "import sys\nfrom evotorch_tpu_torch.serving.__main__ import _main\nsys.exit(_main(['--env', 'cartpole', '--slab', '4', '--device', 'cpu']))\n"
    submit = json.dumps({"op": "submit", "tenant": "a", "values": [[0.0] * 10], "seed": 1})  # CartPole: 4 -> 2, 10 parameters
    lines = '{"op": "admit", "tenant": "a"}\n' + submit + '\n{"op": "result", "request_id": 0}\n'
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, input=lines, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    replies = [json.loads(line) for line in result.stdout.splitlines()]
    assert [r["ok"] for r in replies] == [True, True, True] and len(replies[2]["scores"]) == 1


def test_nothing_names_the_services_item_but_the_autotuner():
    """Items A.12 (the services) and A.12b (the autotuner) are ported:
    nothing in the port (nor ``chip_smoke.py``) cites either."""
    import re

    for path in list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]:
        assert not re.search(r"A\.12", path.read_text()), path


def test_tuning_modules_import_without_jax():
    """The autotuner, the program ledger, the inventory, the report, the
    build cache and the first-use sentinel import neither JAX nor the JAX
    package, and their entry points take the card unless told otherwise."""
    names = [
        "evotorch_tpu_torch.analysis",
        "evotorch_tpu_torch.analysis.retrace_sentinel",
        "evotorch_tpu_torch.observability.autotune",
        "evotorch_tpu_torch.observability.compilecache",
        "evotorch_tpu_torch.observability.inventory",
        "evotorch_tpu_torch.observability.programs",
        "evotorch_tpu_torch.observability.report",
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


def test_tuning_entry_points_default_to_the_card(monkeypatch):
    from evotorch_tpu_torch.observability import autotune
    from evotorch_tpu_torch.observability.inventory import build_specs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = autotune.TuneShape(env_name="cartpole", popsize=8, episode_length=4, hidden=(4,))
    for make in (
        lambda: autotune.RefillHarness(shape, widths=(4,)),
        lambda: autotune.SpanHarness(shape, spans=(1,)),
        lambda: build_specs(),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert autotune.RefillHarness(shape, widths=(4,), device="cpu").device == torch.device("cpu")


# -- the last slice: every public name of the JAX package has its counterpart --

#: JAX public names the port has under another name: JAX name -> port name
_RENAMED = {
    "OptaxOptimizer": "TorchOptimizer",
    "fused_centered_rank": "centered_rank",
    "to_jax_dtype": "to_torch_dtype",
    "ensure_array_length_and_dtype": "ensure_tensor_length_and_dtype",
    "CompileLog": "FirstUseLog",
    "track_compiles": "track_first_use",
    "assert_compiles": "assert_first_use",
}

#: JAX public names, and JAX modules (dotted), with no counterpart in the
#: port: each reason says which idea of JAX or XLA does not exist in eager torch
_ABSENT = {
    "evotorch_tpu.envs.braxenv": "Brax is a JAX library of environments: the port has no Brax",
    "enable_persistent_cache": "XLA's persistent compilation cache: eager torch compiles no programs",
    "guarded_cost_analysis": "XLA cost analysis of a lowered program",
    "guarded_memory_analysis": "XLA memory analysis of a compiled program",
    "verify_runtime_donation": "buffer donation: XLA aliases a donated input to an output",
    "donated_param_indices": "buffer donation: the parameters a lowering marked donated",
    "parse_alias_sources": "buffer donation: the compiled module's input-output alias table",
    "donated_programs": "buffer donation: the programs that donate their inputs",
    "abstract_like": "buffer donation: abstract shapes let XLA lower a donating program without consuming live inputs",
}

_AUDIT = r"""
import importlib, json, pkgutil
import evotorch_tpu
out = {}
for info in pkgutil.walk_packages(evotorch_tpu.__path__, "evotorch_tpu."):
    if info.name.rsplit(".", 1)[-1] == "__main__":
        continue
    names = list(getattr(importlib.import_module(info.name), "__all__", ()))
    port_name = "evotorch_tpu_torch" + info.name[len("evotorch_tpu"):]
    try:
        port = importlib.import_module(port_name)
    except ModuleNotFoundError as e:
        if e.name is not None and e.name.startswith("evotorch_tpu_torch"):
            out[info.name] = {"names": names, "port": None}
            continue
        raise
    has = {n: hasattr(port, n) for n in set(names) | set(%r)}
    out[info.name] = {"names": names, "port": has}
print(json.dumps(out))
""" % (sorted(_RENAMED.values()),)


def test_every_public_name_has_a_counterpart():
    """Walk every module of the JAX package (``__main__`` aside): each name
    of its ``__all__`` is in the port's module at the same dotted path, or
    renamed in ``_RENAMED`` to a name that module has, or in ``_ABSENT``
    with its reason; the port's module exists unless the JAX module is in
    ``_ABSENT``. No entry of either table is stale: each is used, and none
    names what the port has under the JAX name. This is what says the port
    does all the JAX package does."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    result = subprocess.run(
        [sys.executable, "-c", _AUDIT], cwd=REPO_ROOT, capture_output=True, text=True, timeout=600, env=env
    )
    assert result.returncode == 0, result.stderr[-4000:]
    modules = json.loads(result.stdout.strip().splitlines()[-1])
    assert len(modules) > 100
    problems, used = [], set()
    for module, entry in sorted(modules.items()):
        if entry["port"] is None:
            if module in _ABSENT:
                used.add(module)
            else:
                problems.append(f"{module}: the port has no module {module.replace('evotorch_tpu', 'evotorch_tpu_torch', 1)}")
            continue
        if module in _ABSENT:
            problems.append(f"{module}: in _ABSENT, but the port has the module")
        for name in entry["names"]:
            has = entry["port"]
            if has[name]:
                if name in _RENAMED or name in _ABSENT:
                    problems.append(f"{module}.{name}: in a table, but the port has it under the JAX name")
            elif name in _RENAMED:
                used.add(name)
                if not has[_RENAMED[name]]:
                    problems.append(f"{module}.{name}: renamed to {_RENAMED[name]}, which the port's module lacks")
            elif name in _ABSENT:
                used.add(name)
            else:
                problems.append(f"{module}.{name}: missing from the port")
    stale = sorted((set(_RENAMED) | set(_ABSENT)) - used)
    assert not problems, "\n".join(problems)
    assert not stale, f"stale table entries (the JAX package no longer exports them): {stale}"
    assert [k for k in _ABSENT if k.startswith("evotorch_tpu.")] == ["evotorch_tpu.envs.braxenv"]
    assert all(reason.strip() for reason in _ABSENT.values())


def test_no_module_names_a14():
    """Nothing in the port, its smoke test or its scripts cites item A.14
    (the lint and ``TorchOptimizer``): it is ported, and Brax's refusal
    says why it has no port instead."""
    from evotorch_tpu_torch.analysis.graftlint import default_targets

    paths = [p for t in default_targets(REPO_ROOT) for p in ([t] if t.is_file() else t.rglob("*.py"))]
    assert len(paths) > 100
    for path in paths:
        assert "A.14" not in path.read_text(), path
    from evotorch_tpu_torch.envs import make_env

    with pytest.raises(NotImplementedError, match="JAX-only") as raised:
        make_env("brax::ant", device="cpu")
    assert "ROADMAP" not in str(raised.value)


def test_last_slice_modules_import_without_jax():
    """The lint, the optimizers and the observability package (with every
    name it re-exports resolved) import neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import evotorch_tpu_torch.analysis, evotorch_tpu_torch.analysis.checkers, evotorch_tpu_torch.analysis.__main__\n"
        "import evotorch_tpu_torch.optimizers\n"
        "import evotorch_tpu_torch.observability as obs\n"
        "[getattr(obs, n) for n in obs.__all__]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'evotorch_tpu')]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_observability_reexports_the_jax_names():
    """C.10: ``from evotorch_tpu_torch.observability import X`` works for the
    names the JAX package re-exports there, each the object its submodule
    defines, while the package import stays lazy (the submodules that a
    CLI runs as ``-m`` load at first access)."""
    code = (
        "import sys\n"
        "import evotorch_tpu_torch.observability as obs\n"
        "lazy = ('slo', 'metricshub', 'health', 'programs', 'timings')\n"
        "assert not [m for m in lazy if 'evotorch_tpu_torch.observability.' + m in sys.modules]\n"
        "from evotorch_tpu_torch.observability import MetricsHub, SLOWatchdog, HealthMonitor, Rule, SLOReport\n"
        "from evotorch_tpu_torch.observability import TimingLedger, TunedEntry, ProgramLedger, ProgramRecord\n"
        "from evotorch_tpu_torch.observability import lookup_tuned, machine_fingerprint, compute_health_block\n"
        "from evotorch_tpu_torch.observability import pack_group_telemetry, TELEMETRY_WIDTH, get_tracer\n"
        "from evotorch_tpu_torch.observability import cache_stats, compare_to_baseline, DonationReport, timings\n"
        "from evotorch_tpu_torch.observability import ensure_compile_counter, ensure_compile_timer\n"
        "from evotorch_tpu_torch.observability import metricshub, slo, programs\n"
        "assert MetricsHub is metricshub.MetricsHub and SLOWatchdog is slo.SLOWatchdog\n"
        "assert ProgramLedger is programs.ProgramLedger and lookup_tuned is timings.lookup_tuned\n"
        "assert type(timings).__name__ == 'module' and isinstance(timings.timings, TimingLedger)\n"
        "assert set(obs.__all__) <= set(dir(obs))\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_first_use_sinks_and_the_registry_counters(monkeypatch, tmp_path):
    """C.12: permanent first-use sinks (the JAX sentinel's
    ``register_sink``/``unregister_sink``) see every kernel library loaded,
    by name and with its seconds; the registry's ``compiles`` and
    ``compile_seconds`` are two such sinks, installed once however often
    ``ensure_compile_counter``/``ensure_compile_timer`` are called, so a
    load counts once."""
    import types

    from evotorch_tpu_torch.analysis import retrace_sentinel
    from evotorch_tpu_torch.observability import registry
    from evotorch_tpu_torch.observability.registry import counters

    library = tmp_path / "stub.so"
    library.write_bytes(b"")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_library_path", lambda name: library)
    monkeypatch.setattr(_build, "_load_library", lambda path: types.SimpleNamespace())

    class Sink:
        def __init__(self):
            self.seen = []

        def record(self, name, seconds):
            self.seen.append((name, seconds))

        def __eq__(self, other):  # equal sinks must not unregister each other
            return isinstance(other, Sink)

    first, second = Sink(), Sink()
    retrace_sentinel.register_sink(first)
    retrace_sentinel.register_sink(second)
    for _ in range(3):
        registry.ensure_compile_counter()
        registry.ensure_compile_timer()
    before = counters.snapshot(("compiles", "compile_seconds"))
    try:
        _build.library("centered_rank", {})
        retrace_sentinel.unregister_sink(second)
        _build.library("symmetric_gaussian", {})
    finally:
        retrace_sentinel.unregister_sink(first)
        retrace_sentinel.unregister_sink(second)
    assert [name for name, _ in first.seen] == ["centered_rank", "symmetric_gaussian"]
    assert [name for name, _ in second.seen] == ["centered_rank"]
    assert all(seconds >= 0.0 for _, seconds in first.seen)
    delta = counters.delta(before)
    assert delta["compiles"] == 2
    assert abs(delta["compile_seconds"] - sum(seconds for _, seconds in first.seen)) < 1e-9
    assert first not in [s for s in retrace_sentinel._SINKS if s is first]


def test_clone_copies_what_it_is_given():
    """C.12: ``tools.clone`` (also ``utils.clone``) copies a tensor, a nested
    container and a ``SolutionBatch``: writing to the clone leaves the
    original alone (torch tensors are mutable, unlike the JAX arrays the
    JAX ``clone`` returns as they are). ``DType`` and ``Device`` are the
    types the helpers accept."""
    from evotorch_tpu_torch import tools, utils
    from evotorch_tpu_torch.core import Problem, SolutionBatch
    from evotorch_tpu_torch.tools import DType, Device, clone

    assert utils.clone is clone and utils.DType is DType and utils.Device is Device
    assert torch.dtype in DType.__args__ and torch.device in Device.__args__
    x = torch.arange(4.0)
    y = clone(x)
    y[0] = 10.0
    assert x[0] == 0.0
    nested = {"a": [torch.zeros(2), (torch.ones(3),)], "b": 5}
    copied = tools.clone(nested)
    copied["a"][0][1] = 7.0
    copied["a"][1][0].add_(1.0)
    assert torch.equal(nested["a"][0], torch.zeros(2)) and torch.equal(nested["a"][1][0], torch.ones(3))
    problem = Problem("min", lambda v: v.sum(-1), solution_length=3, initial_bounds=(-1, 1), device="cpu")
    batch = SolutionBatch(problem, 4)
    twin = clone(batch)
    before = batch.values.clone()
    twin.access_values()[:] = 9.0
    assert torch.equal(batch.values, before) and torch.all(twin.values == 9.0)


def test_global_lane_ids_are_the_sharded_seeding_contract():
    """C.12: ``vecrl.global_lane_ids(rank, n_local)`` is ``rank * n_local +
    arange(n_local)`` (the JAX package's, with the rank given where JAX
    reads ``axis_index``), on the host by default, and the sharded
    evaluators' blocks take their ids from it."""
    from evotorch_tpu_torch.neuroevolution.net import vecrl
    from evotorch_tpu_torch.parallel import evaluate
    from evotorch_tpu_torch.parallel.mesh import Mesh

    ids = vecrl.global_lane_ids(2, 5)
    assert ids.dtype == torch.int64 and ids.device.type == "cpu"
    assert ids.tolist() == [10, 11, 12, 13, 14]
    assert vecrl.global_lane_ids(0, 3, device="cpu").tolist() == [0, 1, 2]
    calls = []

    def recording(rank, n_local, device=None):
        calls.append((rank, n_local))
        return vecrl.global_lane_ids(rank, n_local, device)

    mesh = Mesh.__new__(Mesh)
    mesh.rank, mesh.size = 1, 3
    import unittest.mock as mock

    with mock.patch.object(evaluate, "global_lane_ids", recording):
        rows, lane_ids, per = evaluate._block(torch.zeros(10, 2), mesh)
    assert calls == [(1, 4)] and lane_ids.tolist() == [4, 5, 6, 7] and per == 4 and rows.shape == (4, 2)
