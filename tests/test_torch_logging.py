"""The port's loggers against the JAX package's on the CPU: the same
searcher run (PGPE on a vectorized sphere, the JAX draws injected through
``eps=``) gives ``StdOutLogger`` the same rows (key order and integer
values exactly, floats to ``rel=1e-5``); ``PandasLogger`` the same frame;
``PicklingLogger`` pickles that load back; importing the module needs none
of the experiment trackers."""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu import logging as jax_logging
from evotorch_tpu.algorithms import PGPE as JaxPGPE
from evotorch_tpu.core import Problem as JaxProblem
from evotorch_tpu_torch import logging as port_logging
from evotorch_tpu_torch.algorithms import PGPE
from evotorch_tpu_torch.core import Problem
from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian

L, N = 6, 10
REPO_ROOT = Path(__file__).resolve().parents[1]


def torch_sphere(x):
    return torch.sum(x**2, dim=-1)


def _searchers(monkeypatch):
    kw = dict(solution_length=L, initial_bounds=(-1.0, 1.0), vectorized=True)
    jax_problem = JaxProblem("min", lambda x: jnp.sum(x**2, axis=-1), **kw)
    port_problem = Problem("min", torch_sphere, device="cpu", **kw)
    center = np.random.default_rng(1).normal(size=L).astype(np.float32)
    skw = dict(popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, center_init=center)
    jax_searcher, port_searcher = JaxPGPE(jax_problem, **skw), PGPE(port_problem, **skw)
    original = SymmetricSeparableGaussian.sample

    def sample(self, num_solutions, *, generator=None, eps=None):
        _, key = jax.random.split(jax_problem._rng_key)
        drawn = np.array(jax.random.normal(key, (num_solutions // 2, L), dtype=jnp.float32))
        return original(self, num_solutions, eps=torch.from_numpy(drawn))

    monkeypatch.setattr(SymmetricSeparableGaussian, "sample", sample)
    return jax_searcher, port_searcher


def _parse(text):
    rows, row = [], []
    for line in text.splitlines():
        if not line.strip():
            if row:
                rows.append(row)
            row = []
            continue
        key, value = (part.strip() for part in line.split(" : ", 1))
        row.append((key, value))
    return rows


def test_stdout_rows_equal_jax(monkeypatch, capsys):
    jax_searcher, port_searcher = _searchers(monkeypatch)
    jax_logging.StdOutLogger(jax_searcher, interval=1)
    port_logging.StdOutLogger(port_searcher, interval=1)
    rows = {"jax": [], "port": []}
    for _ in range(3):
        port_searcher.step()  # reads the JAX key before the JAX step advances it
        rows["port"] += _parse(capsys.readouterr().out)
        jax_searcher.step()
        rows["jax"] += _parse(capsys.readouterr().out)
    assert len(rows["port"]) == len(rows["jax"]) == 3
    for ours, theirs in zip(rows["port"], rows["jax"]):
        theirs = [(k, v) for k, v in theirs if k not in ("compiles", "trace_spans", "telemetry_fetches", "compile_seconds", "peak_hbm_bytes")]
        assert [k for k, _ in ours] == [k for k, _ in theirs]
        for (key, a), (_, b) in zip(ours, theirs):
            if key == "step_seconds":
                continue
            if a == "None" or b == "None":
                assert a == b, key
            else:
                assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7), key


def test_pandas_logger_frame(monkeypatch):
    pytest.importorskip("pandas")
    _, port_searcher = _searchers(monkeypatch)
    logger = port_logging.PandasLogger(port_searcher, interval=2)
    port_searcher.run(4)
    frame = logger.to_dataframe()
    assert list(frame.index) == [2, 4] and "mean_eval" in frame.columns
    assert "center" not in frame.columns  # a vector: not a scalar


def test_pickling_logger_round_trip(monkeypatch, tmp_path):
    _, port_searcher = _searchers(monkeypatch)
    logger = port_logging.PicklingLogger(port_searcher, interval=2, directory=str(tmp_path), prefix="run", verbose=False)
    port_searcher.run(3)  # saves at 2 and at the end of the run
    saved = logger.unpickle_last_file()
    assert Path(logger.last_file_name).name == "run_generation000003.pickle"
    assert saved["iter"] == 3
    assert torch.equal(saved["center"], port_searcher.status["center"])
    assert saved["mean_eval"] == port_searcher.status["mean_eval"]
    assert torch.equal(saved["best"].values, port_searcher.status["best"].values)
    assert len(list(tmp_path.glob("run_generation*.pickle"))) == 2
    with open(tmp_path / "run_generation000002.pickle", "rb") as f:
        assert pickle.load(f)["iter"] == 2


def test_scalar_filter_and_intervals(monkeypatch):
    _, port_searcher = _searchers(monkeypatch)
    seen = []

    class Collect(port_logging.ScalarLogger):
        def _log(self, status):
            seen.append(status)

    Collect(port_searcher, interval=2, after_first_step=True)
    port_searcher.run(5)
    assert [s["iter"] for s in seen] == [1, 3, 5]
    assert all(isinstance(v, (int, float, str, type(None))) for s in seen for v in s.values())


def test_logging_imports_no_tracker_and_gated_loggers_need_theirs():
    code = (
        "import sys\n"
        "import evotorch_tpu_torch.logging\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pandas', 'mlflow', 'neptune', 'sacred', 'wandb', 'jax'))\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    problem = Problem("min", torch_sphere, solution_length=L, initial_bounds=(-1.0, 1.0), vectorized=True, device="cpu")
    searcher = PGPE(problem, popsize=N, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3)
    for name, cls in (("mlflow", port_logging.MlflowLogger), ("wandb", port_logging.WandbLogger)):
        try:
            __import__(name)
        except ImportError:
            with pytest.raises(ImportError):
                cls(searcher)

    class Run:
        def __init__(self):
            self.logged = []
            self.result = None

        def log_scalar(self, key, value, step):
            self.logged.append((key, value, step))

    run = Run()
    port_logging.SacredLogger(searcher, run, result="mean_eval")
    searcher.step()
    assert ("iter", 1.0, 1) in run.logged and run.result == searcher.status["mean_eval"]
