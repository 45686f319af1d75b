"""Loggers that attach to a searcher's log hook (counterpart of
``evotorch_tpu/logging.py``): ``Logger``, ``ScalarLogger``,
``StdOutLogger``, ``PandasLogger``, ``PicklingLogger``, and the
``MlflowLogger``, ``NeptuneLogger``, ``SacredLogger`` and ``WandbLogger``
of the experiment trackers.

Importing this module needs none of pandas, mlflow, neptune, sacred or
wandb: each of them is imported by the logger that uses it, when it is
used.
"""

from __future__ import annotations

import os
import pickle
import weakref
from datetime import datetime
from numbers import Number
from typing import Any, Optional

import torch

__all__ = [
    "Logger",
    "ScalarLogger",
    "StdOutLogger",
    "PandasLogger",
    "PicklingLogger",
    "MlflowLogger",
    "NeptuneLogger",
    "SacredLogger",
    "WandbLogger",
]


class Logger:
    """Base logger: appends itself to ``searcher.log_hook`` and logs every
    ``interval`` steps."""

    def __init__(self, searcher, *, interval: int = 1, after_first_step: bool = False):
        searcher.log_hook.append(self)
        self._interval = int(interval)
        self._after_first_step = bool(after_first_step)
        self._steps_count = 0

    def __call__(self, status: dict):
        if self._after_first_step:
            n = self._steps_count
            self._steps_count += 1
        else:
            self._steps_count += 1
            n = self._steps_count
        if n % self._interval == 0:
            self._filtered_log(status)

    def _filter(self, status: dict) -> dict:
        return status

    def _filtered_log(self, status: dict):
        self._log(self._filter(status))

    def _log(self, status: dict):
        raise NotImplementedError


class ScalarLogger(Logger):
    """Keeps the scalar status items only; a 0-d tensor becomes a float."""

    def _filter(self, status: dict) -> dict:
        result = {}
        for k, v in status.items():
            if isinstance(v, (Number, str, bool, type(None))):
                result[k] = v
            elif getattr(v, "ndim", None) == 0:
                result[k] = float(v)
        return result


class StdOutLogger(ScalarLogger):
    """Prints the status to the standard output, ``leading_keys`` first."""

    def __init__(self, searcher, *, interval: int = 1, after_first_step: bool = False, leading_keys: tuple = ("iter",)):
        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._leading_keys = tuple(leading_keys)

    def _log(self, status: dict):
        max_key_len = max((len(str(k)) for k in status), default=0)
        parts = [(k, status[k]) for k in self._leading_keys if k in status]
        parts += [(k, v) for k, v in status.items() if k not in self._leading_keys]
        for k, v in parts:
            print(f"{str(k):>{max_key_len}} : {v}")
        print()


class PandasLogger(ScalarLogger):
    """Collects the status rows into a pandas DataFrame (pandas is
    imported by ``to_dataframe``)."""

    def __init__(self, searcher, *, interval: int = 1, after_first_step: bool = False):
        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._data = []

    def _log(self, status: dict):
        self._data.append(dict(status))

    def to_dataframe(self, *, index: Optional[str] = "iter"):
        import pandas as pd

        frame = pd.DataFrame(self._data)
        if index is not None and index in frame.columns:
            frame = frame.set_index(index)
        return frame


def _picklable(x: Any) -> Any:
    """Tensors go to the CPU, so the pickle loads on a machine without a
    card."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class PicklingLogger(Logger):
    """Pickles chosen status items (and a ``to_policy`` export, where the
    problem makes one) every ``interval`` steps and at the end of a run."""

    def __init__(
        self,
        searcher,
        *,
        interval: int,
        directory: Optional[str] = None,
        prefix: Optional[str] = None,
        zfill: int = 6,
        items_to_save: tuple = ("center", "best", "pop_best", "median_eval", "mean_eval"),
        make_policy_from: Optional[str] = None,
        after_first_step: bool = False,
        verbose: bool = True,
    ):
        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._searcher_ref = weakref.ref(searcher)
        self._directory = directory if directory is not None else os.getcwd()
        os.makedirs(self._directory, exist_ok=True)
        if prefix is None:
            prefix = "search_" + datetime.now().strftime("%Y%m%d_%H%M%S")
        self._prefix = prefix
        self._zfill = int(zfill)
        self._items_to_save = tuple(items_to_save)
        self._make_policy_from = make_policy_from
        self._verbose = bool(verbose)
        self._last_file: Optional[str] = None
        searcher.end_of_run_hook.append(self._final_save)

    @property
    def last_file_name(self) -> Optional[str]:
        return self._last_file

    def _log(self, status: dict):
        self.save(status)

    def _final_save(self, status: dict):
        self.save(status)

    def save(self, status: Optional[dict] = None) -> str:
        searcher = self._searcher_ref()
        if status is None and searcher is not None:
            status = dict(searcher.status.items())
        payload = {}
        for item in self._items_to_save:
            if status is not None and item in status:
                payload[item] = _picklable(status[item])
        if searcher is not None:
            payload["iter"] = searcher.step_count
            problem = searcher.problem
            policy_source = self._make_policy_from
            if policy_source is None:
                policy_source = next((c for c in ("center", "best", "pop_best") if c in payload), None)
            if policy_source is not None and policy_source in payload and hasattr(problem, "to_policy"):
                payload["policy"] = problem.to_policy(payload[policy_source])
        fname = os.path.join(
            self._directory, f"{self._prefix}_generation{str(payload.get('iter', 0)).zfill(self._zfill)}.pickle"
        )
        with open(fname, "wb") as f:
            pickle.dump(payload, f)
        self._last_file = fname
        if self._verbose:
            print(f"[PicklingLogger] saved {fname}")
        return fname

    def unpickle_last_file(self):
        with open(self._last_file, "rb") as f:
            return pickle.load(f)


class MlflowLogger(ScalarLogger):
    """Logs the scalars to MLflow (imports ``mlflow``)."""

    def __init__(self, searcher, client=None, run=None, *, interval: int = 1, after_first_step: bool = False):
        import mlflow  # noqa: F401  (before attaching: a failed import leaves the searcher as it was)

        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._client = client
        self._run = run

    def _log(self, status: dict):
        import mlflow

        step = status.get("iter", self._steps_count)
        metrics = {k: float(v) for k, v in status.items() if isinstance(v, Number)}
        if self._client is not None and self._run is not None:
            for k, v in metrics.items():
                self._client.log_metric(self._run.info.run_id, k, v, step=step)
        else:
            mlflow.log_metrics(metrics, step=step)


class NeptuneLogger(ScalarLogger):
    """Logs the scalars to a Neptune run."""

    def __init__(self, searcher, run, *, interval: int = 1, after_first_step: bool = False, group: Optional[str] = None):
        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._run = run
        self._group = group

    def _log(self, status: dict):
        for k, v in status.items():
            if isinstance(v, Number):
                self._run[k if self._group is None else f"{self._group}/{k}"].log(v)


class SacredLogger(ScalarLogger):
    """Logs the scalars to a Sacred run."""

    def __init__(self, searcher, run, result: Optional[str] = None, *, interval: int = 1, after_first_step: bool = False):
        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._run = run
        self._result = result

    def _log(self, status: dict):
        step = status.get("iter", self._steps_count)
        for k, v in status.items():
            if isinstance(v, Number):
                self._run.log_scalar(k, float(v), step)
        if self._result is not None and self._result in status:
            self._run.result = float(status[self._result])


class WandbLogger(ScalarLogger):
    """Logs the scalars to Weights & Biases (imports ``wandb``)."""

    def __init__(self, searcher, init: bool = True, *, interval: int = 1, after_first_step: bool = False, **wandb_kwargs):
        import wandb  # before attaching, as in MlflowLogger

        super().__init__(searcher, interval=interval, after_first_step=after_first_step)
        self._wandb = wandb
        if init:
            self._wandb.init(**wandb_kwargs)

    def _log(self, status: dict):
        self._wandb.log({k: float(v) for k, v in status.items() if isinstance(v, Number)})
