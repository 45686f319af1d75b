"""A configuration's env and plain policy, as every reader of the benchmark
takes them.

Two optional keys of a configuration file choose the policy:

- ``"network"``: the port's network string, as ``VecNE(network=...)``
  takes it. Without it, the string is the tanh network of ``hidden``
  (``mlp_policy.network``).
- ``"reference_policy"``: the path, from the checkout's root, of a file
  under ``perfbench/reference/`` that defines the plain policy (the
  interface is in ``mlp_policy.py``'s docstring). It is loaded by path.
  Without it, the policy is ``mlp_policy.py``'s.

``"env"`` names one of ``ENVS``, the envs the reference has. An optional
``"lowrank_rank"`` (a whole number, 1 or more) holds the population
factored (``harness.py``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

from . import mlp_policy
from .physics import Humanoid

__all__ = ["ENVS", "check_config", "make", "make_env", "network", "policy_module"]

ROOT = Path(__file__).resolve().parents[2]
#: the envs the reference has, by the name a configuration's ``env`` gives
ENVS = {"humanoid": Humanoid}


def check_config(config: dict, root: Path = ROOT) -> dict:
    """``config`` with its ``reference_policy`` as an absolute path; raises
    for an env the reference lacks, a ``lowrank_rank`` that is not a whole
    number of 1 or more, or a policy file that is not a file under
    ``perfbench/reference/``."""
    if config["env"] not in ENVS:
        raise ValueError(f"the reference has no env {config['env']!r}; it has {sorted(ENVS)}")
    rank = config.get("lowrank_rank", 1)
    if type(rank) is not int or rank < 1:
        raise ValueError(f"lowrank_rank must be a whole number of 1 or more, got {rank!r}")
    if "reference_policy" not in config:
        return config
    home = (Path(root) / "perfbench" / "reference").resolve()
    path = (Path(root) / config["reference_policy"]).resolve()
    if home not in path.parents or not path.is_file():
        raise ValueError(f"reference_policy {config['reference_policy']!r} is not a file under perfbench/reference/")
    return dict(config, reference_policy=str(path))


def make_env(config: dict, device) -> Humanoid:
    return ENVS[config["env"]](device)


def policy_module(config: dict) -> ModuleType:
    """The configuration's policy file, loaded by path (absolute, or from
    the checkout's root); ``mlp_policy`` when it names none."""
    if "reference_policy" not in config:
        return mlp_policy
    path = Path(config["reference_policy"])
    path = path if path.is_absolute() else ROOT / path
    spec = importlib.util.spec_from_file_location(f"perfbench_policy_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make(config: dict, obs_size: int, act_size: int):
    """The configuration's plain policy for an env of these sizes."""
    return policy_module(config).make(config, int(obs_size), int(act_size))


def network(config: dict) -> str:
    """The port's network string that the configuration runs."""
    return str(config["network"]) if "network" in config else mlp_policy.network(config)
