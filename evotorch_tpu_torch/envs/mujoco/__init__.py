"""Real-MuJoCo evaluation backend (counterpart of
``evotorch_tpu/envs/mujoco``; host numpy over ``mujoco.rollout``).

- :class:`MjVecEnv` (``mjvecenv.py``): a batched host rollout engine that
  steps N real MuJoCo models per call through ``mujoco.rollout``'s threaded
  API, recomputing each ``-v5`` family's observation, reward terms and
  termination from raw physics state. API-compatible with
  ``net.hostvecenv.SyncVectorEnv``, so both host rollout engines run
  unchanged on real physics.
- :func:`make_host_vector_env`: the backend chooser ``GymNE`` uses when
  ``num_envs > 1``: ``MjVecEnv`` for supported MuJoCo envs, the generic
  ``SyncVectorEnv`` for everything else.
- ``fidelity.py``: a matched-action harness that drives one of the port's
  native torch envs and its real ``-v5`` counterpart with identical action
  sequences and reports per-reward-term divergence.

``mujoco`` and ``gymnasium`` are optional: importing this package is
always safe; the submodules import ``mujoco`` at their top level and load
lazily, so the guard is :func:`mujoco_available` (or catching
``ImportError`` around the lazy attribute access).
"""

from __future__ import annotations

from importlib import import_module, util

__all__ = [
    "MjVecEnv",
    "make_host_vector_env",
    "mujoco_available",
    "run_fidelity",
    "format_fidelity_markdown",
]

_LAZY = {
    "MjVecEnv": ".mjvecenv",
    "make_host_vector_env": ".mjvecenv",
    "run_fidelity": ".fidelity",
    "format_fidelity_markdown": ".fidelity",
}


def mujoco_available() -> bool:
    """True when both ``mujoco`` and ``gymnasium`` are importable (cheap:
    spec lookup only, no module import)."""
    return util.find_spec("mujoco") is not None and util.find_spec("gymnasium") is not None


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(target, __name__), name)
