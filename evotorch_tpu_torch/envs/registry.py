"""Environment registry (counterpart of ``evotorch_tpu/envs/registry.py``).

Plain names resolve to the port's envs with the JAX package's
normalization (lowercase, dashes folded, gym-style version suffixes
stripped, aliases folded to one canonical key). ``brax::<name>`` wraps
Brax, which is JAX-only, and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import Env

__all__ = ["canonical_env_key", "make_env", "register_env"]

_REGISTRY: Dict[str, Callable[..., Env]] = {}
_CANONICAL: Dict[str, str] = {}


def register_env(name: str, factory: Callable[..., Env]):
    key = name.lower()
    # aliases of an already-registered factory fold to its first name
    existing = [k for k, f in _REGISTRY.items() if f is factory]
    canonical = _CANONICAL[existing[0]] if existing else key
    _REGISTRY[key] = factory
    _CANONICAL[key] = canonical
    if isinstance(factory, type):
        _CANONICAL.setdefault(factory.__name__.lower(), canonical)


def _normalize(name: str) -> str:
    key = name.lower().replace("-", "_")
    for suffix in ("_v0", "_v1", "_v2", "_v3", "_v4", "_v5"):
        if key.endswith(suffix):
            key = key[: -len(suffix)]
    return key


def canonical_env_key(name: str) -> str:
    """The canonical form of an env name (``"CartPole-v1"`` ->
    ``"cartpole"``, ``"swimmer2d"`` -> ``"swimmer"``)."""
    key = _normalize(name)
    return _CANONICAL.get(key, key)


def make_env(name: str, **kwargs) -> Env:
    """Instantiate an environment by name: ``"cartpole"``, ``"pendulum"``,
    ``"acrobot"``, ``"mountain_car_continuous"``, ``"swimmer"``,
    ``"hopper"``, ``"humanoid"``, ``"ant"``, ``"walker2d"``,
    ``"halfcheetah"`` and their aliases. Keyword arguments go to the env
    (``device=`` among them; the card by default)."""
    if name.startswith("brax::"):
        raise NotImplementedError(
            f"{name!r}: Brax envs are JAX-only and have no port in evotorch_tpu_torch (ROADMAP.md, item A.14)"
        )
    key = canonical_env_key(name)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown environment: {name!r} (known: {sorted(_REGISTRY)})")
    return _REGISTRY[key](**kwargs)


def _register_defaults():
    from .ant import Ant
    from .classic import Acrobot, CartPole, MountainCarContinuous, Pendulum, Swimmer2D
    from .halfcheetah import HalfCheetah
    from .hopper import Hopper
    from .humanoid import Humanoid
    from .walker2d import Walker2D

    # the JAX registry's names and aliases, in its order
    register_env("cartpole", CartPole)
    register_env("pendulum", Pendulum)
    register_env("acrobot", Acrobot)
    register_env("mountain_car_continuous", MountainCarContinuous)
    register_env("mountaincarcontinuous", MountainCarContinuous)
    register_env("swimmer", Swimmer2D)
    register_env("hopper", Hopper)
    register_env("humanoid", Humanoid)
    register_env("ant", Ant)
    register_env("walker2d", Walker2D)
    register_env("walker", Walker2D)
    register_env("halfcheetah", HalfCheetah)
    register_env("half_cheetah", HalfCheetah)


_register_defaults()
