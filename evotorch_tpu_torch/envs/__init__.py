"""Batched environments on the device (counterpart of ``evotorch_tpu/envs``):
the rigid-body Humanoid, the classic-control suite and the registry so far."""

from .base import Env, EnvState, Space
from .classic import Acrobot, CartPole, MountainCarContinuous, Pendulum, Swimmer2D
from .humanoid import Humanoid
from .registry import canonical_env_key, make_env, register_env

__all__ = [
    "Acrobot",
    "CartPole",
    "Env",
    "EnvState",
    "Humanoid",
    "MountainCarContinuous",
    "Pendulum",
    "Space",
    "Swimmer2D",
    "canonical_env_key",
    "make_env",
    "register_env",
]
