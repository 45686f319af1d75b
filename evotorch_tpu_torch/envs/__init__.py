"""Batched environments on the device (counterpart of ``evotorch_tpu/envs``):
the rigid-body locomotion tasks (Humanoid, Ant, Walker2D, HalfCheetah), the
SLIP Hopper, the classic-control suite and the registry."""

from .ant import Ant
from .base import Env, EnvState, Space
from .classic import Acrobot, CartPole, MountainCarContinuous, Pendulum, Swimmer2D
from .halfcheetah import HalfCheetah
from .hopper import Hopper
from .humanoid import Humanoid
from .registry import canonical_env_key, make_env, register_env
from .walker2d import Walker2D

__all__ = [
    "Acrobot",
    "Ant",
    "CartPole",
    "Env",
    "EnvState",
    "HalfCheetah",
    "Hopper",
    "Humanoid",
    "MountainCarContinuous",
    "Pendulum",
    "Space",
    "Swimmer2D",
    "Walker2D",
    "canonical_env_key",
    "make_env",
    "register_env",
]
