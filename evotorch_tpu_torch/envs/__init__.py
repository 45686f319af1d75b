"""Batched environments on the device (counterpart of ``evotorch_tpu/envs``):
the rigid-body Humanoid so far."""

from .base import Env, EnvState, Space
from .humanoid import Humanoid

__all__ = ["Env", "EnvState", "Humanoid", "Space"]
