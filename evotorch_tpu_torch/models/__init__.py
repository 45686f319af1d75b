"""Ready-made policy model families (counterpart of
``evotorch_tpu/models``): factories over the port's layers with
evolution-friendly defaults, usable as ``VecNE``/``GymNE`` network specs or
on their own."""

from .policies import (
    LinearPolicy,
    LSTMPolicy,
    MLPPolicy,
    RNNPolicy,
    locomotor_policy,
    structured_control_policy,
)

__all__ = [
    "LinearPolicy",
    "LSTMPolicy",
    "MLPPolicy",
    "RNNPolicy",
    "locomotor_policy",
    "structured_control_policy",
]
