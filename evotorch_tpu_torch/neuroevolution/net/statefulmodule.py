"""Stateful-module names (counterpart of
``evotorch_tpu/neuroevolution/net/statefulmodule.py``).

Every layer of the port already follows the ``apply(params, x, state) ->
(y, state)`` protocol and ``Sequential`` threads the states, so these are
the JAX package's aliases, kept for its callers.
"""

from __future__ import annotations

from .layers import Module, Sequential

__all__ = ["MultiLayered", "StatefulModule", "ensure_stateful"]

StatefulModule = Module
MultiLayered = Sequential


def ensure_stateful(module: Module) -> Module:
    """The module itself: every module follows the state protocol."""
    if not isinstance(module, Module):
        raise TypeError(f"Expected a Module, got {type(module)}")
    return module
