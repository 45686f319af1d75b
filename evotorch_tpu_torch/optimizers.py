"""Stateful optimizers exposing ``ascent(grad)`` (counterpart of
``evotorch_tpu/optimizers.py``): ``ClipUp`` with ``ClipUpParameterGroup``,
``Adam``, ``SGD`` and ``get_optimizer_class``.

Each one is a thin stateful wrapper around the step of its functional form
(``algorithms/functional/func*.py``, imported at the first step: the
``algorithms`` package imports this module), so the math is written once; the
state lives on the device and no step syncs with the host. The JAX
package's ``OptaxOptimizer`` wraps an optax transformation, which exists
only for JAX; its torch counterpart is open work (``ROADMAP.md``, item
A.14).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional

import torch

from ._device import resolve_device
from .tools.misc import ensure_tensor_length_and_dtype, to_torch_dtype

__all__ = ["ClipUp", "ClipUpParameterGroup", "Adam", "SGD", "get_optimizer_class"]


class _FunctionalWrapper:
    """Base of the stateful wrappers: the functional state tracks a virtual
    center that starts at 0, and ``ascent(grad)`` returns the center's
    change."""

    def __init__(self, *, solution_length: int, dtype="float32", device=None):
        self._dtype = to_torch_dtype(dtype)
        self._length = int(solution_length)
        self._device = resolve_device(device)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self._length, dtype=self._dtype, device=self._device)

    def _scalar(self, x) -> torch.Tensor:
        """A hyperparameter as a 0-d tensor on the device, made once per
        value: a tensor made from a Python number on the card is a copy
        that waits for the card."""
        cache = self.__dict__.setdefault("_scalars", {})
        key = float(x)
        if key not in cache:
            cache[key] = torch.as_tensor(key, dtype=self._dtype, device=self._device)
        return cache[key]

    def _coerce(self, grad) -> torch.Tensor:
        return ensure_tensor_length_and_dtype(
            grad, self._length, self._dtype, device=self._device, about=f"{type(self).__name__}.ascent"
        )

    @property
    def contained_optimizer(self):
        return self


class ClipUp(_FunctionalWrapper):
    """ClipUp (Toklu et al. 2020): normalize the gradient to ``stepsize``,
    accumulate it with momentum, clip the velocity's norm to ``max_speed``
    (default ``2 * stepsize``)."""

    _param_group_items = {"lr": "_stepsize", "max_speed": "_max_speed", "momentum": "_momentum"}
    _param_group_item_lb = {"lr": 0.0, "max_speed": 0.0, "momentum": 0.0}
    _param_group_item_ub = {"momentum": 1.0}

    def __init__(
        self,
        *,
        solution_length: int,
        dtype="float32",
        device=None,
        stepsize: float,
        momentum: float = 0.9,
        max_speed: Optional[float] = None,
    ):
        super().__init__(solution_length=solution_length, dtype=dtype, device=device)
        stepsize = float(stepsize)
        momentum = float(momentum)
        max_speed = stepsize * 2.0 if max_speed is None else float(max_speed)
        if stepsize < 0.0:
            raise ValueError(f"Invalid stepsize: {stepsize}")
        if momentum < 0.0 or momentum > 1.0:
            raise ValueError(f"Invalid momentum: {momentum}")
        if max_speed < 0.0:
            raise ValueError(f"Invalid max_speed: {max_speed}")
        self._stepsize = stepsize
        self._momentum = momentum
        self._max_speed = max_speed
        self._velocity = self._zeros()
        self._param_groups = (ClipUpParameterGroup(self),)

    def ascent(self, globalg, *, cloned_result: bool = True) -> torch.Tensor:
        """The step to add to the center. With ``cloned_result`` (the
        default) it is a tensor of its own; without, it may be the
        optimizer's velocity itself."""
        from .algorithms.functional.funcclipup import _clipup_step

        velocity, _ = _clipup_step(
            self._coerce(globalg),
            self._zeros(),
            self._velocity,
            self._scalar(self._stepsize),
            self._scalar(self._momentum),
            self._scalar(self._max_speed),
        )
        self._velocity = velocity
        return velocity.clone() if cloned_result else velocity

    @property
    def param_groups(self) -> tuple:
        return self._param_groups


class ClipUpParameterGroup(Mapping):
    """Mapping view over ClipUp's hyperparameters (``lr``, ``max_speed``,
    ``momentum``), which may be changed between steps."""

    def __init__(self, clipup: ClipUp):
        self.clipup = clipup

    def __getitem__(self, key: str) -> float:
        return getattr(self.clipup, ClipUp._param_group_items[key])

    def __setitem__(self, key: str, value: float):
        attrname = ClipUp._param_group_items[key]
        value = float(value)
        lb = ClipUp._param_group_item_lb.get(key)
        if lb is not None and value < lb:
            raise ValueError(f"Invalid value for {key!r}: {value}")
        ub = ClipUp._param_group_item_ub.get(key)
        if ub is not None and value > ub:
            raise ValueError(f"Invalid value for {key!r}: {value}")
        setattr(self.clipup, attrname, value)

    def __iter__(self):
        return iter(ClipUp._param_group_items)

    def __len__(self):
        return len(ClipUp._param_group_items)

    def __repr__(self):
        return f"<{type(self).__name__}: {dict(self)}>"


class Adam(_FunctionalWrapper):
    """Adam, ascending the gradient it is given."""

    def __init__(
        self,
        *,
        solution_length: int,
        dtype="float32",
        device=None,
        stepsize: Optional[float] = None,
        beta1: Optional[float] = None,
        beta2: Optional[float] = None,
        epsilon: Optional[float] = None,
        amsgrad: Optional[bool] = None,
    ):
        super().__init__(solution_length=solution_length, dtype=dtype, device=device)
        if amsgrad:
            raise NotImplementedError("amsgrad is not supported by the Adam adapter (nor by the JAX package's)")
        self._stepsize = 0.001 if stepsize is None else float(stepsize)
        self._beta1 = 0.9 if beta1 is None else float(beta1)
        self._beta2 = 0.999 if beta2 is None else float(beta2)
        self._epsilon = 1e-8 if epsilon is None else float(epsilon)
        self._m = self._zeros()
        self._v = self._zeros()
        self._t = torch.zeros((), dtype=self._dtype, device=self._device)

    def ascent(self, globalg, *, cloned_result: bool = True) -> torch.Tensor:
        """The step to add to the center; a new tensor either way, so
        ``cloned_result`` changes nothing."""
        from .algorithms.functional.funcadam import _adam_step

        center, self._m, self._v, self._t = _adam_step(
            self._coerce(globalg),
            self._zeros(),
            self._scalar(self._stepsize),
            self._scalar(self._beta1),
            self._scalar(self._beta2),
            self._scalar(self._epsilon),
            self._m,
            self._v,
            self._t,
        )
        return center


class SGD(_FunctionalWrapper):
    """SGD with optional momentum, ascending the gradient it is given."""

    def __init__(
        self,
        *,
        solution_length: int,
        dtype="float32",
        device=None,
        stepsize: float,
        momentum: Optional[float] = None,
    ):
        super().__init__(solution_length=solution_length, dtype=dtype, device=device)
        self._stepsize = float(stepsize)
        self._momentum = 0.0 if momentum is None else float(momentum)
        self._velocity = self._zeros()

    def ascent(self, globalg, *, cloned_result: bool = True) -> torch.Tensor:
        """The step to add to the center. With ``cloned_result`` (the
        default) it is a tensor of its own; without, it may be the
        optimizer's velocity itself."""
        from .algorithms.functional.funcsgd import _sgd_step

        velocity, _ = _sgd_step(
            self._coerce(globalg),
            self._zeros(),
            self._velocity,
            self._scalar(self._stepsize),
            self._scalar(self._momentum),
        )
        self._velocity = velocity
        return velocity.clone() if cloned_result else velocity


def get_optimizer_class(s: str, optimizer_config: Optional[dict] = None) -> Callable:
    """An optimizer class by name (``"clipup"``/``"clipsgd"``/``"clipsga"``,
    ``"adam"``, ``"sgd"``/``"sga"``), or a factory that applies
    ``optimizer_config`` when one is given."""
    if s in ("clipsgd", "clipsga", "clipup"):
        cls = ClipUp
    elif s == "adam":
        cls = Adam
    elif s in ("sgd", "sga"):
        cls = SGD
    else:
        raise ValueError(f"Unknown optimizer: {s!r}")
    if optimizer_config is None:
        return cls

    def factory(*args, **kwargs):
        conf = dict(optimizer_config)
        conf.update(kwargs)
        return cls(*args, **conf)

    return factory
