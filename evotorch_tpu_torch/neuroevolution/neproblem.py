"""Neuroevolution problems: solutions are flat network parameters
(counterpart of ``evotorch_tpu/neuroevolution/neproblem.py``).

The network may be given as a string (parsed by ``str_to_net`` with the
problem's constants and ``network_args``), a ``Module``, or a callable
returning one (called with the constants when it is marked
``__evotorch_pass_info__``). Its parameter count is the solution length.
Evaluation is population-batched: ``network_eval_func(policy, values)``
gets the ``FlatParamsPolicy`` and the whole ``(N, L)`` population when
``vectorized_network_eval`` (the default), else one ``(L,)`` row at a time.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import Problem, Solution, SolutionBatch
from ..tools.lowrank import dense_values
from .net.functional import FlatParamsPolicy
from .net.layers import FrozenModule, Module
from .net.parser import str_to_net

__all__ = ["BaseNEProblem", "NEProblem"]


class BaseNEProblem(Problem):
    """Marker base of the neuroevolution problems."""


class NEProblem(BaseNEProblem):
    def __init__(
        self,
        objective_sense,
        network: Union[str, Module, Callable],
        network_eval_func: Optional[Callable] = None,
        *,
        network_args: Optional[dict] = None,
        initial_bounds=(-0.00001, 0.00001),
        eval_dtype=None,
        eval_data_length: int = 0,
        seed: Optional[int] = None,
        num_actors=None,
        vectorized_network_eval: bool = True,
        device=None,
        **kwargs,
    ):
        self._network_spec = network
        self._network_args = dict(network_args or {})
        self._network_eval_func = network_eval_func
        self._vectorized_network_eval = bool(vectorized_network_eval)

        net = self._instantiate_net(network)
        self._net_module = net
        self._policy = FlatParamsPolicy(net)

        super().__init__(
            objective_sense,
            initial_bounds=initial_bounds,
            solution_length=self._policy.parameter_count,
            eval_dtype=eval_dtype,
            eval_data_length=eval_data_length,
            seed=seed,
            num_actors=num_actors,
            device=device,
            **kwargs,
        )

    # ------------------------------------------------------------ networking
    def _network_constants(self) -> dict:
        """Constants given to ``str_to_net`` strings and ``@pass_info``
        callables; subclasses add ``obs_length``, ``act_length``, ..."""
        return {}

    def _instantiate_net(self, network) -> Module:
        constants = self._network_constants()
        if isinstance(network, str):
            return str_to_net(network, **{**constants, **self._network_args})
        if isinstance(network, Module):
            return network
        if callable(network):
            if getattr(network, "__evotorch_pass_info__", False):
                return network(**{**constants, **self._network_args})
            return network(**self._network_args) if self._network_args else network()
        raise TypeError(f"Cannot interpret network specification of type {type(network)}")

    @property
    def network_module(self) -> Module:
        return self._net_module

    @property
    def policy(self) -> FlatParamsPolicy:
        return self._policy

    def _solution_values(self, solution) -> torch.Tensor:
        values = solution.values if isinstance(solution, Solution) else solution
        return torch.as_tensor(values, dtype=self.dtype, device=self.device)

    def make_net(self, solution) -> tuple:
        """``(module, leaves)``: the network and one solution's parameter
        leaves (each without a population axis)."""
        values = self._solution_values(solution)
        return self._net_module, [leaf[0] for leaf in self._policy.unravel(values[None])]

    def parameterize_net(self, values) -> Callable:
        """A ready-to-call ``f(x, state=None) -> (y, state)`` over one flat
        parameter vector, the JAX package's contract; ``x`` is ``(B, in)``,
        every row uses these parameters, and ``state`` is the network's
        recurrent state of the ``B`` rows (None on the first call and for a
        stateless network)."""
        module, leaves = self.make_net(values)
        frozen = FrozenModule(module, leaves)
        return lambda x, state=None: frozen.apply([], x, state)

    # ------------------------------------------------------------ evaluation
    def _evaluate_network(self, values: torch.Tensor):
        """Fitnesses of a population ``(N, L)`` (or of one network ``(L,)``
        when not ``vectorized_network_eval``). Override this, or give
        ``network_eval_func``."""
        if self._network_eval_func is None:
            raise NotImplementedError("Provide network_eval_func or override _evaluate_network")
        return self._network_eval_func(self._policy, values)

    def _evaluate_batch(self, batch: SolutionBatch):
        # a factored population is densified here: a network evaluation
        # takes dense parameter vectors (VecNE keeps it factored instead)
        if self._vectorized_network_eval:
            batch.set_evals(*self._split_eval_outputs(self._evaluate_network(dense_values(batch.values))))
        else:
            for sln in batch:
                sln.set_evals(self._evaluate_network(sln.values))
