"""The ``VecNE`` side of the service: evaluate an unmodified problem
through a server (counterpart of ``evotorch_tpu/serving/backend.py``).

``VecNE(..., eval_backend=RemoteEvalBackend(server))`` (or
``eval_backend=server``, which the problem wraps) routes every
evaluation through the shared :class:`~evotorch_tpu_torch.serving.EvalServer`:
the backend admits itself as a tenant, submits each batch with the
problem's own generator, drives the server until the request completes
(serving other tenants' items on the way), and hands back a
``RolloutResult`` the problem consumes as it consumes its own engine's:
scores, the tenant's statistics, the counters and a telemetry wire.
Searchers never know.

The request draws its table rows from the problem's generator at the
problem's popsize, as the problem's own ``episodes_refill`` evaluation
would, and leaves the generator in the same state. So with observation
normalization off the scores equal the problem's standalone ones at the
server's refill width (``refill_config={"width": server.refill_width}``),
bit for bit on the CPU.
"""

from __future__ import annotations

from typing import Optional

from .server import EvalServer, Tenant

__all__ = ["RemoteEvalBackend"]


class RemoteEvalBackend:
    """One ``VecNE`` problem's tenancy on a shared :class:`EvalServer`.
    Made with a server (it admits itself, optionally as ``name``) or with
    an admitted tenant. ``close()`` departs and frees the group row."""

    def __init__(self, server: EvalServer, *, tenant: Optional[Tenant] = None, name: Optional[str] = None):
        if not isinstance(server, EvalServer):
            raise TypeError(f"server must be an EvalServer, got {type(server).__name__}")
        self.server = server
        self.tenant = tenant if tenant is not None else server.admit(name=name)
        self._checked_for = None

    def close(self, *, cancel: bool = False) -> None:
        self.server.depart(self.tenant, cancel=cancel)

    def __enter__(self) -> "RemoteEvalBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel=True)

    def _check_problem(self, problem) -> None:
        """The server runs one eval contract: an attached problem must
        describe the same one (checked once per problem)."""
        if self._checked_for is problem:
            return
        server = self.server
        mismatches = []
        if problem._policy.parameter_count != server.policy.parameter_count:
            mismatches.append(f"parameter_count {problem._policy.parameter_count} != {server.policy.parameter_count}")
        if problem._env.observation_size != server.env.observation_size:
            mismatches.append("observation_size differs")
        if problem._env.action_size != server.env.action_size:
            mismatches.append("action_size differs")
        if problem._num_episodes != server.num_episodes:
            mismatches.append(f"num_episodes {problem._num_episodes} != {server.num_episodes}")
        if problem._episode_length != server.episode_length:
            mismatches.append(f"episode_length {problem._episode_length} != {server.episode_length}")
        if problem._observation_normalization != server.observation_normalization:
            mismatches.append("observation_normalization differs")
        if problem._action_noise_stdev != server.action_noise_stdev:
            mismatches.append(f"action_noise_stdev {problem._action_noise_stdev} != {server.action_noise_stdev}")
        if problem._alive_bonus_schedule is not None or problem._decrease_rewards_by is not None:
            mismatches.append("the server's contract adjusts no rewards")
        if problem._eval_mode == "budget":
            mismatches.append("the server serves the episodes contract; a budget-contract problem cannot evaluate through it")
        if problem.device != server.device:
            mismatches.append(f"the problem lives on {problem.device}, the server on {server.device}")
        if mismatches:
            raise ValueError("problem is incompatible with the server's resident program: " + "; ".join(mismatches))
        self._checked_for = problem

    def evaluate(self, problem, values, generator, groups=None):
        """One evaluation served remotely, with ``problem._rollout_batch``'s
        ``RolloutResult`` contract."""
        from ..tools.lowrank import is_factored

        if groups is not None:
            raise ValueError("solution_groups cannot ride through a RemoteEvalBackend: the server's group axis is the tenant axis")
        if is_factored(values):
            raise ValueError("factored (low-rank / trunk-delta) populations are not servable; densify or evaluate standalone")
        self._check_problem(problem)
        stats = problem._obs_norm.stats if problem._observation_normalization else None
        result = self.server.submit(self.tenant, values, generator, stats=stats).result()
        if problem._nonfinite_quarantine:
            # the standalone rule, applied to this tenant's scores only: the
            # server never takes a worst finite score across tenants
            from ..neuroevolution.net.vecrl import _quarantine_nonfinite

            scores, _ = _quarantine_nonfinite(result.scores, penalty=problem._nonfinite_penalty)
            result = result._replace(scores=scores)
        return result
