"""The in-process multi-tenant evaluation server (counterpart of
``evotorch_tpu/serving/server.py``).

One :class:`EvalServer` owns one resident ``episodes_refill`` rollout
configuration (``parallel.make_resident_rollout_program``) and keeps it
fed with (solution, episode) items from many concurrent searches:
continuous batching in which the telemetry group id is the tenant id.

- The slab (``slab_size`` parameter rows), the lane width, the group-row
  count (``max_tenants + 1``) and the device are fixed when the server is
  made: the residency key (``program.key``), which tenant churn never
  changes.
- Per dispatch, only inputs change: which tenant owns which slab row, the
  rows' random tables and the stacked normalization slots.
- Group row 0 is reserved for padding: a slab that is not full repeats its
  first row into the idle rows but charges their steps to group 0, so no
  tenant's counters or scores see them.

The port keeps each request's matrix on the card from ``submit`` on (a
numpy matrix is copied there once) and packs it into one preallocated
``(slab_size, P)`` slab with slice copies on the device. Each request draws
its random table rows at ``submit``, from its own generator (by default
one seeded from the server's seed and the request id) at its own size
(``vecrl.draw_solution_tables``); an item that spans several dispatches
reads the same rows by its request-local index. So a tenant's scores equal
its standalone ``episodes_refill`` run of the same matrix, at the server's
refill width, from the same generator state, whatever the packing.

Isolation: per-tenant randomness (the tables above), per-tenant
normalization slots (stacked statistics; a slot is zeroed on departure),
per-tenant telemetry rows, and per-tenant SLO admission control (a tenant
whose watchdog trips can no longer submit; its queued items still drain).
The quarantine takes only a fixed ``nonfinite_penalty``: the batch-worst
rule would compare scores across tenants.

Each dispatch copies its telemetry wire to the host, the one host sync a
dispatch makes, to credit the requests; their scores stay on the device.

With a ``mesh`` (``EvalServer(mesh=parallel.default_mesh())``) the server
runs over the ranks of a process group, SPMD: every rank builds the same
server and makes the same ``admit``/``submit``/``step`` calls in the same
order, so every rank packs the same slab, and the resident program lays
the slab's refill lanes, with their rows' lane ids and group ids, over the
ranks (the default sharded form of ``parallel.evaluate``). Each tenant's
scores, group rows and normalization slot come back whole on every rank,
with the one host read a dispatch; the queues, the SLO verdicts and the
metrics rows stay the same on every rank. A request's default generator is
seeded from the server's seed and the request id, the same on every rank.
Dispatches run one at a time, on the default stream, under the server's
dispatch lock; the queues have a lock of their own, held only to pack and
to credit, so a client thread can submit while another thread's dispatch
runs. ``EvalFuture.result()`` may drive dispatches from any thread.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .admission import AdmissionPolicy, resolve_policy
from .requests import EvalFuture, EvalRequest

__all__ = ["EvalServer", "Tenant"]


class Tenant:
    """One admitted search: a group row, a queue of pending requests, its
    cumulative telemetry and its SLO admission state."""

    def __init__(self, group: int, name: str, admitted_dispatch: int, watchdog=None):
        self.group = int(group)
        self.name = str(name)
        self.admitted_dispatch = int(admitted_dispatch)
        self.watchdog = watchdog
        self.pending: deque = deque()
        self.telemetry = None  # cumulative GroupTelemetry of this tenant's row
        self.suspended = False
        self.slo_report = None
        self.requests_served = 0

    @property
    def pending_items(self) -> int:
        return sum(r.pending_items for r in self.pending)

    def oldest_pending_dispatch(self) -> int:
        """The dispatch count at the submit of the oldest pending request
        (the FIFO admission key); large when nothing is pending."""
        if not self.pending:
            return 1 << 62
        return self.pending[0].submit_dispatch

    def __repr__(self):
        state = "suspended" if self.suspended else "active"
        return f"Tenant({self.name!r}, group={self.group}, {state}, pending={self.pending_items})"


def _request_seed(seed: int, request_id: int) -> int:
    """The seed of a request's default generator: a fixed function of the
    server's seed and the request id."""
    return int(np.random.SeedSequence([int(seed), int(request_id)]).generate_state(1, np.uint64)[0] >> 1)


class EvalServer:
    """Long-running in-process evaluation service over one resident program.

    Parameters
    ----------
    env : str or Env, the shared evaluation environment (made on
        ``device`` from a name).
    network : a net Module or FlatParamsPolicy; every tenant's solutions
        are its flat parameters.
    slab_size : parameter rows per dispatch (the packing width).
    max_tenants : group rows ``1..max_tenants`` (row 0 is padding).
    refill_width / refill_period : the refill lanes (the width defaults to
        the engine's default for a slab of ``slab_size * num_episodes``
        items, and is fixed then: ``server.refill_width``).
    num_episodes / episode_length / observation_normalization /
    compute_dtype / action_noise_stdev : the eval contract, the same for
        every tenant.
    admission : an AdmissionPolicy, "fifo", "starvation" or None (FIFO).
    slo : SLO rules; each tenant gets its own watchdog over them, and a
        violating tenant is suspended (``submit`` refuses) while its queued
        items drain.
    metrics : a MetricsHub; one row per dispatch with the per-tenant
        breakdown.
    nonfinite_penalty : turns on the quarantine with this fixed penalty.
    seed : seeds the requests' default generators.
    mesh : a ``parallel.Mesh``: the ranks the slab's lanes are laid over
        (every rank makes the same calls; see the module note). None: one
        rank.
    device : the server's device (the card unless ``"cpu"`` is asked for).
    """

    def __init__(
        self,
        env,
        network,
        *,
        slab_size: int,
        max_tenants: int = 4,
        refill_width: Optional[int] = None,
        refill_period: int = 1,
        num_episodes: int = 1,
        episode_length: Optional[int] = None,
        observation_normalization: bool = False,
        compute_dtype=None,
        action_noise_stdev: Optional[float] = None,
        admission=None,
        slo=None,
        metrics=None,
        health: bool = True,
        nonfinite_penalty: Optional[float] = None,
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        from ..envs import Env, make_env
        from ..neuroevolution.net.functional import FlatParamsPolicy
        from ..neuroevolution.net.layers import Module
        from ..neuroevolution.net.vecrl import _default_refill_width, _max_t
        from ..parallel.evaluate import make_resident_rollout_program

        device = resolve_device(device)
        if isinstance(env, str):
            env = make_env(env, device=device)
        if not isinstance(env, Env):
            raise TypeError(f"env must be a string or Env, got {type(env).__name__}")
        if isinstance(network, FlatParamsPolicy):
            policy = network
        elif isinstance(network, Module):
            policy = FlatParamsPolicy(network)
        else:
            raise TypeError(f"network must be a net Module or FlatParamsPolicy, got {type(network).__name__}")
        self.device = device
        self.env = env
        self.policy = policy
        self.slab_size = int(slab_size)
        if self.slab_size < 1:
            raise ValueError(f"slab_size must be >= 1, got {slab_size}")
        self.max_tenants = int(max_tenants)
        if self.max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        self.num_groups = self.max_tenants + 1  # group 0 is padding
        self.num_episodes = int(num_episodes)
        self.episode_length = None if episode_length is None else int(episode_length)
        self.observation_normalization = bool(observation_normalization)
        self.compute_dtype = compute_dtype
        self.action_noise_stdev = None if action_noise_stdev is None else float(action_noise_stdev)
        items = self.slab_size * self.num_episodes
        self.refill_width = int(min(refill_width if refill_width is not None else _default_refill_width(items), items))
        self.seed = int(seed)
        self._admission: AdmissionPolicy = resolve_policy(admission)
        self._slo_rules = slo
        self._metrics = metrics
        rollout_kwargs = dict(
            num_episodes=self.num_episodes,
            episode_length=self.episode_length,
            observation_normalization=self.observation_normalization,
            compute_dtype=compute_dtype,
            action_noise_stdev=self.action_noise_stdev,
            num_groups=self.num_groups,
            refill_width=self.refill_width,
            refill_period=int(refill_period),
            telemetry=True,  # the server's accounting: not optional
            health=bool(health),
        )
        if nonfinite_penalty is not None:
            rollout_kwargs.update(nonfinite_quarantine=True, nonfinite_penalty=float(nonfinite_penalty))
        self.program = make_resident_rollout_program(env, policy, mesh=mesh, device=device, **rollout_kwargs)

        if self.observation_normalization:
            from ..neuroevolution.net.runningnorm import group_stats_init

            self._stats = group_stats_init(self.num_groups, env.observation_size, device=device)
        else:
            self._stats = None
        # the slab and its tables, reused by every dispatch
        self._slab = torch.empty((self.slab_size, policy.parameter_count), dtype=torch.float32, device=device)
        probe = env.reset_noise(1, torch.Generator(device=device).manual_seed(0))
        self._reset_slab = torch.empty((self.slab_size, self.num_episodes, *probe.shape[1:]), dtype=probe.dtype, device=device)
        self._noise_slab = None
        if self.action_noise_stdev is not None and not env.action_space.is_discrete:
            max_t = _max_t(env, self.episode_length)
            self._noise_slab = torch.empty((self.slab_size, self.num_episodes, max_t, env.action_size), device=device)
        self._groups_host = torch.zeros(self.slab_size, dtype=torch.int64, pin_memory=device.type == "cuda")
        self._generator = torch.Generator(device=device).manual_seed(self.seed)
        self._lock = threading.RLock()  # the tenants and their queues
        self._dispatch_lock = threading.RLock()  # one dispatch at a time (the slab is reused)
        self._tenants: Dict[int, Tenant] = {}  # group -> Tenant
        self._by_name: Dict[str, Tenant] = {}
        self._next_request_id = 0
        self._dispatch_count = 0
        self._items_served = 0
        self.last_telemetry = None  # the last dispatch's whole wire, padding row 0 included

    # ------------------------------------------------------ tenant lifecycle
    def admit(self, name: Optional[str] = None, *, slo=None) -> Tenant:
        """Register a tenant on the lowest free group row; raises when all
        ``max_tenants`` rows are taken. ``slo`` gives this tenant its own
        rules in place of the server's."""
        with self._lock:
            free = [g for g in range(1, self.num_groups) if g not in self._tenants]
            if not free:
                raise RuntimeError(f"server is full: {self.max_tenants} tenants admitted")
            group = free[0]
            if name is None:
                name = f"tenant{group}"
            if name in self._by_name:
                raise ValueError(f"tenant name {name!r} already admitted")
            watchdog = None
            rules = self._slo_rules if slo is None else slo
            if rules is not None:
                from ..observability.slo import SLOWatchdog

                # a watchdog of its own, so that trend windows never mix tenants
                watchdog = SLOWatchdog(rules)
            tenant = Tenant(group, name, self._dispatch_count, watchdog)
            self._tenants[group] = tenant
            self._by_name[name] = tenant
            return tenant

    def depart(self, tenant: Tenant, *, cancel: bool = False) -> None:
        """Release a tenant's group row. Pending requests forbid the
        departure, or with ``cancel`` are cancelled (their futures raise).
        The tenant's normalization slot is zeroed for the next tenant."""
        with self._dispatch_lock, self._lock:
            if self._tenants.get(tenant.group) is not tenant:
                raise ValueError(f"{tenant!r} is not admitted on this server")
            if tenant.pending and not cancel:
                raise RuntimeError(f"{tenant!r} has pending work; drain it or depart(cancel=True)")
            for req in tenant.pending:
                req.future.set_error(RuntimeError(f"request {req.request_id} cancelled: tenant {tenant.name!r} departed"))
            tenant.pending.clear()
            if self._stats is not None:
                self._set_slot(tenant.group, 0.0, 0.0, 0.0)
            del self._tenants[tenant.group]
            del self._by_name[tenant.name]

    @property
    def tenants(self) -> Tuple[Tenant, ...]:
        with self._lock:
            return tuple(self._tenants[g] for g in sorted(self._tenants))

    # -------------------------------------------------------------- obs-norm
    def _set_slot(self, g: int, count, total, squares) -> None:
        from ..neuroevolution.net.runningnorm import CollectedStats

        count_, sum_, squares_ = (t.clone() for t in (self._stats.count, self._stats.sum, self._stats.sum_of_squares))
        count_[g] = count
        sum_[g] = total
        squares_[g] = squares
        self._stats = CollectedStats(count_, sum_, squares_)

    def tenant_stats(self, tenant: Tenant):
        """The tenant's normalization slot as plain statistics (None when
        the server runs without observation normalization)."""
        if self._stats is None:
            return None
        from ..neuroevolution.net.runningnorm import stats_slot

        return stats_slot(self._stats, tenant.group)

    # ------------------------------------------------------------- submission
    def submit(
        self, tenant: Tenant, values, generator: Optional[torch.Generator] = None, *, stats=None, tables=None
    ) -> EvalFuture:  # fmt: skip
        """Queue one evaluation of an ``(n, P)`` parameter matrix under the
        tenant's identity; returns the :class:`EvalFuture`.

        The request draws its random table rows now, from ``generator`` (a
        generator on the server's device) at its own size: item ``i`` then
        computes what a standalone ``episodes_refill`` run of the same
        matrix from that generator state computes, whatever the packing,
        and the generator is left as that run leaves it. The default is a
        generator seeded from the server's seed and the request id
        (reproducible, but no standalone run's). ``tables`` (a
        ``vecrl.SolutionTables`` of the request's ``n`` solutions) gives the
        rows instead, drawn elsewhere. ``stats`` re-seeds the tenant's
        normalization slot (a resuming search's history)."""
        from ..neuroevolution.net.vecrl import draw_solution_tables

        # re-seeding a slot waits for the dispatch in flight, which would
        # write the slots back over it
        reseed = self._dispatch_lock if stats is not None else contextlib.nullcontext()
        with reseed, self._lock:
            if self._tenants.get(tenant.group) is not tenant:
                raise ValueError(f"{tenant!r} is not admitted on this server")
            if tenant.suspended:
                summary = tenant.slo_report.summary() if tenant.slo_report else "no report"
                raise RuntimeError(f"tenant {tenant.name!r} is suspended by its SLO watchdog ({summary})")
            if isinstance(values, torch.Tensor):
                values = values.to(device=self.device, dtype=torch.float32)
            else:
                values = torch.as_tensor(np.asarray(values, dtype=np.float32)).to(self.device)
            if values.ndim != 2 or values.shape[1] != self.policy.parameter_count:
                raise ValueError(f"values must be (n, {self.policy.parameter_count}), got {tuple(values.shape)}")
            if tables is not None and generator is not None:
                raise ValueError("pass a generator to draw the request's rows, or its tables, not both")
            if generator is None and tables is None:
                generator = torch.Generator(device=self.device).manual_seed(_request_seed(self.seed, self._next_request_id))
            if stats is not None:
                if self._stats is None:
                    raise ValueError("stats submitted but the server runs without observation normalization")
                self._set_slot(tenant.group, stats.count, stats.sum, stats.sum_of_squares)
            if tables is None:
                tables = draw_solution_tables(
                    self.env, int(values.shape[0]), generator, num_episodes=self.num_episodes,
                    episode_length=self.episode_length, action_noise_stdev=self.action_noise_stdev,
                )  # fmt: skip
            else:
                tables = self._check_tables(tables, int(values.shape[0]))
            request = EvalRequest(self._next_request_id, tenant, values, tables, self)
            request.submit_dispatch = self._dispatch_count
            self._next_request_id += 1
            tenant.pending.append(request)
            return request.future

    def _check_tables(self, tables, n: int):
        from ..neuroevolution.net.vecrl import SolutionTables

        if not isinstance(tables, SolutionTables):
            raise TypeError(f"tables must be a SolutionTables, got {type(tables).__name__}")
        if tuple(tables.reset.shape) != (n, *self._reset_slab.shape[1:]):
            raise ValueError(f"tables.reset has shape {tuple(tables.reset.shape)}; {(n, *self._reset_slab.shape[1:])} is needed")
        if (tables.action_noise is None) != (self._noise_slab is None):
            raise ValueError("tables.action_noise must be given exactly when the server draws action noise")
        noise = None if tables.action_noise is None else tables.action_noise.to(self.device, torch.float32)
        return SolutionTables(tables.reset.to(self.device, self._reset_slab.dtype), noise)

    # --------------------------------------------------------------- serving
    def step(self) -> int:
        """Pack one slab from the pending queues and dispatch it; returns
        the number of real (non-padding) items served (0: nothing was
        pending, no dispatch)."""
        from ..neuroevolution.net.vecrl import SolutionTables

        with self._dispatch_lock:
            with self._lock:
                runs = self._pack()
                if not runs:
                    return 0
                n_packed = self._fill_slab(runs)
                stats = self._stats
            groups = self._groups_host.to(self.device, non_blocking=True)
            out = self.program(self._slab, self._generator, stats, None, groups, SolutionTables(self._reset_slab, self._noise_slab))
            with self._lock:
                self._dispatch_count += 1
                self._items_served += n_packed
                if self._stats is not None:
                    self._stats = out.stats
                self._credit(runs, out)
            return n_packed

    def drain(self) -> int:
        """Serve until every queue is empty; returns the dispatches run."""
        dispatches = 0
        while self.step():
            dispatches += 1
        return dispatches

    @contextlib.contextmanager
    def holding(self):
        """Hold dispatches for the block: a ``step`` (or a future's
        ``result``) on another thread waits until it ends, so the requests
        submitted meanwhile share the next dispatch. Only submits that pass
        statistics wait too."""
        with self._dispatch_lock:
            yield self

    def _pack(self) -> List[Tuple[EvalRequest, int, int]]:
        """One packing round: tenants in the admission policy's order, each
        one's queued items first in, first out, until the slab is full or
        nothing is pending. Suspended tenants still drain. Returns
        contiguous runs ``(request, first_item, count)``."""
        ready = [t for t in self._tenants.values() if t.pending]
        if not ready:
            return []
        runs: List[Tuple[EvalRequest, int, int]] = []
        n_packed = 0
        for tenant in self._admission.order(ready, self):
            for request in tenant.pending:
                room = self.slab_size - n_packed
                if room <= 0:
                    break
                taken = request.take_items(room)
                if len(taken):
                    runs.append((request, taken.start, len(taken)))
                    n_packed += len(taken)
            if n_packed >= self.slab_size:
                break
        return runs

    def _fill_slab(self, runs) -> int:
        """Copy the runs' parameter rows and table rows into the slab (slice
        copies on the device) and their groups into the pinned group row;
        idle rows repeat the first row, bound to group 0. Returns the rows
        packed."""
        row = 0
        for request, start, count in runs:
            stop = row + count
            self._slab[row:stop].copy_(request.values[start : start + count])
            self._reset_slab[row:stop].copy_(request.tables.reset[start : start + count])
            if self._noise_slab is not None:
                self._noise_slab[row:stop].copy_(request.tables.action_noise[start : start + count])
            self._groups_host[row:stop] = request.tenant.group
            row = stop
        if row < self.slab_size:
            self._slab[row:].copy_(self._slab[:1].expand(self.slab_size - row, -1))
            self._reset_slab[row:].copy_(self._reset_slab[:1].expand_as(self._reset_slab[row:]))
            if self._noise_slab is not None:
                self._noise_slab[row:].copy_(self._noise_slab[:1].expand_as(self._noise_slab[row:]))
            self._groups_host[row:] = 0
        return row

    def _credit(self, runs, out) -> None:
        """Distribute one dispatch's results: scores into their requests
        (slice copies on the device), the per-group telemetry rows into
        tenant and request accounting, SLO verdicts into admission state,
        completed requests into their futures, and a MetricsHub row. The
        wire's copy to the host is the dispatch's one host sync."""
        from ..observability.devicemetrics import GroupTelemetry

        gt = GroupTelemetry.from_array(out.telemetry.cpu())  # graftlint: allow(host-sync): the server's one host sync a dispatch (PERF.md §5)
        self.last_telemetry = gt
        touched_requests: List[EvalRequest] = []
        touched_tenants: List[Tenant] = []
        row0 = 0
        for request, start, count in runs:
            request.scores[start : start + count].copy_(out.scores[row0 : row0 + count])
            request.pending_items -= count
            row0 += count
            if not touched_requests or touched_requests[-1] is not request:
                touched_requests.append(request)
            tenant = request.tenant
            if not touched_tenants or touched_tenants[-1] is not tenant:
                touched_tenants.append(tenant)

        rows: Dict[int, GroupTelemetry] = {}

        def tenant_row(g: int) -> GroupTelemetry:
            if g not in rows:
                rows[g] = GroupTelemetry(data=gt.data[g : g + 1].copy(), health=None if gt.health is None else gt.health[g : g + 1].copy())
            return rows[g]

        for tenant in touched_tenants:
            row = tenant_row(tenant.group)
            tenant.telemetry = row if tenant.telemetry is None else tenant.telemetry + row
            if tenant.watchdog is not None:
                report = tenant.watchdog.check(tenant.telemetry)
                tenant.slo_report = report
                if not report.ok:
                    tenant.suspended = True
        for request in touched_requests:
            # a tenant's row covers all its lanes of the dispatch: with
            # requests of one tenant in flight together, each accrues the
            # shared row (per-tenant figures stay exact)
            row = tenant_row(request.tenant.group)
            request.telemetry = row if request.telemetry is None else request.telemetry + row
            if request.done:
                request.tenant.pending.remove(request)
                request.tenant.requests_served += 1
                self._finish(request)
        if self._metrics is not None:
            self._metrics.emit(
                {
                    "dispatch": self._dispatch_count - 1,
                    "served": row0,
                    "slab": self.slab_size,
                    "tenants": {t.name: t.group for t in self._tenants.values()},
                },
                telemetry=gt,
            )

    def _finish(self, request: EvalRequest) -> None:
        """A completed request's ``RolloutResult``: its scores on the
        device, the tenant's statistics, its counters, its wire (on the
        host, as ``GroupTelemetry.to_wire`` packs it)."""
        from ..neuroevolution.net.vecrl import RolloutResult

        total = request.telemetry.total()
        result = RolloutResult(
            scores=request.scores,
            stats=self.tenant_stats(request.tenant),
            total_steps=total.env_steps,
            total_episodes=total.episodes,
            telemetry=torch.from_numpy(request.telemetry.to_wire()),
        )
        request.future.set_result(result)

    # ------------------------------------------------------------- inspection
    @property
    def dispatches(self) -> int:
        return self._dispatch_count

    @property
    def items_served(self) -> int:
        return self._items_served

    def occupancy(self) -> float:
        """Share of the dispatched slab rows that carried tenant items (the
        rest were group-0 padding), over the server's life; 0.0 before the
        first dispatch."""
        total_rows = self._dispatch_count * self.slab_size
        return self._items_served / total_rows if total_rows else 0.0

    def status(self) -> dict:
        """A JSON-safe summary (the stdio front's ``status`` op)."""
        with self._lock:
            tenants = {}
            for t in self._tenants.values():
                entry = {"group": t.group, "suspended": bool(t.suspended), "pending_items": t.pending_items, "requests_served": t.requests_served}
                if t.telemetry is not None:
                    entry["queue_wait_p50"] = t.telemetry.queue_wait_quantile(0.5)
                    entry["queue_wait_p99"] = t.telemetry.queue_wait_quantile(0.99)
                    entry["starvation_share"] = round(t.telemetry.starvation_share(), 6)
                    entry["env_steps"] = t.telemetry.total().env_steps
                    entry["episodes"] = t.telemetry.total().episodes
                if t.slo_report is not None:
                    entry.update(t.slo_report.as_status())
                tenants[t.name] = entry
            return {
                "slab_size": self.slab_size,
                "max_tenants": self.max_tenants,
                "refill_width": self.refill_width,
                "dispatches": self._dispatch_count,
                "items_served": self._items_served,
                "occupancy": round(self.occupancy(), 6),
                "admission": repr(self._admission),
                "program_key": list(self.program.key),
                "tenants": tenants,
            }
