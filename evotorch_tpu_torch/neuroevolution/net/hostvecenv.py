"""Host-side vector envs and batched or pipelined rollouts for gym-API envs
(counterpart of ``evotorch_tpu/neuroevolution/net/hostvecenv.py``).

N gym(nasium) environments stepped in lockstep on the host, eager
auto-reset, per-env episode accounting with activity masking, and a
*batched* policy forward: one call of the port's ``FlatParamsPolicy`` on
the card per timestep for a whole lane block, the parameters of every lane
gathered by ``index_select`` from the population held on the card.

Two rollout engines share the vector-env contract:

- :func:`run_host_vectorized_rollout`: the synchronous loop; one lane
  block, device forward and host physics strictly alternating, each
  solution pinned to one lane for all its episodes
  (``GymNE(host_pipeline="chunked")``).
- :func:`run_host_pipelined_rollout`: the Sebulba-style scheduler
  (Podracer, arXiv:2104.06272). The lanes are split into blocks; while the
  card runs the batched policy forward for block A, a host worker thread
  runs the physics of block B. It is **work-conserving**: the whole batch's
  (solution, episode) items form one pending queue, and a lane whose
  episode finishes is re-seeded with the next pending item. Its
  ``mode="sync"`` twin executes the *identical* event order without the
  worker thread, so pipelined and sync are equal bit for bit.

Host and card meet at two points a block and a step. The block's
observations go to the card through pinned memory without a host sync,
and its actions come back in one device-to-host copy, the swap point: the
engines' only host sync, one per block per step. Only the main thread
touches CUDA; the worker thread only steps host physics, so the overlap
is real only where the physics releases the interpreter lock
(``mujoco.rollout`` does, a numpy env does not).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..._device import resolve_device
from ...observability import tracer
from ...observability.tracer import span
from .layers import map_state
from .rl import alive_bonus_for_step_host
from .vecrl import reset_tensors

__all__ = [
    "SyncVectorEnv",
    "run_host_vectorized_rollout",
    "run_host_pipelined_rollout",
    "HungPhysicsWorkerError",
]


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on the card through pinned memory and a
    non-blocking copy (no host sync; the caching host allocator keeps the
    pinned block until the copy has run), on the CPU as a view of it."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _initial_states(policy, width: int, device: torch.device):
    """The fresh recurrent states of ``width`` lanes on ``device`` (None for
    a stateless policy)."""
    return map_state(lambda leaf: leaf.to(device).expand(width, *leaf.shape), policy.initial_state())


def _actions_to_host(out: torch.Tensor) -> np.ndarray:
    """The swap point: the block's policy outputs copied to the host (the
    engines' one host sync)."""
    return out.detach().to("cpu", torch.float64).numpy()


class HungPhysicsWorkerError(RuntimeError):
    """The pipeline's physics worker thread would not exit (a hung native
    step). The vector env it was driving must be discarded, NOT closed or
    reused — its buffers may still be touched by the stuck thread."""


class SyncVectorEnv:
    """Steps ``num_envs`` gymnasium environments in lockstep.

    - ``reset()`` -> ``(num_envs, obs_dim)`` float32 observations.
    - ``step(actions, active=None)`` -> ``(obs, rewards, dones)``; an env
      whose episode ended is eagerly auto-reset (its returned observation is
      the fresh reset observation, matching the reference's eager-autoreset
      contract, ``vecrl.py:1541``); inactive lanes are skipped and yield NaN
      dummy observations (the reference's exhausted-lane marker).
    """

    def __init__(
        self,
        env_fn: Union[Callable, Sequence[Callable]],
        num_envs: Optional[int] = None,
    ):
        if callable(env_fn):
            if num_envs is None:
                raise ValueError("Give num_envs when env_fn is a single factory")
            fns: List[Callable] = [env_fn] * int(num_envs)
        else:
            fns = list(env_fn)
        self.envs = [fn() for fn in fns]
        first = self.envs[0]
        self.observation_space = first.observation_space
        self.action_space = first.action_space
        self._obs_dim = int(np.prod(first.observation_space.shape))

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    @property
    def is_discrete(self) -> bool:
        return hasattr(self.action_space, "n")

    def _flat_obs(self, obs) -> np.ndarray:
        return np.asarray(obs, dtype=np.float32).reshape(-1)

    def _reset_one(self, i: int) -> np.ndarray:
        out = self.envs[i].reset()
        if isinstance(out, tuple):  # modern gym API: (obs, info)
            out = out[0]
        return self._flat_obs(out)

    def reset(self) -> np.ndarray:
        return np.stack([self._reset_one(i) for i in range(self.num_envs)])

    def step(self, actions, active: Optional[np.ndarray] = None):
        n = self.num_envs
        obs = np.full((n, self._obs_dim), np.nan, dtype=np.float32)
        rewards = np.zeros(n, dtype=np.float32)
        dones = np.zeros(n, dtype=bool)
        for i in range(n):
            if active is not None and not active[i]:
                continue
            result = self.envs[i].step(actions[i])
            if len(result) == 5:  # modern API: obs, r, terminated, truncated, info
                o, r, terminated, truncated, _ = result
                done = bool(terminated) or bool(truncated)
            else:  # classic API: obs, r, done, info
                o, r, done, _ = result
                done = bool(done)
            rewards[i] = float(r)
            dones[i] = done
            obs[i] = self._reset_one(i) if done else self._flat_obs(o)
        return obs, rewards, dones

    def seed(self, seeds: Sequence[int]):
        for env, s in zip(self.envs, seeds):
            if hasattr(env, "reset"):
                try:
                    env.reset(seed=int(s))
                except TypeError:
                    pass  # classic API without seed kwarg

    def close(self):
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()


def run_host_vectorized_rollout(
    vec_env: SyncVectorEnv,
    policy,
    params_batch,
    *,
    num_episodes: int = 1,
    episode_length: Optional[int] = None,
    obs_stats=None,
    update_stats: bool = True,
    decrease_rewards_by: float = 0.0,
    alive_bonus_schedule: Optional[tuple] = None,
    action_noise_stdev: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> dict:
    """Evaluate ``n <= num_envs`` policies, one per env lane, with a single
    batched policy forward on ``device`` (the card unless given) per
    timestep.

    ``policy`` is a :class:`FlatParamsPolicy`; ``params_batch`` is ``(n, L)``.
    ``obs_stats`` is an optional ``RunningStat`` updated in place with every
    observation the policies consume (when ``update_stats``) and used for
    normalization. Returns ``{"scores", "interactions", "episodes",
    "control_steps"}``, the last the lockstep iterations run (one batched
    forward and one device-to-host copy of its actions each).
    """
    device = resolve_device(device)
    params_batch = torch.as_tensor(params_batch, device=device)
    n = params_batch.shape[0]
    if n > vec_env.num_envs:
        raise ValueError(f"{n} solutions > {vec_env.num_envs} env lanes")
    rng = np.random.default_rng() if rng is None else rng

    lanes = np.arange(n)
    obs = vec_env.reset()[:n]
    if obs_stats is not None and update_stats:
        obs_stats.update(obs)

    states = _initial_states(policy, n, device)

    scores = np.zeros(n, dtype=np.float64)
    episodes_done = np.zeros(n, dtype=np.int64)
    steps_in_episode = np.zeros(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    interactions = 0
    act_space = vec_env.action_space
    discrete = vec_env.is_discrete

    # hard iteration cap: with episode_length=None and an env
    # lacking its own TimeLimit the loop would otherwise never terminate;
    # 100k steps/episode is far beyond any gym episode horizon
    per_episode_cap = int(episode_length) if episode_length is not None else 100_000
    step_cap = per_episode_cap * int(num_episodes)
    total_loop_steps = 0

    while active.any():
        if total_loop_steps >= step_cap:
            raise RuntimeError(
                f"run_host_vectorized_rollout exceeded {step_cap} lockstep"
                " iterations without every lane finishing its episodes; the"
                " env likely never terminates — pass episode_length= or wrap"
                " it in a TimeLimit"
            )
        total_loop_steps += 1
        norm_obs = obs
        if obs_stats is not None and obs_stats.count >= 2:
            norm_obs = obs_stats.normalize(obs).astype(np.float32)
        norm_obs = np.nan_to_num(np.asarray(norm_obs, dtype=np.float32))  # NaN dummy rows of inactive lanes
        out, new_states = policy(params_batch, _to_device(norm_obs, device), states)
        out = _actions_to_host(out)  # graftlint: allow(host-sync): the host engines' one host sync a control step (PERF.md §5)

        if discrete:
            actions = np.argmax(out, axis=-1)
        else:
            actions = out.reshape((n,) + act_space.shape)
            if action_noise_stdev is not None:
                actions = actions + rng.normal(size=actions.shape) * float(
                    action_noise_stdev
                )
            actions = np.clip(actions, act_space.low, act_space.high)

        # lanes beyond n (shorter final chunk) stay permanently inactive
        pad = vec_env.num_envs - n
        if pad:
            actions = np.concatenate(
                [actions, np.zeros((pad,) + actions.shape[1:], actions.dtype)]
            )
            full_active = np.concatenate([active, np.zeros(pad, dtype=bool)])
        else:
            full_active = active
        new_obs, rewards, env_dones = vec_env.step(actions, active=full_active)
        new_obs, rewards, env_dones = new_obs[:n], rewards[:n], env_dones[:n]
        steps_in_episode[active] += 1
        interactions += int(active.sum())
        dones = env_dones.copy()
        if episode_length is not None:
            dones = dones | (active & (steps_in_episode >= int(episode_length)))

        rewards = rewards - decrease_rewards_by
        if alive_bonus_schedule is not None:
            # host step counters: float math (a tensor per lane per step
            # would be a launch and a sync each)
            for i in lanes[active & ~dones]:
                rewards[i] += alive_bonus_for_step_host(
                    int(steps_in_episode[i]), alive_bonus_schedule
                )
        scores[active] += rewards[active]

        finished = dones & active
        episodes_done[finished] += 1
        steps_in_episode[finished] = 0
        if new_states is not None:
            new_states = reset_tensors(new_states, _to_device(finished, device))
        states = new_states
        active = episodes_done < int(num_episodes)

        # lanes truncated by episode_length need a manual reset — the env
        # auto-resets only on its own terminal signal (env_dones)
        for i in lanes[finished & active & ~env_dones]:
            new_obs[i] = vec_env._reset_one(i)
        obs = new_obs

        if obs_stats is not None and update_stats and active.any():
            obs_stats.update(obs[active])

    return {
        "scores": scores / np.maximum(episodes_done, 1),
        "interactions": interactions,
        "episodes": int(episodes_done.sum()),
        "control_steps": total_loop_steps,
    }


# ---------------------------------------------------------------------------
# the Sebulba-style pipelined scheduler (host refill + host/device overlap)
# ---------------------------------------------------------------------------

class _PhysicsWorker:
    """One host thread draining a FIFO of ``vec_env.step`` calls.

    The double buffer of the pipeline: the main thread submits block A's
    actions and immediately goes on to materialize block B's forward (the
    only host sync) while the physics for
    A runs here. ``mujoco.rollout`` releases the GIL, so on a multi-core
    host the physics genuinely overlaps the device forward *and* the main
    thread's numpy bookkeeping. Results come back in submission order —
    exactly the order the scheduler retires blocks — so a single result
    queue is the whole synchronization story.
    """

    def __init__(self, vec_env):
        self._vec_env = vec_env
        self._tasks: "queue.Queue" = queue.Queue()
        self._results: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="hostvecenv-physics", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            task = self._tasks.get()
            if task is None:
                return
            actions, active, label = task
            try:
                # the physics track: this span lives on the WORKER thread's
                # tid, so in a Perfetto view it overlaps the main thread's
                # device-forward spans — the pipeline's whole point, visible
                with span("physics", "pipeline", block=label):
                    result = self._vec_env.step(actions, active=active)
                self._results.put(("ok", result))
            except BaseException as exc:  # graftlint: allow(swallow): shipped to the main thread and re-raised there
                self._results.put(("error", exc))

    def submit(self, actions, active, label=None):
        self._tasks.put((actions, active, label))

    def result(self):
        status, payload = self._results.get()
        if status == "error":
            raise payload
        return payload

    def close(self):
        """Stop the thread; raises if it will not die (a hung native physics
        call) — the caller must then discard the vec_env rather than hand it
        to a fresh worker, or two threads would race on the same MjData
        buffers."""
        self._tasks.put(None)
        # generous: at most ONE physics step is in flight ahead of the
        # sentinel, and a block step is milliseconds — only a hung native
        # call exceeds this
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise HungPhysicsWorkerError(
                "hostvecenv physics worker did not exit (native step hung);"
                " discard this vector env — it is not safe to reuse"
            )


class _LaneBlock:
    """One lane block of the pipeline: a contiguous slice of env lanes, the
    (solution, episode) item each lane is currently serving, and the block's
    in-flight forward."""

    __slots__ = (
        "lanes", "sl", "item", "active", "obs", "states", "fwd", "pending_states",
        "iters", "sol_idx_dev", "full_actions", "full_active", "index", "fwd_t0",
    )

    def __init__(self, lanes: np.ndarray, items: np.ndarray, obs: np.ndarray, states, num_envs: int, act_shape, act_dtype, index: int = 0):
        self.index = index  # block number (trace-span labeling only)
        self.fwd_t0 = None  # trace clock at forward dispatch (tracing only)
        self.lanes = lanes  # global lane indices, (w,) — contiguous
        self.sl = slice(int(lanes[0]), int(lanes[-1]) + 1)  # view, not copy
        self.item = items  # global item id per lane, -1 = exhausted, (w,)
        self.active = items >= 0
        self.obs = obs  # (w, obs_dim) float32
        self.states = states  # per-lane policy state pytree or None
        self.fwd = None  # dispatched forward (out, new_states) or None
        self.pending_states = None
        self.iters = 0  # lockstep iterations this block executed
        self.sol_idx_dev = None  # cached lane->solution index vector
        # reusable full-width submission buffers (refreshed in place)
        self.full_actions = np.zeros((num_envs,) + act_shape, dtype=act_dtype)
        self.full_active = np.zeros(num_envs, dtype=bool)
        self.full_active[lanes] = self.active


def run_host_pipelined_rollout(
    vec_env,
    policy,
    params_batch,
    *,
    num_episodes: int = 1,
    episode_length: Optional[int] = None,
    obs_stats=None,
    update_stats: bool = True,
    decrease_rewards_by: float = 0.0,
    alive_bonus_schedule: Optional[tuple] = None,
    action_noise_stdev: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    mode: str = "pipelined",
    num_blocks: Optional[int] = None,
    use_tuned_cache: bool = True,
    tuned_config_source: Optional[str] = None,
    device=None,
) -> dict:
    """Evaluate a whole batch of ``P`` policies over ``vec_env``'s lanes with
    the pipelined two-lane-block scheduler.

    The work list is every (solution, episode) pair — ``P * num_episodes``
    items, solution-major. ``W = min(items, num_envs)`` lanes are split into
    ``num_blocks`` contiguous blocks; each scheduler round runs, per block:

    - **S1** normalize the block's observations and *dispatch* the batched
      device forward (async);
    - **S2** materialize the actions (``np.asarray`` — the swap point, the
      only device sync) and submit the block's physics;
    - **S3** collect the physics results, do all bookkeeping (reward credit,
      episode accounting, obs-stat updates) and **refill** each finished lane
      with the next pending item, so lanes never idle while work remains.

    ``mode="pipelined"`` runs the physics on a worker thread with a
    one-submission pipeline depth: block A's physics overlaps block B's
    device forward (the Sebulba split). ``mode="sync"`` executes the physics
    inline at the submit point — the **same S1/S2/S3 event order**, so
    scores, per-episode step counts, RNG draws and obs-normalization
    statistics are bit-identical between the two modes; the thread is the
    only difference. All bookkeeping lives on the main thread, which is what
    makes that determinism structural rather than lucky.

    Returns ``{"scores" (P,), "interactions", "episodes",
    "episode_steps" (P, num_episodes), "lane_episodes" (num_envs,),
    "block_iters" [per-block lockstep iteration counts],
    "occupancy" [counted interactions / executed lane-step slots]}``.

    With tracing on (``EVOTORCH_TRACE`` / ``observability.tracer``), each
    scheduler stage emits a span — ``s1.forward_dispatch``,
    ``s2.actions_sync`` (the device sync), ``s3.bookkeep_refill``,
    ``physics_wait`` — plus a ``device_forward`` span covering each block's
    dispatch->materialize window; the worker thread's ``physics`` spans land
    on their own track, so S1/S2/S3 overlap is directly visible in Perfetto.
    """
    if mode not in ("pipelined", "sync"):
        raise ValueError(f"mode must be 'pipelined' or 'sync', got {mode!r}")
    device = resolve_device(device)
    params_batch = torch.as_tensor(params_batch, device=device)
    num_solutions = int(params_batch.shape[0])
    episodes_per_solution = int(num_episodes)
    total_items = num_solutions * episodes_per_solution
    if total_items == 0:
        return {
            "scores": np.zeros(num_solutions, dtype=np.float64),
            "interactions": 0,
            "episodes": 0,
            "episode_steps": np.zeros((num_solutions, episodes_per_solution), dtype=np.int64),
            "lane_episodes": np.zeros(vec_env.num_envs, dtype=np.int64),
            "block_iters": [],
            "tuned_config_source": (
                tuned_config_source
                if tuned_config_source is not None
                else ("override" if num_blocks is not None else "fallback")
            ),
        }
    rng = np.random.default_rng() if rng is None else rng

    width = min(total_items, vec_env.num_envs)
    caller_source = tuned_config_source
    if num_blocks is None:
        # no explicit block count: consult the machine-scoped
        # "host_pipeline" entry of the tuned-config cache (the autotuner's
        # measured split for THIS box — observability/timings.py) before
        # the heuristic. Callers that already resolved the group at their
        # own altitude (GymNE) — or that must NOT see tuned configs (the
        # autotuner's own baseline) — pass
        # use_tuned_cache=False so the group is resolved exactly once.
        # auto-heuristic: the two-block split only pays when the host
        # physics can genuinely overlap the device forward — on a
        # single-core box the split just doubles the per-round dispatch
        # cost, so run one block and keep the refill win.
        from ...observability.timings import SOURCE_CACHE, SOURCE_FALLBACK, lookup_tuned, machine_fingerprint

        entry = lookup_tuned("host_pipeline", {}, machine=machine_fingerprint(device)) if use_tuned_cache else None
        if entry is not None and set(entry.config) - {"num_blocks"}:
            # the entry was measured as a JOINT config (e.g. blocks +
            # mj_nthread together), but nthread is baked into the already-
            # built vec_env at this altitude — applying only part of it
            # would run an unmeasured combination labeled "cache". GymNE,
            # which builds the vec env, applies the full group; direct
            # callers fall back to the heuristic.
            entry = None
        if entry is not None and entry.config.get("num_blocks") is not None:
            num_blocks = int(entry.config["num_blocks"])
            tuned_config_source = SOURCE_CACHE
        else:
            num_blocks = 2 if (os.cpu_count() or 1) > 1 else 1
            tuned_config_source = SOURCE_FALLBACK
    else:
        from ...observability.timings import SOURCE_OVERRIDE

        tuned_config_source = SOURCE_OVERRIDE
    if caller_source is not None:
        # a caller that resolved the group at its own altitude (GymNE:
        # explicit > cache > fallback across blocks AND nthread together)
        # passes the TRUE provenance — its concrete num_blocks must not be
        # mislabeled "override" when it actually came from the cache
        tuned_config_source = caller_source
    num_blocks = max(1, min(int(num_blocks), width))
    act_space = vec_env.action_space
    discrete = vec_env.is_discrete
    act_shape = () if discrete else tuple(act_space.shape)

    # hard cap (the same contract as the synchronous loop): an env
    # with neither its own TimeLimit nor episode_length= must fail loudly
    per_episode_cap = int(episode_length) if episode_length is not None else 100_000

    # ---- global accounting --------------------------------------------------
    item_return = np.zeros(total_items, dtype=np.float64)
    item_steps = np.zeros(total_items, dtype=np.int64)
    lane_episodes = np.zeros(vec_env.num_envs, dtype=np.int64)
    steps_in_episode = np.zeros(vec_env.num_envs, dtype=np.int64)
    interactions = 0
    episodes_finished = 0
    next_item = width  # items 0..width-1 seed the lanes below

    # ---- lanes + blocks -----------------------------------------------------
    all_obs = vec_env.reset()[:width]
    blocks: List[_LaneBlock] = []
    for bi, lanes in enumerate(np.array_split(np.arange(width), num_blocks)):
        lanes = lanes.astype(np.int64)
        states = _initial_states(policy, len(lanes), device)
        blocks.append(
            _LaneBlock(
                lanes, lanes.copy(), all_obs[lanes], states, vec_env.num_envs,
                act_shape, np.int64 if discrete else np.float64, index=bi,
            )
        )
        lane_episodes[lanes] += 1
    if obs_stats is not None and update_stats:
        for blk in blocks:  # block order: the canonical accumulation order
            obs_stats.update(blk.obs[blk.active])

    # ---- stages -------------------------------------------------------------
    def s1_dispatch_forward(blk: _LaneBlock):
        with span("s1.forward_dispatch", "pipeline", block=blk.index):
            norm_obs = blk.obs
            if obs_stats is not None and obs_stats.count >= 2:
                norm_obs = np.asarray(obs_stats.normalize(norm_obs), dtype=np.float32)
            # unconditional, matching the reference loop: scrubs both the NaN
            # dummy rows of exhausted lanes AND non-finite observations from
            # diverged physics on live lanes (no-termination families)
            norm_obs = np.nan_to_num(np.asarray(norm_obs, dtype=np.float32))
            if blk.sol_idx_dev is None:  # refreshed only after a refill/exhaustion
                blk.sol_idx_dev = _to_device(np.where(blk.item >= 0, blk.item // episodes_per_solution, 0), device)
            # the lanes' current solutions gathered from the population on
            # the card, so a refill changes one index and copies no row
            params = params_batch.index_select(0, blk.sol_idx_dev)
            blk.fwd = policy(params, _to_device(norm_obs, device), blk.states)
        trace = tracer.get_tracer()
        if trace is not None:
            blk.fwd_t0 = trace.now_us()

    def s2_submit_physics(blk: _LaneBlock, worker: Optional[_PhysicsWorker]):
        with span("s2.actions_sync", "pipeline", block=blk.index):
            out, new_states = blk.fwd
            blk.fwd = None
            blk.pending_states = new_states
            out = _actions_to_host(out)  # the swap point: the pipeline's only host sync
            trace = tracer.get_tracer()
            if trace is not None and blk.fwd_t0 is not None:
                # the dispatched forward's lifetime, dispatch -> materialize:
                # the host-visible "device forward" span the physics track
                # overlaps with
                trace.complete(
                    "device_forward",
                    blk.fwd_t0,
                    trace.now_us() - blk.fwd_t0,
                    "pipeline",
                    block=blk.index,
                )
                blk.fwd_t0 = None
            if discrete:
                actions = np.argmax(out, axis=-1)
            else:
                actions = out.reshape((len(blk.lanes),) + act_shape)
                if action_noise_stdev is not None:
                    actions = actions + rng.normal(size=actions.shape) * float(action_noise_stdev)
                actions = np.clip(actions, act_space.low, act_space.high)
            blk.full_actions[blk.sl] = actions
        if worker is not None:
            worker.submit(blk.full_actions, blk.full_active, blk.index)
            return None
        with span("physics", "pipeline", block=blk.index):  # sync mode: inline
            return vec_env.step(blk.full_actions, active=blk.full_active)

    def s3_bookkeep_and_refill(blk: _LaneBlock, step_result):
        with span("s3.bookkeep_refill", "pipeline", block=blk.index):
            _s3_inner(blk, step_result)

    def _s3_inner(blk: _LaneBlock, step_result):
        nonlocal interactions, episodes_finished, next_item
        obs_full, rewards_full, dones_full = step_result
        obs = obs_full[blk.sl]
        rewards = rewards_full[blk.sl].astype(np.float64)
        env_dones = dones_full[blk.sl]
        active = blk.active
        blk.iters += 1

        block_steps = steps_in_episode[blk.sl]  # view: writes land globally
        block_steps[active] += 1
        if np.any(block_steps[active] > 100_000):
            raise RuntimeError(
                "run_host_pipelined_rollout exceeded 100000 steps in one"
                " episode; the env likely never terminates — pass"
                " episode_length= or wrap it in a TimeLimit"
            )
        interactions += int(active.sum())
        dones = env_dones.copy()
        if episode_length is not None:
            dones |= active & (block_steps >= per_episode_cap)

        if decrease_rewards_by != 0.0:
            rewards = rewards - decrease_rewards_by
        if alive_bonus_schedule is not None:
            # host step counters: float math (a tensor per lane per step
            # would be a launch and a sync each)
            for j in np.flatnonzero(active & ~dones):
                rewards[j] += alive_bonus_for_step_host(
                    int(steps_in_episode[blk.lanes[j]]), alive_bonus_schedule
                )
        # lane items are distinct, so a fancy-indexed add is exact
        item_return[blk.item[active]] += rewards[active]

        finished = dones & active
        if finished.any():
            for j in np.flatnonzero(finished):
                lane = int(blk.lanes[j])
                item_steps[blk.item[j]] = steps_in_episode[lane]
                steps_in_episode[lane] = 0
                episodes_finished += 1
                if next_item < total_items:  # work-conserving refill
                    blk.item[j] = next_item
                    next_item += 1
                    lane_episodes[lane] += 1
                    if not env_dones[j]:
                        # truncated by episode_length: the env auto-resets
                        # only on its own terminal signal, so reseed manually
                        obs[j] = vec_env._reset_one(lane)
                    # (on env_dones the eager auto-reset obs in `obs[j]` IS
                    # the refilled item's fresh initial observation)
                else:
                    blk.item[j] = -1
                    blk.active[j] = False
            blk.sol_idx_dev = None  # lane->solution mapping changed
            blk.full_active[blk.lanes] = blk.active
            if blk.pending_states is not None:
                blk.states = reset_tensors(blk.pending_states, _to_device(finished, device))
                blk.pending_states = None
        if blk.pending_states is not None:
            blk.states = blk.pending_states
            blk.pending_states = None
        blk.obs = obs
        if obs_stats is not None and update_stats and blk.active.any():
            obs_stats.update(obs[blk.active])

    # ---- the scheduler loop -------------------------------------------------
    # Round-robin over blocks in a FIXED order; `inflight` is the FIFO of
    # blocks whose physics is submitted but not yet retired. In pipelined
    # mode one submission stays in flight across the S2 of the next block, so
    # its physics (worker thread) overlaps that block's device forward; in
    # sync mode the depth is 0 and every submission retires immediately. The
    # S1/S2/S3 event sequence is identical in both modes — only the waiting
    # pattern differs — which is the determinism guarantee.
    worker = _PhysicsWorker(vec_env) if mode == "pipelined" else None
    depth = 1 if worker is not None else 0
    live = [blk for blk in blocks if blk.active.any()]
    inflight: deque = deque()
    try:
        for blk in live:
            s1_dispatch_forward(blk)
        while live:
            for blk in blocks:
                if blk in live and blk.fwd is not None:
                    result = s2_submit_physics(blk, worker)
                    inflight.append((blk, result))
            while inflight and (
                len(inflight) > depth
                or not any(b.fwd is not None for b in live)
            ):
                prev, result = inflight.popleft()
                if result is None:
                    # main-thread stall waiting on the worker: visible in a
                    # trace as the gap the pipeline exists to shrink
                    with span("physics_wait", "pipeline", block=prev.index):
                        result = worker.result()
                s3_bookkeep_and_refill(prev, result)
                if prev.active.any():
                    s1_dispatch_forward(prev)
                else:
                    live.remove(prev)
    finally:
        if worker is not None:
            worker.close()

    # lane-step slots executed = per-block width x lockstep iterations; the
    # fraction that were counted interactions is the host-path occupancy
    # (the same figure the on-device engines report)
    capacity = sum(len(blk.lanes) * blk.iters for blk in blocks)
    return {
        "scores": item_return.reshape(num_solutions, episodes_per_solution).mean(axis=1),
        "interactions": interactions,
        "episodes": episodes_finished,
        "episode_steps": item_steps.reshape(num_solutions, episodes_per_solution),
        "lane_episodes": lane_episodes,
        "block_iters": [blk.iters for blk in blocks],
        "occupancy": interactions / capacity if capacity else 0.0,
        # where the block split came from: "override" (explicit
        # num_blocks), "cache" (tuned_configs.json machine entry) or
        # "fallback" (the core-count heuristic)
        "tuned_config_source": tuned_config_source,
    }
