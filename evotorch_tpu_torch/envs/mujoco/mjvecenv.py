"""Batched host rollout engine over real MuJoCo models (counterpart of
``evotorch_tpu/envs/mujoco/mjvecenv.py``, the same host numpy).

``MjVecEnv`` steps N gymnasium ``-v5`` MuJoCo environments in lockstep by
driving their raw ``MjModel``s through ``mujoco.rollout`` — MuJoCo's native
threaded batched stepper — instead of N sequential ``env.step`` calls. One
``rollout`` call per control timestep advances every active lane by
``frame_skip`` physics substeps; observation, reward terms and termination
are then recomputed *from the physics state* by a per-family table
(:class:`_V5Family`), which is what makes the per-term reward decomposition
(forward velocity / control cost / healthy bonus) available on every step —
the fidelity harness (``fidelity.py``) consumes it.

Faithfulness: ``FULLPHYSICS``-state round-tripping through ``rollout`` with
``nstep = frame_skip`` reproduces gymnasium's own ``do_simulation`` stepping
to ~1e-15 (measured on Hopper-v5 over a full episode — the integrator path is
identical, only the Python loop around it differs); resets go through each lane's own
``env.reset()`` so reset-noise distributions and seeding are exactly
gymnasium's. The v5 reward/termination math below is transcribed from
``gymnasium/envs/mujoco/*_v5.py`` and asserted equivalent (rewards AND
observations) against real ``env.step`` lanes in the JAX package's tests,
and the port's engine is held to the JAX package's bit for bit.

The class is API-compatible with ``net.hostvecenv.SyncVectorEnv`` (``reset``
/ ``step(actions, active)`` / ``_reset_one`` / ``seed`` / ``close``), so both
host rollout engines run unchanged on real physics: the synchronous
``run_host_vectorized_rollout`` loop and the Sebulba-style
``run_host_pipelined_rollout`` scheduler (Podracer, arXiv:2104.06272 —
batched host physics overlapping the device policy forward). Under the
pipelined scheduler, ``step`` is called **block-sliced** (the ``active`` mask
covers one lane block) from a single worker thread while the main thread may
``_reset_one`` lanes of a *different* block; that is safe because every
per-lane buffer (``_state`` rows, ``_steps``, the lane's own env) is touched
by exactly one block at a time, and ``_pool.rollout`` copies its
``_state[idx]`` slice per call. ``last_terms`` consequently reflects the most
recent *block's* step, not the whole width, when pipelined.

Envs outside the supported family table (or with non-default observation
flags) fall back to the generic ``SyncVectorEnv`` via
:func:`make_host_vector_env`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Type, Union

import numpy as np

import mujoco
from mujoco import rollout as mj_rollout

__all__ = ["MjVecEnv", "make_host_vector_env"]

_FULLPHYSICS = mujoco.mjtState.mjSTATE_FULLPHYSICS


# --------------------------------------------------------------------------
# -v5 family table: observation / reward terms / termination from raw state
# --------------------------------------------------------------------------
class _V5Family:
    """Vectorized re-implementation of one gymnasium ``-v5`` family's
    observation, reward decomposition and termination as pure functions of
    ``(qpos, qvel, action)`` batches (lane-leading shapes ``(B, ...)``).

    Weights/ranges are read from the live env instance at construction, so
    ``env_config`` overrides (e.g. a custom ``ctrl_cost_weight``) are
    honored; *structural* overrides (e.g. including the root x in the
    observation) make :meth:`supports` return False and route the env to the
    generic fallback instead.
    """

    #: value of ``_exclude_current_positions_from_observation`` this family's
    #: ``obs()`` assumes; None = the env has no such flag
    expects_exclude_x: Optional[bool] = True

    def __init__(self, env):
        u = env.unwrapped
        self.dt = float(u.dt)
        self.forward_reward_weight = float(getattr(u, "_forward_reward_weight", 0.0))
        self.ctrl_cost_weight = float(getattr(u, "_ctrl_cost_weight", 0.0))
        self.healthy_reward = float(getattr(u, "_healthy_reward", 0.0))
        self.terminate_when_unhealthy = bool(getattr(u, "_terminate_when_unhealthy", False))
        zr = getattr(u, "_healthy_z_range", (-np.inf, np.inf))
        ar = getattr(u, "_healthy_angle_range", (-np.inf, np.inf))
        sr = getattr(u, "_healthy_state_range", (-np.inf, np.inf))
        self.healthy_z_range = (float(zr[0]), float(zr[1]))
        self.healthy_angle_range = (float(ar[0]), float(ar[1]))
        self.healthy_state_range = (float(sr[0]), float(sr[1]))

    @classmethod
    def supports(cls, env) -> bool:
        if cls.expects_exclude_x is None:
            return True
        flag = getattr(env.unwrapped, "_exclude_current_positions_from_observation", None)
        return bool(flag) == cls.expects_exclude_x

    # -- the three per-family functions (B-leading batches) -----------------
    def obs(self, qpos: np.ndarray, qvel: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def is_healthy(self, qpos: np.ndarray, qvel: np.ndarray) -> np.ndarray:
        return np.ones(qpos.shape[0], dtype=bool)

    def reward_terms(self, x_vel, action, qpos, qvel):
        """-> ``(reward (B,), terminated (B,), terms: dict[str, (B,)])``."""
        raise NotImplementedError

    # shared pieces
    def _ctrl_cost(self, action: np.ndarray) -> np.ndarray:
        return self.ctrl_cost_weight * np.sum(np.square(action), axis=-1)


class _RunnerFamily(_V5Family):
    """forward - ctrl_cost, no termination (HalfCheetah-v5 / Swimmer-v5)."""

    qpos_skip = 1
    clip_qvel: Optional[float] = None

    def obs(self, qpos, qvel):
        v = qvel if self.clip_qvel is None else np.clip(qvel, -self.clip_qvel, self.clip_qvel)
        return np.concatenate([qpos[:, self.qpos_skip :], v], axis=1)

    def reward_terms(self, x_vel, action, qpos, qvel):
        forward = self.forward_reward_weight * x_vel
        ctrl = self._ctrl_cost(action)
        terms = {"x_velocity": x_vel, "reward_forward": forward, "reward_ctrl": -ctrl}
        return forward - ctrl, np.zeros(qpos.shape[0], dtype=bool), terms


class _HalfCheetahFamily(_RunnerFamily):
    qpos_skip = 1


class _SwimmerFamily(_RunnerFamily):
    qpos_skip = 2


class _WalkerFamily(_V5Family):
    """forward + healthy*bonus - ctrl_cost, unhealthy terminates
    (Walker2d-v5; Hopper-v5 adds the state-range check)."""

    check_state_range = False

    def obs(self, qpos, qvel):
        return np.concatenate([qpos[:, 1:], np.clip(qvel, -10.0, 10.0)], axis=1)

    def is_healthy(self, qpos, qvel):
        z, angle = qpos[:, 1], qpos[:, 2]
        lo_z, hi_z = self.healthy_z_range
        lo_a, hi_a = self.healthy_angle_range
        healthy = (z > lo_z) & (z < hi_z) & (angle > lo_a) & (angle < hi_a)
        if self.check_state_range:
            lo_s, hi_s = self.healthy_state_range
            state = np.concatenate([qpos[:, 2:], qvel], axis=1)
            healthy &= np.all((state > lo_s) & (state < hi_s), axis=1)
        return healthy

    def reward_terms(self, x_vel, action, qpos, qvel):
        healthy = self.is_healthy(qpos, qvel)
        forward = self.forward_reward_weight * x_vel
        survive = self.healthy_reward * healthy
        ctrl = self._ctrl_cost(action)
        terminated = (
            ~healthy if self.terminate_when_unhealthy else np.zeros_like(healthy)
        )
        terms = {
            "x_velocity": x_vel,
            "reward_forward": forward,
            "reward_ctrl": -ctrl,
            "reward_survive": survive,
        }
        return forward + survive - ctrl, terminated, terms


class _HopperFamily(_WalkerFamily):
    check_state_range = True


class _InvertedPendulumFamily(_V5Family):
    """reward 1 while upright; |pole angle| > 0.2 (or non-finite obs)
    terminates (InvertedPendulum-v5)."""

    expects_exclude_x = None

    def obs(self, qpos, qvel):
        return np.concatenate([qpos, qvel], axis=1)

    def reward_terms(self, x_vel, action, qpos, qvel):
        obs = self.obs(qpos, qvel)
        terminated = ~np.isfinite(obs).all(axis=1) | (np.abs(qpos[:, 1]) > 0.2)
        reward = (~terminated).astype(np.float64)
        return reward, terminated, {"reward_survive": reward}


_FAMILIES: Dict[str, Type[_V5Family]] = {
    "HalfCheetah-v5": _HalfCheetahFamily,
    "Swimmer-v5": _SwimmerFamily,
    "Walker2d-v5": _WalkerFamily,
    "Hopper-v5": _HopperFamily,
    "InvertedPendulum-v5": _InvertedPendulumFamily,
}


def _family_for(env) -> Optional[Type[_V5Family]]:
    spec = getattr(env, "spec", None)
    cls = _FAMILIES.get(getattr(spec, "id", ""))
    if cls is not None and cls.supports(env):
        return cls
    return None


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
class MjVecEnv:
    """Steps ``num_envs`` real MuJoCo envs in lockstep via ``mujoco.rollout``.

    Same contract as ``SyncVectorEnv``: ``reset() -> (N, obs_dim)`` float32;
    ``step(actions, active) -> (obs, rewards, dones)`` with eager auto-reset
    on done lanes and NaN dummy observations on inactive ones. Additionally
    exposes ``last_terms`` — the per-lane reward decomposition of the most
    recent step (``x_velocity`` / ``reward_forward`` / ``reward_ctrl`` /
    ``reward_survive``, NaN on inactive lanes) — and honors each env's own
    gymnasium TimeLimit.
    """

    def __init__(
        self,
        env_fn: Union[Callable, Sequence[Callable], Sequence],
        num_envs: Optional[int] = None,
        *,
        nthread: Optional[int] = None,
    ):
        self.envs = _instantiate(env_fn, num_envs)
        env0 = self.envs[0]
        fam_cls = _family_for(env0)
        if fam_cls is None:
            raise ValueError(
                f"MjVecEnv does not support {getattr(env0.spec, 'id', env0)!r}"
                f" (supported -v5 families: {sorted(_FAMILIES)}, with default"
                " observation flags); use SyncVectorEnv / make_host_vector_env"
            )
        self.family: _V5Family = fam_cls(env0)
        u0 = env0.unwrapped
        self._models = [e.unwrapped.model for e in self.envs]
        self._nq = int(u0.model.nq)
        self._nv = int(u0.model.nv)
        self._frame_skip = int(u0.frame_skip)
        self._nstate = mujoco.mj_stateSize(u0.model, _FULLPHYSICS)
        n = len(self.envs)
        self._state = np.zeros((n, self._nstate), dtype=np.float64)
        self._steps = np.zeros(n, dtype=np.int64)
        spec = getattr(env0, "spec", None)
        self._max_episode_steps = getattr(spec, "max_episode_steps", None)

        self.observation_space = env0.observation_space
        self.action_space = env0.action_space
        self._obs_dim = int(np.prod(env0.observation_space.shape))

        if nthread is None:
            # EVOTORCH_MJ_NTHREAD overrides the physics thread-pool width
            # (mujoco.rollout's nthread). The default saturates the machine —
            # which on a 1-core box means nthread=1, i.e. NO physics
            # parallelism: the pipelined scheduler's overlap gains there come
            # from lane refill, not threading.
            env_nthread = os.environ.get("EVOTORCH_MJ_NTHREAD", "")
            if env_nthread:
                nthread = int(env_nthread)
            else:
                nthread = max(1, min(n, os.cpu_count() or 1))
        self.nthread = int(nthread)
        self._pool = mj_rollout.Rollout(nthread=int(nthread))
        self._scratch = [mujoco.MjData(self._models[0]) for _ in range(int(nthread))]
        self.last_terms: Dict[str, np.ndarray] = {}

    # ------------------------------------------------- SyncVectorEnv contract
    @property
    def num_envs(self) -> int:
        return len(self.envs)

    @property
    def is_discrete(self) -> bool:
        return hasattr(self.action_space, "n")

    def _pull_state(self, i: int):
        mujoco.mj_getState(
            self._models[i], self.envs[i].unwrapped.data, self._state[i], _FULLPHYSICS
        )

    def _reset_one(self, i: int) -> np.ndarray:
        out = self.envs[i].reset()
        if isinstance(out, tuple):
            out = out[0]
        self._pull_state(i)
        self._steps[i] = 0
        return np.asarray(out, dtype=np.float32).reshape(-1)

    def reset(self) -> np.ndarray:
        return np.stack([self._reset_one(i) for i in range(self.num_envs)])

    def step(self, actions, active: Optional[np.ndarray] = None):
        n = self.num_envs
        obs = np.full((n, self._obs_dim), np.nan, dtype=np.float32)
        rewards = np.zeros(n, dtype=np.float32)
        dones = np.zeros(n, dtype=bool)
        idx = np.arange(n) if active is None else np.flatnonzero(np.asarray(active)[:n])
        self.last_terms = {}
        if idx.size == 0:
            return obs, rewards, dones

        acts = np.asarray(actions, dtype=np.float64).reshape((n, -1))[idx]
        x_before = self._state[idx, 1]  # FULLPHYSICS layout: [time, qpos, qvel, act]
        ctrl = np.ascontiguousarray(
            np.repeat(acts[:, None, :], self._frame_skip, axis=1)
        )
        out_state, _ = self._pool.rollout(
            [self._models[i] for i in idx], self._scratch, self._state[idx], ctrl
        )
        new_state = out_state[:, -1, :]
        qpos = new_state[:, 1 : 1 + self._nq]
        qvel = new_state[:, 1 + self._nq : 1 + self._nq + self._nv]
        x_vel = (qpos[:, 0] - x_before) / self.family.dt

        reward, terminated, terms = self.family.reward_terms(x_vel, acts, qpos, qvel)
        self._state[idx] = new_state
        self._steps[idx] += 1
        done = terminated.copy()
        if self._max_episode_steps is not None:
            done |= self._steps[idx] >= int(self._max_episode_steps)

        obs[idx] = self.family.obs(qpos, qvel).astype(np.float32)
        rewards[idx] = reward
        dones[idx] = done
        for term_name, values in terms.items():
            full = np.full(n, np.nan)
            full[idx] = values
            self.last_terms[term_name] = full
        for j, i in enumerate(idx):
            if done[j]:
                obs[i] = self._reset_one(i)
        return obs, rewards, dones

    def seed(self, seeds: Sequence[int]):
        for i, s in enumerate(seeds[: self.num_envs]):
            try:
                self.envs[i].reset(seed=int(s))
            except TypeError:
                continue
            self._pull_state(i)
            self._steps[i] = 0

    def close(self):
        self._pool.close()
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()


def _instantiate(env_fn, num_envs) -> List:
    """Accept a single factory + count, a sequence of factories, or a
    sequence of already-constructed envs."""
    if callable(env_fn):
        if num_envs is None:
            raise ValueError("Give num_envs when env_fn is a single factory")
        return [env_fn() for _ in range(int(num_envs))]
    items = list(env_fn)
    return [item() if callable(item) else item for item in items]


def make_host_vector_env(env_fn: Callable, num_envs: int, *, nthread: Optional[int] = None):
    """Backend chooser for ``GymNE``'s vectorized host evaluation: a real
    MuJoCo batched engine when the env is a supported ``-v5`` family, the
    generic lockstep ``SyncVectorEnv`` otherwise. The probe env is reused as
    lane 0 either way (never constructed twice). ``nthread`` feeds
    ``mujoco.rollout``'s thread pool (default: ``EVOTORCH_MJ_NTHREAD`` or
    one thread per core)."""
    from ...neuroevolution.net.hostvecenv import SyncVectorEnv

    probe = env_fn()
    rest = [env_fn for _ in range(int(num_envs) - 1)]
    if _family_for(probe) is not None:
        return MjVecEnv([probe] + rest, nthread=nthread)
    return SyncVectorEnv([lambda: probe] + rest)
