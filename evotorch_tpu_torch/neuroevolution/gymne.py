"""Classical (non-vectorized) gym RL neuroevolution (counterpart of
``evotorch_tpu/neuroevolution/gymne.py``).

One gym-API env, sequential episode loops, online observation
normalization with the host ``RunningStat``, interaction and episode
counters (which feed adaptive popsize), ``decrease_rewards_by`` /
``alive_bonus_schedule`` / ``action_noise_stdev`` / ``episode_length``,
discrete-action argmax, ``to_policy``, ``save_solution`` and the four
host-pool sync hooks.

With ``num_envs > 1`` the evaluation is lane-vectorized: one batched policy
forward on the problem's device (the card unless given) per timestep for a
whole lane block, and for real MuJoCo ``-v5`` envs the lanes are stepped by
the batched ``envs.mujoco.MjVecEnv`` engine over ``mujoco.rollout``. The
default ``host_pipeline="pipelined"`` drives the lanes with the
Sebulba-style scheduler (``net.hostvecenv.run_host_pipelined_rollout``):
the whole batch is submitted at once, the policy forward of one lane block
overlaps the host physics of the other, and finished lanes are re-seeded
from the batch-wide pending queue. ``"sync"`` runs the same event order
without the worker thread (equal bit for bit); ``"chunked"`` evaluates
fixed chunks of ``num_envs`` solutions one after the other
(``run_host_vectorized_rollout``).

``gymnasium`` is imported only for a string env spec, so a callable that
builds a gym-API env runs without it. Scores are set on the problem's
device.
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional, Union

import numpy as np
import torch

from .neproblem import NEProblem
from .net.layers import Module
from .net.rl import alive_bonus_for_step_host, reset_env, take_step_in_env
from .net.runningnorm import RunningStat
from ..tools.lowrank import dense_values

__all__ = ["GymNE"]


class GymNE(NEProblem):
    def __init__(
        self,
        env: Optional[Union[str, Callable]] = None,
        network: Optional[Union[str, Module, Callable]] = None,
        *,
        env_name: Optional[str] = None,
        network_args: Optional[dict] = None,
        env_config: Optional[dict] = None,
        observation_normalization: bool = False,
        num_episodes: int = 1,
        num_envs: Optional[int] = None,
        episode_length: Optional[int] = None,
        decrease_rewards_by: Optional[float] = None,
        alive_bonus_schedule: Optional[tuple] = None,
        action_noise_stdev: Optional[float] = None,
        initial_bounds=(-0.00001, 0.00001),
        seed: Optional[int] = None,
        num_actors=None,
        vector_env_backend: str = "auto",
        host_pipeline: str = "pipelined",
        host_pipeline_blocks: Optional[int] = None,
        mj_nthread: Optional[int] = None,
        **kwargs,
    ):
        if env is None and env_name is None:
            raise ValueError("Provide `env` (or the legacy `env_name`)")
        self._env_spec = env if env is not None else env_name
        self._env_config = dict(env_config or {})
        self._gym_env = None
        self._observation_normalization = bool(observation_normalization)
        self._num_episodes = int(num_episodes)
        self._episode_length = episode_length
        self._decrease_rewards_by = 0.0 if decrease_rewards_by is None else float(decrease_rewards_by)
        self._alive_bonus_schedule = alive_bonus_schedule
        self._action_noise_stdev = action_noise_stdev
        self._obs_stats = RunningStat()
        self._interaction_count = 0
        self._episode_count = 0
        # policy forwards: one per env step serially, one per lane block per
        # lockstep iteration in the vectorized engines
        self._control_step_count = 0
        # num_envs > 1 turns on in-process vectorized evaluation: num_envs env
        # lanes stepped in lockstep with ONE batched device forward per
        # timestep. The lane engine is
        # chosen by vector_env_backend: "auto" picks the real-MuJoCo batched
        # engine (envs.mujoco.MjVecEnv over mujoco.rollout's threaded API)
        # when the env is a supported -v5 family, else the generic
        # SyncVectorEnv; "mujoco"/"sync" force one or the other.
        self._num_envs = None if num_envs is None else int(num_envs)
        self._vector_env_backend = str(vector_env_backend)
        if self._vector_env_backend not in ("auto", "mujoco", "sync"):
            raise ValueError(
                "vector_env_backend must be 'auto', 'mujoco' or 'sync',"
                f" got {vector_env_backend!r}"
            )
        # host_pipeline picks the scheduler that drives the lanes:
        # "pipelined" (default) — the Sebulba-style two-lane-block scheduler
        # with work-conserving lane refill over the WHOLE batch (device
        # forward for block A overlaps host physics for block B);
        # "sync" — the same scheduler, same event order, no worker thread
        # (bit-identical scores/stats: the determinism baseline);
        # "chunked" — the legacy serial fixed-chunk loop (one
        # run_host_vectorized_rollout per num_envs-sized chunk), kept as the
        # A/B reference the pipeline is benched against.
        self._host_pipeline = str(host_pipeline)
        if self._host_pipeline not in ("pipelined", "sync", "chunked"):
            raise ValueError(
                "host_pipeline must be 'pipelined', 'sync' or 'chunked',"
                f" got {host_pipeline!r}"
            )
        # None = the scheduler's host-adaptive block split (2 when the box
        # has a second core to overlap on, else 1). NOTE: with observation
        # normalization on, the block count sets the obs-stat accumulation
        # grouping, so auto makes scores bitwise host-dependent — pass an
        # explicit count for cross-machine bit-reproducibility.
        self._host_pipeline_blocks = (
            None if host_pipeline_blocks is None else int(host_pipeline_blocks)
        )
        self._mj_nthread = None if mj_nthread is None else int(mj_nthread)
        # host-knob tuning (observability/timings.py): with no explicit
        # host_pipeline_blocks / mj_nthread (and no EVOTORCH_MJ_NTHREAD env
        # override), eval setup consults the machine-scoped "host_pipeline"
        # entry of the tuned-config cache — the autotuner's measured block
        # split / thread-pool width for THIS box — before falling back to
        # the built-in heuristics. Provenance lands in the
        # `tuned_config_source` status key.
        self._tuned_host = None
        self._vec_env = None

        self._make_gym_env()  # early, so network constants are available

        super().__init__(
            "max",
            network,
            network_args=network_args,
            initial_bounds=initial_bounds,
            seed=seed,
            num_actors=num_actors,
            vectorized_network_eval=False,
            **kwargs,
        )
        self.after_eval_hook.append(self._report_counters)

    # --------------------------------------------------------------- the env
    def _build_one_env(self):
        """Resolve the env spec (callable, plain name, or ``"gym::"`` string)
        into a fresh env instance, shared by the serial env and the
        vectorized lanes. ``gymnasium`` is imported for a string only."""
        if callable(self._env_spec):
            return self._env_spec(**self._env_config)
        import gymnasium as gym

        name = str(self._env_spec)
        if name.startswith("gym::"):
            name = name[len("gym::") :]
        return gym.make(name, **self._env_config)

    def _make_gym_env(self):
        if self._gym_env is None:
            self._gym_env = self._build_one_env()
        return self._gym_env

    @property
    def _env(self):
        return self._make_gym_env()

    def _network_constants(self) -> dict:
        env = self._make_gym_env()
        obs_space = env.observation_space
        act_space = env.action_space
        obs_length = int(np.prod(obs_space.shape))
        if hasattr(act_space, "n"):
            act_length = int(act_space.n)
        else:
            act_length = int(np.prod(act_space.shape))
        return {
            "obs_length": obs_length,
            "act_length": act_length,
            "obs_space": obs_space,
            "act_space": act_space,
            "obs_shape": tuple(obs_space.shape),
        }

    @property
    def observation_normalization(self) -> bool:
        return self._observation_normalization

    def _report_counters(self, batch) -> dict:
        status = {
            "total_interaction_count": self._interaction_count,
            "total_episode_count": self._episode_count,
            "total_control_step_count": self._control_step_count,
        }
        if self._tuned_host is not None:
            status["tuned_config_source"] = self._tuned_host[1]
        return status

    def _resolve_host_tuning(self) -> dict:
        """The host-path knobs, resolved once with the shared precedence
        rule (``observability.timings.resolve_knobs``): any explicit ctor
        knob — or the ``EVOTORCH_MJ_NTHREAD`` env override — wins for the
        whole group; else the machine-scoped ``"host_pipeline"`` cache
        entry; else ``{}`` (the scheduler / MjVecEnv heuristics)."""
        if self._tuned_host is None:
            import os

            from ..observability.timings import resolve_knobs

            env_nthread = os.environ.get("EVOTORCH_MJ_NTHREAD", "")
            explicit = {
                "num_blocks": self._host_pipeline_blocks,
                "mj_nthread": (
                    self._mj_nthread
                    if self._mj_nthread is not None
                    else (int(env_nthread) if env_nthread else None)
                ),
            }
            from ..observability.timings import machine_fingerprint

            self._tuned_host = resolve_knobs(explicit, "host_pipeline", {}, machine=machine_fingerprint(self.device))
        return self._tuned_host[0]

    # ------------------------------------------------------------- rollouts
    def _normalize_observation(self, obs, *, update_stats: bool = True) -> np.ndarray:
        obs = np.asarray(obs, dtype=np.float32).reshape(-1)
        if self._observation_normalization:
            if update_stats:
                self._obs_stats.update(obs)
            return np.asarray(self._obs_stats.normalize(obs), dtype=np.float32)
        return obs

    def _action_from_output(self, output: np.ndarray):
        env = self._make_gym_env()
        act_space = env.action_space
        if hasattr(act_space, "n"):
            return int(np.argmax(output))
        action = np.asarray(output, dtype=np.float64).reshape(act_space.shape)
        if self._action_noise_stdev is not None:
            action = action + np.random.randn(*action.shape) * self._action_noise_stdev
        return np.clip(action, act_space.low, act_space.high)

    def _rollout(
        self,
        policy_apply: Callable,
        *,
        update_stats: bool = True,
        visualize: bool = False,
        decrease_rewards_by: Optional[float] = None,
    ) -> dict:
        """One episode."""
        env = self._make_gym_env()
        decrease = self._decrease_rewards_by if decrease_rewards_by is None else float(decrease_rewards_by)
        obs = self._normalize_observation(reset_env(env), update_stats=update_stats)
        state = None
        cumulative = 0.0
        t = 0
        while True:
            out, state = policy_apply(torch.as_tensor(obs, device=self.device)[None], state)
            action = self._action_from_output(out[0].detach().cpu().numpy())
            raw_obs, reward, done = take_step_in_env(env, action)
            t += 1
            self._interaction_count += 1
            self._control_step_count += 1
            reward = reward - decrease
            if self._alive_bonus_schedule is not None and not done:
                # host t: float math, no tensor per step
                reward += alive_bonus_for_step_host(t, self._alive_bonus_schedule)
            cumulative += reward
            if visualize and hasattr(env, "render"):
                env.render()
            obs = self._normalize_observation(raw_obs, update_stats=update_stats)
            if done or (self._episode_length is not None and t >= int(self._episode_length)):
                break
        self._episode_count += 1
        return {"cumulative_reward": cumulative, "interaction_count": t}

    def _evaluate_network(self, flat_params):
        apply = self.parameterize_net(flat_params)
        total = 0.0
        for _ in range(self._num_episodes):
            total += self._rollout(apply)["cumulative_reward"]
        return total / self._num_episodes

    # --------------------------------------- in-process vectorized evaluation
    def _make_vector_env(self):
        if self._vec_env is not None:
            return self._vec_env
        # explicit mj_nthread / EVOTORCH_MJ_NTHREAD, else the tuned cache's
        # machine entry, else None (MjVecEnv's saturate-the-machine default)
        nthread = self._resolve_host_tuning().get("mj_nthread")
        backend = self._vector_env_backend
        if backend in ("auto", "mujoco"):
            try:
                from ..envs.mujoco import make_host_vector_env
                from ..envs.mujoco.mjvecenv import MjVecEnv

                if backend == "mujoco":
                    self._vec_env = MjVecEnv(
                        self._build_one_env, self._num_envs, nthread=nthread
                    )
                else:
                    self._vec_env = make_host_vector_env(
                        self._build_one_env, self._num_envs, nthread=nthread
                    )
                return self._vec_env
            except ImportError:
                if backend == "mujoco":
                    raise  # explicitly requested; don't silently degrade
        from .net.hostvecenv import SyncVectorEnv

        self._vec_env = SyncVectorEnv(self._build_one_env, self._num_envs)
        return self._vec_env

    def _evaluate_batch(self, batch):
        if self._num_envs is None or self._num_envs <= 1:
            return super()._evaluate_batch(batch)
        vec_env = self._make_vector_env()
        values = dense_values(batch.values)
        obs_stats = self._obs_stats if self._observation_normalization else None
        common = dict(
            num_episodes=self._num_episodes,
            episode_length=self._episode_length,
            obs_stats=obs_stats,
            decrease_rewards_by=self._decrease_rewards_by,
            alive_bonus_schedule=self._alive_bonus_schedule,
            action_noise_stdev=self._action_noise_stdev,
            device=self.device,
        )
        if self._host_pipeline == "chunked":
            # serial fixed-size chunks, each padded to its slowest episode:
            # the A/B baseline of the pipelined scheduler
            from .net.hostvecenv import run_host_vectorized_rollout

            n = values.shape[0]
            scores = []
            for start in range(0, n, self._num_envs):
                result = run_host_vectorized_rollout(
                    vec_env, self._policy, values[start : start + self._num_envs], **common
                )
                scores.append(result["scores"])
                self._interaction_count += result["interactions"]
                self._episode_count += result["episodes"]
                self._control_step_count += result["control_steps"]
            batch.set_evals(torch.as_tensor(np.concatenate(scores), dtype=torch.float32, device=self.device))
            return
        # whole-batch submission: every (solution, episode) item goes into one
        # pending queue and freed lanes are re-seeded immediately, so a long
        # episode stalls one lane, not a whole chunk
        from .net.hostvecenv import HungPhysicsWorkerError, run_host_pipelined_rollout

        try:
            result = run_host_pipelined_rollout(
                vec_env,
                self._policy,
                values,
                mode=self._host_pipeline,
                num_blocks=self._resolve_host_tuning().get("num_blocks"),
                # the group was resolved HERE (explicit > cache > fallback,
                # one rule for blocks AND nthread together) — the scheduler
                # must not re-consult the cache at its own altitude, and the
                # result dict carries THIS resolution's provenance
                use_tuned_cache=False,
                tuned_config_source=self._tuned_host[1],
                **common,
            )
        except HungPhysicsWorkerError:
            # the physics worker thread is still alive inside this vec_env (a
            # hung native step): closing under a running thread could crash,
            # so just drop the reference and never reuse it
            self._vec_env = None
            raise
        except BaseException:
            # a failed evaluation leaves env lanes mid-episode: close the
            # vec_env (its worker exited cleanly) and build a fresh one next
            # time rather than leaking gym envs / native MuJoCo buffers
            self._vec_env = None
            try:
                vec_env.close()
            except Exception:  # best-effort cleanup while the eval failure is re-raised
                pass
            raise
        self._interaction_count += result["interactions"]
        self._episode_count += result["episodes"]
        self._control_step_count += sum(result["block_iters"])
        batch.set_evals(torch.as_tensor(result["scores"], dtype=torch.float32, device=self.device))

    def run_solution(self, solution, *, num_episodes: int = 1, visualize: bool = False) -> float:
        """Deterministically run a solution (no stat updates)."""
        apply = self.parameterize_net(self._solution_values(solution))
        total = 0.0
        for _ in range(int(num_episodes)):
            total += self._rollout(apply, update_stats=False, visualize=visualize, decrease_rewards_by=0.0)[
                "cumulative_reward"
            ]
        return total / num_episodes

    def visualize(self, solution, *, num_episodes: int = 1) -> float:
        """Render a solution's episodes."""
        return self.run_solution(solution, num_episodes=num_episodes, visualize=True)

    # ------------------------------------------------------- policy exports
    def to_policy(self, solution) -> Module:
        """Deployable module **carrying the solution's evolved weights**:
        obs-norm + parameterized network + action clip, on the problem's
        device; call it as ``module.apply([], x)`` with ``x`` ``(B, obs)``."""
        from .net.layers import FrozenModule
        from .net.rl import ActClipLayer, ObsNormLayer

        module: Module = FrozenModule(*self.make_net(solution))

        def const(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

        if self._observation_normalization and self._obs_stats.count >= 2:
            module = ObsNormLayer(mean=const(self._obs_stats.mean), stdev=const(self._obs_stats.stdev)) >> module
        env = self._make_gym_env()
        act_space = env.action_space
        if not hasattr(act_space, "n"):
            module = module >> ActClipLayer(const(act_space.low), const(act_space.high))
        return module

    def get_observation_stats(self) -> RunningStat:
        return self._obs_stats

    def set_observation_stats(self, stats: RunningStat):
        self._obs_stats = stats

    def save_solution(self, solution, fname: str):
        """Pickle the solution values, the obs stats and the network spec,
        as numpy arrays and Python values (the JAX package's payload, so a
        file either package wrote loads in both)."""
        values = self._solution_values(solution).detach().cpu().numpy()
        payload = {
            "values": values,
            "obs_count": self._obs_stats.count,
            "obs_mean": None if self._obs_stats.count < 2 else self._obs_stats.mean,
            "obs_stdev": None if self._obs_stats.count < 2 else self._obs_stats.stdev,
            "network_spec": self._network_spec if isinstance(self._network_spec, str) else repr(self._network_spec),
            "env_spec": self._env_spec if isinstance(self._env_spec, str) else repr(self._env_spec),
        }
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    # ------------------------------------------------- host-pool sync protocol
    def _make_sync_data_for_actors(self):
        if not self._observation_normalization:
            return None
        return {"obs_stats": self._obs_stats}

    def _use_sync_data_from_main(self, data: dict):
        # worker-side: adopt the broadcast stats and remember the baseline so
        # only the *delta* collected during this round is sent home
        import copy

        self._obs_stats = copy.deepcopy(data["obs_stats"])
        self._stats_at_sync = copy.deepcopy(self._obs_stats)

    def _make_sync_data_for_main(self) -> dict:
        data = {
            "interactions": self._interaction_count,
            "episodes": self._episode_count,
            "control_steps": self._control_step_count,
        }
        # worker-side counters reset after reporting: each round reports a delta
        self._interaction_count = 0
        self._episode_count = 0
        self._control_step_count = 0
        if self._observation_normalization:
            baseline = getattr(self, "_stats_at_sync", None)
            if baseline is None:
                data["obs_delta"] = self._obs_stats
            else:
                data["obs_delta"] = self._obs_stats.to_delta(baseline)
        return data

    def _use_sync_data_from_actors(self, data_list):
        for data in data_list:
            self._interaction_count += int(data.get("interactions", 0))
            self._episode_count += int(data.get("episodes", 0))
            self._control_step_count += int(data.get("control_steps", 0))
            delta = data.get("obs_delta")
            if delta is not None:
                self._obs_stats.update(delta)

    def _get_cloned_state(self, *, memo: dict) -> dict:
        state = super()._get_cloned_state(memo=memo)
        state["_gym_env"] = None  # env handles are not picklable
        state["_vec_env"] = None
        return state
