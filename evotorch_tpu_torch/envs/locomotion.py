"""Shared base of the rigid-body locomotion environments (counterpart of
``evotorch_tpu/envs/locomotion.py``): population-minor ``reset_noise`` /
``batch_reset_from`` / ``batch_step`` / ``batch_where`` / ``batch_take``,
the MuJoCo-style reward (forward velocity
+ alive bonus - control cost, terminating outside a healthy height band)
and the common observation layout:

====================  =====================================================
dims                  content
====================  =====================================================
1                     torso height
4                     torso orientation quaternion
3                     torso linear velocity (world)
3                     torso angular velocity (world)
num_act               joint angles (action-DOF order)
num_act               joint angular velocities (action-DOF order)
3 * (num_bodies - 1)  non-torso body COM positions relative to the torso
3 * (num_bodies - 1)  non-torso body velocities relative to the torso
n_contact_obs         ground contact depths of the first collider spheres
====================  =====================================================

Planar tasks (``planar = True``: Walker2D, HalfCheetah) project each control
step back onto the x-z sagittal plane after the physics.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Env, EnvState, Space
from .rigidbody import (
    BodyState,
    joint_angles_batched,
    joint_velocities_batched,
    physics_step_batched,
    sphere_penetrations_batched,
)

__all__ = ["RigidBodyLocomotionEnv"]


class RigidBodyLocomotionEnv(Env):
    """Base class: subclasses set ``sys``/``_default_pos`` (the body plan,
    on ``self.device``), ``dt``/``substeps`` and the reward constants before
    calling ``_finalize_spaces()``."""

    max_episode_steps = 1000
    n_contact_obs = 4
    state_lane_axis = -1
    # planar tasks: after each control step, lateral velocity, roll and yaw
    # rates are zeroed, body y snaps to the body plan's offsets and the
    # orientations project onto pure y-rotations
    planar = False
    # largest per-substep h the default joint stiffness tolerates
    integrator_h_budget = 0.008

    forward_reward_weight = 1.25
    alive_bonus = 5.0
    ctrl_cost_weight = 0.1
    healthy_z_range = (0.2, 2.0)
    reset_noise_scale = 0.01

    def _finalize_spaces(self):
        if self.substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {self.substeps}")
        if self.dt / self.substeps > self.integrator_h_budget:
            raise ValueError(
                f"dt/substeps = {self.dt / self.substeps:.4f}s exceeds the"
                f" integrator stability budget ({self.integrator_h_budget}s"
                " at the default joint stiffness); increase substeps or lower dt"
            )
        na = self.sys.num_act
        ones = torch.ones(na, device=self.device)
        self.action_space = Space(shape=(na,), lb=-ones, ub=ones)
        self.observation_space = Space(shape=(self._obs_dim(),))

        # selection matrix flattening per-joint axis components (nj, 3) into
        # action-DOF order: one (na, nj*3) x (nj*3, B) product
        nj = self.sys.num_joints
        idx = self.sys.act_index.reshape(-1).cpu().numpy()
        sel = np.zeros((na, nj * 3), dtype=np.float32)
        for flat_pos, a in enumerate(idx):
            if a < na:
                sel[a, flat_pos] = 1.0
        self._free_sel = torch.as_tensor(sel, device=self.device)

        # the planar projection's component masks, (1, comp, 1): each field
        # is then one torch.where, a new tensor (no lane shares memory)
        def mask(size, rows):
            m = torch.zeros((1, size, 1), dtype=torch.bool, device=self.device)
            m[:, list(rows)] = True
            return m

        self._y_row = mask(3, (1,))
        self._xz_rows = mask(3, (0, 2))
        self._wy_rows = mask(4, (0, 2))

    def _obs_dim(self) -> int:
        nb = self.sys.num_bodies
        na = self.sys.num_act
        return 1 + 4 + 3 + 3 + 2 * na + 2 * 3 * (nb - 1) + self.n_contact_obs

    def _batch_free_components(self, comps: torch.Tensor) -> torch.Tensor:
        """``(nj, 3, B)`` axis components -> ``(na, B)`` action-DOF order."""
        return self._free_sel @ comps.reshape(self.sys.num_joints * 3, -1)

    def _batch_obs(self, st: BodyState) -> torch.Tensor:
        """Observation of a population state ``(nb, comp, B)`` -> ``(B, obs)``."""
        B = st.pos.shape[-1]
        ja = self._batch_free_components(joint_angles_batched(self.sys, st))
        jv = self._batch_free_components(joint_velocities_batched(self.sys, st))
        obs = torch.cat(
            (
                st.pos[0, 2:3, :],
                st.quat[0],
                st.vel[0],
                st.ang[0],
                ja,
                jv,
                (st.pos[1:] - st.pos[:1]).reshape(-1, B),
                (st.vel[1:] - st.vel[:1]).reshape(-1, B),
                sphere_penetrations_batched(self.sys, st)[: self.n_contact_obs],
            ),
            dim=0,
        )
        return obs.t().contiguous()

    def _batch_reward_done(self, st: BodyState, actions_minor: torch.Tensor, t: torch.Tensor):
        """``actions_minor`` is ``(na, B)`` (clipped). Returns
        ``(reward (B,), done (B,))``."""
        z = st.pos[0, 2, :]
        lo, hi = self.healthy_z_range
        unhealthy = (z < lo) | (z > hi)
        done = unhealthy | (t >= self.max_episode_steps)
        forward_vel = st.vel[0, 0, :]
        ctrl_cost = self.ctrl_cost_weight * torch.sum(actions_minor * actions_minor, dim=0)
        reward = self.forward_reward_weight * forward_vel + self.alive_bonus - ctrl_cost
        reward = torch.where(unhealthy, reward - self.alive_bonus, reward)
        return reward, done

    def batch_reward_terms(self, st: BodyState, actions_minor: torch.Tensor) -> dict:
        """The step reward term by term, ``(B,)`` each: ``reward_forward +
        reward_ctrl + reward_survive`` is the reward of :meth:`batch_step`
        (``actions_minor`` ``(na, B)``, clipped)."""
        z = st.pos[0, 2, :]
        lo, hi = self.healthy_z_range
        healthy = (z >= lo) & (z <= hi)
        forward_vel = st.vel[0, 0, :]
        ctrl_cost = self.ctrl_cost_weight * torch.sum(actions_minor * actions_minor, dim=0)
        return {
            "x_velocity": forward_vel,
            "reward_forward": self.forward_reward_weight * forward_vel,
            "reward_ctrl": -ctrl_cost,
            "reward_survive": self.alive_bonus * healthy,
            "healthy": healthy,
        }

    def _planar_project(self, st: BodyState) -> BodyState:
        """The state projected onto the sagittal plane: one ``torch.where``
        per field, the (w, y) quaternion renormalized (norm floored at
        ``1e-6``, a squared norm of ``1e-12``, as in the JAX package)."""
        pos = torch.where(self._y_row, self._default_pos[..., None], st.pos)
        vel = torch.where(self._y_row, 0.0, st.vel)
        ang = torch.where(self._xz_rows, 0.0, st.ang)
        w, y = st.quat[:, 0, :], st.quat[:, 2, :]
        norm = torch.sqrt(torch.clamp(w * w + y * y, min=1e-12))
        quat = torch.where(self._wy_rows, st.quat, 0.0) / norm[:, None, :]
        return BodyState(pos=pos, quat=quat, vel=vel, ang=ang)

    def reset_noise(self, num_items: int, generator: torch.Generator) -> torch.Tensor:
        """The raw standard normals of ``num_items`` resets, ``(num_items,
        2, nb, 3)``: body velocities then angular velocities. One
        ``randn((2, nb, 3, num_items))`` call, the lane axis moved to the
        front (a view), so ``batch_reset`` draws what it always drew (a
        generator on the env's device avoids a copy)."""
        nb = self.sys.num_bodies
        draws = torch.randn((2, nb, 3, int(num_items)), generator=generator, device=generator.device)
        return draws.to(self.device).movedim(-1, 0)

    def batch_reset_from(self, noise_rows: torch.Tensor):
        """Reset one lane per row of ``noise_rows`` (``(B, 2, nb, 3)``): the
        default pose, at rest up to ``reset_noise_scale`` times the row's
        normals on the body velocities."""
        B = noise_rows.shape[0]
        nb = self.sys.num_bodies
        noise = self.reset_noise_scale
        draws = noise_rows.movedim(0, -1)  # (2, nb, 3, B)
        quat = torch.zeros((nb, 4, B), device=self.device)
        quat[:, 0] = 1.0
        st = BodyState(
            pos=self._default_pos[..., None].expand(nb, 3, B),
            quat=quat,
            vel=noise * draws[0],
            ang=noise * draws[1],
        )
        state = EnvState(obs_state=st, t=torch.zeros(B, dtype=torch.int32, device=self.device))
        return state, self._batch_obs(st)

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        """Step ``B`` lanes: ``actions`` ``(B, na)`` -> leading-batch outputs."""
        actions = torch.clamp(actions, self.action_space.lb, self.action_space.ub)
        a = actions.t()  # (na, B): population-minor for the physics
        st = physics_step_batched(self.sys, state.obs_state, a, self.dt, self.substeps)
        if self.planar:
            st = self._planar_project(st)
        t = state.t + 1
        reward, done = self._batch_reward_done(st, a, t)
        return EnvState(obs_state=st, t=t), self._batch_obs(st), reward, done

    def batch_where(self, mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
        """Per-lane state select (the rollout's auto-reset): the body state is
        population-minor, ``t`` population-leading."""
        obs_state = BodyState(*(torch.where(mask, x, y) for x, y in zip(a.obs_state, b.obs_state)))
        return EnvState(obs_state=obs_state, t=torch.where(mask, a.t, b.t))

    def batch_take(self, state: EnvState, idx: torch.Tensor) -> EnvState:
        """Lanes ``idx`` (lane compaction): the body state is
        population-minor, ``t`` population-leading."""
        obs_state = BodyState(*(x.index_select(-1, idx) for x in state.obs_state))
        return EnvState(obs_state=obs_state, t=state.t.index_select(0, idx))
