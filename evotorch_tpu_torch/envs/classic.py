"""Classic-control environments, batched on the device (counterpart of
``evotorch_tpu/envs/classic.py``).

Dynamics follow the standard gym formulations, as in the JAX package:
CartPole (Barto, Sutton & Anderson 1983), Pendulum, Acrobot (Sutton 1996),
MountainCarContinuous (Moore 1990), and the light planar ``Swimmer2D``.
Every tensor is population-leading: the state is ``(B, k)``, actions
``(B, ·)``, observations ``(B, obs_dim)``. A reset row holds the raw
uniform ``[0, 1)`` draws of one reset, mapped inside into the ranges of the
JAX package (``u * (hi - lo) + lo``, floored at ``lo``, as
``jax.random.uniform`` computes them).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .base import Env, EnvState, Space

__all__ = ["Acrobot", "CartPole", "MountainCarContinuous", "Pendulum", "Swimmer2D"]


class _ClassicEnv(Env):
    """Shared protocol pieces: ``(B, k)`` state rows and ``(B,)`` step
    counters. Subclasses set ``reset_width`` (uniform draws per reset)."""

    reset_width: int

    def _setup(self, device):
        self.device = resolve_device(device)

    def _box(self, lo, hi) -> Space:
        lb = torch.tensor(lo, dtype=torch.float32, device=self.device)
        ub = torch.tensor(hi, dtype=torch.float32, device=self.device)
        return Space(shape=tuple(lb.shape), lb=lb, ub=ub)

    @staticmethod
    def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        # the float32 values of lo and hi - lo, as Python floats: a tensor
        # op casts them back to float32 exactly, and no tensor is made
        lo32 = float(np.float32(lo))
        span = float(np.float32(hi) - np.float32(lo))
        return torch.clamp(u * span + lo32, min=lo32)

    def _fresh(self, obs_state: torch.Tensor) -> EnvState:
        return EnvState(obs_state=obs_state, t=torch.zeros(obs_state.shape[0], dtype=torch.int32, device=self.device))

    def reset_noise(self, num_items: int, generator: torch.Generator) -> torch.Tensor:
        """Raw uniform draws ``(num_items, reset_width)`` in ``[0, 1)``."""
        draws = torch.rand((int(num_items), self.reset_width), generator=generator, device=generator.device)
        return draws.to(self.device)

    def batch_where(self, mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
        return EnvState(obs_state=torch.where(mask[:, None], a.obs_state, b.obs_state), t=torch.where(mask, a.t, b.t))

    def batch_take(self, state: EnvState, idx: torch.Tensor) -> EnvState:
        return EnvState(obs_state=state.obs_state.index_select(0, idx), t=state.t.index_select(0, idx))


class CartPole(_ClassicEnv):
    """CartPole-v1 dynamics. ``continuous_actions=True`` exposes a Box(-1, 1)
    action mapped to force direction (for policies without argmax heads)."""

    max_episode_steps = 500
    reset_width = 4

    def __init__(self, *, continuous_actions: bool = False, device=None):
        self._setup(device)
        self.continuous = bool(continuous_actions)
        self.observation_space = Space(shape=(4,))
        if self.continuous:
            self.action_space = self._box([-1.0], [1.0])
        else:
            self.action_space = Space(shape=(), n=2)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4

    def batch_reset_from(self, noise_rows: torch.Tensor):
        obs = self._uniform(noise_rows, -0.05, 0.05)
        return self._fresh(obs), obs

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        x, x_dot, theta, theta_dot = state.obs_state.unbind(1)
        B = x.shape[0]
        if self.continuous:
            force = self.force_mag * torch.clamp(actions.reshape(B), -1.0, 1.0)
        else:
            force = torch.where(actions.reshape(B) == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        obs = torch.stack([x, x_dot, theta, theta_dot], dim=1)
        t = state.t + 1
        done = (torch.abs(x) > self.x_threshold) | (torch.abs(theta) > self.theta_threshold) | (t >= self.max_episode_steps)
        reward = torch.ones(B, device=obs.device)
        return EnvState(obs_state=obs, t=t), obs, reward, done


class Pendulum(_ClassicEnv):
    """Pendulum-v1 dynamics: swing-up with torque penalty."""

    max_episode_steps = 200
    reset_width = 2

    def __init__(self, *, device=None):
        self._setup(device)
        self.observation_space = Space(shape=(3,))
        self.action_space = self._box([-2.0], [2.0])
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.l = 1.0  # noqa: E741

    def _obs(self, th, thdot):
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=1)

    def batch_reset_from(self, noise_rows: torch.Tensor):
        th = self._uniform(noise_rows[:, 0], -math.pi, math.pi)
        thdot = self._uniform(noise_rows[:, 1], -1.0, 1.0)
        return self._fresh(torch.stack([th, thdot], dim=1)), self._obs(th, thdot)

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        th, thdot = state.obs_state.unbind(1)
        u = torch.clamp(actions.reshape(th.shape[0]), -self.max_torque, self.max_torque)
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3 * self.g / (2 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        t = state.t + 1
        done = t >= self.max_episode_steps
        new_state = EnvState(obs_state=torch.stack([newth, newthdot], dim=1), t=t)
        return new_state, self._obs(newth, newthdot), -cost, done


class Acrobot(_ClassicEnv):
    """Acrobot-v1 dynamics (two-link underactuated swing-up)."""

    max_episode_steps = 500
    reset_width = 4

    def __init__(self, *, device=None):
        self._setup(device)
        self.observation_space = Space(shape=(6,))
        self.action_space = Space(shape=(), n=3)
        self.dt = 0.2
        self.link_length_1 = 1.0
        self.link_length_2 = 1.0
        self.link_mass_1 = 1.0
        self.link_mass_2 = 1.0
        self.link_com_pos_1 = 0.5
        self.link_com_pos_2 = 0.5
        self.link_moi = 1.0
        self.max_vel_1 = 4 * math.pi
        self.max_vel_2 = 9 * math.pi

    def _obs(self, s):
        th1, th2, dth1, dth2 = s.unbind(1)
        return torch.stack([torch.cos(th1), torch.sin(th1), torch.cos(th2), torch.sin(th2), dth1, dth2], dim=1)

    def batch_reset_from(self, noise_rows: torch.Tensor):
        s = self._uniform(noise_rows, -0.1, 0.1)
        return self._fresh(s), self._obs(s)

    def _dynamics(self, y):
        """Derivative of the augmented state ``(th1, th2, dth1, dth2, a)``."""
        m1, m2 = self.link_mass_1, self.link_mass_2
        l1 = self.link_length_1
        lc1, lc2 = self.link_com_pos_1, self.link_com_pos_2
        I1 = I2 = self.link_moi
        g = 9.8
        th1, th2, dth1, dth2, a = y
        d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(th2)) + I1 + I2
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(th2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(th1 + th2 - math.pi / 2)
        phi1 = (
            -m2 * l1 * lc2 * dth2**2 * torch.sin(th2)
            - 2 * m2 * l1 * lc2 * dth2 * dth1 * torch.sin(th2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(th1 - math.pi / 2)
            + phi2
        )
        ddth2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dth1**2 * torch.sin(th2) - phi2) / (m2 * lc2**2 + I2 - d2**2 / d1)
        ddth1 = -(d2 * ddth2 + phi1) / d1
        return (dth1, dth2, ddth1, ddth2, torch.zeros_like(a))

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        B = state.obs_state.shape[0]
        torque = actions.reshape(B).to(torch.int32).to(torch.float32) - 1.0  # {-1, 0, +1}
        y0 = (*state.obs_state.unbind(1), torque)
        dt = self.dt

        def shifted(h, k):
            return tuple(yi + h * ki for yi, ki in zip(y0, k))

        # rk4 integration over dt
        k1 = self._dynamics(y0)
        k2 = self._dynamics(shifted(dt / 2, k1))
        k3 = self._dynamics(shifted(dt / 2, k2))
        k4 = self._dynamics(shifted(dt, k3))
        ns = [yi + dt / 6 * (a + 2 * b + 2 * c + d) for yi, a, b, c, d in zip(y0, k1, k2, k3, k4)]
        th1 = ((ns[0] + math.pi) % (2 * math.pi)) - math.pi
        th2 = ((ns[1] + math.pi) % (2 * math.pi)) - math.pi
        dth1 = torch.clamp(ns[2], -self.max_vel_1, self.max_vel_1)
        dth2 = torch.clamp(ns[3], -self.max_vel_2, self.max_vel_2)
        s = torch.stack([th1, th2, dth1, dth2], dim=1)
        t = state.t + 1
        solved = -torch.cos(th1) - torch.cos(th2 + th1) > 1.0
        done = solved | (t >= self.max_episode_steps)
        reward = torch.where(solved, 0.0, -1.0).to(torch.float32)
        return EnvState(obs_state=s, t=t), self._obs(s), reward, done


class MountainCarContinuous(_ClassicEnv):
    """MountainCarContinuous-v0 dynamics."""

    max_episode_steps = 999
    reset_width = 1

    def __init__(self, *, device=None):
        self._setup(device)
        self.observation_space = Space(shape=(2,))
        self.action_space = self._box([-1.0], [1.0])
        self.min_position = -1.2
        self.max_position = 0.6
        self.max_speed = 0.07
        self.goal_position = 0.45
        self.power = 0.0015

    def batch_reset_from(self, noise_rows: torch.Tensor):
        position = self._uniform(noise_rows[:, 0], -0.6, -0.4)
        s = torch.stack([position, torch.zeros_like(position)], dim=1)
        return self._fresh(s), s

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        position, velocity = state.obs_state.unbind(1)
        force = torch.clamp(actions.reshape(position.shape[0]), -1.0, 1.0)
        velocity = velocity + force * self.power - 0.0025 * torch.cos(3 * position)
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(position + velocity, self.min_position, self.max_position)
        velocity = torch.where((position <= self.min_position) & (velocity < 0), 0.0, velocity)
        s = torch.stack([position, velocity], dim=1)
        t = state.t + 1
        goal = position >= self.goal_position
        done = goal | (t >= self.max_episode_steps)
        reward = torch.where(goal, 100.0, 0.0) - 0.1 * force**2
        return EnvState(obs_state=s, t=t), s, reward, done


class Swimmer2D(_ClassicEnv):
    """A light n-link planar swimmer: a chain of links in a viscous fluid,
    rewarded for the forward velocity of its head."""

    max_episode_steps = 1000

    def __init__(self, n_links: int = 3, *, device=None):
        self._setup(device)
        self.n_links = int(n_links)
        self.reset_width = self.n_links
        # obs: link angles (n), angular velocities (n), head velocity (2)
        self.observation_space = Space(shape=(2 * self.n_links + 2,))
        n_act = self.n_links - 1
        self.action_space = self._box([-1.0] * n_act, [1.0] * n_act)
        self.dt = 0.04
        self.viscosity = 0.1
        self.torque_scale = 1.0

    def batch_reset_from(self, noise_rows: torch.Tensor):
        angles = self._uniform(noise_rows, -0.1, 0.1)
        B, n = angles.shape
        s = torch.cat([angles, torch.zeros((B, n + 2), device=angles.device)], dim=1)
        return self._fresh(s), s

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        n = self.n_links
        s = state.obs_state
        B = s.shape[0]
        angles, omega, head_vel = s[:, :n], s[:, n : 2 * n], s[:, 2 * n :]
        torque = self.torque_scale * torch.clamp(actions.reshape(B, n - 1), -1.0, 1.0)
        # joint torques act on adjacent links with opposite signs
        joint_torque = F.pad(torque, (0, 1)) + F.pad(-torque, (1, 0))
        # viscous drag opposes angular velocity; lateral drag on each link
        # couples into forward thrust when links oscillate out of phase
        alpha = joint_torque - self.viscosity * 30.0 * omega
        omega = omega + self.dt * alpha
        angles = angles + self.dt * omega
        lateral = torch.sin(angles) * omega
        thrust = torch.sum(lateral * torch.cos(angles), dim=1) / n
        head_vel = 0.9 * head_vel + self.dt * torch.stack([torch.abs(thrust), thrust], dim=1)
        s = torch.cat([angles, omega, head_vel], dim=1)
        t = state.t + 1
        reward = head_vel[:, 0] - 0.0001 * torch.sum(torque**2, dim=1)
        done = t >= self.max_episode_steps
        return EnvState(obs_state=s, t=t), s, reward, done
