"""Planar SLIP hopper (counterpart of ``evotorch_tpu/envs/hopper.py``): a
spring-loaded inverted pendulum monopod, with hybrid dynamics (ballistic
flight, compliant stance, touchdown and liftoff events).

Controls: the target leg angle in flight (foot placement) and the stance
thrust (spring precompression). Reward: forward velocity + 0.5 alive bonus
- control cost; the episode ends when the body falls.

The JAX package writes one env's step and vmaps it; here the step is
batched and population-minor: the state is ``(7, B)``, rows ``[x, z, vx,
vz, leg_angle, foot_x, in_stance]``, each a ``(B,)`` vector, and the
phases are elementwise masks (``torch.where``) over the population, as
``jnp.where`` switches them there.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .base import Env, EnvState, Space

__all__ = ["Hopper"]


class Hopper(Env):
    max_episode_steps = 1000
    state_lane_axis = -1

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self.observation_space = Space(shape=(7,))
        lb = torch.tensor([-1.0, 0.0], device=self.device)
        ub = torch.tensor([1.0, 1.0], device=self.device)
        self.action_space = Space(shape=(2,), lb=lb, ub=ub)
        self.g = 9.81
        self.m = 1.0  # body mass
        self.r0 = 1.0  # rest leg length
        self.k = 150.0  # spring stiffness
        self.dt = 0.02
        self.substeps = 4
        self.max_leg_angle = 0.5  # rad, from vertical
        self.max_thrust = 0.15  # max spring precompression (m)
        self.fall_height = 0.35

    def _obs(self, s: torch.Tensor) -> torch.Tensor:
        """``(7, B)`` state -> ``(B, 7)`` observation; the leg length is
        observable in stance."""
        x, z, vx, vz, theta, foot_x, stance = s.unbind(0)
        dx = x - foot_x
        r = torch.where(stance > 0.5, torch.sqrt(torch.clamp(dx * dx + z * z, min=1e-6)), self.r0)
        return torch.stack((z, vx, vz, theta, r, stance, torch.sin(theta)), dim=1)

    def reset_noise(self, num_items: int, generator: torch.Generator) -> torch.Tensor:
        """The perturbations of ``num_items`` resets, ``(num_items, 2)``:
        uniforms in ``[-0.05, 0.05)`` on the height and the forward speed,
        mapped from ``[0, 1)`` draws as ``jax.random.uniform`` maps them."""
        u = torch.rand((int(num_items), 2), generator=generator, device=generator.device).to(self.device)
        lo, hi = np.float32(-0.05), np.float32(0.05)
        return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))

    def batch_reset_from(self, noise_rows: torch.Tensor):
        B = noise_rows.shape[0]
        zeros = torch.zeros(B, device=self.device)
        s = torch.stack((zeros, 1.05 + noise_rows[:, 0], 0.0 + noise_rows[:, 1], zeros, zeros, zeros, zeros))
        return EnvState(obs_state=s, t=torch.zeros(B, dtype=torch.int32, device=self.device)), self._obs(s)

    def _substep(self, s: torch.Tensor, target_angle: torch.Tensor, thrust: torch.Tensor) -> torch.Tensor:
        x, z, vx, vz, theta, foot_x, stance = s.unbind(0)
        h = self.dt / self.substeps
        in_stance = stance > 0.5

        # flight: ballistic body, the leg servoing toward the target angle
        theta_flight = theta + torch.clamp(target_angle - theta, -8.0 * h, 8.0 * h)
        z_flight = z + h * vz
        x_flight = x + h * vx
        vz_flight = vz - h * self.g

        # touchdown, tested after the flight integration
        foot_height = z_flight - self.r0 * torch.cos(theta_flight)
        touchdown = ~in_stance & (foot_height <= 0.0) & (vz_flight < 0.0)
        new_foot_x = torch.where(touchdown, x_flight + self.r0 * torch.sin(theta_flight), foot_x)

        # stance: a unilateral spring along the leg (the ground only pushes)
        dx = x - new_foot_x
        r = torch.sqrt(torch.clamp(dx * dx + z * z, min=1e-6))
        rest = self.r0 + thrust
        spring_force = torch.clamp(self.k * (rest - r), min=0.0)
        ax = spring_force * (dx / r) / self.m
        az = spring_force * (z / r) / self.m - self.g
        vx_stance = vx + h * ax
        vz_stance = vz + h * az
        x_stance = x + h * vx_stance
        z_stance = z + h * vz_stance
        theta_stance = torch.atan2(new_foot_x - x_stance, z_stance)

        # liftoff: the leg reached its rest length
        lx = x_stance - new_foot_x
        r_new = torch.sqrt(torch.clamp(lx * lx + z_stance * z_stance, min=1e-6))
        liftoff = in_stance & (r_new >= rest)
        next_stance = torch.where(in_stance, ~liftoff, touchdown)

        def pick(a, b):
            return torch.where(in_stance, a, b)

        return torch.stack(
            (
                pick(x_stance, x_flight),
                pick(z_stance, z_flight),
                pick(vx_stance, vx),
                pick(vz_stance, vz_flight),
                pick(theta_stance, theta_flight),
                new_foot_x,
                next_stance.to(s.dtype),
            )
        )

    def batch_step(self, state: EnvState, actions: torch.Tensor):
        """Step ``B`` lanes: ``actions`` ``(B, 2)`` -> ``(B, 7)``
        observations, ``(B,)`` rewards and dones."""
        actions = torch.clamp(actions, self.action_space.lb, self.action_space.ub)
        target_angle = self.max_leg_angle * actions[:, 0]
        thrust = self.max_thrust * actions[:, 1]
        s = state.obs_state
        for _ in range(self.substeps):
            s = self._substep(s, target_angle, thrust)
        t = state.t + 1
        fallen = s[1] < self.fall_height
        done = fallen | (t >= self.max_episode_steps)
        reward = s[2] - 0.001 * torch.sum(actions * actions, dim=1) + 0.5  # forward speed + alive
        reward = torch.where(fallen, reward - 2.0, reward)
        return EnvState(obs_state=s, t=t), self._obs(s), reward, done

    def batch_where(self, mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
        return EnvState(obs_state=torch.where(mask, a.obs_state, b.obs_state), t=torch.where(mask, a.t, b.t))

    def batch_take(self, state: EnvState, idx: torch.Tensor) -> EnvState:
        return EnvState(obs_state=state.obs_state.index_select(-1, idx), t=state.t.index_select(0, idx))
