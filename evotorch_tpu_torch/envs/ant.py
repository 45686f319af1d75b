"""Ant: quadruped locomotion on the rigid-body engine (counterpart of
``evotorch_tpu/envs/ant.py``): a torso sphere and four legs (upper link
horizontal along +x/+y/-x/-y, lower link dropping to a foot sphere), 9
bodies, 8 joints carrying 8 actuated DOF (per leg: hip swing about z, knee
lift about the horizontal axis across the leg), and a 79-dim observation.
The reward is ``Ant-v4``'s: forward velocity + alive bonus - control cost,
ending outside the healthy height band. The body plan below is the JAX
package's, value for value.
"""

from __future__ import annotations

from .._device import resolve_device
from .locomotion import RigidBodyLocomotionEnv
from .rigidbody import SystemBuilder, capsule_inertia, sphere_inertia

__all__ = ["Ant"]


def _build_ant(device, act_mode: str = "position"):
    b = SystemBuilder(
        omega_pos=200.0,
        omega_ang=200.0,
        zeta=1.0,
        limit_gain=4.0,
        tone_ratio=0.1,
        free_damping_ratio=0.1,
        contact_k=15_000.0,
        contact_c=300.0,
        friction_mu=1.0,
        tangent_damping=300.0,
        act_mode=act_mode,
        # stronger servos than the inertia-scaled default: the leg links are
        # light, so act_kp would otherwise lose to gravity torques
        act_kp_ratio=2.0,
    )

    # bodies: torso sphere + 4 legs, legs horizontal and lower legs vertical
    # in the reference pose (z up, ground at 0)
    z0 = 0.55
    b.add_body("torso", (0, 0, z0), 10.0, sphere_inertia(10.0, 0.25))
    dirs = {"front": (1.0, 0.0), "left": (0.0, 1.0), "back": (-1.0, 0.0), "right": (0.0, -1.0)}
    for name, (dx, dy) in dirs.items():
        horizontal = "x" if dx != 0.0 else "y"  # upper-leg long axis
        ux, uy = 0.425 * dx, 0.425 * dy  # upper-leg COM (hip at 0.25, length 0.35)
        b.add_body(f"{name}_upper", (ux, uy, z0), 1.5, capsule_inertia(1.5, 0.05, 0.35, horizontal))
        lx, ly = 0.6 * dx, 0.6 * dy  # the lower leg hangs from the knee at 0.6
        b.add_body(f"{name}_lower", (lx, ly, z0 - 0.21), 1.2, capsule_inertia(1.2, 0.04, 0.42, "z"))

    # joints: per leg, hip swing about z and knee lift about the horizontal
    # axis across the leg; a stiff passive tone supports the posture
    for name, (dx, dy) in dirs.items():
        lift_axis = "y" if dx != 0.0 else "x"
        b.add_joint(
            "torso", f"{name}_upper", (0.25 * dx, 0.25 * dy, z0),
            free_axes=("z",), limits=[(-0.6, 0.6)], gears=(40.0,), tone=40.0,
        )  # fmt: skip
        b.add_joint(
            f"{name}_upper", f"{name}_lower", (0.6 * dx, 0.6 * dy, z0),
            free_axes=(lift_axis,), limits=[(-0.9, 0.9)], gears=(60.0,), tone=40.0,
        )  # fmt: skip

    # colliders: the four feet first (their contact depths are observed),
    # then the torso
    for name, (dx, dy) in dirs.items():
        b.add_sphere(f"{name}_lower", (0.6 * dx, 0.6 * dy, z0 - 0.44), 0.08)
    b.add_sphere("torso", (0, 0, z0), 0.25)

    return b.build(device)


class Ant(RigidBodyLocomotionEnv):
    """Quadruped locomotion with ``Ant-v4``'s reward and DOF budget. The
    constants live on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(
        self,
        *,
        forward_reward_weight: float = 1.0,
        alive_bonus: float = 1.0,
        ctrl_cost_weight: float = 0.5,
        healthy_z_range=(0.2, 1.0),
        reset_noise_scale: float = 0.01,
        act_mode: str = "position",
        dt: float = 0.015,
        substeps: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sys, self._default_pos = _build_ant(self.device, act_mode)
        self.dt = float(dt)
        self.substeps = int(substeps)
        self.forward_reward_weight = forward_reward_weight
        self.alive_bonus = alive_bonus
        self.ctrl_cost_weight = ctrl_cost_weight
        self.healthy_z_range = healthy_z_range
        self.reset_noise_scale = reset_noise_scale
        self._finalize_spaces()
