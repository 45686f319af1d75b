"""HalfCheetah: planar galloper on the rigid-body engine (counterpart of
``evotorch_tpu/envs/halfcheetah.py``): a long horizontal torso with a back
and a front leg of thigh, shin and foot, 7 bodies and 6 actuated DOF about
y. The task is planar and never terminates: the episode runs its full
length, and the reward is ``forward_velocity - ctrl_cost``
(``HalfCheetah-v4``: no alive bonus, no healthy band). The body plan below
is the JAX package's, value for value.
"""

from __future__ import annotations

import math

from .._device import resolve_device
from .locomotion import RigidBodyLocomotionEnv
from .rigidbody import SystemBuilder, capsule_inertia

__all__ = ["HalfCheetah"]


def _build_halfcheetah(device, act_mode: str = "position"):
    b = SystemBuilder(
        omega_pos=200.0,
        omega_ang=200.0,
        zeta=1.0,
        limit_gain=4.0,
        tone_ratio=0.1,
        free_damping_ratio=0.1,
        contact_k=15_000.0,
        # near-critical contact damping: underdamped feet micro-bounce, and
        # the bounce rectifies through friction into a zero-action glide
        contact_c=600.0,
        friction_mu=1.0,
        tangent_damping=300.0,
        act_mode=act_mode,
        act_kp_ratio=2.0,
    )

    # bodies (x forward, z up): a 1.0 m torso at hip height, a back leg at
    # its rear and a front leg at its nose, each thigh 0.29 / shin 0.26 /
    # foot; ~14 kg in all
    z0 = 0.60
    b.add_body("torso", (0, 0, z0), 6.4, capsule_inertia(6.4, 0.046, 1.0, "x"))
    for part, px in (("back", -0.5), ("front", 0.5)):
        b.add_body(f"{part}_thigh", (px, 0, z0 - 0.145), 1.5, capsule_inertia(1.5, 0.045, 0.29, "z"))
        b.add_body(f"{part}_shin", (px, 0, z0 - 0.42), 1.2, capsule_inertia(1.2, 0.04, 0.26, "z"))
        b.add_body(f"{part}_foot", (px, 0, z0 - 0.52), 0.9, capsule_inertia(0.9, 0.04, 0.16, "x"))

    # joints, all about y; action layout:
    #   0 back_hip, 1 back_knee, 2 back_ankle, 3 front_hip, 4 front_knee, 5 front_ankle
    for part, px, hip, knee, ankle in (
        ("back", -0.5, (-0.6, 1.0), (-1.2, 0.8), (-0.5, 0.8)),
        ("front", 0.5, (-1.0, 0.7), (-1.1, 0.8), (-0.5, 0.5)),
    ):
        b.add_joint("torso", f"{part}_thigh", (px, 0, z0), free_axes=("y",), limits=[hip], gears=(90.0,))
        b.add_joint(f"{part}_thigh", f"{part}_shin", (px, 0, z0 - 0.29), free_axes=("y",), limits=[knee], gears=(60.0,))
        b.add_joint(f"{part}_shin", f"{part}_foot", (px, 0, z0 - 0.55), free_axes=("y",), limits=[ankle], gears=(30.0,))

    # colliders: heel and toe of each foot first (observed contacts), then
    # the torso's ends
    for part, px in (("back", -0.5), ("front", 0.5)):
        b.add_sphere(f"{part}_foot", (px - 0.055, 0, z0 - 0.55), 0.046)  # heel
        b.add_sphere(f"{part}_foot", (px + 0.055, 0, z0 - 0.55), 0.046)  # toe
    b.add_sphere("torso", (-0.5, 0, z0), 0.046)
    b.add_sphere("torso", (0.55, 0, z0 + 0.05), 0.046)  # head
    return b.build(device)


class HalfCheetah(RigidBodyLocomotionEnv):
    """Planar cheetah with ``HalfCheetah-v4``'s semantics. The constants
    live on ``device`` (``cuda`` unless ``device="cpu"``)."""

    planar = True
    n_contact_obs = 4
    # never terminates: no healthy band (every height is healthy) and, with
    # ``alive_bonus = 0``, the base class's reward is ``forward_velocity -
    # ctrl_cost`` on the card and on the CPU alike
    healthy_z_range = (-math.inf, math.inf)

    def __init__(
        self,
        *,
        forward_reward_weight: float = 1.0,
        ctrl_cost_weight: float = 0.1,
        reset_noise_scale: float = 0.005,
        act_mode: str = "position",
        dt: float = 0.015,
        substeps: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sys, self._default_pos = _build_halfcheetah(self.device, act_mode)
        self.dt = float(dt)
        self.substeps = int(substeps)
        self.forward_reward_weight = forward_reward_weight
        self.alive_bonus = 0.0
        self.ctrl_cost_weight = ctrl_cost_weight
        self.reset_noise_scale = reset_noise_scale
        self._finalize_spaces()
