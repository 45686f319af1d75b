"""Humanoid: the flagship 3-D locomotion workload (counterpart of
``evotorch_tpu/envs/humanoid.py``): 11 rigid bodies, 10 joints carrying 17
actuated DOF, penalty ground contact on heel/toe/hand/pelvis/torso/head
spheres, and a 109-dim observation. The body plan below is the JAX
package's, value for value.
"""

from __future__ import annotations

from .._device import resolve_device
from .locomotion import RigidBodyLocomotionEnv
from .rigidbody import SystemBuilder, capsule_inertia

__all__ = ["Humanoid"]


def _build_humanoid(device, act_mode: str = "position"):
    b = SystemBuilder(
        omega_pos=250.0,
        omega_ang=200.0,
        zeta=1.0,
        limit_gain=4.0,
        tone_ratio=0.1,
        free_damping_ratio=0.1,
        contact_k=20_000.0,
        contact_c=350.0,
        friction_mu=1.0,
        tangent_damping=350.0,
        act_mode=act_mode,
    )

    # bodies: world COM positions in the standing reference pose
    # (x forward, y left, z up; ground at z=0)
    b.add_body("torso", (0, 0, 1.25), 8.3, capsule_inertia(8.3, 0.11, 0.30, "z"))
    b.add_body("lwaist", (0, 0, 1.05), 2.0, capsule_inertia(2.0, 0.11, 0.16, "z"))
    b.add_body("pelvis", (0, 0, 0.92), 6.0, capsule_inertia(6.0, 0.10, 0.26, "y"))
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.1 * sy
        b.add_body(f"{side}_thigh", (0, y, 0.63), 4.5, capsule_inertia(4.5, 0.06, 0.42, "z"))
        b.add_body(f"{side}_shin", (0, y, 0.25), 3.0, capsule_inertia(3.0, 0.05, 0.40, "z"))
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.17 * sy
        b.add_body(f"{side}_upper_arm", (0, y, 1.24), 1.6, capsule_inertia(1.6, 0.04, 0.28, "z"))
        b.add_body(f"{side}_lower_arm", (0, y, 0.98), 1.2, capsule_inertia(1.2, 0.035, 0.24, "z"))

    # joints: 17 actuated DOF; the free-axis order fixes the action layout
    #   0 abdomen_z, 1 abdomen_y, 2 abdomen_x,
    #   3 r_hip_x, 4 r_hip_z, 5 r_hip_y, 6 r_knee,
    #   7 l_hip_x, 8 l_hip_z, 9 l_hip_y, 10 l_knee,
    #   11 r_shoulder_x, 12 r_shoulder_y, 13 r_elbow,
    #   14 l_shoulder_x, 15 l_shoulder_y, 16 l_elbow
    b.add_joint(
        "torso", "lwaist", (0, 0, 1.13),
        free_axes=("z", "y"), limits=[(-0.79, 0.79), (-1.31, 0.52)], gears=(40.0, 40.0),
    )
    b.add_joint(
        "lwaist", "pelvis", (0, 0, 1.00),
        free_axes=("x",), limits=[(-0.61, 0.61)], gears=(40.0,),
    )
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.1 * sy
        hip_x = (-0.61, 0.17) if sy < 0 else (-0.17, 0.61)
        hip_z = (-1.05, 0.61) if sy < 0 else (-0.61, 1.05)
        b.add_joint(
            "pelvis", f"{side}_thigh", (0, y, 0.84),
            free_axes=("x", "z", "y"),
            limits=[hip_x, hip_z, (-1.92, 0.35)],
            gears=(40.0, 40.0, 120.0),
        )
        b.add_joint(
            f"{side}_thigh", f"{side}_shin", (0, y, 0.42),
            free_axes=("y",), limits=[(-0.05, 2.70)], gears=(80.0,),
        )
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.17 * sy
        sh_x = (-1.48, 1.05) if sy < 0 else (-1.05, 1.48)
        b.add_joint(
            "torso", f"{side}_upper_arm", (0, y, 1.38),
            free_axes=("x", "y"), limits=[sh_x, (-1.48, 1.05)], gears=(25.0, 25.0),
        )
        b.add_joint(
            f"{side}_upper_arm", f"{side}_lower_arm", (0, y, 1.10),
            free_axes=("y",), limits=[(-2.27, 0.05)], gears=(25.0,),
        )

    # colliders; the first four are the feet (heel + toe per side), whose
    # contact depths the observation exposes
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.1 * sy
        b.add_sphere(f"{side}_shin", (-0.08, y, 0.045), 0.045)  # heel
        b.add_sphere(f"{side}_shin", (0.15, y, 0.045), 0.045)  # toe
    b.add_sphere("right_lower_arm", (0, -0.17, 0.87), 0.05)  # hand
    b.add_sphere("left_lower_arm", (0, 0.17, 0.87), 0.05)
    b.add_sphere("pelvis", (0, 0, 0.92), 0.09)
    b.add_sphere("torso", (0, 0, 1.25), 0.11)
    b.add_sphere("torso", (0, 0, 1.50), 0.09)  # head

    return b.build(device)


class Humanoid(RigidBodyLocomotionEnv):
    """3-D humanoid locomotion. Action: 17 values in ``[-1, 1]``, PD servo
    targets with the default ``act_mode="position"`` or gear-scaled torques
    with ``"torque"``. Reward: ``1.25 * forward_velocity + 5.0 - 0.1 *
    ||action||^2`` while the torso stays in the healthy height band.

    The constants live on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(
        self,
        *,
        forward_reward_weight: float = 1.25,
        alive_bonus: float = 5.0,
        ctrl_cost_weight: float = 0.1,
        healthy_z_range=(0.85, 1.75),
        reset_noise_scale: float = 0.01,
        act_mode: str = "position",
        dt: float = 0.015,
        substeps: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sys, self._default_pos = _build_humanoid(self.device, act_mode)
        self.dt = float(dt)
        self.substeps = int(substeps)
        self.forward_reward_weight = forward_reward_weight
        self.alive_bonus = alive_bonus
        self.ctrl_cost_weight = ctrl_cost_weight
        self.healthy_z_range = healthy_z_range
        self.reset_noise_scale = reset_noise_scale
        self._finalize_spaces()
