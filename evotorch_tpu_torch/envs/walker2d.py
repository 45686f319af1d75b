"""Walker2D: planar biped locomotion on the rigid-body engine (counterpart
of ``evotorch_tpu/envs/walker2d.py``): a torso and two legs of thigh, shin
and foot, 7 bodies and 6 actuated DOF about y. The engine is 3-D; the task
sets ``planar = True``, which projects each control step back onto the x-z
plane. The reward is ``Walker2d-v4``'s: forward velocity + alive bonus -
control cost, ending outside the healthy height band ``(0.8, 2.0)``. The
body plan below is the JAX package's, value for value.
"""

from __future__ import annotations

from .._device import resolve_device
from .locomotion import RigidBodyLocomotionEnv
from .rigidbody import SystemBuilder, capsule_inertia

__all__ = ["Walker2D"]


def _build_walker(device, act_mode: str = "position"):
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
        act_kp_ratio=2.0,
    )

    # bodies (x forward, z up, ground 0): torso 0.4, thigh 0.45, shin 0.5,
    # foot 0.2 along x; the legs sit at y = +/-0.05 and the projection keeps
    # them in their plane
    b.add_body("torso", (0, 0, 1.25), 3.7, capsule_inertia(3.7, 0.07, 0.40, "z"))
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.05 * sy
        b.add_body(f"{side}_thigh", (0, y, 0.825), 4.0, capsule_inertia(4.0, 0.05, 0.45, "z"))
        b.add_body(f"{side}_shin", (0, y, 0.35), 2.7, capsule_inertia(2.7, 0.04, 0.50, "z"))
        b.add_body(f"{side}_foot", (0.06, y, 0.06), 3.2, capsule_inertia(3.2, 0.05, 0.20, "x"))

    # joints, all about y; action layout:
    #   0 r_hip, 1 r_knee, 2 r_ankle, 3 l_hip, 4 l_knee, 5 l_ankle
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.05 * sy
        b.add_joint("torso", f"{side}_thigh", (0, y, 1.05), free_axes=("y",), limits=[(-1.0, 1.2)], gears=(80.0,))
        b.add_joint(f"{side}_thigh", f"{side}_shin", (0, y, 0.60), free_axes=("y",), limits=[(-2.6, 0.05)], gears=(60.0,))
        b.add_joint(f"{side}_shin", f"{side}_foot", (0, y, 0.10), free_axes=("y",), limits=[(-0.8, 0.8)], gears=(30.0,))

    # colliders: heel and toe of each foot first (contact depths observed)
    for side, sy in (("right", -1.0), ("left", 1.0)):
        y = 0.05 * sy
        b.add_sphere(f"{side}_foot", (-0.03, y, 0.05), 0.05)  # heel
        b.add_sphere(f"{side}_foot", (0.16, y, 0.05), 0.05)  # toe
    b.add_sphere("torso", (0, 0, 1.25), 0.07)

    return b.build(device)


class Walker2D(RigidBodyLocomotionEnv):
    """Planar biped with ``Walker2d-v4``'s reward and DOF budget. The
    constants live on ``device`` (``cuda`` unless ``device="cpu"``)."""

    planar = True

    def __init__(
        self,
        *,
        forward_reward_weight: float = 1.0,
        alive_bonus: float = 1.0,
        ctrl_cost_weight: float = 0.001,
        healthy_z_range=(0.8, 2.0),
        reset_noise_scale: float = 0.005,
        act_mode: str = "position",
        dt: float = 0.015,
        substeps: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sys, self._default_pos = _build_walker(self.device, act_mode)
        self.dt = float(dt)
        self.substeps = int(substeps)
        self.forward_reward_weight = forward_reward_weight
        self.alive_bonus = alive_bonus
        self.ctrl_cost_weight = ctrl_cost_weight
        self.healthy_z_range = healthy_z_range
        self.reset_noise_scale = reset_noise_scale
        self._finalize_spaces()
