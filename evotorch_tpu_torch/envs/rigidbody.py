"""Maximal-coordinates rigid-body dynamics, population-batched (counterpart
of the batched path of ``evotorch_tpu/envs/rigidbody.py``).

Every body carries position, quaternion ``(w, x, y, z)``, linear and angular
velocity; joints are stiff spring-dampers, ground contact is a penalty
model with clamped viscous friction. State arrays keep the JAX package's
population-minor layout ``(n_bodies, components, B)``: the population is
the fastest axis, so every elementwise op reads and writes it coalesced on
the card. Body gathers are ``index_select`` over the first axis and the
per-body force scatters are one small matrix product with a one-hot matrix
the builder makes once.

Only the batched path is ported; ``SystemBuilder`` is the JAX package's
numpy builder, copied, producing tensors on the requested device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BodyState",
    "System",
    "SystemBuilder",
    "capsule_inertia",
    "joint_angles_batched",
    "joint_velocities_batched",
    "physics_step_batched",
    "physics_substep_batched",
    "sphere_inertia",
    "sphere_penetrations_batched",
]


class BodyState(NamedTuple):
    """Dynamic state of all bodies of B instances: ``(nb, comp, B)`` tensors."""

    pos: torch.Tensor  # (nb, 3, B) world COM positions
    quat: torch.Tensor  # (nb, 4, B) world orientations (w, x, y, z)
    vel: torch.Tensor  # (nb, 3, B) world linear velocities
    ang: torch.Tensor  # (nb, 3, B) world angular velocities


class System(NamedTuple):
    """Static model description; the fields of the JAX package's ``System``,
    as tensors on one device (index fields as int64 tensors), plus the
    one-hot scatter matrices the batched step uses."""

    mass: torch.Tensor  # (nb,)
    inertia: torch.Tensor  # (nb, 3) diagonal body-frame inertia
    joint_parent: torch.Tensor  # (nj,) int64
    joint_child: torch.Tensor  # (nj,) int64
    anchor_p: torch.Tensor  # (nj, 3) anchor in parent body frame
    anchor_c: torch.Tensor  # (nj, 3) anchor in child body frame
    axes: torch.Tensor  # (nj, 3, 3) joint axes (rows) in parent body frame
    free: torch.Tensor  # (nj, 3) 1.0 where the axis is a free DOF
    limit_lo: torch.Tensor  # (nj, 3)
    limit_hi: torch.Tensor  # (nj, 3)
    gear: torch.Tensor  # (nj, 3) actuator torque limit per free axis
    act_index: torch.Tensor  # (nj, 3) int64, num_act for unactuated axes
    num_act: int
    act_mode: str  # "torque" or "position" (PD servo to a target angle)
    act_kp: torch.Tensor  # (nj, 3)
    act_kd: torch.Tensor  # (nj, 3)
    sph_body: torch.Tensor  # (ns,) int64
    sph_offset: torch.Tensor  # (ns, 3) in body frame
    sph_radius: torch.Tensor  # (ns,)
    pos_k: torch.Tensor  # (nj,)
    pos_c: torch.Tensor  # (nj,)
    ang_k: torch.Tensor  # (nj, 3)
    ang_c: torch.Tensor  # (nj, 3)
    limit_k: torch.Tensor  # (nj, 3)
    tone_k: torch.Tensor  # (nj, 3)
    joint_damping: torch.Tensor  # (nj, 3)
    gravity: torch.Tensor  # (3,)
    contact_k: float
    contact_c: float
    friction_mu: float
    tangent_damping: float
    max_vel: float
    max_ang: float
    # one-hot scatter matrices (not in the JAX System, which builds them as
    # trace-time constants): child, parent and sphere body selections
    child_hot: torch.Tensor  # (nj, nb)
    parent_hot: torch.Tensor  # (nj, nb)
    sph_hot: torch.Tensor  # (ns, nb)

    @property
    def num_bodies(self) -> int:
        return int(self.mass.shape[0])

    @property
    def num_joints(self) -> int:
        return int(self.anchor_p.shape[0])


# -- batched quaternion and matrix helpers: component axis -2, population last --


def _bcross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the component axis -2 (``(..., 3, B)``)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack((a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-2)


def _bquat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :], a[..., 3, :]
    bw, bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    return torch.stack(
        (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ),
        dim=-2,
    )


def _bquat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat((q[..., :1, :], -q[..., 1:, :]), dim=-2)


def _bquat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qw = q[..., :1, :]
    qv = q[..., 1:, :]
    t = 2.0 * _bcross(qv, v)
    return v + qw * t + _bcross(qv, t)


def _bquat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _bquat_rotate(_bquat_conj(q), v)


def _bquat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    q = torch.where(q[..., :1, :] < 0.0, -q, q)  # shortest rotation
    w = q[..., 0, :]
    xyz = q[..., 1:, :]
    s = torch.sqrt(torch.sum(xyz * xyz, dim=-2))
    angle = 2.0 * torch.atan2(s, w)
    scale = torch.where(s < 1e-7, 2.0, angle / torch.clamp(s, min=1e-12))
    return xyz * scale[..., None, :]


def _bquat_integrate(q: torch.Tensor, omega_world: torch.Tensor, h: float) -> torch.Tensor:
    omega_q = torch.cat((torch.zeros_like(omega_world[..., :1, :]), omega_world), dim=-2)
    q_new = q + 0.5 * h * _bquat_mul(omega_q, q)
    return q_new / torch.sqrt(torch.sum(q_new * q_new, dim=-2, keepdim=True))


def _bquat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3, B)`` from quaternions ``(..., 4, B)``."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r0 = torch.stack((1.0 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)), dim=-2)
    r1 = torch.stack((2 * (xy + wz), 1.0 - 2 * (xx + zz), 2 * (yz - wx)), dim=-2)
    r2 = torch.stack((2 * (xz - wy), 2 * (yz + wx), 1.0 - 2 * (xx + yy)), dim=-2)
    return torch.stack((r0, r1, r2), dim=-3)


def _bmat_rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 3, 3, B)`` rotations to ``(..., 3, B)`` vectors."""
    return torch.sum(R * v[..., None, :, :], dim=-2)


def _bmat_rotate_inv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the transposed (inverse) rotations."""
    return torch.sum(R * v[..., :, None, :], dim=-3)


def _scatter_bodies(hot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Accumulate per-joint/per-sphere wrenches ``(nj, 3, B)`` onto bodies
    ``(nb, 3, B)``: one ``(nb, nj) x (nj, 3B)`` product."""
    return (hot.t() @ v.reshape(v.shape[0], -1)).reshape(hot.shape[1], *v.shape[1:])


def _on_axes(axes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("jak,jkB->jaB")``: components of ``v`` along each joint's axes."""
    return torch.bmm(axes, v)


def _joint_forces_batched(sys: System, st: BodyState, actions: torch.Tensor, R: torch.Tensor):
    """Constraint + limit + actuation wrenches of every joint; state
    ``(nb, comp, B)``, actions ``(num_act, B)``, ``R`` the per-body rotation
    matrices. Returns force and torque accumulators ``(nb, 3, B)``."""
    p, c = sys.joint_parent, sys.joint_child
    pq, cq = st.quat[p], st.quat[c]
    Rp, Rc = R[p], R[c]
    pp, cp = st.pos[p], st.pos[c]
    pv, cv = st.vel[p], st.vel[c]
    pw, cw = st.ang[p], st.ang[c]

    # positional constraint: pull the two anchor points together
    ra = _bmat_rotate(Rp, sys.anchor_p[:, :, None])
    rb = _bmat_rotate(Rc, sys.anchor_c[:, :, None])
    err = (cp + rb) - (pp + ra)
    verr = (cv + _bcross(cw, rb)) - (pv + _bcross(pw, ra))
    fj = -sys.pos_k[:, None, None] * err - sys.pos_c[:, None, None] * verr

    inc = sys.child_hot - sys.parent_hot  # force on child, reaction on parent
    f = _scatter_bodies(inc, fj)
    tau = _scatter_bodies(sys.child_hot, _bcross(rb, fj)) - _scatter_bodies(sys.parent_hot, _bcross(ra, fj))

    # angular: relative rotation decomposed onto the joint axes
    q_rel = _bquat_mul(_bquat_conj(pq), cq)
    phi = _bquat_to_rotvec(q_rel)
    w_rel = _bmat_rotate_inv(Rp, cw - pw)
    phi_comp = _on_axes(sys.axes, phi)
    w_comp = _on_axes(sys.axes, w_rel)

    limit_hi = sys.limit_hi[:, :, None]
    limit_lo = sys.limit_lo[:, :, None]
    gear = sys.gear[:, :, None]
    over = torch.clamp(phi_comp - limit_hi, min=0.0)
    under = torch.clamp(limit_lo - phi_comp, min=0.0)
    act = torch.cat((actions, torch.zeros_like(actions[:1])), dim=0)
    drive = act[sys.act_index]  # (nj, 3, B); 0 for unactuated axes
    actuated = (gear > 0.0).to(st.pos.dtype)
    if sys.act_mode == "position":
        target = torch.where(drive >= 0.0, drive * limit_hi, -drive * limit_lo)
        pd = sys.act_kp[:, :, None] * (target - phi_comp) - sys.act_kd[:, :, None] * w_comp
        act_torque = actuated * torch.clamp(pd, -gear, gear)
    else:
        act_torque = gear * drive
    free = sys.free[:, :, None]
    locked = 1.0 - free
    comp_torque = locked * (-sys.ang_k[:, :, None] * phi_comp - sys.ang_c[:, :, None] * w_comp) + free * (
        sys.limit_k[:, :, None] * (under - over)
        - sys.tone_k[:, :, None] * phi_comp
        - sys.joint_damping[:, :, None] * w_comp
        + act_torque
    )
    tau_j = torch.bmm(sys.axes.transpose(1, 2), comp_torque)  # einsum("jak,jaB->jkB")
    tau_w = _bmat_rotate(Rp, tau_j)  # parent frame -> world
    return f, tau + _scatter_bodies(inc, tau_w)


def _contact_forces_batched(sys: System, st: BodyState, R: torch.Tensor):
    """Sphere-vs-ground penalty contacts with clamped viscous friction."""
    b = sys.sph_body
    r_off = _bmat_rotate(R[b], sys.sph_offset[:, :, None])
    pen = sys.sph_radius[:, None] - (st.pos[b][..., 2, :] + r_off[..., 2, :])
    in_contact = pen > 0.0

    # lever arm to the lowest point of each sphere (offset minus radius * e_z)
    rel = torch.stack((r_off[:, 0], r_off[:, 1], r_off[:, 2] - sys.sph_radius[:, None]), dim=1)
    vc = st.vel[b] + _bcross(st.ang[b], rel)

    fn = torch.clamp(sys.contact_k * pen - sys.contact_c * vc[..., 2, :], min=0.0)
    fn = torch.where(in_contact, fn, 0.0)

    # clamped viscous friction on the tangential slip: viscous at small slip,
    # Coulomb cap mu * N above
    vt_norm = torch.sqrt(vc[..., 0, :] ** 2 + vc[..., 1, :] ** 2)
    ft_mag = torch.minimum(sys.friction_mu * fn, sys.tangent_damping * vt_norm)
    ft_scale = ft_mag / torch.clamp(vt_norm, min=1e-6)
    fc = torch.stack((-vc[..., 0, :] * ft_scale, -vc[..., 1, :] * ft_scale, fn), dim=-2)

    f = _scatter_bodies(sys.sph_hot, fc)
    tau = _scatter_bodies(sys.sph_hot, _bcross(rel, fc))
    return f, tau


def physics_substep_batched(sys: System, st: BodyState, actions: torch.Tensor, h: float) -> BodyState:
    """One semi-implicit Euler substep for a population: ``st`` tensors
    ``(nb, comp, B)``, ``actions`` ``(num_act, B)``."""
    R = _bquat_to_mat(st.quat)  # built once, shared by every rotation below
    fj, tj = _joint_forces_batched(sys, st, actions, R)
    fc, tc = _contact_forces_batched(sys, st, R)
    mass = sys.mass[:, None, None]
    f = fj + fc + mass * sys.gravity[None, :, None]
    tau = tj + tc

    vel = st.vel + h * f / mass
    # angular update in the body frame, where the inertia is diagonal
    inertia = sys.inertia[:, :, None]
    w_body = _bmat_rotate_inv(R, st.ang)
    tau_body = _bmat_rotate_inv(R, tau)
    w_body = w_body + h * (tau_body - _bcross(w_body, inertia * w_body)) / inertia
    ang = _bmat_rotate(R, w_body)

    # stability clamps
    vel = torch.clamp(vel, -sys.max_vel, sys.max_vel)
    ang = torch.clamp(ang, -sys.max_ang, sys.max_ang)

    pos = st.pos + h * vel
    quat = _bquat_integrate(st.quat, ang, h)
    return BodyState(pos=pos, quat=quat, vel=vel, ang=ang)


def physics_step_batched(sys: System, st: BodyState, actions: torch.Tensor, dt: float, substeps: int) -> BodyState:
    """One control step = ``substeps`` substeps with the action held."""
    h = dt / substeps
    for _ in range(int(substeps)):
        st = physics_substep_batched(sys, st, actions, h)
    return st


# -- measurements ----------------------------------------------------------------


def joint_angles_batched(sys: System, st: BodyState) -> torch.Tensor:
    """Rotation of each joint decomposed onto its axes, ``(nj, 3, B)``."""
    pq = st.quat[sys.joint_parent]
    cq = st.quat[sys.joint_child]
    return _on_axes(sys.axes, _bquat_to_rotvec(_bquat_mul(_bquat_conj(pq), cq)))


def joint_velocities_batched(sys: System, st: BodyState) -> torch.Tensor:
    """Relative angular velocity of each joint on its axes, ``(nj, 3, B)``."""
    p, c = sys.joint_parent, sys.joint_child
    return _on_axes(sys.axes, _bquat_rotate_inv(st.quat[p], st.ang[c] - st.ang[p]))


def sphere_penetrations_batched(sys: System, st: BodyState) -> torch.Tensor:
    """Ground penetration depth per collider sphere (``(ns, B)``, >= 0)."""
    b = sys.sph_body
    r_off = _bquat_rotate(st.quat[b], sys.sph_offset[:, :, None])
    center_z = st.pos[b][..., 2, :] + r_off[..., 2, :]
    return torch.clamp(sys.sph_radius[:, None] - center_z, min=0.0)


# -- inertia helpers + builder (numpy, as in the JAX package) ----------------------


def capsule_inertia(mass: float, radius: float, length: float, axis: str) -> np.ndarray:
    """Diagonal inertia of a capsule approximated as a solid cylinder of the
    same total length, aligned with ``axis`` in {'x','y','z'}."""
    i_axis = 0.5 * mass * radius**2
    i_perp = mass * (3.0 * radius**2 + length**2) / 12.0
    diag = {"x": (i_axis, i_perp, i_perp), "y": (i_perp, i_axis, i_perp), "z": (i_perp, i_perp, i_axis)}
    return np.asarray(diag[axis], dtype=np.float64)


def sphere_inertia(mass: float, radius: float) -> np.ndarray:
    """Diagonal inertia of a solid sphere."""
    i = 0.4 * mass * radius**2
    return np.asarray([i, i, i], dtype=np.float64)


class SystemBuilder:
    """Incrementally assemble a :class:`System` in the reference pose
    (all body frames axis-aligned with the world). Bodies are declared with
    world COM positions, joints with world anchors and axes; per-joint gains
    follow from target constraint frequencies and the reduced mass/inertia
    of each body pair, as in the JAX package's builder."""

    def __init__(
        self,
        *,
        gravity: float = -9.81,
        omega_pos: float = 250.0,
        omega_ang: float = 150.0,
        zeta: float = 1.0,
        limit_gain: float = 4.0,
        tone_ratio: float = 0.1,
        free_damping_ratio: float = 0.1,
        contact_k: float = 20_000.0,
        contact_c: float = 60.0,
        friction_mu: float = 1.0,
        tangent_damping: float = 400.0,
        max_vel: float = 50.0,
        max_ang: float = 40.0,
        act_mode: str = "torque",
        act_kp_ratio: float = 1.0,
        act_kd_ratio: float = 1.0,
    ):
        if act_mode not in ("torque", "position"):
            raise ValueError(f"act_mode must be 'torque' or 'position', got {act_mode!r}")
        self._params = dict(
            gravity=np.asarray([0.0, 0.0, gravity]),
            omega_pos=omega_pos,
            omega_ang=omega_ang,
            zeta=zeta,
            limit_gain=limit_gain,
            tone_ratio=tone_ratio,
            free_damping_ratio=free_damping_ratio,
            contact_k=contact_k,
            contact_c=contact_c,
            friction_mu=friction_mu,
            tangent_damping=tangent_damping,
            max_vel=max_vel,
            max_ang=max_ang,
            act_mode=act_mode,
            act_kp_ratio=act_kp_ratio,
            act_kd_ratio=act_kd_ratio,
        )
        self._names: List[str] = []
        self._pos: List[np.ndarray] = []
        self._mass: List[float] = []
        self._inertia: List[np.ndarray] = []
        self._joints: List[dict] = []
        self._spheres: List[Tuple[int, np.ndarray, float]] = []

    def add_body(self, name: str, pos, mass: float, inertia) -> int:
        idx = len(self._names)
        self._names.append(name)
        self._pos.append(np.asarray(pos, dtype=np.float64))
        self._mass.append(float(mass))
        self._inertia.append(np.asarray(inertia, dtype=np.float64))
        return idx

    def body_index(self, name: str) -> int:
        return self._names.index(name)

    @property
    def body_positions(self) -> np.ndarray:
        """World COM positions of the bodies declared so far, ``(nb, 3)``."""
        return np.stack(self._pos)

    def add_joint(
        self,
        parent: str,
        child: str,
        world_anchor,
        *,
        free_axes: Sequence[str],
        limits: Sequence[Tuple[float, float]],
        gears: Sequence[float],
        axes: Optional[np.ndarray] = None,
        tone: Optional[float] = None,
    ):
        """``free_axes`` names rows of ``axes`` (default the world x/y/z)
        that are free DOF, in action order; ``limits``/``gears`` align with
        them. ``tone`` (Nm/rad) replaces the default passive spring toward
        the reference pose (``tone_ratio`` times the joint's angular
        stiffness) on this joint's free axes."""
        if not (len(free_axes) == len(limits) == len(gears)):
            raise ValueError(
                f"free_axes/limits/gears must align: got {len(free_axes)}/"
                f"{len(limits)}/{len(gears)} for joint {parent}->{child}"
            )
        p = self.body_index(parent)
        c = self.body_index(child)
        anchor = np.asarray(world_anchor, dtype=np.float64)
        axes = np.eye(3) if axes is None else np.asarray(axes, dtype=np.float64)
        name_to_row = {"x": 0, "y": 1, "z": 2}
        free, lo, hi, gear = np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3)
        order = []
        for ax_name, (l, u), g in zip(free_axes, limits, gears):
            row = name_to_row[ax_name]
            free[row] = 1.0
            lo[row], hi[row] = float(l), float(u)
            gear[row] = float(g)
            order.append(row)
        self._joints.append(
            dict(
                parent=p,
                child=c,
                anchor_p=anchor - self._pos[p],
                anchor_c=anchor - self._pos[c],
                axes=axes,
                free=free,
                lo=lo,
                hi=hi,
                gear=gear,
                order=order,
                tone=tone,
            )
        )

    def add_sphere(self, body: str, world_center, radius: float):
        b = self.body_index(body)
        center = np.asarray(world_center, dtype=np.float64)
        self._spheres.append((b, center - self._pos[b], float(radius)))

    def build(self, device) -> Tuple[System, torch.Tensor]:
        """Returns ``(system, default_pose_positions)`` on ``device``; action
        indices are assigned in joint declaration order, then per-joint axis
        order."""

        def stack(key_or_rows, shape):
            rows = [s[key_or_rows] for s in self._joints] if isinstance(key_or_rows, str) else key_or_rows
            if not rows:
                return np.zeros((0,) + shape)
            return np.stack(rows)

        nj = len(self._joints)
        act_index = np.full((nj, 3), -1, dtype=np.int64)
        n_act = 0
        for j, spec in enumerate(self._joints):
            for row in spec["order"]:
                act_index[j, row] = n_act
                n_act += 1
        act_index[act_index < 0] = n_act  # points at the appended zero action

        masses = np.asarray(self._mass)
        i_mean = np.stack(self._inertia).mean(axis=1)
        jp = np.asarray([s["parent"] for s in self._joints], dtype=np.int64)
        jc = np.asarray([s["child"] for s in self._joints], dtype=np.int64)
        # constraint-space effective mass, lever arms included (r^2 / I)
        r_p2 = np.sum(stack("anchor_p", (3,)) ** 2, axis=1)
        r_c2 = np.sum(stack("anchor_c", (3,)) ** 2, axis=1)
        inv_m_eff = 1.0 / masses[jp] + 1.0 / masses[jc] + r_p2 / i_mean[jp] + r_c2 / i_mean[jc]
        m_eff = 1.0 / inv_m_eff
        inertias = np.stack(self._inertia)
        i_red = inertias[jp] * inertias[jc] / (inertias[jp] + inertias[jc])  # (nj, 3)
        P = self._params
        pos_k = P["omega_pos"] ** 2 * m_eff
        pos_c = 2.0 * P["zeta"] * P["omega_pos"] * m_eff
        ang_k = P["omega_ang"] ** 2 * i_red
        ang_c = 2.0 * P["zeta"] * P["omega_ang"] * i_red
        tone_k = [P["tone_ratio"] * k if s["tone"] is None else np.full(3, s["tone"]) for k, s in zip(ang_k, self._joints)]
        sph_body = np.asarray([s[0] for s in self._spheres], dtype=np.int64)
        nb = len(self._names)
        eye = np.eye(nb, dtype=np.float32)

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

        def i64(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)

        sys = System(
            mass=f32(self._mass),
            inertia=f32(inertias),
            joint_parent=i64(jp),
            joint_child=i64(jc),
            anchor_p=f32(stack("anchor_p", (3,))),
            anchor_c=f32(stack("anchor_c", (3,))),
            axes=f32(stack("axes", (3, 3))),
            free=f32(stack("free", (3,))),
            limit_lo=f32(stack("lo", (3,))),
            limit_hi=f32(stack("hi", (3,))),
            gear=f32(stack("gear", (3,))),
            act_index=i64(act_index),
            num_act=n_act,
            act_mode=P["act_mode"],
            act_kp=f32(P["act_kp_ratio"] * ang_k),
            act_kd=f32(P["act_kd_ratio"] * ang_c),
            sph_body=i64(sph_body),
            sph_offset=f32(stack([s[1] for s in self._spheres], (3,))),
            sph_radius=f32([s[2] for s in self._spheres]),
            pos_k=f32(pos_k),
            pos_c=f32(pos_c),
            ang_k=f32(ang_k),
            ang_c=f32(ang_c),
            limit_k=f32(P["limit_gain"] * ang_k),
            tone_k=f32(stack(tone_k, (3,))),
            joint_damping=f32(P["free_damping_ratio"] * ang_c),
            gravity=f32(P["gravity"]),
            contact_k=P["contact_k"],
            contact_c=P["contact_c"],
            friction_mu=P["friction_mu"],
            tangent_damping=P["tangent_damping"],
            max_vel=P["max_vel"],
            max_ang=P["max_ang"],
            child_hot=f32(eye[jc]),
            parent_hot=f32(eye[jp]),
            sph_hot=f32(eye[sph_body]),
        )
        return sys, f32(self.body_positions)
