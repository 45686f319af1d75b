// One control step of the maximal-coordinates rigid-body physics on Hopper:
// `substeps` semi-implicit Euler substeps with the action held, for every
// lane of a population, in one launch. It computes exactly
// envs/rigidbody.py:physics_substep_batched repeated `substeps` times: the
// rotation matrices from the quaternions; the joint wrenches (positional
// spring-damper, the relative rotation as a rotation vector on the joint's
// axes, limits, the PD servo or torque actuation, the locked axes' springs);
// penalty sphere-ground contacts with clamped viscous friction; the scatters
// of both onto the bodies; the body-frame angular update; the velocity
// clamps; the position and quaternion integration with renormalisation.
// Same float32 and the same formulas, in another order, with no fast math:
// sqrtf, atan2f and IEEE division. It is built with -fmad=false
// (ops/_build.py's SOURCE_FLAGS): no multiply and add is contracted into an
// FMA, so each rounds on its own as in the plain loop's separate PyTorch
// kernels. The stiff joint springs carry the difference of one rounding
// through the 8 substeps: with contraction, one Humanoid control step from
// states a random policy drove into contact and joint limits differed from
// the plain loop on the card by up to 4.5e-3 (|x - x_plain| / max(1,
// |x_plain|), angular velocities), without it by up to 6.1e-4, against
// 3.6e-4 between the plain loop on the card and on the CPU (H100).
//
// Replaces no TPU kernel: the JAX package leaves this physics to XLA, which
// fuses each substep's elementwise chains on the TPU. Eagerly, the port
// issued ~300 small PyTorch launches a substep, ~2,400 a control step, and
// the host's launch path set the step's time.
//
// Bound on the H100: neither bytes nor flops. The state is read once and
// written once (13 floats a body, 11 bodies on the Humanoid: ~11 MB a step
// at 10,000 lanes, ~3.4 us at 3.35 TB/s) and the arithmetic is ~30-40k
// flops a lane a step (~0.4 GFLOP at 10,000 lanes, ~6 us at 67 TFLOP/s).
// What sets the time is the chain of dependent operations each lane runs
// in order: 8 substeps of joints, contacts and bodies, each reading the
// state the last one wrote. The kernel is latency-bound.
//
// Design:
// - One lane per thread. The state stays in the port's population-minor
//   layout (n_bodies, components, B): each load and store of a body
//   component is coalesced across a warp, and the state is read once and
//   written once a control step.
// - The per-lane working set lives in shared memory, lane-minor
//   (slot * kThreads + threadIdx.x: a warp's 32 lanes hit 32 banks): body
//   position, quaternion, velocity and angular velocity, the rotation
//   matrices, the force and torque accumulators and the held action, 28
//   floats a body and one an action (325 floats, 1.3 KB a lane, on the
//   Humanoid). Not registers: the joints gather their parent's and child's
//   state by indices that are data, which registers cannot be indexed by
//   (the compiler would move the arrays to local memory), and the kernel
//   keeps one path for every body plan, with no body count as a template
//   parameter.
// - The System's constants (masses, inertias, anchors, axes, gains, limits,
//   gears, action indices, sphere offsets and radii, parent and child
//   indices, gravity; ~2.5 KB on the Humanoid) come as one float32 device
//   buffer that the wrapper packs once per System. Each block copies it to
//   shared memory; every lane of a warp then reads the same word (a
//   broadcast). Scalars come as launch arguments.
// - The scatters onto the bodies are plain += into the lane's own
//   accumulators: nothing is shared between lanes, so there are no atomics.
// - Small blocks (kThreads = 64): 10,000 lanes are 157 blocks, spread over
//   the 132 SMs, and 2,048 lanes 32 blocks. At 85 KB of shared memory a
//   block on the Humanoid, two blocks fit on an SM.
// - The joint, sphere and body loops are not unrolled (#pragma unroll 1):
//   their trip counts are data, and the loop bodies are large.
//
// The epilogue: a locomotion env's step (envs/locomotion.py:batch_step) is
// this one launch on the card. After the last substep the kernel holds the
// lane's bodies in its slots, and from them, on request (a null pointer
// asks for nothing), it writes what the plain path computed in ~130 small
// PyTorch launches around the physics:
// - the planar projection (`planar`: Walker2D, HalfCheetah) of
//   RigidBodyLocomotionEnv._planar_project, before anything is written;
//   the body plan's y offsets come with the packed System;
// - the reward and done of _batch_reward_done in its formula order, from
//   the action clamped at load to the action space, and t + 1: the healthy
//   band's bounds come as float32, as PyTorch rounds a Python scalar it
//   compares a float32 tensor with, so that done is the plain path's bit
//   for bit on the same state;
// - the observation row of _batch_obs, (B, obs_dim) row-major: joint angles
//   and velocities land at their action index (the plain path's selection
//   matrix), penetrations of the first obs_contacts spheres. A thread
//   writing its own row would store 109 floats 436 bytes apart across a
//   warp. So each lane first writes its row into the slots of the working
//   set past the state (rotations, accumulators, action: free after the
//   last substep, once the block has synchronised), rows an odd number of
//   floats apart so that a warp's 32 rows hit 32 banks; then the block
//   stores its 64 rows as one contiguous run, a warp's 32 threads on 32
//   consecutive floats.
// With substeps = 0 and no action the kernel is a reset's observation
// (batch_reset_from): the state is read and not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
// The largest body plan the kernel takes; the wrapper raises above it
// (the wrapper in envs/rigidbody.py keeps the same numbers). The
// Humanoid has 11 bodies, 10 joints and 9 spheres.
constexpr int kMaxBodies = 24;
constexpr int kMaxJoints = 24;
constexpr int kMaxSpheres = 24;
constexpr int kMaxDevices = 64;

// Offsets of the fields of the packed System, in floats. The wrapper packs
// the fields in this order, each flattened row-major (indices as floats):
// mass (nb), inertia (nb, 3), gravity (3), joint_parent (nj), joint_child
// (nj), anchor_p (nj, 3), anchor_c (nj, 3), axes (nj, 3, 3), free (nj, 3),
// limit_lo, limit_hi, gear, act_index, act_kp, act_kd (nj, 3 each), pos_k
// (nj), pos_c (nj), ang_k, ang_c, limit_k, tone_k, joint_damping (nj, 3
// each), sph_body (ns), sph_offset (ns, 3), sph_radius (ns), then the body
// plan's y offsets plan_y (nb), which the planar projection snaps to.
struct Layout {
  int mass, inertia, gravity, parent, child, anchor_p, anchor_c, axes, free, lo, hi, gear, act_index, kp, kd,
      pos_k, pos_c, ang_k, ang_c, limit_k, tone_k, damping, sph_body, sph_offset, sph_radius, plan_y, total;
};

Layout make_layout(int nb, int nj, int ns) {
  Layout L;
  int o = 0;
  L.mass = o, o += nb;
  L.inertia = o, o += 3 * nb;
  L.gravity = o, o += 3;
  L.parent = o, o += nj;
  L.child = o, o += nj;
  L.anchor_p = o, o += 3 * nj;
  L.anchor_c = o, o += 3 * nj;
  L.axes = o, o += 9 * nj;
  L.free = o, o += 3 * nj;
  L.lo = o, o += 3 * nj;
  L.hi = o, o += 3 * nj;
  L.gear = o, o += 3 * nj;
  L.act_index = o, o += 3 * nj;
  L.kp = o, o += 3 * nj;
  L.kd = o, o += 3 * nj;
  L.pos_k = o, o += nj;
  L.pos_c = o, o += nj;
  L.ang_k = o, o += 3 * nj;
  L.ang_c = o, o += 3 * nj;
  L.limit_k = o, o += 3 * nj;
  L.tone_k = o, o += 3 * nj;
  L.damping = o, o += 3 * nj;
  L.sph_body = o, o += ns;
  L.sph_offset = o, o += 3 * ns;
  L.sph_radius = o, o += ns;
  L.plan_y = o, o += nb;
  L.total = o;
  return L;
}

struct Params {
  const float* pos;  // (nb, 3, B) contiguous
  const float* quat;  // (nb, 4, B)
  const float* vel;  // (nb, 3, B)
  const float* ang;  // (nb, 3, B)
  const float* actions;  // (na, B), element (a, lane) at a * act_stride + lane * lane_stride
  int64_t act_stride, lane_stride;
  const float* sys;  // the packed System
  float* out;  // (13 nb, B): pos, quat, vel, ang rows; null: the state is not written
  // the epilogue, each output null where it is not wanted
  float* obs;  // (B, obs_dim) row-major
  float* reward;  // (B,)
  uint8_t* done;  // (B,) bool
  const int32_t* t_in;  // (B,), read where reward is wanted
  int32_t* t_out;  // (B,): t_in + 1
  int64_t B;
  int nb, nj, ns, na, position_mode, substeps, consts;  // consts: the shared slots of the System, padded
  int planar, obs_contacts, obs_dim, stage_stride, max_steps;
  float h, half_h, contact_k, contact_c, friction_mu, tangent_damping, max_vel, max_ang;
  float act_lo, act_hi, forward_w, alive, ctrl_w, z_lo, z_hi;
  Layout L;
};

// The lane's slot i (slot * kThreads + threadIdx.x, `my` at the lane's slot
// 0). The rows of the state come first, in the output's order, then the
// rotations, the accumulators and the action.
#define S(i) my[(i) * kThreads]

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// R v and R^T v for a row-major 3x3 R
__device__ __forceinline__ void rotate(const float R[9], const float v[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

__device__ __forceinline__ void rotate_inv(const float R[9], const float v[3], float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = R[k] * v[0] + R[3 + k] * v[1] + R[6 + k] * v[2];
}

// Hamilton product a * b, (w, x, y, z)
__device__ __forceinline__ void quat_mul(const float a[4], const float b[4], float out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// Log map on the shortest arc; finite at the identity
__device__ __forceinline__ void quat_to_rotvec(float q[4], float out[3]) {
  if (q[0] < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
  }
  const float s = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float angle = 2.0f * atan2f(s, q[0]);
  const float scale = s < 1e-7f ? 2.0f : angle / fmaxf(s, 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = q[1 + k] * scale;
}

// v rotated by the quaternion (w, x, y, z), as envs/rigidbody.py's
// _bquat_rotate: t = 2 (q_xyz x v), v + w t + q_xyz x t
__device__ __forceinline__ void quat_rotate(const float w, const float qv[3], const float v[3], float out[3]) {
  float t[3], u[3];
  cross(qv, v, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = 2.0f * t[k];
  cross(qv, t, u);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = v[k] + w * t[k] + u[k];
}

// RigidBodyLocomotionEnv._planar_project on the lane's state: body y at the
// plan's offsets, no lateral velocity, no roll or yaw rate, each quaternion
// projected onto a pure y-rotation (its norm floored at a square of 1e-12;
// a NaN stays NaN, as in torch.clamp)
__device__ void planar_project(const Params& p, const float* c, float* my) {
  const int nb = p.nb, kPos = 0, kQuat = 3 * nb, kVel = 7 * nb, kAng = 10 * nb;
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    S(kPos + 3 * b + 1) = c[p.L.plan_y + b];
    S(kVel + 3 * b + 1) = 0.0f;
    S(kAng + 3 * b) = 0.0f;
    S(kAng + 3 * b + 2) = 0.0f;
    const float w = S(kQuat + 4 * b), y = S(kQuat + 4 * b + 2);
    const float sq = w * w + y * y;
    const float norm = sqrtf(sq < 1e-12f ? 1e-12f : sq);
    S(kQuat + 4 * b) = w / norm;
    S(kQuat + 4 * b + 1) = 0.0f / norm;
    S(kQuat + 4 * b + 2) = y / norm;
    S(kQuat + 4 * b + 3) = 0.0f / norm;
  }
}

// _batch_reward_done of the lane: the reward (forward velocity, alive bonus,
// control cost of the clamped action), done (outside the healthy band, or
// at the episode's last step) and t + 1
__device__ void reward_done(const Params& p, const float* my, const int64_t lane) {
  const int nb = p.nb, kPos = 0, kVel = 7 * nb, kAct = 28 * nb;
  const int32_t t = p.t_in[lane] + 1;
  const float z = S(kPos + 2);
  const bool unhealthy = (z < p.z_lo) || (z > p.z_hi);
  float sq = 0.0f;
#pragma unroll 1
  for (int a = 0; a < p.na; ++a) sq += S(kAct + a) * S(kAct + a);
  const float ctrl_cost = p.ctrl_w * sq;
  float reward = p.forward_w * S(kVel) + p.alive - ctrl_cost;
  if (unhealthy) reward = reward - p.alive;
  p.reward[lane] = reward;
  p.done[lane] = static_cast<uint8_t>(unhealthy || t >= p.max_steps);
  p.t_out[lane] = t;
}

// _batch_obs of the lane into its row `o` (obs_dim floats): torso height,
// quaternion, velocity and angular velocity; joint angles, then joint
// velocities, each axis at its action index; the other bodies' positions,
// then velocities, relative to the torso; the first obs_contacts spheres'
// ground penetrations. The formulas of joint_angles_batched,
// joint_velocities_batched (the rotation by the parent's quaternion, not
// its matrix) and sphere_penetrations_batched.
__device__ void observe(const Params& p, const float* c, const float* my, float* o) {
  const int nb = p.nb, na = p.na, kPos = 0, kQuat = 3 * nb, kVel = 7 * nb, kAng = 10 * nb;
  const Layout& L = p.L;
  o[0] = S(kPos + 2);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[1 + k] = S(kQuat + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[5 + k] = S(kVel + k);
    o[8 + k] = S(kAng + k);
  }
  float* angles = o + 11;
  float* rates = o + 11 + na;
#pragma unroll 1
  for (int j = 0; j < p.nj; ++j) {
    const int jp = static_cast<int>(c[L.parent + j]), jc = static_cast<int>(c[L.child + j]);
    float pq_conj[4], cq[4], q_rel[4], phi[3], dw[3], w_rel[3];
    pq_conj[0] = S(kQuat + 4 * jp);
#pragma unroll
    for (int k = 1; k < 4; ++k) pq_conj[k] = -S(kQuat + 4 * jp + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) cq[k] = S(kQuat + 4 * jc + k);
    quat_mul(pq_conj, cq, q_rel);
    quat_to_rotvec(q_rel, phi);
#pragma unroll
    for (int k = 0; k < 3; ++k) dw[k] = S(kAng + 3 * jc + k) - S(kAng + 3 * jp + k);
    quat_rotate(pq_conj[0], pq_conj + 1, dw, w_rel);
    const float* axes = c + L.axes + 9 * j;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int act = static_cast<int>(c[L.act_index + 3 * j + a]);
      if (act < na) {
        angles[act] = axes[3 * a] * phi[0] + axes[3 * a + 1] * phi[1] + axes[3 * a + 2] * phi[2];
        rates[act] = axes[3 * a] * w_rel[0] + axes[3 * a + 1] * w_rel[1] + axes[3 * a + 2] * w_rel[2];
      }
    }
  }
  float* rel_pos = o + 11 + 2 * na;
  float* rel_vel = rel_pos + 3 * (nb - 1);
#pragma unroll 1
  for (int b = 1; b < nb; ++b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rel_pos[3 * (b - 1) + k] = S(kPos + 3 * b + k) - S(kPos + k);
      rel_vel[3 * (b - 1) + k] = S(kVel + 3 * b + k) - S(kVel + k);
    }
  }
  float* depth = rel_vel + 3 * (nb - 1);
#pragma unroll 1
  for (int s = 0; s < p.obs_contacts; ++s) {
    const int b = static_cast<int>(c[L.sph_body + s]);
    const float qv[3] = {S(kQuat + 4 * b + 1), S(kQuat + 4 * b + 2), S(kQuat + 4 * b + 3)};
    const float off[3] = {c[L.sph_offset + 3 * s], c[L.sph_offset + 3 * s + 1], c[L.sph_offset + 3 * s + 2]};
    float r_off[3];
    quat_rotate(S(kQuat + 4 * b), qv, off, r_off);
    const float d = c[L.sph_radius + s] - (S(kPos + 3 * b + 2) + r_off[2]);
    depth[s] = d < 0.0f ? 0.0f : d;  // torch.clamp(min=0): a NaN stays NaN
  }
}

// The lane's state and its action (clamped to [act_lo, act_hi]; a NaN stays
// NaN, as in torch.clamp) into its slots, then `substeps` substeps
__device__ void physics(const Params& p, const float* c, float* my, const int64_t lane) {
  const int nb = p.nb;
  const int kPos = 0, kQuat = 3 * nb, kVel = 7 * nb, kAng = 10 * nb, kR = 13 * nb, kF = 22 * nb, kT = 25 * nb,
            kAct = 28 * nb;
  const int64_t B = p.B;
#pragma unroll 1
  for (int r = 0; r < 3 * nb; ++r) {
    S(kPos + r) = p.pos[r * B + lane];
    S(kVel + r) = p.vel[r * B + lane];
    S(kAng + r) = p.ang[r * B + lane];
  }
#pragma unroll 1
  for (int r = 0; r < 4 * nb; ++r) S(kQuat + r) = p.quat[r * B + lane];
  if (p.actions != nullptr) {
#pragma unroll 1
    for (int a = 0; a < p.na; ++a) {
      const float v = p.actions[a * p.act_stride + lane * p.lane_stride];
      S(kAct + a) = v < p.act_lo ? p.act_lo : (v > p.act_hi ? p.act_hi : v);
    }
  }

  const Layout& L = p.L;
  const float h = p.h;
#pragma unroll 1
  for (int step = 0; step < p.substeps; ++step) {
    // rotation matrices of the substep's state; zeroed accumulators
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      const float w = S(kQuat + 4 * b), x = S(kQuat + 4 * b + 1), y = S(kQuat + 4 * b + 2), z = S(kQuat + 4 * b + 3);
      const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z, wx = w * x, wy = w * y,
                  wz = w * z;
      S(kR + 9 * b + 0) = 1.0f - 2.0f * (yy + zz);
      S(kR + 9 * b + 1) = 2.0f * (xy - wz);
      S(kR + 9 * b + 2) = 2.0f * (xz + wy);
      S(kR + 9 * b + 3) = 2.0f * (xy + wz);
      S(kR + 9 * b + 4) = 1.0f - 2.0f * (xx + zz);
      S(kR + 9 * b + 5) = 2.0f * (yz - wx);
      S(kR + 9 * b + 6) = 2.0f * (xz - wy);
      S(kR + 9 * b + 7) = 2.0f * (yz + wx);
      S(kR + 9 * b + 8) = 1.0f - 2.0f * (xx + yy);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S(kF + 3 * b + k) = 0.0f;
        S(kT + 3 * b + k) = 0.0f;
      }
    }

    // joints: constraint, limit and actuation wrenches
#pragma unroll 1
    for (int j = 0; j < p.nj; ++j) {
      const int jp = static_cast<int>(c[L.parent + j]), jc = static_cast<int>(c[L.child + j]);
      float Rp[9], Rc[9], pq[4], cq[4], pp[3], cp[3], pv[3], cv[3], pw[3], cw[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        Rp[k] = S(kR + 9 * jp + k);
        Rc[k] = S(kR + 9 * jc + k);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pq[k] = S(kQuat + 4 * jp + k);
        cq[k] = S(kQuat + 4 * jc + k);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pp[k] = S(kPos + 3 * jp + k);
        cp[k] = S(kPos + 3 * jc + k);
        pv[k] = S(kVel + 3 * jp + k);
        cv[k] = S(kVel + 3 * jc + k);
        pw[k] = S(kAng + 3 * jp + k);
        cw[k] = S(kAng + 3 * jc + k);
      }

      // positional constraint: pull the two anchor points together
      const float ap[3] = {c[L.anchor_p + 3 * j], c[L.anchor_p + 3 * j + 1], c[L.anchor_p + 3 * j + 2]};
      const float ac[3] = {c[L.anchor_c + 3 * j], c[L.anchor_c + 3 * j + 1], c[L.anchor_c + 3 * j + 2]};
      float ra[3], rb[3], wra[3], wrb[3], fj[3];
      rotate(Rp, ap, ra);
      rotate(Rc, ac, rb);
      cross(cw, rb, wrb);
      cross(pw, ra, wra);
      const float pos_k = c[L.pos_k + j], pos_c = c[L.pos_c + j];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float err = (cp[k] + rb[k]) - (pp[k] + ra[k]);
        const float verr = (cv[k] + wrb[k]) - (pv[k] + wra[k]);
        fj[k] = -pos_k * err - pos_c * verr;
      }
      float tb[3], ta[3];
      cross(rb, fj, tb);
      cross(ra, fj, ta);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S(kF + 3 * jc + k) += fj[k];
        S(kF + 3 * jp + k) -= fj[k];
        S(kT + 3 * jc + k) += tb[k];
        S(kT + 3 * jp + k) -= ta[k];
      }

      // angular: the relative rotation decomposed onto the joint's axes
      const float pq_conj[4] = {pq[0], -pq[1], -pq[2], -pq[3]};
      float q_rel[4], phi[3], dw[3], w_rel[3];
      quat_mul(pq_conj, cq, q_rel);
      quat_to_rotvec(q_rel, phi);
#pragma unroll
      for (int k = 0; k < 3; ++k) dw[k] = cw[k] - pw[k];
      rotate_inv(Rp, dw, w_rel);
      const float* axes = c + L.axes + 9 * j;
      float comp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int i = 3 * j + a;
        const float phi_c = axes[3 * a] * phi[0] + axes[3 * a + 1] * phi[1] + axes[3 * a + 2] * phi[2];
        const float w_c = axes[3 * a] * w_rel[0] + axes[3 * a + 1] * w_rel[1] + axes[3 * a + 2] * w_rel[2];
        const float lo = c[L.lo + i], hi = c[L.hi + i], gear = c[L.gear + i], free = c[L.free + i];
        const float over = fmaxf(phi_c - hi, 0.0f);
        const float under = fmaxf(lo - phi_c, 0.0f);
        const int act = static_cast<int>(c[L.act_index + i]);
        const float drive = act < p.na ? S(kAct + act) : 0.0f;  // 0 on an unactuated axis
        float act_torque;
        if (p.position_mode) {
          const float target = drive >= 0.0f ? drive * hi : -drive * lo;
          const float pd = c[L.kp + i] * (target - phi_c) - c[L.kd + i] * w_c;
          act_torque = (gear > 0.0f ? 1.0f : 0.0f) * fminf(fmaxf(pd, -gear), gear);
        } else {
          act_torque = gear * drive;
        }
        const float locked = 1.0f - free;
        comp[a] = locked * (-c[L.ang_k + i] * phi_c - c[L.ang_c + i] * w_c) +
                  free * (c[L.limit_k + i] * (under - over) - c[L.tone_k + i] * phi_c - c[L.damping + i] * w_c +
                          act_torque);
      }
      float tau_j[3], tau_w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) tau_j[k] = axes[k] * comp[0] + axes[3 + k] * comp[1] + axes[6 + k] * comp[2];
      rotate(Rp, tau_j, tau_w);  // parent frame -> world
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S(kT + 3 * jc + k) += tau_w[k];
        S(kT + 3 * jp + k) -= tau_w[k];
      }
    }

    // sphere-vs-ground penalty contacts with clamped viscous friction
#pragma unroll 1
    for (int s = 0; s < p.ns; ++s) {
      const int b = static_cast<int>(c[L.sph_body + s]);
      const float radius = c[L.sph_radius + s];
      const float off[3] = {c[L.sph_offset + 3 * s], c[L.sph_offset + 3 * s + 1], c[L.sph_offset + 3 * s + 2]};
      float R[9], r_off[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = S(kR + 9 * b + k);
      rotate(R, off, r_off);
      const float pen = radius - (S(kPos + 3 * b + 2) + r_off[2]);
      // lever arm to the lowest point of the sphere (offset minus radius * e_z)
      const float rel[3] = {r_off[0], r_off[1], r_off[2] - radius};
      const float w[3] = {S(kAng + 3 * b), S(kAng + 3 * b + 1), S(kAng + 3 * b + 2)};
      float wr[3], vc[3];
      cross(w, rel, wr);
#pragma unroll
      for (int k = 0; k < 3; ++k) vc[k] = S(kVel + 3 * b + k) + wr[k];
      const float fn = pen > 0.0f ? fmaxf(p.contact_k * pen - p.contact_c * vc[2], 0.0f) : 0.0f;
      // viscous at small slip, Coulomb cap mu * N above
      const float vt_norm = sqrtf(vc[0] * vc[0] + vc[1] * vc[1]);
      const float ft_mag = fminf(p.friction_mu * fn, p.tangent_damping * vt_norm);
      const float ft_scale = ft_mag / fmaxf(vt_norm, 1e-6f);
      const float fc[3] = {-vc[0] * ft_scale, -vc[1] * ft_scale, fn};
      float tc[3];
      cross(rel, fc, tc);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S(kF + 3 * b + k) += fc[k];
        S(kT + 3 * b + k) += tc[k];
      }
    }

    // bodies: semi-implicit Euler, the angular update in the body frame
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      const float mass = c[L.mass + b];
      float R[9], w[3], tau[3], w_body[3], tau_body[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = S(kR + 9 * b + k);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float f = S(kF + 3 * b + k) + mass * c[L.gravity + k];
        const float v = S(kVel + 3 * b + k) + h * f / mass;
        S(kVel + 3 * b + k) = fminf(fmaxf(v, -p.max_vel), p.max_vel);
        w[k] = S(kAng + 3 * b + k);
        tau[k] = S(kT + 3 * b + k);
      }
      rotate_inv(R, w, w_body);
      rotate_inv(R, tau, tau_body);
      const float inertia[3] = {c[L.inertia + 3 * b], c[L.inertia + 3 * b + 1], c[L.inertia + 3 * b + 2]};
      const float iw[3] = {inertia[0] * w_body[0], inertia[1] * w_body[1], inertia[2] * w_body[2]};
      float gyro[3], ang[3];
      cross(w_body, iw, gyro);
#pragma unroll
      for (int k = 0; k < 3; ++k) w_body[k] = w_body[k] + h * (tau_body[k] - gyro[k]) / inertia[k];
      rotate(R, w_body, ang);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ang[k] = fminf(fmaxf(ang[k], -p.max_ang), p.max_ang);
        S(kAng + 3 * b + k) = ang[k];
        S(kPos + 3 * b + k) += h * S(kVel + 3 * b + k);
      }
      const float omega[4] = {0.0f, ang[0], ang[1], ang[2]};
      float q[4], dq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = S(kQuat + 4 * b + k);
      quat_mul(omega, q, dq);
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = q[k] + p.half_h * dq[k];
      const float norm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) S(kQuat + 4 * b + k) = q[k] / norm;
    }
  }
}

__global__ void __launch_bounds__(kThreads) rigid_body_step_kernel(const Params p) {
  extern __shared__ float smem[];
  float* c = smem;  // the System
  for (int i = threadIdx.x; i < p.L.total; i += kThreads) c[i] = p.sys[i];
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t lane = first + threadIdx.x;
  // the last block's lanes past B compute nothing, and take part in its
  // barriers
  const bool active = lane < p.B;
  float* my = smem + p.consts + threadIdx.x;
  if (active) {
    physics(p, c, my, lane);
    if (p.planar) planar_project(p, c, my);
    if (p.out != nullptr) {
#pragma unroll 1
      for (int r = 0; r < 13 * p.nb; ++r) p.out[r * p.B + lane] = S(r);
    }
    if (p.reward != nullptr) reward_done(p, my, lane);
  }
  if (p.obs == nullptr) return;

  // the observation rows, staged past the state's slots: every lane of the
  // block has read its rotations, accumulators and action for the last time
  float* stage = smem + p.consts + 13 * p.nb * kThreads;
  __syncthreads();
  if (active) observe(p, c, my, stage + threadIdx.x * p.stage_stride);
  __syncthreads();
  const int rows = static_cast<int>(p.B - first < kThreads ? p.B - first : kThreads);
  const int n = rows * p.obs_dim;
  float* dst = p.obs + first * p.obs_dim;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / p.obs_dim;
    dst[i] = stage[r * p.stage_stride + (i - r * p.obs_dim)];
  }
}
#undef S

}  // namespace

// pos, quat, vel, ang: (nb, comp, B) float32, contiguous; actions: (na, B)
// float32 with the given strides, clamped to [act_lo, act_hi] at load (null
// with substeps = 0: no action); sys: the packed System (see Layout); out:
// (13 nb, B) float32, contiguous: the new pos, quat, vel and ang rows, after
// the planar projection where `planar` (null: not written). The epilogue,
// each null where not wanted: obs (B, obs_dim) float32, row-major, obs_dim
// = 11 + 2 na + 6 (nb - 1) + obs_contacts; reward (B,) float32, done (B,)
// bool and t_out (B,) int32 from t_in (B,) int32, all four or none.
// position_mode != 0 runs the PD servo, else torque actuation. B = 0
// launches nothing; a body plan above the kernel's maxima, or an epilogue
// that does not fit it, returns cudaErrorInvalidValue.
extern "C" int evt_rigid_body_step(const void* pos, const void* quat, const void* vel, const void* ang,
                                   const void* actions, int64_t act_stride, int64_t lane_stride, const void* sys,
                                   void* out, void* obs, void* reward, void* done, const void* t_in, void* t_out,
                                   int64_t B, int nb, int nj, int ns, int na, int position_mode, int substeps,
                                   int planar, int obs_contacts, int obs_dim, int max_steps, float h, float half_h,
                                   float contact_k, float contact_c, float friction_mu, float tangent_damping,
                                   float max_vel, float max_ang, float act_lo, float act_hi, float forward_w,
                                   float alive, float ctrl_w, float z_lo, float z_hi, int device, void* stream) {
  const bool tally = reward != nullptr || done != nullptr || t_in != nullptr || t_out != nullptr;
  if (nb < 1 || nb > kMaxBodies || nj < 0 || nj > kMaxJoints || ns < 0 || ns > kMaxSpheres || na < 0 ||
      na > 3 * kMaxJoints || substeps < 0 || device < 0 || device >= kMaxDevices ||
      (substeps > 0 && actions == nullptr) ||
      (tally && (reward == nullptr || done == nullptr || t_in == nullptr || t_out == nullptr)) ||
      (obs != nullptr &&
       (obs_contacts < 0 || obs_contacts > ns || obs_dim != 11 + 2 * na + 6 * (nb - 1) + obs_contacts))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.pos = static_cast<const float*>(pos);
  p.quat = static_cast<const float*>(quat);
  p.vel = static_cast<const float*>(vel);
  p.ang = static_cast<const float*>(ang);
  p.actions = static_cast<const float*>(actions);
  p.act_stride = act_stride;
  p.lane_stride = lane_stride;
  p.sys = static_cast<const float*>(sys);
  p.out = static_cast<float*>(out);
  p.obs = static_cast<float*>(obs);
  p.reward = static_cast<float*>(reward);
  p.done = static_cast<uint8_t*>(done);
  p.t_in = static_cast<const int32_t*>(t_in);
  p.t_out = static_cast<int32_t*>(t_out);
  p.B = B;
  p.nb = nb, p.nj = nj, p.ns = ns, p.na = na;
  p.position_mode = position_mode;
  p.substeps = substeps;
  p.planar = planar;
  p.obs_contacts = obs_contacts;
  p.obs_dim = obs_dim;
  p.stage_stride = obs_dim | 1;  // odd: a warp's 32 rows on 32 banks
  p.max_steps = max_steps;
  p.h = h, p.half_h = half_h;
  p.contact_k = contact_k, p.contact_c = contact_c;
  p.friction_mu = friction_mu, p.tangent_damping = tangent_damping;
  p.max_vel = max_vel, p.max_ang = max_ang;
  p.act_lo = act_lo, p.act_hi = act_hi;
  p.forward_w = forward_w, p.alive = alive, p.ctrl_w = ctrl_w;
  p.z_lo = z_lo, p.z_hi = z_hi;
  p.L = make_layout(nb, nj, ns);
  p.consts = (p.L.total + 31) / 32 * 32;  // the lanes' slots start on a bank-0 word
  // a lane's slots: the working set, or the state and its staged
  // observation row where that is more
  int slots = 28 * nb + na;
  if (obs != nullptr && 13 * nb + p.stage_stride > slots) slots = 13 * nb + p.stage_stride;
  const size_t smem = sizeof(float) * (static_cast<size_t>(p.consts) + static_cast<size_t>(slots) * kThreads);
  // above 48 KB a block's dynamic shared memory has to be allowed first; once
  // per device for the largest size asked so far
  static size_t allowed[kMaxDevices] = {};
  if (smem > 48 * 1024 && smem > allowed[device]) {
    err = cudaFuncSetAttribute(rigid_body_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem;
  }
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  rigid_body_step_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
