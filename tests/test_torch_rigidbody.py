"""The single-instance rigid-body API of the port (``quat_*``,
``physics_substep``, ``physics_step``, ``joint_angles``,
``joint_velocities``, ``sphere_penetrations`` in
``evotorch_tpu_torch/envs/rigidbody.py``) against its JAX twin, on one
seeded body state of the Humanoid and of the Ant, on the CPU.

A physics step is 8 substeps of stiff springs: float32 round-off from
another summation order grows over them, so it is held at the tolerance of
``tests/test_torch_locomotion.py`` for one step (``rtol=1e-5,
atol=2e-4``), one substep at ``rtol=1e-5, atol=2e-5``. The quaternion
helpers and the measurements are a few products each and are held at
``rtol=1e-6, atol=1e-6``. Each unbatched function is also the batched form
at a population of one, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.envs import make_env as jax_make_env
from evotorch_tpu.envs import rigidbody as jrb
from evotorch_tpu_torch.envs import make_env
from evotorch_tpu_torch.envs import rigidbody as rb

QUAT_TOL = dict(rtol=1e-6, atol=1e-6)
SUBSTEP_TOL = dict(rtol=1e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=2e-4)


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = _unit_quats(rng, (7,)), _unit_quats(rng, (7,))
    b[0] = [1.0, 0.0, 0.0, 0.0]  # the identity: quat_to_rotvec's series limit
    b[1] = -b[1]  # a negative real part: the shortest arc
    v = rng.normal(size=(7, 3)).astype(np.float32)
    omega = rng.normal(size=(7, 3)).astype(np.float32)
    pairs = {
        "quat_mul": (rb.quat_mul(torch.from_numpy(a), torch.from_numpy(b)), jrb.quat_mul(a, b)),
        "quat_conj": (rb.quat_conj(torch.from_numpy(a)), jrb.quat_conj(jnp.asarray(a))),
        "quat_rotate": (rb.quat_rotate(torch.from_numpy(a), torch.from_numpy(v)), jrb.quat_rotate(a, v)),
        "quat_rotate_inv": (rb.quat_rotate_inv(torch.from_numpy(a), torch.from_numpy(v)), jrb.quat_rotate_inv(jnp.asarray(a), v)),
        "quat_to_rotvec": (rb.quat_to_rotvec(torch.from_numpy(b)), jrb.quat_to_rotvec(jnp.asarray(b))),
        "quat_integrate": (
            rb.quat_integrate(torch.from_numpy(a), torch.from_numpy(omega), 0.01),
            jrb.quat_integrate(jnp.asarray(a), jnp.asarray(omega), 0.01),
        ),
    }
    for name, (ours, theirs) in pairs.items():
        assert ours.shape == tuple(theirs.shape), name
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **QUAT_TOL, err_msg=name)
    # one quaternion, no leading axis; and broadcasting one quaternion over vectors
    np.testing.assert_allclose(
        rb.quat_rotate(torch.from_numpy(a[0]), torch.from_numpy(v)).numpy(), np.asarray(jrb.quat_rotate(a[0], v)), **QUAT_TOL
    )


def _body_state(env, seed):
    """One perturbed body state of ``env`` (``(nb, comp)`` arrays), and one
    action of the env's width."""
    rng = np.random.default_rng(seed)
    nb = env.sys.num_bodies
    pos = env._default_pos.numpy() + 0.005 * rng.normal(size=(nb, 3))
    quat = np.zeros((nb, 4))
    quat[:, 0] = 1.0
    quat += 0.02 * rng.normal(size=(nb, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    vel = 0.1 * rng.normal(size=(nb, 3))
    ang = 0.1 * rng.normal(size=(nb, 3))
    action = rng.uniform(-1.0, 1.0, size=(env.action_size,))
    return [x.astype(np.float32) for x in (pos, quat, vel, ang)], action.astype(np.float32)


@pytest.mark.parametrize("env_name", ["humanoid", "ant"])
def test_single_instance_physics_and_measurements_match_jax(env_name):
    jax_env, env = jax_make_env(env_name), make_env(env_name, device="cpu")
    fields, action = _body_state(env, seed=3)
    st = rb.BodyState(*(torch.from_numpy(x) for x in fields))
    jst = jrb.BodyState(*(jnp.asarray(x) for x in fields))
    h = env.dt / env.substeps

    for name in ("joint_angles", "joint_velocities", "sphere_penetrations"):
        ours, theirs = getattr(rb, name)(env.sys, st), getattr(jrb, name)(jax_env.sys, jst)
        assert ours.shape == tuple(theirs.shape), name
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **QUAT_TOL, err_msg=name)

    sub = rb.physics_substep(env.sys, st, torch.from_numpy(action), h)
    jsub = jrb.physics_substep(jax_env.sys, jst, jnp.asarray(action), h)
    step = rb.physics_step(env.sys, st, torch.from_numpy(action), env.dt, env.substeps)
    jstep = jrb.physics_step(jax_env.sys, jst, jnp.asarray(action), env.dt, env.substeps)
    for ours, theirs in zip(sub, jsub):
        assert ours.shape == tuple(theirs.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **SUBSTEP_TOL)
    for ours, theirs in zip(step, jstep):
        assert ours.shape == tuple(theirs.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **STEP_TOL)


@pytest.mark.parametrize("env_name", ["humanoid", "ant"])
def test_single_instance_api_is_the_batched_form_at_one(env_name):
    env = make_env(env_name, device="cpu")
    fields, action = _body_state(env, seed=5)
    st = rb.BodyState(*(torch.from_numpy(x) for x in fields))
    batched = rb.BodyState(*(torch.from_numpy(x)[..., None] for x in fields))
    act = torch.from_numpy(action)
    step = rb.physics_step(env.sys, st, act, env.dt, env.substeps)
    bstep = rb.physics_step_batched(env.sys, batched, act[:, None], env.dt, env.substeps)
    for ours, theirs in zip(step, bstep):
        assert torch.equal(ours, theirs[..., 0])
    for name in ("joint_angles", "joint_velocities", "sphere_penetrations"):
        assert torch.equal(getattr(rb, name)(env.sys, st), getattr(rb, f"{name}_batched")(env.sys, batched)[..., 0])
