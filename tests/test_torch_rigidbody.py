"""The single-instance rigid-body API of the port (``quat_*``,
``physics_substep``, ``physics_step``, ``joint_angles``,
``joint_velocities``, ``sphere_penetrations`` in
``evotorch_tpu_torch/envs/rigidbody.py``) against its JAX twin, on one
seeded body state of the Humanoid and of the Ant, on the CPU; and the
physics kernel (``csrc/rigid_body_step.cu``): its packed System and its
CPU dispatch here, the kernel against the plain loop on the card.

A physics step is 8 substeps of stiff springs: float32 round-off from
another summation order grows over them, so it is held at the tolerance of
``tests/test_torch_locomotion.py`` for one step (``rtol=1e-5,
atol=2e-4``), one substep at ``rtol=1e-5, atol=2e-5``. The quaternion
helpers and the measurements are a few products each and are held at
``rtol=1e-6, atol=1e-6``. Each unbatched function is also the batched form
at a population of one, bit for bit.

The card tests (marker ``cuda``) run on a machine with the card with
``python3 -m pytest --noconftest -m cuda tests/test_torch_rigidbody.py``:
the JAX package is imported inside the tests that compare with it, so this
module imports without JAX. The kernel computes the plain loop's float32
formulas in another order (no FMA contraction): from states that a random
policy drove into ground contact and joint limits, one control step is held
to ``|x - x_plain| / max(1, |x_plain|) <= 1e-3`` (``KERNEL_TOL``); the
plain loop on the card and on the CPU differ by up to 3.6e-4 there.
"""

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.envs import make_env
from evotorch_tpu_torch.envs import rigidbody as rb

QUAT_TOL = dict(rtol=1e-6, atol=1e-6)
SUBSTEP_TOL = dict(rtol=1e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=2e-4)
KERNEL_TOL = 1e-3
LOCOMOTION_ENVS = ["humanoid", "ant", "halfcheetah", "walker2d"]


def _jax():
    """The JAX package's ``make_env``, its ``rigidbody`` and ``jax.numpy``."""
    import jax.numpy as jnp

    from evotorch_tpu.envs import make_env as jax_make_env
    from evotorch_tpu.envs import rigidbody as jrb

    return jax_make_env, jrb, jnp


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_quaternion_helpers_match_jax():
    _, jrb, jnp = _jax()
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
    jax_make_env, jrb, jnp = _jax()
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


# -- the physics kernel: its packed System, its CPU dispatch, and on the card --


def _unpack(packed: torch.Tensor, nb: int, nj: int, ns: int) -> dict:
    """The packed System read back by csrc/rigid_body_step.cu's Layout,
    written out here field by field."""
    shapes = [
        ("mass", (nb,)), ("inertia", (nb, 3)), ("gravity", (3,)), ("joint_parent", (nj,)), ("joint_child", (nj,)),
        ("anchor_p", (nj, 3)), ("anchor_c", (nj, 3)), ("axes", (nj, 3, 3)), ("free", (nj, 3)),
        ("limit_lo", (nj, 3)), ("limit_hi", (nj, 3)), ("gear", (nj, 3)), ("act_index", (nj, 3)),
        ("act_kp", (nj, 3)), ("act_kd", (nj, 3)), ("pos_k", (nj,)), ("pos_c", (nj,)), ("ang_k", (nj, 3)),
        ("ang_c", (nj, 3)), ("limit_k", (nj, 3)), ("tone_k", (nj, 3)), ("joint_damping", (nj, 3)),
        ("sph_body", (ns,)), ("sph_offset", (ns, 3)), ("sph_radius", (ns,)),
    ]  # fmt: skip
    values = packed.tolist()
    fields, at = {}, 0
    for name, shape in shapes:
        size = int(np.prod(shape))
        fields[name] = np.asarray(values[at : at + size], dtype=np.float64).reshape(shape)
        at += size
    assert at == len(values)
    return fields


@pytest.mark.parametrize("env_name", LOCOMOTION_ENVS)
def test_packed_system_holds_every_field(env_name):
    sys = make_env(env_name, device="cpu").sys
    packed = rb.pack_system(sys)
    assert packed.dtype == torch.float32 and packed.ndim == 1
    nb, nj, ns = sys.num_bodies, sys.num_joints, int(sys.sph_radius.shape[0])
    assert nb <= rb.MAX_BODIES and nj <= rb.MAX_JOINTS and ns <= rb.MAX_SPHERES
    for name, value in _unpack(packed, nb, nj, ns).items():
        field = getattr(sys, name)
        assert value.shape == tuple(field.shape), name
        np.testing.assert_array_equal(value, field.double().numpy(), err_msg=name)
    # the cache: one buffer per System, made at its first use
    assert rb._packed_system(sys) is rb._packed_system(sys)
    assert torch.equal(rb._packed_system(sys), packed)


def _random_policy_states(env, num_lanes, *, seed, steps=(20, 40)):
    """Body states of ``num_lanes`` lanes of the CPU ``env`` that uniform
    random actions drove for ``steps[0]`` to ``steps[1]`` control steps
    (lane by lane) from the env's resets: by then the Humanoid and the
    Walker2D have fallen, and contacts and joint limits are engaged."""
    g = torch.Generator().manual_seed(seed)
    state, _ = env.batch_reset_from(env.reset_noise(num_lanes, g))
    depth = torch.randint(steps[0], steps[1] + 1, (num_lanes,), generator=g)
    for t in range(steps[1]):
        actions = 2.0 * torch.rand((num_lanes, env.action_size), generator=g) - 1.0
        stepped, _, _, _ = env.batch_step(state, actions)
        state = env.batch_where(t < depth, stepped, state)
    return state.obs_state


@pytest.mark.parametrize("act_mode", ["position", "torque"])
def test_cpu_state_takes_the_plain_loop(act_mode):
    env = make_env("humanoid", device="cpu", act_mode=act_mode)
    st = _random_policy_states(env, 16, seed=7)
    actions = 2.0 * torch.rand((env.sys.num_act, 16), generator=torch.Generator().manual_seed(8)) - 1.0
    launches = rb.physics_step_batched.launches
    got = rb.physics_step_batched(env.sys, st, actions, env.dt, env.substeps)
    want = st
    for _ in range(env.substeps):
        want = rb.physics_substep_batched(env.sys, want, actions, env.dt / env.substeps)
    assert rb.physics_step_batched.launches == launches
    for ours, theirs in zip(got, want):
        assert torch.equal(ours, theirs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _widest_gap(got: rb.BodyState, want: rb.BodyState) -> float:
    """``max |x - x_plain| / max(1, |x_plain|)`` over pos, quat, vel and ang."""
    gaps = [((a - b).abs() / b.abs().clamp(min=1.0)).max() for a, b in zip(got, want) if b.numel()]
    return float(torch.stack(gaps).max()) if gaps else 0.0


def _kernel_and_plain(sys, st, actions, env):
    """One control step by the kernel and by the plain loop on the card;
    the kernel's launches are counted."""
    launches = rb.physics_step_batched.launches
    got = rb.physics_step_batched(sys, st, actions, env.dt, env.substeps)
    launched = rb.physics_step_batched.launches - launches
    want = rb.physics_step_batched_plain(sys, st, actions, env.dt, env.substeps)
    torch.cuda.synchronize()
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize("act_mode", ["position", "torque"])
@pytest.mark.parametrize("env_name", LOCOMOTION_ENVS)
def test_kernel_matches_plain_loop_on_the_card(cuda, env_name, act_mode):
    """300 lanes (not a whole number of 64-lane blocks) of states a random
    policy drove into ground contact and joint limits (60-294 of the lanes
    touch the ground, 4-226 are past a limit, by env and mode); three
    control steps in a row, each one launch."""
    cpu_env = make_env(env_name, device="cpu", act_mode=act_mode)
    env = make_env(env_name, device=cuda, act_mode=act_mode)
    B = 300
    st = _random_policy_states(cpu_env, B, seed=11)
    penetration = rb.sphere_penetrations_batched(cpu_env.sys, st)
    angles = rb.joint_angles_batched(cpu_env.sys, st)
    free = cpu_env.sys.free[:, :, None] > 0
    over = torch.where(free, angles - cpu_env.sys.limit_hi[:, :, None], 0.0).clamp(min=0.0)
    under = torch.where(free, cpu_env.sys.limit_lo[:, :, None] - angles, 0.0).clamp(min=0.0)
    assert bool((penetration > 0).any()), "no lane touches the ground"
    assert bool(((over > 0) | (under > 0)).any()), "no lane is past a joint limit"

    st = rb.BodyState(*(x.to(cuda) for x in st))
    g = torch.Generator(device=cuda).manual_seed(12)
    for _ in range(3):
        actions = (2.0 * torch.rand((B, env.action_size), generator=g, device=cuda) - 1.0).t()  # as batch_step has it
        got, want, launched = _kernel_and_plain(env.sys, st, actions, env)
        assert launched == 1
        gap = _widest_gap(got, want)
        assert gap <= KERNEL_TOL, f"{env_name} ({act_mode}): kernel and plain loop differ by {gap}"
        assert all(x.is_contiguous() and x.dtype == torch.float32 for x in got)
        st = want

    # batch_step launches it once a control step
    state, _ = env.batch_reset_from(env.reset_noise(B, torch.Generator(device=cuda).manual_seed(13)))
    launches = rb.physics_step_batched.launches
    for _ in range(4):
        state, _, _, _ = env.batch_step(state, torch.zeros((B, env.action_size), device=cuda))
    assert rb.physics_step_batched.launches - launches == 4


@pytest.mark.cuda
def test_kernel_takes_any_lane_count_and_strides_on_the_card(cuda):
    """B = 1 (and the single-instance ``physics_step``), B = 0 (no launch),
    and a reset's state, whose ``pos`` is a stride-0 expand."""
    env = make_env("humanoid", device=cuda)
    sys = env.sys
    g = torch.Generator(device=cuda).manual_seed(21)

    st = rb.BodyState(*(x.to(cuda) for x in _random_policy_states(make_env("humanoid", device="cpu"), 1, seed=22)))
    actions = 2.0 * torch.rand((sys.num_act, 1), generator=g, device=cuda) - 1.0
    got, want, launched = _kernel_and_plain(sys, st, actions, env)
    assert launched == 1 and _widest_gap(got, want) <= KERNEL_TOL
    launches = rb.physics_step_batched.launches
    one = rb.physics_step(sys, rb.BodyState(*(x[..., 0] for x in st)), actions[:, 0], env.dt, env.substeps)
    assert rb.physics_step_batched.launches - launches == 1
    assert all(torch.equal(a, b[..., 0]) for a, b in zip(one, got))

    empty = rb.BodyState(*(x[..., :0] for x in st))
    got, want, launched = _kernel_and_plain(sys, empty, actions[:, :0], env)
    assert launched == 0
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want] == [(11, 3, 0), (11, 4, 0), (11, 3, 0), (11, 3, 0)]

    B = 129
    state, _ = env.batch_reset_from(env.reset_noise(B, g))
    assert state.obs_state.pos.stride()[-1] == 0
    actions = (2.0 * torch.rand((B, sys.num_act), generator=g, device=cuda) - 1.0).t()
    got, want, launched = _kernel_and_plain(sys, state.obs_state, actions, env)
    assert launched == 1 and _widest_gap(got, want) <= KERNEL_TOL

    with pytest.raises(TypeError):
        rb.physics_step_batched(sys, rb.BodyState(*(x.double() for x in st)), actions[:, :1].double(), env.dt, env.substeps)
