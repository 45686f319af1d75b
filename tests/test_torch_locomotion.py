"""Parity of the port's locomotion envs (Ant, Walker2D, HalfCheetah, the
SLIP Hopper) with the JAX package on the CPU, and the single-env API.

One ``batch_step`` (8 physics substeps) from the same perturbed states and
actions must agree in observation, reward and done. As for the Humanoid
(``tests/test_torch_envs.py``), the joint springs are stiff, so float32
round-off from another summation order (XLA contracts products into FMAs,
torch on the CPU does not) grows over the substeps in the angular
velocities: observations are held at ``rtol=1e-5, atol=2e-4`` (the largest
difference measured is 1.7e-4, on angular velocities of magnitude ~1),
rewards at ``rtol=1e-5, atol=1e-6``, dones exactly. Reset rows of raw
draws taken from the JAX chain give the JAX reset to float32 rounding
(``atol=1e-6``). The Hopper, four explicit substeps of a hybrid
spring-mass model, matches ``vmap(env.step)`` at ``rtol=1e-5,
atol=1e-6`` with its stance flags exactly.

The single-env ``reset``/``step`` are the B=1 case of the batched forms,
so they are held to lane 0 of those forms bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.envs import EnvState as JaxEnvState
from evotorch_tpu.envs import make_env as jax_make_env
from evotorch_tpu.envs.rigidbody import BodyState as JaxBodyState
from evotorch_tpu_torch.envs import EnvState, make_env
from evotorch_tpu_torch.envs.rigidbody import BodyState

NEW_RIGID = ["ant", "walker2d", "halfcheetah"]
ALL_RIGID = ["humanoid"] + NEW_RIGID


def _pair(name, **kwargs):
    return jax_make_env(name, **kwargs), make_env(name, device="cpu", **kwargs)


def _perturbed(env, B, seed, *, planar_offsets=True):
    """The default pose with small perturbations of every state component
    (off the sagittal plane too), step counters and actions. Two lanes
    end: their torso is lifted above the healthy band, or, for an env
    without one, their step counter reaches the time limit."""
    rng = np.random.default_rng(seed)
    nb = env.sys.num_bodies
    pos = env._default_pos.numpy()[:, :, None] + 0.005 * rng.normal(size=(nb, 3, B))
    quat = np.zeros((nb, 4, B))
    quat[:, 0] = 1.0
    quat += 0.02 * rng.normal(size=(nb, 4, B))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    vel = 0.1 * rng.normal(size=(nb, 3, B))
    ang = 0.1 * rng.normal(size=(nb, 3, B))
    t = rng.integers(0, 5, size=B).astype(np.int32)
    if env.alive_bonus:
        pos[:, 2, :2] += env.healthy_z_range[1] - pos[0, 2, :2] + 0.3
    else:
        t[:2] = env.max_episode_steps - 1
    actions = rng.uniform(-1.2, 1.2, size=(B, env.action_size))
    as32 = lambda x: x.astype(np.float32)  # noqa: E731
    return [as32(x) for x in (pos, quat, vel, ang)], t, as32(actions)


def _states(fields, t, B):
    jax_state = JaxEnvState(
        obs_state=JaxBodyState(*(jnp.asarray(x) for x in fields)),
        t=jnp.asarray(t),
        key=jax.random.split(jax.random.key(0), B),
    )
    state = EnvState(obs_state=BodyState(*(torch.from_numpy(x) for x in fields)), t=torch.from_numpy(t))
    return jax_state, state


@pytest.mark.parametrize("act_mode", ["position", "torque"])
@pytest.mark.parametrize("env_name", NEW_RIGID)
def test_locomotion_batch_step_matches_jax(env_name, act_mode):
    jax_env, env = _pair(env_name, act_mode=act_mode)
    B = 24
    fields, t, actions = _perturbed(env, B, seed=1)
    jax_state, state = _states(fields, t, B)
    jax_new, jax_obs, jax_reward, jax_done = jax.jit(jax_env.batch_step)(jax_state, jnp.asarray(actions))
    new, obs, reward, done = env.batch_step(state, torch.from_numpy(actions))

    assert obs.shape == (B, jax_env.observation_size) and env.observation_size == jax_env.observation_size
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jax_done))
    assert done[:2].all() and not done[2:].any()
    for ours, theirs in zip(new.obs_state, jax_new.obs_state):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=2e-4)
    if env.planar:
        # on the plane: y pinned to the body plan, no lateral velocity, no
        # roll or yaw rates, pure y-rotations
        st = new.obs_state
        assert torch.equal(st.pos[:, 1], env._default_pos[:, 1:2].expand(-1, B))
        assert not st.vel[:, 1].any() and not st.ang[:, 0].any() and not st.ang[:, 2].any()
        assert not st.quat[:, 1].any() and not st.quat[:, 3].any()


def test_ant_dimensions():
    env = make_env("ant", device="cpu")
    assert (env.sys.num_bodies, env.sys.num_joints, env.action_size, env.observation_size) == (9, 8, 8, 79)
    assert torch.all(env.sys.tone_k == 40.0)


@pytest.mark.parametrize("env_name", NEW_RIGID)
def test_locomotion_reset_from_jax_normals_matches_jax(env_name):
    """A reset row holds the raw normals ``(2, nb, 3)`` the JAX
    ``batch_reset`` draws from ``split(key, 3)[1:]``."""
    jax_env, env = _pair(env_name)
    keys = jax.random.split(jax.random.key(3), 5)
    _, jax_obs = jax_env.batch_reset(keys)
    nb = jax_env.sys.num_bodies

    def draws(k):
        parts = jax.random.split(k, 3)
        return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

    rows = torch.from_numpy(np.array(jax.vmap(draws)(keys)))
    state, obs = env.batch_reset_from(rows)
    assert obs.shape == (5, env.observation_size) and state.obs_state.vel.shape == (nb, 3, 5)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("env_name", ["walker2d", "halfcheetah"])
def test_planar_project_matches_jax(env_name):
    """The projection alone, on states off the plane: equal to JAX's up to
    the rounding of ``w*w + y*y`` (one float32 ulp of the quaternion)."""
    jax_env, env = _pair(env_name)
    fields, _, _ = _perturbed(env, 16, seed=7)
    fields[1] = fields[1] * np.float32(1.5)  # unnormalized quaternions: the renormalization shows
    fields[1][:, :, 0] = 0.0  # a lane at w = y = 0: the 1e-12 floor
    theirs = jax_env._planar_project(JaxBodyState(*(jnp.asarray(x) for x in fields)))
    ours = env._planar_project(BodyState(*(torch.from_numpy(x) for x in fields)))
    for name, a, b in zip(BodyState._fields, ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0, err_msg=name)
    # each field is a tensor of its own: writing one lane changes no other
    pos = ours.pos
    pos[:, 1, 0] += 1.0
    assert torch.equal(pos[:, 1, 1], env._default_pos[:, 1])


@pytest.mark.parametrize("env_name", ALL_RIGID)
def test_batch_reward_terms_match_jax_and_sum_to_the_reward(env_name):
    jax_env, env = _pair(env_name)
    B = 24
    fields, t, actions = _perturbed(env, B, seed=2)
    jax_state, state = _states(fields, t, B)
    new, _, reward, _ = env.batch_step(state, torch.from_numpy(actions))
    a = torch.clamp(torch.from_numpy(actions), -1.0, 1.0).t()
    terms = env.batch_reward_terms(new.obs_state, a)
    jax_terms = jax_env.batch_reward_terms(JaxBodyState(*(jnp.asarray(x.numpy()) for x in new.obs_state)), jnp.asarray(a.numpy()))
    assert set(terms) == set(jax_terms)
    for key in terms:
        np.testing.assert_allclose(terms[key].numpy(), np.asarray(jax_terms[key]), rtol=1e-6, atol=1e-7, err_msg=key)
    total = terms["reward_forward"] + terms["reward_ctrl"] + terms["reward_survive"]
    torch.testing.assert_close(total, reward, rtol=1e-6, atol=1e-6)
    assert terms["healthy"].dtype == torch.bool


# ---------------------------------------------------------------- the Hopper


def _hopper_states(B, seed):
    """Lanes in flight and in stance, near touchdown and liftoff, two of
    them falling, two at the time limit."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, B)
    theta = rng.uniform(-0.4, 0.4, B)
    stance = (rng.uniform(size=B) < 0.5).astype(np.float64)
    z = np.where(stance > 0.5, rng.uniform(0.85, 1.1, B), np.cos(theta) + rng.uniform(-0.01, 0.05, B))
    vx = rng.uniform(-1.0, 2.0, B)
    vz = rng.uniform(-1.5, 1.5, B)
    foot_x = np.where(stance > 0.5, x + rng.uniform(-0.3, 0.3, B), x + rng.uniform(-0.4, 0.4, B))
    z[:2], vz[:2], stance[:2] = 0.34, -1.0, 0.0  # falling
    s = np.stack([x, z, vx, vz, theta, foot_x, stance]).astype(np.float32)  # (7, B)
    t = rng.integers(0, 900, size=B).astype(np.int32)
    t[2:4] = 999
    actions = rng.uniform(-1.5, 1.5, size=(B, 2)).astype(np.float32)
    return s, t, actions


def test_hopper_batch_step_matches_jax():
    jax_env, env = _pair("hopper")
    B = 64
    s, t, actions = _hopper_states(B, seed=3)
    jax_state = JaxEnvState(obs_state=jnp.asarray(s.T), t=jnp.asarray(t), key=jax.random.split(jax.random.key(0), B))
    jax_new, jax_obs, jax_reward, jax_done = jax.jit(jax.vmap(jax_env.step))(jax_state, jnp.asarray(actions))
    new, obs, reward, done = env.batch_step(EnvState(obs_state=torch.from_numpy(s), t=torch.from_numpy(t)), torch.from_numpy(actions))
    assert new.obs_state.shape == (7, B) and obs.shape == (B, 7)
    stance, jax_stance = new.obs_state[6].numpy(), np.asarray(jax_new.obs_state)[:, 6]
    np.testing.assert_array_equal(stance, jax_stance)
    # both phase changes happen in this step, on the same lanes
    assert ((s[6] < 0.5) & (stance > 0.5)).any() and ((s[6] > 0.5) & (stance < 0.5)).any()
    np.testing.assert_allclose(new.obs_state.numpy(), np.asarray(jax_new.obs_state).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jax_done))
    assert done[:4].all()
    assert torch.equal(new.t, torch.from_numpy(t) + 1)


def test_hopper_reset_from_jax_uniforms_matches_jax():
    """A reset row holds the two perturbations the JAX ``reset`` draws,
    uniforms in ``[-0.05, 0.05)``; ``reset_noise`` draws rows of that form."""
    jax_env, env = _pair("hopper")
    keys = jax.random.split(jax.random.key(9), 6)
    _, jax_obs = jax.vmap(jax_env.reset)(keys)
    rows = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (2,), minval=-0.05, maxval=0.05))(keys)
    state, obs = env.batch_reset_from(torch.from_numpy(np.array(rows)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-6, atol=1e-7)
    assert state.obs_state.shape == (7, 6) and torch.equal(state.t, torch.zeros(6, dtype=torch.int32))
    drawn = env.reset_noise(1000, torch.Generator().manual_seed(0))
    assert drawn.shape == (1000, 2) and bool((drawn >= -0.05).all() and (drawn < 0.05).all())


def test_hopper_batch_where_and_take():
    env = make_env("hopper", device="cpu")
    a, _ = env.batch_reset(4, torch.Generator().manual_seed(0))
    b, _ = env.batch_reset(4, torch.Generator().manual_seed(1))
    b = EnvState(obs_state=b.obs_state, t=b.t + 7)
    mixed = env.batch_where(torch.tensor([True, False, False, True]), a, b)
    assert torch.equal(mixed.obs_state[:, 0], a.obs_state[:, 0]) and torch.equal(mixed.obs_state[:, 1], b.obs_state[:, 1])
    assert mixed.t.tolist() == [0, 7, 7, 0]
    taken = env.batch_take(mixed, torch.tensor([2, 0]))
    assert torch.equal(taken.obs_state, mixed.obs_state[:, [2, 0]]) and taken.t.tolist() == [7, 0]


# ------------------------------------------------------ the single-env API

SINGLE = [
    ("cartpole", {}),
    ("cartpole", dict(continuous_actions=True)),
    ("pendulum", {}),
    ("acrobot", {}),
    ("mountain_car_continuous", {}),
    ("swimmer", {}),
    ("hopper", {}),
    ("humanoid", {}),
    ("ant", {}),
    ("walker2d", {}),
    ("halfcheetah", {}),
]


@pytest.mark.parametrize("name,kwargs", SINGLE, ids=[n + ("_continuous" if k else "") for n, k in SINGLE])
def test_single_env_reset_and_step_are_the_batch_of_one(name, kwargs):
    env = make_env(name, device="cpu", **kwargs)
    state, obs = env.reset(torch.Generator().manual_seed(5))
    bstate, bobs = env.batch_reset_from(env.reset_noise(1, torch.Generator().manual_seed(5)))
    assert obs.shape == (env.observation_size,) and torch.equal(obs, bobs[0])
    assert state.t.shape == () and int(state.t) == 0
    space = env.action_space
    if space.is_discrete:
        action = torch.tensor(1)
    else:
        action = torch.linspace(-0.9, 0.9, env.action_size)
    for _ in range(3):
        state, obs, reward, done = env.step(state, action)
        bstate, bobs, breward, bdone = env.batch_step(bstate, action.reshape((1,) + tuple(space.shape)))
        assert obs.shape == (env.observation_size,) and reward.shape == () and done.shape == ()
        assert torch.equal(obs, bobs[0]) and torch.equal(reward, breward[0]) and torch.equal(done, bdone[0])
    for ours, batched in zip(
        (state.obs_state,) if isinstance(state.obs_state, torch.Tensor) else state.obs_state,
        (bstate.obs_state,) if isinstance(bstate.obs_state, torch.Tensor) else bstate.obs_state,
    ):
        assert torch.equal(ours, batched.select(env.state_lane_axis, 0))
    assert int(state.t) == 3


@pytest.mark.parametrize("env_name", ["ant", "hopper"])
def test_single_env_step_matches_the_jax_single_step(env_name):
    """The port's single step from JAX's own reset state gives JAX's single
    step (tolerances as for the batched forms)."""
    jax_env, env = _pair(env_name)
    jax_state, jax_obs = jax_env.reset(jax.random.key(11))
    action = np.linspace(-0.8, 0.8, env.action_size).astype(np.float32)
    _, jax_obs, jax_reward, jax_done = jax_env.step(jax_state, jnp.asarray(action))
    obs_state = jax_state.obs_state
    if isinstance(obs_state, JaxBodyState):
        obs_state = BodyState(*(torch.from_numpy(np.array(x)) for x in obs_state))
    else:
        obs_state = torch.from_numpy(np.array(obs_state))
    state = EnvState(obs_state=obs_state, t=torch.tensor(int(jax_state.t), dtype=torch.int32))
    _, obs, reward, done = env.step(state, torch.from_numpy(action))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(float(reward), float(jax_reward), rtol=1e-5, atol=1e-6)
    assert bool(done) == bool(jax_done)
