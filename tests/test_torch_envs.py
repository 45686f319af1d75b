"""Parity of the port's envs (``evotorch_tpu_torch.envs``: the Humanoid and
the classic-control suite) with the JAX package, on the CPU; the other
locomotion envs are held in ``tests/test_torch_locomotion.py``.

The ``System`` every rigid-body env builds must be equal to JAX's field by
field, exactly:
both round the same float64 numpy values to float32 once. One
``batch_step`` (8 physics substeps) from the same injected small-noise
states and actions must then agree in observation, reward and done. The
dynamics are stiff (joint springs up to 250 rad/s), so float32 round-off
from different summation orders grows over the substeps; the tolerance is
``atol=2e-4`` on observations and rewards of magnitude ~1-10.

Resets: a row of raw draws taken from the JAX chain (normals for the
Humanoid, ``[0, 1)`` uniforms for the classic envs) gives the JAX reset to
float32 rounding (``atol=1e-6``; XLA may contract ``u * span + lo`` into an
FMA). The classic envs' ``batch_step`` matches ``vmap(env.step)`` at
``rtol=1e-5`` (FMA contraction again), and their dones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.envs import EnvState as JaxEnvState
from evotorch_tpu.envs import Humanoid as JaxHumanoid
from evotorch_tpu.envs.rigidbody import BodyState as JaxBodyState
from evotorch_tpu_torch.envs import EnvState, Humanoid
from evotorch_tpu_torch.envs.rigidbody import BodyState


RIGID = ["humanoid", "ant", "walker2d", "halfcheetah"]


def _rigid_pair(name, **kwargs):
    from evotorch_tpu.envs import make_env as jax_make_env
    from evotorch_tpu_torch.envs import make_env

    return jax_make_env(name, **kwargs), make_env(name, device="cpu", **kwargs)


@pytest.mark.parametrize("env_name", RIGID)
def test_system_fields_equal(env_name):
    """Every field, ``tone_k`` (Ant's ``tone=40``) and ``axes`` among them."""
    jax_env, env = _rigid_pair(env_name)
    jax_sys, sys = jax_env.sys, env.sys
    np.testing.assert_array_equal(env._default_pos.numpy(), np.asarray(jax_env._default_pos))
    for name in jax_sys._fields:
        ours, theirs = getattr(sys, name), getattr(jax_sys, name)
        if isinstance(theirs, (int, float, str)):
            assert ours == theirs, name
        else:
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=name)
            assert ours.dtype == (torch.int64 if np.asarray(theirs).dtype.kind == "i" else torch.float32), name


def _noisy_states(B, seed):
    """Default pose with small perturbations of every state component."""
    env = Humanoid(device="cpu")
    rng = np.random.default_rng(seed)
    nb = env.sys.num_bodies
    pos = env._default_pos.numpy()[:, :, None] + 0.005 * rng.normal(size=(nb, 3, B))
    pos[:, 2, :2] += 0.6  # two lanes above the healthy band: done, no alive bonus
    quat = np.zeros((nb, 4, B))
    quat[:, 0] = 1.0
    quat += 0.02 * rng.normal(size=(nb, 4, B))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    vel = 0.1 * rng.normal(size=(nb, 3, B))
    ang = 0.1 * rng.normal(size=(nb, 3, B))
    t = rng.integers(0, 5, size=B).astype(np.int32)
    actions = rng.uniform(-1.2, 1.2, size=(B, env.action_size))
    as32 = lambda x: x.astype(np.float32)  # noqa: E731
    return [as32(x) for x in (pos, quat, vel, ang)], t, as32(actions)


@pytest.mark.parametrize("act_mode", ["position", "torque"])
def test_batch_step_matches_jax(act_mode):
    B = 24
    (pos, quat, vel, ang), t, actions = _noisy_states(B, seed=1)
    jax_env = JaxHumanoid(act_mode=act_mode)
    jax_state = JaxEnvState(
        obs_state=JaxBodyState(*(jnp.asarray(x) for x in (pos, quat, vel, ang))),
        t=jnp.asarray(t),
        key=jax.random.split(jax.random.key(0), B),
    )
    _, jax_obs, jax_reward, jax_done = jax.jit(jax_env.batch_step)(jax_state, jnp.asarray(actions))

    env = Humanoid(act_mode=act_mode, device="cpu")
    state = EnvState(obs_state=BodyState(*(torch.from_numpy(x) for x in (pos, quat, vel, ang))), t=torch.from_numpy(t))
    _, obs, reward, done = env.batch_step(state, torch.from_numpy(actions))

    assert obs.shape == (B, 109)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=0, atol=2e-4)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jax_done))
    assert done[:2].all() and not done[2:].any()


def test_batch_reset_observation_matches_jax_without_noise():
    jax_env = JaxHumanoid(reset_noise_scale=0.0)
    _, jax_obs = jax_env.batch_reset(jax.random.split(jax.random.key(0), 3))
    env = Humanoid(reset_noise_scale=0.0, device="cpu")
    _, obs = env.batch_reset(3, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=0, atol=1e-6)


# ------------------------------------------- reset from noise rows, batch_take


def test_humanoid_reset_from_jax_normals_matches_jax():
    """A reset row holds the raw normals ``(2, nb, 3)`` the JAX
    ``batch_reset`` draws from ``split(key, 3)[1:]``; scaled inside by
    ``reset_noise_scale``, they give the JAX reset to float32 rounding."""
    jax_env = JaxHumanoid()
    keys = jax.random.split(jax.random.key(3), 5)
    _, jax_obs = jax_env.batch_reset(keys)
    nb = jax_env.sys.num_bodies

    def draws(k):
        parts = jax.random.split(k, 3)
        return jnp.stack([jax.random.normal(parts[1], (nb, 3)), jax.random.normal(parts[2], (nb, 3))])

    rows = torch.from_numpy(np.array(jax.vmap(draws)(keys)))
    env = Humanoid(device="cpu")
    state, obs = env.batch_reset_from(rows)
    assert obs.shape == (5, 109) and state.obs_state.vel.shape == (nb, 3, 5)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=0, atol=1e-6)


def test_batch_reset_is_reset_from_reset_noise():
    """``batch_reset`` draws exactly what ``reset_noise`` does (one
    ``randn((2, nb, 3, B))``), so the budget contract's stream is the one
    it always was."""
    env = Humanoid(device="cpu")
    nb = env.sys.num_bodies
    rows = env.reset_noise(6, torch.Generator().manual_seed(4))
    assert rows.shape == (6, 2, nb, 3)
    legacy = torch.randn((2, nb, 3, 6), generator=torch.Generator().manual_seed(4))
    assert torch.equal(rows, legacy.movedim(-1, 0))
    a_state, a_obs = env.batch_reset(6, torch.Generator().manual_seed(4))
    b_state, b_obs = env.batch_reset_from(rows)
    assert torch.equal(a_obs, b_obs)
    assert torch.equal(a_state.obs_state.vel, 0.01 * legacy[0]) and torch.equal(a_state.obs_state.ang, 0.01 * legacy[1])


def test_humanoid_batch_take():
    env = Humanoid(device="cpu")
    state, obs = env.batch_reset(5, torch.Generator().manual_seed(1))
    state = EnvState(obs_state=state.obs_state, t=torch.arange(5, dtype=torch.int32))
    idx = torch.tensor([3, 0, 3])
    taken = env.batch_take(state, idx)
    for x, y in zip(taken.obs_state, state.obs_state):
        assert torch.equal(x, y[..., idx])
    assert torch.equal(taken.t, torch.tensor([3, 0, 3], dtype=torch.int32))


# ----------------------------------------------------------- classic control

CLASSIC = [
    ("cartpole_discrete", dict(continuous_actions=False)),
    ("cartpole_continuous", dict(continuous_actions=True)),
    ("pendulum", {}),
    ("acrobot", {}),
    ("mountain_car_continuous", {}),
    ("swimmer", {}),
]


def _classic_pair(name, kwargs):
    from evotorch_tpu.envs import make_env as jax_make_env
    from evotorch_tpu_torch.envs import make_env

    key = name.replace("_discrete", "").replace("_continuous", "") if name.startswith("cartpole") else name
    return jax_make_env(key, **kwargs), make_env(key, device="cpu", **kwargs)


def _classic_draws(name, env, rng, B):
    """States spread over each env's operating range, and actions."""
    width = env.reset_width
    rows = rng.uniform(size=(B, width)).astype(np.float32)
    if name.startswith("cartpole"):
        states = rng.uniform(-0.3, 0.3, size=(B, 4)) * np.array([8.0, 3.0, 0.7, 3.0])
    elif name == "pendulum":
        states = np.stack([rng.uniform(-np.pi, np.pi, B), rng.uniform(-8, 8, B)], axis=1)
    elif name == "acrobot":
        states = rng.uniform(-1.0, 1.0, size=(B, 4)) * np.array([np.pi, np.pi, 5.0, 10.0])
    elif name == "mountain_car_continuous":
        states = np.stack([rng.uniform(-1.2, 0.6, B), rng.uniform(-0.07, 0.07, B)], axis=1)
    else:
        states = rng.uniform(-0.5, 0.5, size=(B, 2 * env.n_links + 2))
    if env.action_space.is_discrete:
        actions = rng.integers(0, env.action_space.n, size=B)
    else:
        actions = rng.uniform(-1.5, 1.5, size=(B,) + tuple(env.action_space.shape)).astype(np.float32)
    return rows, states.astype(np.float32), actions


@pytest.mark.parametrize("name,kwargs", CLASSIC, ids=[n for n, _ in CLASSIC])
def test_classic_batch_step_matches_jax(name, kwargs):
    jax_env, env = _classic_pair(name, kwargs)
    B = 32
    rng = np.random.default_rng(len(name))
    _, states, actions = _classic_draws(name, env, rng, B)
    t = rng.integers(0, env.max_episode_steps, size=B).astype(np.int32)
    t[:2] = env.max_episode_steps - 1  # time limits
    jax_state = JaxEnvState(obs_state=jnp.asarray(states), t=jnp.asarray(t), key=jax.random.split(jax.random.key(0), B))
    _, jax_obs, jax_reward, jax_done = jax.jit(jax.vmap(jax_env.step))(jax_state, jnp.asarray(actions))
    state = EnvState(obs_state=torch.from_numpy(states), t=torch.from_numpy(t))
    new_state, obs, reward, done = env.batch_step(state, torch.from_numpy(actions))
    assert obs.shape == (B, env.observation_size) and reward.shape == (B,) and done.dtype == torch.bool
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jax_done))
    assert done[:2].all()
    assert torch.equal(new_state.t, torch.from_numpy(t) + 1)


@pytest.mark.parametrize("name,kwargs", CLASSIC, ids=[n for n, _ in CLASSIC])
def test_classic_reset_from_jax_uniforms_matches_jax(name, kwargs):
    """A reset row holds the raw ``[0, 1)`` uniforms the JAX ``reset``
    draws; mapped into the env's ranges they give the JAX reset."""
    jax_env, env = _classic_pair(name, kwargs)
    keys = jax.random.split(jax.random.key(9), 6)
    _, jax_obs = jax.vmap(jax_env.reset)(keys)

    def draws(k):
        out = []
        for _ in range(2 if name == "pendulum" else 1):
            k, sub = jax.random.split(k)
            shape = () if name in ("pendulum", "mountain_car_continuous") else (env.reset_width,)
            out.append(jnp.reshape(jax.random.uniform(sub, shape), (-1,)))
        return jnp.concatenate(out)

    rows = torch.from_numpy(np.array(jax.vmap(draws)(keys)))
    state, obs = env.batch_reset_from(rows)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_obs), rtol=1e-6, atol=1e-7)
    assert torch.equal(state.t, torch.zeros(6, dtype=torch.int32))
    same_state, same_obs = env.batch_reset(6, torch.Generator().manual_seed(2))
    assert torch.equal(same_obs, env.batch_reset_from(env.reset_noise(6, torch.Generator().manual_seed(2)))[1])


@pytest.mark.parametrize("name,kwargs", CLASSIC, ids=[n for n, _ in CLASSIC])
def test_classic_batch_where_and_take(name, kwargs):
    _, env = _classic_pair(name, kwargs)
    a, _ = env.batch_reset(4, torch.Generator().manual_seed(0))
    b, _ = env.batch_reset(4, torch.Generator().manual_seed(1))
    b = EnvState(obs_state=b.obs_state, t=b.t + 7)
    mask = torch.tensor([True, False, False, True])
    mixed = env.batch_where(mask, a, b)
    assert torch.equal(mixed.obs_state[0], a.obs_state[0]) and torch.equal(mixed.obs_state[1], b.obs_state[1])
    assert mixed.t.tolist() == [0, 7, 7, 0]
    taken = env.batch_take(mixed, torch.tensor([2, 0]))
    assert torch.equal(taken.obs_state, mixed.obs_state[[2, 0]]) and taken.t.tolist() == [7, 0]


def test_make_env_names_and_unported_envs():
    """Every name and alias of the JAX registry builds (the locomotion envs
    too, since they are ported); only ``brax::`` still raises."""
    from evotorch_tpu.envs.registry import canonical_env_key as jax_canonical_env_key
    from evotorch_tpu_torch.envs import (
        Ant,
        CartPole,
        HalfCheetah,
        Hopper,
        Humanoid,
        Swimmer2D,
        Walker2D,
        canonical_env_key,
        make_env,
    )

    assert isinstance(make_env("CartPole-v1", device="cpu"), CartPole)
    assert make_env("cartpole", device="cpu", continuous_actions=True).action_space.shape == (1,)
    assert isinstance(make_env("swimmer", device="cpu", n_links=4), Swimmer2D)
    assert isinstance(make_env("humanoid", device="cpu"), Humanoid)
    built = {
        "hopper": Hopper,
        "ant": Ant,
        "Ant-v4": Ant,
        "walker2d": Walker2D,
        "Walker": Walker2D,
        "Walker2d-v4": Walker2D,
        "halfcheetah": HalfCheetah,
        "half_cheetah": HalfCheetah,
        "HalfCheetah-v4": HalfCheetah,
    }
    for name, cls in built.items():
        env = make_env(name, device="cpu")
        assert type(env) is cls and env.device == torch.device("cpu"), name
    for name in (
        "CartPole-v1", "mountain-car-continuous", "MountainCarContinuous", "swimmer2d", "Humanoid-v4",
        "walker", "Walker2D", "half_cheetah", "HalfCheetah-v4", "hopper", "Ant",
    ):  # fmt: skip
        assert canonical_env_key(name) == jax_canonical_env_key(name), name
    with pytest.raises(NotImplementedError, match="JAX-only"):
        make_env("brax::humanoid", device="cpu")
    with pytest.raises(ValueError, match="Unknown environment"):
        make_env("nonsense", device="cpu")
