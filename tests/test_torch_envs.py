"""Parity of the port's Humanoid (``evotorch_tpu_torch.envs``) with the JAX
package, on the CPU.

The ``System`` both packages build must be equal field by field, exactly:
both round the same float64 numpy values to float32 once. One
``batch_step`` (8 physics substeps) from the same injected small-noise
states and actions must then agree in observation, reward and done. The
dynamics are stiff (joint springs up to 250 rad/s), so float32 round-off
from different summation orders grows over the substeps; the tolerance is
``atol=2e-4`` on observations and rewards of magnitude ~1-10.
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


def test_system_fields_equal():
    jax_sys = JaxHumanoid().sys
    sys = Humanoid(device="cpu").sys
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
