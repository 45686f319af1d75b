"""The real-MuJoCo backend in the port against the JAX package, on the CPU:
``MjVecEnv`` on Hopper-v5 and InvertedPendulum-v5 from the same seeds and
actions, bit for bit (observations, rewards, dones, the reward terms, the
physics state: the same host numpy over the same ``mujoco.rollout``);
``make_host_vector_env``'s fallback to the port's ``SyncVectorEnv`` for an
env outside the family table; the pipelined engine over ``MjVecEnv``
against the JAX engine; and the fidelity harness at a few steps: its
MuJoCo side equal to the JAX harness's, its native side (the port's torch
envs, whose resets draw from a ``torch.Generator`` and not from JAX's key)
held where the native trace depends only on the actions: the control cost,
to ``rtol=1e-5``."""

import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")
gym = pytest.importorskip("gymnasium")

import evotorch_tpu.envs.mujoco.fidelity as JFid  # noqa: E402
import evotorch_tpu.envs.mujoco.mjvecenv as JMj  # noqa: E402
import evotorch_tpu.models as JM  # noqa: E402
import evotorch_tpu.neuroevolution.net.hostvecenv as JH  # noqa: E402
import evotorch_tpu_torch.envs.mujoco as PMuj  # noqa: E402
import evotorch_tpu_torch.envs.mujoco.fidelity as PFid  # noqa: E402
import evotorch_tpu_torch.envs.mujoco.mjvecenv as PMj  # noqa: E402
import evotorch_tpu_torch.models as PM  # noqa: E402
import evotorch_tpu_torch.neuroevolution.net.hostvecenv as PH  # noqa: E402
from evotorch_tpu.neuroevolution.net import FlatParamsPolicy as JaxFlatParamsPolicy  # noqa: E402
from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy  # noqa: E402


def _pair(env_id, n, seed=11):
    ours = PMj.MjVecEnv(lambda: gym.make(env_id), n, nthread=2)
    theirs = JMj.MjVecEnv(lambda: gym.make(env_id), n, nthread=2)
    for vec in (ours, theirs):
        vec.seed([seed + i for i in range(n)])
    return ours, theirs


@pytest.mark.parametrize("env_id,steps", [("Hopper-v5", 40), ("InvertedPendulum-v5", 30)])
def test_mjvecenv_matches_jax_bit_for_bit(env_id, steps):
    ours, theirs = _pair(env_id, 5)
    try:
        np.testing.assert_array_equal(ours.reset(), theirs.reset())
        rng = np.random.default_rng(0)
        dims = int(np.prod(ours.action_space.shape))
        for _ in range(steps):
            actions = rng.uniform(-1, 1, size=(5, dims))
            active = rng.random(5) < 0.9
            a, b = ours.step(actions, active=active), theirs.step(actions, active=active)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert ours.last_terms.keys() == theirs.last_terms.keys()
            for k in ours.last_terms:
                np.testing.assert_array_equal(ours.last_terms[k], theirs.last_terms[k])
            np.testing.assert_array_equal(ours._state, theirs._state)
    finally:
        ours.close()
        theirs.close()


def test_make_host_vector_env_falls_back_for_other_envs():
    vec = PMuj.make_host_vector_env(lambda: gym.make("CartPole-v1"), 3)
    assert isinstance(vec, PH.SyncVectorEnv) and vec.num_envs == 3
    vec.close()
    vec = PMuj.make_host_vector_env(lambda: gym.make("Hopper-v5"), 2)
    assert isinstance(vec, PMj.MjVecEnv)
    vec.close()
    assert PMuj.mujoco_available()
    with pytest.raises(ValueError, match="does not support"):
        PMj.MjVecEnv(lambda: gym.make("CartPole-v1"), 2)


def test_pipelined_engine_over_mjvecenv_matches_jax():
    policy = FlatParamsPolicy(PM.LinearPolicy(11, 3))
    jpolicy = JaxFlatParamsPolicy(JM.LinearPolicy(11, 3))
    params = (np.random.default_rng(1).normal(size=(6, policy.parameter_count)) * 0.1).astype(np.float32)
    ours, theirs = _pair("Hopper-v5", 4)
    kw = dict(num_episodes=1, episode_length=20, num_blocks=2)
    a = PH.run_host_pipelined_rollout(ours, policy, torch.from_numpy(params), device="cpu", **kw)
    b = JH.run_host_pipelined_rollout(theirs, jpolicy, params, **kw)
    ours.close()
    theirs.close()
    for k in ("interactions", "episodes", "episode_steps", "lane_episodes", "block_iters"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    # the actions agree to float32 rounding; 20 Hopper steps keep the
    # returns within that at this gentle scale
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-4, atol=1e-4)


def test_fidelity_harness_matches_jax_at_a_few_steps():
    kw = dict(n_seqs=3, n_steps=6, seed=0)
    ours = PFid.run_fidelity(["halfcheetah", "cartpole"], device="cpu", **kw)
    theirs = JFid.run_fidelity(["halfcheetah", "cartpole"], **kw)
    assert ours["config"] == theirs["config"]
    for name in ("halfcheetah", "cartpole"):
        a, b = ours["pairs"][name], theirs["pairs"][name]
        assert a["mujoco_env"] == b["mujoco_env"] and a["action_dim"] == b["action_dim"]
        assert a["native_weights"] == b["native_weights"]
        assert a["terms"].keys() == b["terms"].keys()
        assert a["episode"]["mujoco_mean_length"] == b["episode"]["mujoco_mean_length"]
        for term in a["terms"]:
            assert a["terms"][term]["mujoco_mean"] == b["terms"][term]["mujoco_mean"], term
    ctrl_a = ours["pairs"]["halfcheetah"]["terms"]["reward_ctrl"]
    ctrl_b = theirs["pairs"]["halfcheetah"]["terms"]["reward_ctrl"]
    np.testing.assert_allclose(ctrl_a["native_mean"], ctrl_b["native_mean"], rtol=1e-5)
    text = PFid.format_fidelity_markdown(ours)
    assert "halfcheetah vs HalfCheetah-v5" in text and "evotorch_tpu_torch" in text
