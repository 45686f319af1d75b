"""The CUDA kernels of ``evotorch_tpu_torch`` against their plain PyTorch
versions, and the episodes contracts against the same contracts on the
CPU, on the card. These tests need a CUDA device (and ``nvcc`` for the
kernels); each decides inside the test (never at import) and skips without
a card.

Run them on a machine with the card:
``python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
root ``conftest.py`` imports JAX, which that machine need not have).
``chip_smoke.py`` holds the kernels to the same checks at the flagship shapes.

Tolerances: the ranking kernel must equal its plain version exactly; the
sampling kernel too. Both versions take the same Philox counters and the
same float32 steps without fast math: ``logf``, ``sqrtf``, and ``sincosf``,
which gives the values of the ``sinf`` and ``cosf`` that ``torch.sin`` and
``torch.cos`` call on the card, of the same angle ``2*pi*u2``; and the scale
and +/- are written so that nvcc cannot contract them into an FMA.
"""

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.ops import ranking, sampling


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# n (csrc/centered_rank.cu's tiling: kR = 4 i per thread, 128 threads, j-tiles
# of 512, j-splits of equal length on multiples of 16): the smallest; one
# thread's 4 values +/- 1; a warp's i range (128) +/- 1; a block's i range
# (kThreads * kR = 512, also a tile) +/- 1; 1,023 and 1,025, which end one
# 16-j split before and after its boundary (64 and 65 splits); the flagship
# 10,000 (66 splits of ~152 j). Batched rows, where a split holds several
# tiles and ends in a short one: 64 x 3,000 (splits of 992 and 1,008 j),
# 8 x 10,000 (5 splits of 2,000 j); and 3 x 1,537 (66 splits of 16-32 j).
RANK_SHAPES = [
    (2,), (3,), (5,), (127,), (129,), (511,), (513,), (1023,), (1025,), (10000,),
    (3, 1537), (64, 3000), (8, 10000), (2, 2, 300),
]  # fmt: skip


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RANK_SHAPES)
@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int16])
def test_centered_rank_kernel_equals_plain(device, shape, higher_is_better, dtype):
    g = torch.Generator(device=device).manual_seed(shape[-1])
    x = torch.randint(-5, 5, shape, generator=g, device=device).to(dtype)  # many ties
    if dtype.is_floating_point and shape[-1] > 6:
        x[..., 1] = float("nan")
        x[..., 3] = float("inf")
        x[..., 4] = -float("inf")
        x[..., 5] = -0.0
        x[..., -1] = float("nan")
    before = ranking.centered_rank.launches
    got = ranking.centered_rank(x, higher_is_better=higher_is_better)
    assert ranking.centered_rank.launches == before + 1
    assert torch.equal(got, ranking.centered_rank_plain(x, higher_is_better=higher_is_better))


@pytest.mark.cuda
def test_centered_rank_kernel_rejects_int64(device):
    with pytest.raises(TypeError):
        ranking.centered_rank(torch.arange(5, device=device))


@pytest.mark.cuda
# L = 0, 1, 2, 3 (mod 4), L < 4, a row shorter than a warp's 128 columns,
# num_solutions = 2, and the flagship width
@pytest.mark.parametrize(
    "num_solutions,length",
    [(2, 1), (2, 3), (6, 2), (6, 4), (6, 7), (10, 513), (10, 514), (10, 515), (10, 516), (2, 12305), (64, 12305)],
)
def test_sampling_kernel_equals_plain(device, num_solutions, length):
    g = torch.Generator(device=device).manual_seed(length)
    mu = torch.randn(length, generator=g, device=device)
    sigma = torch.rand(length, generator=g, device=device) + 0.05
    seed = sampling.draw_seed(g, device)
    before = sampling.sample_symmetric_gaussian.launches
    got = sampling.sample_symmetric_gaussian(mu, sigma, num_solutions, seed=seed)
    assert sampling.sample_symmetric_gaussian.launches == before + 1
    assert torch.equal(got, sampling.sample_symmetric_gaussian_plain(mu, sigma, num_solutions, seed=seed))
    eps = torch.randn(num_solutions // 2, length, generator=g, device=device)
    got = sampling.sample_symmetric_gaussian(mu, sigma, num_solutions, eps=eps)
    assert torch.equal(got, sampling.sample_symmetric_gaussian_plain(mu, sigma, num_solutions, eps=eps))


@pytest.mark.cuda
def test_sampling_kernel_rejects_float64(device):
    mu = torch.zeros(3, device=device, dtype=torch.float64)
    with pytest.raises(TypeError):
        sampling.sample_symmetric_gaussian(mu, mu + 1, 4, generator=torch.Generator(device=device))


# ------------------------------------------------- the episodes contracts on the card

CONTRACTS = ["episodes", "episodes_refill", "episodes_compact"]


def _cartpole_contract(device, eval_mode, num_episodes, popsize=256):
    """CartPole (continuous actions) under one contract, reset noise from
    one seeded table, a linear policy with seeded weights."""
    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import (
        FlatParamsPolicy,
        Linear,
        run_vectorized_rollout,
        run_vectorized_rollout_compacting,
    )

    env = CartPole(continuous_actions=True, device=device)
    policy = FlatParamsPolicy(Linear(4, 1))
    params = torch.randn((popsize, policy.parameter_count), generator=torch.Generator().manual_seed(1)).to(device)
    table = env.reset_noise(popsize * num_episodes, torch.Generator().manual_seed(2)).to(device)
    kw = dict(num_episodes=num_episodes, episode_length=200, reset_noise=table, loop_stats={})
    if eval_mode == "episodes_compact":
        result = run_vectorized_rollout_compacting(
            env, policy, params, None, None, allowed_widths=(32, 64, 128), chunk_size=10, **kw
        )
    else:
        extra = dict(refill_width=64) if eval_mode == "episodes_refill" else {}
        result = run_vectorized_rollout(env, policy, params, None, None, eval_mode=eval_mode, **kw, **extra)
    return result, kw["loop_stats"]


@pytest.mark.cuda
@pytest.mark.parametrize("num_episodes", [1, 2])
@pytest.mark.parametrize("eval_mode", CONTRACTS)
def test_contract_on_card_matches_cpu(device, eval_mode, num_episodes):
    """Tolerance: an episode ends where a threshold is crossed and the card
    rounds some steps differently (a division by a constant is a product
    by its reciprocal there), so one ulp can move an end by a step: at
    most 1% of the scores may differ by more than 1e-4 relative, and
    ``total_steps`` by 0.5%. The counters hold exactly on each device."""
    from evotorch_tpu_torch.observability import GroupTelemetry

    ours, _ = _cartpole_contract(device, eval_mode, num_episodes)
    ref, _ = _cartpole_contract(torch.device("cpu"), eval_mode, num_episodes)
    assert ours.scores.device.type == "cuda" and ours.telemetry.shape == (1, 20)
    for result in (ours, ref):
        tele = GroupTelemetry.from_array(result.telemetry).total()
        assert tele.episodes == int(result.total_episodes) == 256 * num_episodes
        assert tele.env_steps == result.total_steps
    close = torch.isclose(ours.scores.cpu(), ref.scores, rtol=1e-4, atol=0)
    assert int((~close).sum()) <= 2, torch.nonzero(~close).flatten().tolist()
    assert abs(ours.total_steps - ref.total_steps) <= 0.005 * ref.total_steps


@pytest.mark.cuda
@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill"])
def test_episode_loops_do_not_sync_per_step(device, eval_mode):
    """Under ``set_sync_debug_mode("warn")`` every host sync warns. The
    loop watches its end through non-blocking copies and events, so the
    warnings are a constant few (the packing of the result), not one per
    control step."""
    import warnings

    _cartpole_contract(device, eval_mode, 1)  # warm up
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result, loop_stats = _cartpole_contract(device, eval_mode, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    assert loop_stats["steps_issued"] >= 50
    assert len(syncs) <= 4 + loop_stats["steps_issued"] // 8, [str(w.message) for w in syncs]
    assert loop_stats["steps_issued"] - loop_stats["steps"] <= 8 + 1


@pytest.mark.cuda
def test_budget_on_card_matches_cpu(device):
    """``budget`` draws its resets from the generator every step, and the
    card's generator is not the CPU's, so the comparison takes noise-free
    Humanoid resets and a gentle population (center and stdev 0.01, where
    round-off stays small) over 10 steps: scores (returns ~50) to 1e-4,
    the counters and the telemetry's counter block exactly."""
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, run_vectorized_rollout, tanh_mlp

    policy = FlatParamsPolicy(tanh_mlp(109, 17, [64, 64]))
    g = torch.Generator().manual_seed(3)
    params = 0.01 * torch.randn(policy.parameter_count, generator=g) + 0.01 * torch.randn((256, policy.parameter_count), generator=g)
    results = {}
    for dev in (device, torch.device("cpu")):
        env = Humanoid(reset_noise_scale=0.0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        results[dev.type] = run_vectorized_rollout(
            env, policy, params.to(dev), gen, None, episode_length=10, eval_mode="budget"
        )
    ours, ref = results["cuda"], results["cpu"]
    assert ours.total_steps == ref.total_steps == 2560
    torch.testing.assert_close(ours.scores.cpu(), ref.scores, rtol=0, atol=1e-4)
    assert torch.equal(ours.telemetry.cpu()[:, :15], ref.telemetry[:, :15])


# ------------------------------------------------------------- the OO layer on the card


def _oo_searcher(device, episode_length, *, compute_dtype=None):
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE

    problem = VecNE(
        "humanoid",
        "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)",
        observation_normalization=True,
        episode_length=episode_length,
        eval_mode="budget",
        compute_dtype=compute_dtype,
        seed=0,
        device=device,
    )
    return PGPE(
        problem,
        popsize=256,
        center_learning_rate=0.06,
        stdev_learning_rate=0.1,
        radius_init=0.27,
        optimizer="clipup",
        optimizer_config={"max_speed": 0.12},
        ranking_method="centered",
    )


def _syncs_in_step(searcher) -> list:
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            searcher.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]


@pytest.mark.cuda
def test_oo_step_syncs_a_constant_few(device):
    """An OO generation (``PGPE.step`` on ``VecNE``, budget, bf16,
    normalization on, no logger) makes at most 2 host syncs under
    ``set_sync_debug_mode("warn")``, whatever the episode length (5 or 40
    control steps): none per control step, and the status stays on the
    device until a key is read."""
    counts = {}
    for episode_length in (5, 40):
        searcher = _oo_searcher(device, episode_length, compute_dtype=torch.bfloat16)
        searcher.step()  # the first generation (no tell) and the kernel builds
        searcher.step()
        counts[episode_length] = _syncs_in_step(searcher)
    assert len(counts[5]) == len(counts[40]) <= 2, counts


@pytest.mark.cuda
def test_oo_bf16_generation_on_card_matches_cpu(device):
    """One OO generation with ``compute_dtype=torch.bfloat16`` on the card
    and on the CPU from the same population and noise-free resets: the
    scores of a gentle population (center and stdev 0.01) over 10 steps
    agree to 0.1 absolute (returns ~50; bf16 keeps 8 bits of mantissa, and
    the card's bf16 ``baddbmm`` accumulates in another order)."""
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution import VecNE

    g = torch.Generator().manual_seed(4)
    values = None
    scores = {}
    for dev in (device, torch.device("cpu")):
        problem = VecNE(
            Humanoid(reset_noise_scale=0.0, device=dev),
            "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)",
            episode_length=10,
            eval_mode="budget",
            compute_dtype=torch.bfloat16,
            device=dev,
        )
        if values is None:
            L = problem.solution_length
            values = 0.01 * torch.randn(L, generator=g) + 0.01 * torch.randn((64, L), generator=g)
        batch = SolutionBatch(problem, 64, values=values.to(dev))
        problem.evaluate(batch)
        scores[dev.type] = batch.evals[:, 0].cpu()
    torch.testing.assert_close(scores["cuda"], scores["cpu"], rtol=0, atol=0.1)


# ------------------------------------------------- the locomotion envs on the card


@pytest.mark.cuda
@pytest.mark.parametrize("env_name", ["walker2d", "halfcheetah", "ant", "hopper"])
def test_locomotion_batch_step_on_card_matches_cpu(device, env_name):
    """One ``batch_step`` of each locomotion env (the planar projection
    included) from the same perturbed states and actions on the card and
    on the CPU: observations within ``rtol=1e-5, atol=2e-4``, rewards within
    ``rtol=1e-5, atol=1e-5``, dones exactly (the CPU parity tests'
    tolerances for one step against JAX)."""
    from evotorch_tpu_torch.envs import EnvState, make_env

    results = {}
    for dev in (device, torch.device("cpu")):
        env = make_env(env_name, device=dev)
        g = torch.Generator().manual_seed(8)
        state, _ = env.batch_reset_from(env.reset_noise(512, g).to(dev))
        noisy = env._map_state(lambda x: x + 0.01 * torch.randn(x.shape, generator=g).to(dev), state.obs_state)
        state = EnvState(obs_state=noisy, t=state.t)
        actions = torch.empty((512, env.action_size)).uniform_(-1.2, 1.2, generator=g).to(dev)
        new, obs, reward, done = env.batch_step(state, actions)
        results[dev.type] = (new, obs.cpu(), reward.cpu(), done.cpu())
    (_, obs, reward, done), (_, cpu_obs, cpu_reward, cpu_done) = results["cuda"], results["cpu"]
    torch.testing.assert_close(obs, cpu_obs, rtol=1e-5, atol=2e-4)
    torch.testing.assert_close(reward, cpu_reward, rtol=1e-5, atol=1e-5)
    assert torch.equal(done, cpu_done)
    if getattr(env, "planar", False):
        st = results["cuda"][0].obs_state
        assert not st.vel[:, 1].any() and not st.quat[:, 1].any() and not st.quat[:, 3].any()


def _episodes_syncs(device, env_name, episode_length=40, popsize=256):
    import warnings

    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.envs import make_env
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, tanh_mlp
    from evotorch_tpu_torch.parallel import make_generation_step

    env = make_env(env_name, device=device)
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    state = pgpe(
        center_init=torch.zeros(policy.parameter_count, device=device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=0.1,
    )
    loop_stats = {}
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize), tell=pgpe_tell, popsize=popsize,
        device=device, eval_mode="episodes", episode_length=episode_length, loop_stats=loop_stats,
    )  # fmt: skip
    generator = torch.Generator(device=device).manual_seed(0)
    stats = stats_init(env.observation_size, device=device)
    state, *_ = generation(state, generator, stats)  # builds the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            generation(state, generator, stats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()], loop_stats


@pytest.mark.cuda
def test_ant_episodes_generation_syncs_no_more_than_the_humanoid(device):
    """An Ant ``episodes`` generation makes at most the host syncs that the
    Humanoid one makes at the same popsize and episode length, and none per
    control step (one pending-flag wait per 8 steps at most)."""
    ant, ant_stats = _episodes_syncs(device, "ant")
    humanoid, _ = _episodes_syncs(device, "humanoid")
    assert len(ant) <= len(humanoid), (ant, humanoid)
    assert len(ant) <= 4 + ant_stats["steps_issued"] // 8, ant


@pytest.mark.cuda
def test_searcher_pickled_on_card_loads_back_there(device, tmp_path):
    """A searcher saved on the card loads back on the card and takes the
    step the saved one takes, bit for bit."""
    import numpy as np

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.checkpoint import load_searcher, save_searcher
    from evotorch_tpu_torch.neuroevolution import SupervisedNE

    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 4)).astype(np.float32)
    y = (X @ rng.normal(size=(4, 1))).astype(np.float32)
    problem = SupervisedNE((X, y), "Linear(4, 8) >> Tanh() >> Linear(8, 1)", minibatch_size=32, seed=3, device=device)
    searcher = PGPE(problem, popsize=64, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.2)
    searcher.run(2)
    path = str(tmp_path / "searcher.pkl")
    save_searcher(path, searcher)
    loaded = load_searcher(path)
    assert loaded.population.values.device.type == "cuda" and loaded.problem.generator.device.type == "cuda"
    searcher.step()
    loaded.step()
    assert torch.equal(loaded.population.values, searcher.population.values)
    assert torch.equal(loaded.population.evals, searcher.population.evals)
    assert torch.equal(loaded.status["center"], searcher.status["center"])


# ----------------------------------------- recurrent policies and action noise on the card

RECURRENT_SPECS = [
    "RNN(4, 16) >> Linear(16, 1)",
    "RNN(4, 16, nonlinearity='relu') >> Linear(16, 1)",
    "LSTM(4, 16) >> Linear(16, 1)",
    "FeedForwardNet(4, [(16, Tanh()), (1, None)])",
    "StructuredControlNet(in_features=4, out_features=1, num_layers=2, hidden_size=16)",
    "LocomotorNet(in_features=4, out_features=1, num_sinusoids=16)",
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", RECURRENT_SPECS)
def test_recurrent_and_structured_forward_on_card_matches_cpu(device, spec):
    """Two steps (the second from the first's state) of 512 solutions drawn
    by ``init_parameters`` on the card's generator. Tolerance ``atol=1e-5,
    rtol=1e-5``: float32 products of at most 16 terms of magnitude up to ~2,
    summed in another order on the card."""
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net
    from evotorch_tpu_torch.neuroevolution.net.layers import map_state

    policy = FlatParamsPolicy(str_to_net(spec))
    g = torch.Generator(device=device).manual_seed(3)
    params = torch.stack([policy.init_parameters(g) for _ in range(512)])
    assert params.device.type == "cuda"
    x = torch.randn((2, 512, 4), generator=g, device=device)
    outs = {}
    for dev in (device, torch.device("cpu")):
        y0, state = policy(params.to(dev), x[0].to(dev))
        y1, state = policy(params.to(dev), x[1].to(dev), state)
        outs[dev.type] = (y0, y1, state)
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    map_state(lambda a, b: torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5), outs["cuda"][2], outs["cpu"][2])


def _noisy_lstm_contract(device, eval_mode, popsize=256, loop_stats=None):
    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import (
        FlatParamsPolicy,
        run_vectorized_rollout,
        run_vectorized_rollout_compacting,
        str_to_net,
    )

    env = CartPole(continuous_actions=True, device=device)
    policy = FlatParamsPolicy(str_to_net("LSTM(4, 16) >> Linear(16, 1)"))
    params = torch.randn((popsize, policy.parameter_count), generator=torch.Generator().manual_seed(1)).to(device)
    kw = dict(
        episode_length=200,
        action_noise_stdev=0.2,
        reset_noise=env.reset_noise(popsize, torch.Generator().manual_seed(2)).to(device),
        action_noise=(0.2 * torch.randn((popsize, 200, 1), generator=torch.Generator().manual_seed(3))).to(device),
        loop_stats=loop_stats,
    )
    if eval_mode == "episodes_compact":
        return run_vectorized_rollout_compacting(env, policy, params, None, None, allowed_widths=(32, 64, 128), chunk_size=10, **kw)
    extra = dict(refill_width=64) if eval_mode == "episodes_refill" else {}
    return run_vectorized_rollout(env, policy, params, None, None, eval_mode=eval_mode, **kw, **extra)


@pytest.mark.cuda
def test_noisy_recurrent_contracts_on_card(device):
    """An LSTM with injected reset and noise tables: the three episodes
    contracts equal bit for bit on the card, and the card against the CPU
    within ``test_contract_on_card_matches_cpu``'s tolerance."""
    runs = {mode: _noisy_lstm_contract(device, mode) for mode in CONTRACTS}
    for mode, result in runs.items():
        assert torch.equal(result.scores, runs["episodes"].scores), mode
        assert result.total_steps == runs["episodes"].total_steps
    ref = _noisy_lstm_contract(torch.device("cpu"), "episodes")
    close = torch.isclose(runs["episodes"].scores.cpu(), ref.scores, rtol=1e-4, atol=0)
    assert int((~close).sum()) <= 2, torch.nonzero(~close).flatten().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill"])
def test_noisy_recurrent_loops_do_not_sync_per_step(device, eval_mode):
    """The state selects and the noise lookups add no host sync to a step
    (see ``test_episode_loops_do_not_sync_per_step``)."""
    import warnings

    _noisy_lstm_contract(device, eval_mode)  # warm up
    torch.cuda.synchronize()
    loop_stats = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _noisy_lstm_contract(device, eval_mode, loop_stats=loop_stats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    assert loop_stats["steps_issued"] >= 50
    assert len(syncs) <= 4 + loop_stats["steps_issued"] // 8, [str(w.message) for w in syncs]


@pytest.mark.cuda
def test_recurrent_vecne_and_policy_on_card(device):
    """``VecNE`` with an LSTM string and action noise on the default device
    (the card), one ``episodes`` evaluation; ``Policy`` keeps its state on
    the card."""
    from evotorch_tpu_torch.core import SolutionBatch
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.neuroevolution.net import Policy, str_to_net

    problem = VecNE("cartpole", "LSTM(obs_length, 8) >> Linear(8, act_length)", episode_length=50, action_noise_stdev=0.1,
                    env_config={"continuous_actions": True}, seed=0)  # fmt: skip
    values = 0.5 * torch.randn((64, problem.solution_length), generator=torch.Generator().manual_seed(4))
    batch = SolutionBatch(problem, 64, values=values.to(problem.device))
    problem.evaluate(batch)
    assert batch.evals.device.type == "cuda" and bool(torch.isfinite(batch.evals).all())
    policy = Policy(str_to_net("LSTM(4, 8) >> Linear(8, 1)"))
    policy.set_parameters(values[:3, : policy.parameter_count].to(device))
    out = policy(torch.randn(3, 4, device=device))
    assert out.device.type == "cuda" and policy.h[0][0].device.type == "cuda"
    policy.reset(torch.tensor([True, False, True], device=device))
    assert bool((policy.h[0][0][0] == 0).all()) and bool((policy.h[0][1][2] == 0).all())


# ------------------------------------------------- the other searchers and operators on the card


def _shared_cpu_draws(monkeypatch) -> torch.Generator:
    """The operators', CMA-ES's and the samplers' draws from one CPU
    generator (returned: seed it before each run), moved to the caller's
    device: a card run and a CPU run then start from the same draws."""
    from evotorch_tpu_torch import distributions
    from evotorch_tpu_torch.algorithms.functional import funccmaes
    from evotorch_tpu_torch.operators import functional as F

    g = torch.Generator()

    def on_cpu(draw):
        def wrapped(generator, *args):
            *rest, device = args
            out = draw(g, *rest, "cpu")
            return tuple(t.to(device) for t in out) if isinstance(out, tuple) else out.to(device)

        return wrapped

    for name in ("_draw_tournament", "_draw_cut_points", "_draw_uniform", "_draw_normal"):
        monkeypatch.setattr(F, name, on_cpu(getattr(F, name)))
    monkeypatch.setattr(
        funccmaes,
        "_draw_local_coordinates",
        lambda generator, state: torch.randn((state.popsize, state.m.shape[0]), generator=g).to(state.m.device),
    )
    monkeypatch.setattr(
        distributions, "_draw_sampler_noise", lambda generator, shape, dtype: torch.randn(shape, generator=g).to(generator.device)
    )
    return g


def _host_fitness(x):
    h = x.detach().double().cpu()
    return (torch.sum(h**2, dim=-1) + torch.sum(torch.cos(3 * h), dim=-1)).float().to(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("searcher_name", ["ga", "cosyne", "mapelites"])
def test_population_searchers_on_card_match_cpu(device, searcher_name, monkeypatch):
    """Two generations of a GA (SBX, mutation), CoSyNE and MAP-Elites at
    popsize 64 from one initial population and the same draws, on a fitness
    computed on the host: the populations within ``rtol=1e-5`` and in the
    same order; the tournaments launch the rank kernel on the card."""
    from evotorch_tpu_torch.algorithms import Cosyne, GeneticAlgorithm, MAPElites
    from evotorch_tpu_torch.core import Problem, SolutionBatch
    from evotorch_tpu_torch.operators.real import GaussianMutation, SimulatedBinaryCrossOver

    start = torch.randn((64, 16), generator=torch.Generator().manual_seed(3))
    draws = _shared_cpu_draws(monkeypatch)
    out = {}
    for dev in (device, torch.device("cpu")):
        if searcher_name == "mapelites":
            problem = Problem(
                "min", lambda x: (_host_fitness(x)[:, None], x[:, :2]), solution_length=16, initial_bounds=(-1, 1),
                eval_data_length=2, vectorized=True, device=dev,
            )  # fmt: skip
            grid = MAPElites.make_feature_grid([-1.0, -1.0], [1.0, 1.0], num_bins=8, device=dev)
            searcher = MAPElites(problem, operators=[GaussianMutation(problem, stdev=0.3)], feature_grid=grid)
        else:
            problem = Problem("min", _host_fitness, solution_length=16, initial_bounds=(-1, 1), vectorized=True, device=dev)
            if searcher_name == "ga":
                ops = [SimulatedBinaryCrossOver(problem, tournament_size=4, eta=8.0), GaussianMutation(problem, stdev=0.03)]
                searcher = GeneticAlgorithm(problem, popsize=64, operators=ops)
            else:
                searcher = Cosyne(problem, popsize=64, tournament_size=4, mutation_stdev=0.03)
        searcher._population = SolutionBatch(problem, values=start.to(dev))
        draws.manual_seed(4)
        before = ranking.centered_rank.launches
        searcher.step()
        searcher.step()
        if dev.type == "cuda" and searcher_name != "mapelites":
            assert ranking.centered_rank.launches > before
        out[dev.type] = searcher
    card, cpu = out["cuda"].population, out["cpu"].population
    torch.testing.assert_close(card.values.cpu(), cpu.values, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(card.evals.cpu(), cpu.evals, rtol=1e-5, atol=1e-6, equal_nan=True)
    if searcher_name == "mapelites":
        assert torch.equal(out["cuda"].filled.cpu(), out["cpu"].filled)
    else:
        assert torch.equal(card.argsort().cpu(), cpu.argsort())


@pytest.mark.cuda
@pytest.mark.parametrize("separable", [False, True])
def test_cmaes_tell_on_card_matches_cpu(device, separable, monkeypatch):
    """Three CMA-ES generations at d = 300 (the factor refreshed every
    generation), card against CPU from the same draws, fitnesses from the
    CPU population: ``rtol=1e-5`` on the state, ``1e-4`` on the factor."""
    from evotorch_tpu_torch.algorithms.functional import cmaes, cmaes_ask, cmaes_tell

    center = torch.randn(300, generator=torch.Generator().manual_seed(5))
    states = {}
    for dev in (device, torch.device("cpu")):
        states[dev.type] = cmaes(
            center_init=center.to(dev), stdev_init=0.5, objective_sense="min", separable=separable, limit_C_decomposition=False
        )
    draws = _shared_cpu_draws(monkeypatch)
    for gen in range(3):
        asked = {}
        for name, state in states.items():
            draws.manual_seed(10 + gen)
            asked[name] = cmaes_ask(None, state)
        f = torch.sum(asked["cpu"][1].double() ** 2, dim=-1).float()
        states = {name: cmaes_tell(s, xs, f.to(xs.device)) for name, (s, xs) in asked.items()}
        for field in ("m", "sigma", "C", "p_sigma", "p_c"):
            torch.testing.assert_close(getattr(states["cuda"], field).cpu(), getattr(states["cpu"], field), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(states["cuda"].A.cpu(), states["cpu"].A, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_pareto_sort_on_card_matches_cpu(device):
    """Pareto ranks of 3,000 Kursawe-like points exactly, crowding distances
    to ``rtol=1e-6``, Pareto utilities exactly in order."""
    from evotorch_tpu_torch.operators import functional as F

    x = torch.rand((3000, 3), generator=torch.Generator().manual_seed(6)) * 10 - 5
    evals = torch.stack([torch.sum(-10 * torch.exp(-0.2 * torch.sqrt(x[:, :-1] ** 2 + x[:, 1:] ** 2)), -1), torch.sum(x.abs() ** 0.8, -1)], 1)
    sense = ["min", "min"]
    assert torch.equal(F.pareto_ranks(evals.to(device), objective_sense=sense).cpu(), F.pareto_ranks(evals, objective_sense=sense))
    torch.testing.assert_close(
        F.crowding_distances(evals.to(device), objective_sense=sense).cpu(), F.crowding_distances(evals, objective_sense=sense), rtol=1e-6, atol=0
    )
    order_card = torch.argsort(F.pareto_utility(evals.to(device), objective_sense=sense), stable=True).cpu()
    assert torch.equal(order_card, torch.argsort(F.pareto_utility(evals, objective_sense=sense), stable=True))


@pytest.mark.cuda
def test_ga_step_syncs_a_constant_few(device):
    """A GA generation on a vectorized problem makes a handful of host
    syncs (``take_best`` reads its indices on the host), at popsize 64 as
    at 1,024: none per solution."""
    from evotorch_tpu_torch.algorithms import GeneticAlgorithm
    from evotorch_tpu_torch.core import Problem
    from evotorch_tpu_torch.operators.real import GaussianMutation, SimulatedBinaryCrossOver

    counts = {}
    for popsize in (64, 1024):
        problem = Problem("min", lambda x: torch.sum(x**2, -1), solution_length=16, initial_bounds=(-1, 1), vectorized=True, device=device)
        ops = [SimulatedBinaryCrossOver(problem, tournament_size=4, eta=8.0), GaussianMutation(problem, stdev=0.03)]
        searcher = GeneticAlgorithm(problem, popsize=popsize, operators=ops)
        searcher.step()
        counts[popsize] = len(_syncs_in_step(searcher))
    assert max(counts.values()) <= 6, counts


# ------------------------------------------------------- factored populations on the card


def _factored_batch(form, policy, device, n=64, k=4):
    """A low-rank or trunk-delta batch made on the CPU from one seed, moved
    to ``device`` tensor by tensor."""
    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask_lowrank, pgpe_ask_trunk_delta

    state = pgpe(center_init=0.2 * torch.randn(policy.parameter_count, generator=torch.Generator().manual_seed(1)),
                 center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.3)  # fmt: skip
    generator = torch.Generator().manual_seed(2)
    if form == "lowrank":
        batch = pgpe_ask_lowrank(generator, state, popsize=n, rank=k)
    else:
        batch = pgpe_ask_trunk_delta(generator, state, popsize=n, rank=k, policy=policy)
    moved = batch._replace(**{f: getattr(batch, f).to(device) for f in ("center", "basis", "coeffs")})
    if form == "trunk_delta":
        moved = moved._replace(factors=[type(f)(f.a.to(device), f.b.to(device)) for f in batch.factors])
    return batch, moved


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["lowrank", "trunk_delta"])
@pytest.mark.parametrize("spec", ["Linear(9, 32) >> Tanh() >> Linear(32, 4)", "RNN(9, 16) >> Linear(16, 4)", "LSTM(9, 16) >> Linear(16, 4)"])
def test_factored_forward_on_card_matches_cpu(device, form, spec):
    """Both factored forwards on the card against the CPU on one batch,
    over 3 steps with the state carried (float32, TF32 off): ``rtol=1e-5,
    atol=1e-5`` (sums of products of magnitude ~1 that cancel leave an
    absolute round-off: ``chip_smoke.py`` saw 2.0e-6 at an output near 0)."""
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, lowrank_forward, str_to_net, trunk_delta_forward
    from evotorch_tpu_torch.neuroevolution.net.layers import state_leaves

    policy = FlatParamsPolicy(str_to_net(spec))
    cpu_batch, card_batch = _factored_batch(form, policy, device)
    forward = lowrank_forward if form == "lowrank" else trunk_delta_forward
    states = {"cpu": None, "cuda": None}
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        obs = torch.randn(64, 9, generator=g)
        out_cpu, states["cpu"] = forward(policy, cpu_batch, None, obs, states["cpu"])
        out_card, states["cuda"] = forward(policy, card_batch, None, obs.to(device), states["cuda"])
        torch.testing.assert_close(out_card.cpu(), out_cpu, rtol=1e-5, atol=1e-5)
        for a, b in zip(state_leaves(states["cuda"]), state_leaves(states["cpu"])):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_factored_tell_on_card_launches_the_rank_kernel(device):
    """``pgpe_tell_lowrank`` on the card ranks through the kernel (one
    launch, no sampling launch) and agrees with the CPU tell: ``rtol=1e-5,
    atol=1e-6``."""
    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_tell_lowrank
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, str_to_net

    policy = FlatParamsPolicy(str_to_net("Linear(9, 32) >> Tanh() >> Linear(32, 4)"))
    cpu_batch, card_batch = _factored_batch("lowrank", policy, device, n=100, k=8)
    kw = dict(center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.3)
    evals = torch.randn(100, generator=torch.Generator().manual_seed(5))
    before = (ranking.centered_rank.launches, sampling.sample_symmetric_gaussian.launches)
    on_card = pgpe_tell_lowrank(pgpe(center_init=card_batch.center, **kw), card_batch, evals.to(device))
    assert (ranking.centered_rank.launches - before[0], sampling.sample_symmetric_gaussian.launches - before[1]) == (1, 0)
    on_cpu = pgpe_tell_lowrank(pgpe(center_init=cpu_batch.center, **kw), cpu_batch, evals)
    torch.testing.assert_close(on_card.optimizer_state.center.cpu(), on_cpu.optimizer_state.center, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(on_card.stdev.cpu(), on_cpu.stdev, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["lowrank", "trunk_delta"])
@pytest.mark.parametrize("eval_mode", ["episodes", "episodes_refill"])
def test_factored_rollout_on_card_matches_cpu_without_per_step_syncs(device, form, eval_mode):
    """A factored rollout on CartPole on the card: scores as on the CPU from
    the same reset table (``atol=1e-4``, episode lengths), no host sync per
    step (see ``test_episode_loops_do_not_sync_per_step``)."""
    import warnings

    from evotorch_tpu_torch.envs import CartPole
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, run_vectorized_rollout, str_to_net

    policy = FlatParamsPolicy(str_to_net("Linear(4, 16) >> Tanh() >> Linear(16, 1)"))
    cpu_batch, card_batch = _factored_batch(form, policy, device, n=256)
    table = CartPole(continuous_actions=True, device="cpu").reset_noise(256, torch.Generator().manual_seed(6))
    kw = dict(eval_mode=eval_mode, episode_length=100, reset_noise=table)
    if eval_mode == "episodes_refill":
        kw["refill_width"] = 64
    ref = run_vectorized_rollout(CartPole(continuous_actions=True, device="cpu"), policy, cpu_batch, torch.Generator(), None, **kw)
    env = CartPole(continuous_actions=True, device=device)
    run_vectorized_rollout(env, policy, card_batch, torch.Generator(device=device), None, **kw)  # warm up
    torch.cuda.synchronize()
    loop_stats = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = run_vectorized_rollout(env, policy, card_batch, torch.Generator(device=device), None, loop_stats=loop_stats, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    assert len(syncs) <= 4 + loop_stats["steps_issued"] // 8, [str(w.message) for w in syncs]
    torch.testing.assert_close(result.scores.cpu(), ref.scores, rtol=0, atol=1e-4)
    assert result.total_steps == ref.total_steps


@pytest.mark.cuda
def test_vecne_pgpe_lowrank_on_card(device):
    """``PGPE(lowrank_rank=)`` over a ``VecNE`` problem on the default device
    (the card): the population stays factored on the card, and a
    generation makes a constant few host syncs (the guardrail's one read of
    the previous generation's capture among them)."""
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE
    from evotorch_tpu_torch.tools.lowrank import LowRankParamsBatch

    problem = VecNE("cartpole", "Linear(obs_length, 16) >> Tanh() >> Linear(16, act_length)", episode_length=50,
                    env_config={"continuous_actions": True}, eval_mode="budget", seed=0)  # fmt: skip
    searcher = PGPE(problem, popsize=256, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1, lowrank_rank=4)
    searcher.run(3)
    values = searcher.population.values
    assert isinstance(values, LowRankParamsBatch) and values.coeffs.device.type == "cuda"
    assert searcher.status["basis_capture"] is not None
    assert len(_syncs_in_step(searcher)) <= 6


@pytest.mark.cuda
@pytest.mark.parametrize("obs_norm", [False, True], ids=["plain", "obs_norm"])
@pytest.mark.parametrize("eval_mode", ["budget", "episodes", "episodes_refill"])
def test_world_one_nccl_sharded_generation_equals_unsharded(device, eval_mode, obs_norm, tmp_path):
    """One rank over NCCL (a ``file://`` store): the sharded generation, its
    collectives on the card (with normalization, the observations gathered
    every step; under refill, the idle masks), equals the unsharded
    generation from the same seed bit for bit, and launches each kernel
    once."""
    import datetime

    import torch.distributed as dist

    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, tanh_mlp
    from evotorch_tpu_torch.parallel import default_mesh, init_distributed, make_generation_step

    assert init_distributed(
        f"file://{tmp_path / 'store'}", world_size=1, rank=0, timeout=datetime.timedelta(seconds=60)
    ) and dist.get_backend() == "nccl"
    try:
        env = Humanoid(device=device)
        policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
        out = {}
        for name, mesh in (("sharded", default_mesh()), ("unsharded", None)):
            generation = make_generation_step(
                env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=1000), tell=pgpe_tell, popsize=1000, mesh=mesh,
                num_episodes=1, episode_length=50, eval_mode=eval_mode, observation_normalization=obs_norm,
            )  # fmt: skip
            state = pgpe(
                center_init=torch.zeros(policy.parameter_count, device=device), center_learning_rate=0.1,
                stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1,
            )  # fmt: skip
            before = (sampling.sample_symmetric_gaussian.launches, ranking.centered_rank.launches)
            state, scores, _, steps, telemetry = generation(state, torch.Generator(device=device).manual_seed(0), stats_init(env.observation_size, device=device))
            after = (sampling.sample_symmetric_gaussian.launches, ranking.centered_rank.launches)
            assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
            out[name] = (scores, state.optimizer_state.center, steps, telemetry)
        (s1, c1, n1, t1), (s2, c2, n2, t2) = out["sharded"], out["unsharded"]
        assert torch.equal(s1, s2) and torch.equal(c1, c2) and n1 == n2 and torch.equal(t1, t2)
    finally:
        dist.destroy_process_group()


# ---------------------------------------- host backends and structures on the card


class _LengthEnv:
    """A gym-API env whose first action sets its episode length (as in
    ``tests/test_torch_hostenv.py``), here of width 3 so the policy forward
    is a batched product."""

    class _Box:
        def __init__(self, n):
            self.low, self.high, self.shape = np.full(n, -10.0), np.full(n, 10.0), (n,)

    observation_space = _Box(3)
    action_space = _Box(1)

    def __init__(self):
        self._t, self._length = 0, 1

    def reset(self, seed=None):
        self._t, self._length = 0, 1
        return np.ones(3, dtype=np.float32), {}

    def step(self, action):
        if self._t == 0:
            self._length = int(np.clip(round(10.0 * float(np.asarray(action).reshape(-1)[0])), 1, 60))
        self._t += 1
        return np.ones(3, dtype=np.float32), 1.0, self._t >= self._length, False, {}


@pytest.mark.cuda
def test_host_pipeline_on_card_syncs_once_per_block_step_and_matches_cpu(device):
    """``run_host_pipelined_rollout`` with the policy forward on the card:
    pipelined equals sync bit for bit, one host sync per block per step
    (the swap point; the observations go up through pinned memory), and
    the counts equal the CPU run's (the outputs agree to float32 rounding
    and only the first action's rounding decides a length)."""
    import warnings

    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, Linear, RunningStat
    from evotorch_tpu_torch.neuroevolution.net.hostvecenv import SyncVectorEnv, run_host_pipelined_rollout

    policy = FlatParamsPolicy(Linear(3, 1))
    params = torch.from_numpy(np.random.default_rng(0).uniform(0.05, 0.7, size=(10, 4)).astype(np.float32))
    out = {}
    for name, dev, mode in (("pipelined", device, "pipelined"), ("sync", device, "sync"), ("cpu", torch.device("cpu"), "sync")):
        population = params.to(dev)  # before the count: a copy from pageable memory syncs
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = run_host_pipelined_rollout(
                    SyncVectorEnv(_LengthEnv, 4), policy, population, num_episodes=2, num_blocks=2, mode=mode,
                    obs_stats=RunningStat(), device=dev,
                )  # fmt: skip
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum(1 for w in caught if "called a synchronizing" in str(w.message).lower())
        out[name] = result, syncs
    (a, sa), (b, sb), (c, _) = out["pipelined"], out["sync"], out["cpu"]
    for k in ("scores", "episode_steps", "lane_episodes", "block_iters", "interactions"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(c[k]))
    assert sa == sb == sum(a["block_iters"]), (sa, sb, a["block_iters"])


@pytest.mark.cuda
def test_gymne_pgpe_on_card_launches_each_kernel_once_a_generation(device):
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import GymNE

    problem = GymNE(_LengthEnv, "Linear(obs_length, 8) >> Tanh() >> Linear(8, act_length)", num_envs=8, observation_normalization=True)
    assert problem.device.type == "cuda"
    searcher = PGPE(problem, popsize=32, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.1)
    searcher.step()
    before = (sampling.sample_symmetric_gaussian.launches, ranking.centered_rank.launches)
    searcher.step()
    after = (sampling.sample_symmetric_gaussian.launches, ranking.centered_rank.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert searcher.population.evals.is_cuda and bool(torch.isfinite(searcher.population.evals).all())


@pytest.mark.cuda
def test_structures_on_card_equal_cpu(device):
    from evotorch_tpu_torch.tools import CBag, CList, CMemory, TensorFrame

    g = torch.Generator().manual_seed(0)
    out = {}
    for dev in (device, torch.device("cpu")):
        lst = CList.create(8, 3, batch_shape=(50,), device=dev)
        mem = CMemory.create(16, batch_shape=(50,), device=dev)
        bag = CBag.create(8, batch_shape=(50,), device=dev)
        keys = torch.randint(0, 16, (6, 50), generator=torch.Generator().manual_seed(1))
        for step in range(6):
            lst = lst.append_(torch.full((50, 3), float(step), device=dev), where=(keys[step] % 3 > 0).to(dev))
            mem = mem.add_(keys[step].to(dev), 1.5)
            bag = bag.push_((keys[step] % 8).to(dev))
        lst, popped = lst.popleft_()
        bag, key, ok = bag.pop_((keys[0] % 8).to(dev))
        frame = TensorFrame.create(a=mem.data[:, 0], b=torch.arange(50, device=dev)).sort("a", descending=True)
        out[dev.type] = [t.cpu() for t in (lst.data, lst.length, popped, mem.data, bag.counts, key, ok, frame.a, frame.b)]
    for x, y in zip(out["cuda"], out["cpu"]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_first_use_sentinel_counts_new_allocator_segments(device):
    """On the card the sentinel counts the caching allocator's new segments:
    a first allocation of a new size class maps a segment, the same
    allocation again reuses it."""
    from evotorch_tpu_torch.analysis import track_first_use

    size = 3 * 2**26 + 12_345  # ~805 MB: larger than any cached block
    with track_first_use() as log:
        x = torch.empty(size, dtype=torch.float32, device=device)
        del x
    assert log.segments >= 1 and log.builds == 0
    with track_first_use() as log:
        y = torch.empty(size, dtype=torch.float32, device=device)
        del y
    assert log.segments == 0 and log.count == 0


@pytest.mark.cuda
def test_refill_harness_on_the_card(device, tmp_path):
    """A small refill tuning on the card: no first-use work in its timed
    trials, a captured peak for every candidate, the machine the card's."""
    from evotorch_tpu_torch.observability import autotune
    from evotorch_tpu_torch.observability.timings import TimingLedger

    shape = autotune.TuneShape(env_name="cartpole", popsize=1_000, episode_length=50, hidden=(8,))
    harness = autotune.RefillHarness(shape, widths=(128, 256), device=device)
    outcome = autotune.tune_group(harness, trials=2, max_rounds=1, refine=False, min_occupancy=0.0,
                                  ledger_out=TimingLedger(), cache_path=tmp_path / "tuned.json")  # fmt: skip
    assert all(r.steady_compiles == 0 and r.cost["peak_bytes"] > 0 for r in outcome.results)
    assert outcome.cache_written
    entry = (tmp_path / "tuned.json").read_text()
    assert '"backend": "cuda"' in entry and '"runtime": "torch"' in entry


@pytest.mark.cuda
def test_a_device_timed_span_skips_graph_capture_and_resolves(device):
    """A span given the card's device, while a profiler records, leaves a
    pair of timing events for ``resolve_device_seconds``, which adds a
    positive time; the same span inside a graph's capture records none."""
    from torch.profiler import ProfilerActivity, profile

    from evotorch_tpu_torch.observability import counters, tracer

    tracer.resolve_device_seconds()
    key = "span.probe.card.device_seconds"
    before = counters.get(key)
    a = torch.randn(512, 512, device=device)
    b = torch.empty_like(a)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("probe.card", device=device):
            torch.matmul(a, a, out=b)
        assert len(tracer._pending) == 1
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            torch.matmul(a, a, out=b)  # warm-up on the side stream, as capture wants
        torch.cuda.current_stream(device).wait_stream(stream)
        with torch.cuda.graph(graph):
            with tracer.span("probe.card", device=device):
                torch.matmul(a, a, out=b)
        assert len(tracer._pending) == 1
    graph.replay()
    tracer.resolve_device_seconds()
    assert tracer._pending == []
    assert counters.get(key) - before > 0
