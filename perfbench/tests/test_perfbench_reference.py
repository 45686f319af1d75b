"""The plain reference against the program at a tiny size on the CPU.

The reference follows the program's rollouts bit for bit when it is given
the program's population, statistics and generator state (the noise the
program drew, read back by replaying the generator); the ask and the tell
agree to float32 rounding. Run: ``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.reference import rollout as ref_rollout  # noqa: E402
from perfbench.reference.mlp_policy import MLP  # noqa: E402
from perfbench.reference import search as ref_search  # noqa: E402
from perfbench.reference.physics import Humanoid  # noqa: E402

POPSIZE = 8
STEPS = 10
NETWORK = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"


def _problem(eval_mode: str, refill=None, seed: int = 5):
    from evotorch_tpu_torch.neuroevolution import VecNE

    return VecNE(
        "humanoid", NETWORK, observation_normalization=True, decrease_rewards_by=5.0, episode_length=STEPS,
        eval_mode=eval_mode, refill_config=refill, device="cpu", seed=seed,
    )  # fmt: skip


@pytest.mark.parametrize(
    "eval_mode, refill",
    [("budget", None), ("episodes", None), ("episodes_refill", {"width": 4, "period": 1})],
)
def test_rollout_equals_the_program_bit_for_bit(eval_mode, refill):
    from evotorch_tpu_torch.core import SolutionBatch

    torch.manual_seed(0)
    problem = _problem(eval_mode, refill)
    # two evaluations, so that the second starts from collected statistics
    for radius in (0.5, 2.25):
        values = radius / math.sqrt(problem.solution_length) * torch.randn(POPSIZE, problem.solution_length)
        batch = SolutionBatch(problem, values=values)
        state = problem.generator.get_state()
        stats = problem.obs_norm.stats
        count = int(problem.status.get("total_interaction_count", 0))
        problem.evaluate(batch)
        env = Humanoid("cpu")
        policy = MLP([env.observation_size, 64, 64, env.action_size])
        gen = torch.Generator()
        gen.set_state(state)
        out = ref_rollout.rollout(
            env, policy, batch.values, gen, ref_rollout.Stats(stats.count, stats.sum, stats.sum_of_squares),
            contract=eval_mode, episode_length=STEPS, decrease_rewards_by=5.0, observation_normalization=True,
            refill_width=None if refill is None else refill["width"], refill_period=1,
        )  # fmt: skip
        assert torch.equal(batch.evals[:, 0], out.scores)
        new = problem.obs_norm.stats
        assert torch.equal(new.count, out.stats.count)
        assert torch.equal(new.sum, out.stats.sum)
        assert torch.equal(new.sum_of_squares, out.stats.sum_of_squares)
        assert int(problem.status["total_interaction_count"]) - count == out.env_steps
        assert torch.equal(gen.get_state(), problem.generator.get_state())


def test_ask_rows_match_the_sampler():
    from evotorch_tpu_torch.ops.sampling import sample_symmetric_gaussian

    gen = torch.Generator().manual_seed(11)
    mu = torch.randn(1031) * 0.1
    sigma = torch.rand(1031) * 0.02 + 0.001
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    pop = sample_symmetric_gaussian(mu, sigma, POPSIZE, generator=gen)
    key, offset = ref_search.draw_seed(replay)
    assert torch.equal(replay.get_state(), gen.get_state())
    rows = list(range(POPSIZE))
    ref, e = ref_search.ask_rows(key, offset, mu.double().numpy(), sigma.double().numpy(), rows)
    scale = np.abs(mu.numpy()) + sigma.numpy() * (1 + np.abs(e))
    assert np.max(np.abs(pop.numpy() - ref) / scale) < 1e-6
    # antithetic pairs around the center
    assert np.allclose(ref[0::2] + ref[1::2], 2 * mu.double().numpy()[None, :])


@pytest.mark.parametrize("lowrank_rank", [None, 4])
def test_tell_matches_pgpe(lowrank_rank):
    """The reference tell on the population's ``+`` rows follows PGPE's, a
    factored population's (its rows materialized in float64) too."""
    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.core import Problem

    n, length = 16, 37
    problem = Problem("max", lambda x: -(x**2).sum(-1), solution_length=length, initial_bounds=(-1, 1), vectorized=True, device="cpu", seed=3)
    searcher = PGPE(
        problem, popsize=n, center_learning_rate=0.1125, stdev_learning_rate=0.1, radius_init=2.25, optimizer="clipup",
        optimizer_config={"max_speed": 0.15, "momentum": 0.9}, ranking_method="centered", stdev_max_change=0.2,
        lowrank_rank=lowrank_rank,
    )  # fmt: skip
    mu0 = searcher.distribution.parameters["mu"].clone()
    state = ref_search.TellState(
        mu0.double(), searcher.distribution.parameters["sigma"].double(), torch.zeros(length, dtype=torch.float64)
    )
    searcher.step()  # the first generation: sampled and evaluated
    for _ in range(3):
        pop = searcher.population
        values, scores = pop.values, pop.evals[:, 0].clone()
        if lowrank_rank is None:
            plus = values[0::2].clone()
        else:
            plus = values.center.double() + values.coeffs[0::2].double() @ values.basis.double().T
        state = ref_search.tell(
            state, [plus], scores, center_learning_rate=0.1125, momentum=0.9, max_speed=0.15, stdev_learning_rate=0.1,
            stdev_max_change=0.2,
        )  # fmt: skip
        searcher.step()  # the tell of that population, then the next one
        mu = searcher.distribution.parameters["mu"].double()
        sigma = searcher.distribution.parameters["sigma"].double()
        assert float(torch.linalg.vector_norm(mu - state.mu) / torch.linalg.vector_norm(state.mu - mu0.double())) < 1e-5
        assert float(torch.max(torch.abs(sigma - state.sigma) / state.sigma)) < 1e-5


_RUN_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import perfbench.harness, perfbench.check, perfbench.output, perfbench.tracing, perfbench.roofline
import perfbench.reference.physics, perfbench.reference.rollout, perfbench.reference.search
from perfbench import harness
bench = harness.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(m["name"])
{extra}
top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(" ".join(top))
"""


def _top_level_modules(extra: str) -> set:
    code = _RUN_IMPORTS.format(root=str(ROOT), extra=extra)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_a_run_imports_no_jax_nor_the_jax_package():
    """Every module a run imports, the program's included: no top-level
    ``jax``, ``jaxlib``, ``flax`` or ``evotorch_tpu`` (whole names: the
    program ``evotorch_tpu_torch`` is allowed)."""
    extra = (
        "import evotorch_tpu_torch.algorithms, evotorch_tpu_torch.core, evotorch_tpu_torch.neuroevolution\n"
        "import evotorch_tpu_torch.observability, evotorch_tpu_torch.ops.ranking, evotorch_tpu_torch.ops._build\n"
        "import torch.profiler"
    )
    top = _top_level_modules(extra)
    assert "evotorch_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "evotorch_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    """The reference, the checks and the metric readers import nothing of
    the program (the harness imports it only inside a run)."""
    top = _top_level_modules("")
    assert "perfbench" in top
    assert not top & {"evotorch_tpu_torch", "evotorch_tpu", "jax", "jaxlib", "flax"}
