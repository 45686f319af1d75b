"""The comparison fails what it must: the program's lower precision and the
faults a cell can have, each planted underneath a whole run (the harness's
look for a card skipped, on the CPU at a tiny size).

- the control: the program's own bfloat16 policy forward;
- a step that returns its state unchanged: the tell leaves the
  distribution as it was; the env's step leaves the bodies where they
  were; the rollout leaves the observation statistics;
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced: one score, one population entry.

One chip holds each cell, so no exchange between chips can be left out.
Run: ``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import output  # noqa: E402
from perfbench.tests.test_perfbench_harness import MIXES, mix_spec, tiny, tiny_run  # noqa: E402


def _line(traffic, seconds=0.3, min_rounds=0, **kw):
    spec = tiny(mix_spec(traffic), popsize=16, steps=20)
    spec["min_rounds"] = min_rounds
    result = tiny_run(spec, seconds=seconds, **kw)
    return output.result_line(spec, result, trace=False)


def _failing(line) -> set:
    return {name for name, item in line["checks"].items() if not item["value"] <= item["limit"]}


@pytest.mark.parametrize("traffic", MIXES)
def test_sound_runs_are_correct(traffic):
    line = _line(traffic)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("traffic", MIXES)
def test_the_bf16_control_is_not_correct(traffic):
    line = _line(traffic, control=torch.bfloat16)
    assert line["correct"] is False
    assert "step_gap" in _failing(line)


def _state_unchanged_tell(monkeypatch):
    from evotorch_tpu_torch.algorithms.gaussian import GaussianSearchAlgorithm

    monkeypatch.setattr(GaussianSearchAlgorithm, "_update_distribution", lambda self, gradients: None)
    return {"center_gap", "stdev_gap"}


def _state_unchanged_env_step(monkeypatch):
    from evotorch_tpu_torch.envs.locomotion import RigidBodyLocomotionEnv

    original = RigidBodyLocomotionEnv.batch_step

    def frozen(self, state, actions):
        _, obs, reward, done = original(self, state, actions)
        return state, self._batch_obs(state.obs_state), reward, done

    monkeypatch.setattr(RigidBodyLocomotionEnv, "batch_step", frozen)
    return {"step_gap"}


def _state_unchanged_statistics(monkeypatch):
    from evotorch_tpu_torch.neuroevolution.vecneproblem import VecNE

    original = VecNE._consume_rollout_side_effects

    def keep_stats(self, result):
        stats = self._obs_norm.stats
        original(self, result)
        self._obs_norm.stats = stats

    monkeypatch.setattr(VecNE, "_consume_rollout_side_effects", keep_stats)
    return {"stats_gap"}


def _half_the_batch(monkeypatch):
    from evotorch_tpu_torch.neuroevolution.vecneproblem import VecNE

    original = VecNE._rollout_batch

    def half(self, values, tables, groups=None):
        n = values.shape[0]
        result = original(self, values[: n // 2], tables, groups)
        rest = result.scores.mean().expand(n - n // 2)
        return result._replace(scores=torch.cat([result.scores, rest]))

    monkeypatch.setattr(VecNE, "_rollout_batch", half)
    return {"tally_gap"}


def _altered_score(monkeypatch):
    from evotorch_tpu_torch.neuroevolution.vecneproblem import VecNE

    original = VecNE._rollout_batch

    def altered(self, values, tables, groups=None):
        result = original(self, values, tables, groups)
        scores = result.scores.clone()
        scores[3] += 1.0
        return result._replace(scores=scores)

    monkeypatch.setattr(VecNE, "_rollout_batch", altered)
    return {"tally_gap"}


def _altered_population_entry(monkeypatch):
    from evotorch_tpu_torch import distributions

    original = distributions.sample_symmetric_gaussian

    def altered(*args, **kwargs):
        out = original(*args, **kwargs).clone()
        out[-1, 7] += 1e-3
        return out

    monkeypatch.setattr(distributions, "sample_symmetric_gaussian", altered)
    return {"ask_gap"}


FAULTS = {
    "state_unchanged_tell": _state_unchanged_tell,
    "state_unchanged_env_step": _state_unchanged_env_step,
    "state_unchanged_statistics": _state_unchanged_statistics,
    "half_the_batch": _half_the_batch,
    "altered_score": _altered_score,
    "altered_population_entry": _altered_population_entry,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("traffic", MIXES)
def test_a_planted_fault_is_not_correct(traffic, fault, monkeypatch):
    expected = FAULTS[fault](monkeypatch)
    # a window of at least four rounds: three tells at this size
    line = _line(traffic, min_rounds=4)
    assert expected <= set(line["checks"])
    assert line["correct"] is False
    assert expected & _failing(line), line["checks"]
