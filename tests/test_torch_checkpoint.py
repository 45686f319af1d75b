"""``evotorch_tpu_torch.checkpoint``: functional states round-trip exactly
through ``save_state``/``load_state`` (a flat dict of tensors that
``torch.load`` reads with ``weights_only=True``, grafted into a template),
and a whole OO searcher through ``save_searcher``/``load_searcher``, after
which the loaded searcher takes the step the saved one takes, bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from evotorch_tpu_torch.algorithms import PGPE
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_tell
from evotorch_tpu_torch.checkpoint import load_searcher, load_state, save_searcher, save_state
from evotorch_tpu_torch.neuroevolution import SupervisedNE
from evotorch_tpu_torch.neuroevolution.net import CollectedStats


def _pgpe_state(optimizer, seed=0, steps=2):
    state = pgpe(
        center_init=torch.zeros(6),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=0.2,
        optimizer=optimizer,
    )
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        values = pgpe_ask(g, state, popsize=8)
        state = pgpe_tell(state, values, -(values**2).sum(dim=1))
    return state


def _fields(state):
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if dataclasses.is_dataclass(value):
            out.update({f"{f.name}.{k}": v for k, v in _fields(value).items()})
        else:
            out[f.name] = value
    return out


@pytest.mark.parametrize("optimizer", ["clipup", "adam", "sgd"])
def test_pgpe_state_round_trips(optimizer, tmp_path):
    state = _pgpe_state(optimizer)
    path = tmp_path / "state.pt"
    save_state(str(path), state)
    assert not (tmp_path / "state.pt.tmp").exists()
    flat = torch.load(path, weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    assert "optimizer_state.center" in flat and "stdev" in flat
    loaded = load_state(str(path), _pgpe_state(optimizer, steps=0))
    ours, saved = _fields(loaded), _fields(state)
    assert ours.keys() == saved.keys()
    for name, value in saved.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(ours[name], value) and ours[name].dtype == value.dtype, name
        else:
            assert ours[name] == value, name
    # the loaded state tells as the saved one does
    values = pgpe_ask(torch.Generator().manual_seed(9), state, popsize=8)
    fitness = -(values**2).sum(dim=1)
    a, b = pgpe_tell(state, values, fitness), pgpe_tell(loaded, values, fitness)
    assert torch.equal(a.optimizer_state.center, b.optimizer_state.center) and torch.equal(a.stdev, b.stdev)


def test_optimizer_state_and_stats_round_trip(tmp_path):
    opt = _pgpe_state("clipup").optimizer_state
    save_state(str(tmp_path / "opt.pt"), opt)
    back = load_state(str(tmp_path / "opt.pt"), _pgpe_state("clipup", steps=0).optimizer_state)
    assert torch.equal(back.velocity, opt.velocity) and torch.equal(back.center, opt.center)
    stats = CollectedStats(torch.tensor(5.0), torch.arange(3.0), torch.arange(3.0) ** 2)
    save_state(str(tmp_path / "stats.pt"), stats)
    template = CollectedStats(torch.tensor(0.0), torch.zeros(3), torch.zeros(3))
    back = load_state(str(tmp_path / "stats.pt"), template)
    for name in ("count", "sum", "sum_of_squares"):
        assert torch.equal(getattr(back, name), getattr(stats, name))


def test_load_state_refuses_a_template_that_does_not_fit(tmp_path):
    path = str(tmp_path / "state.pt")
    save_state(path, _pgpe_state("clipup"))
    with pytest.raises(ValueError, match="does not fit"):
        load_state(path, _pgpe_state("adam", steps=0))
    small = CollectedStats(torch.tensor(0.0), torch.zeros(2), torch.zeros(2))
    save_state(path, small)
    with pytest.raises(ValueError, match="template's"):
        load_state(path, CollectedStats(torch.tensor(0.0), torch.zeros(3), torch.zeros(3)))


def _searcher():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    y = X @ np.array([[1.0], [-2.0], [0.5]], dtype=np.float32)
    problem = SupervisedNE((X, y), "Linear(3, 1)", minibatch_size=16, num_minibatches=2, seed=2, device="cpu")
    return PGPE(problem, popsize=10, center_learning_rate=0.1, stdev_learning_rate=0.1, stdev_init=0.3, optimizer="clipup")


def test_searcher_round_trips_and_steps_as_the_saved_one(tmp_path):
    searcher = _searcher()
    searcher.run(2)
    path = str(tmp_path / "searcher.pkl")
    assert save_searcher(path, searcher) == path
    assert not (tmp_path / "searcher.pkl.tmp").exists()
    loaded = load_searcher(path)
    assert loaded is not searcher and loaded.step_count == searcher.step_count == 2
    searcher.step()
    loaded.step()
    assert torch.equal(loaded.population.values, searcher.population.values)
    assert torch.equal(loaded.population.evals, searcher.population.evals)
    assert torch.equal(loaded.status["center"], searcher.status["center"])
    assert torch.equal(loaded.problem.generator.get_state(), searcher.problem.generator.get_state())


@pytest.mark.parametrize("content", [b"", b"not a pickle at all", "truncated"], ids=["empty", "garbage", "truncated"])
def test_corrupt_searcher_file_raises_runtime_error(content, tmp_path):
    path = tmp_path / "searcher.pkl"
    if content == "truncated":
        content = pickle.dumps(_searcher())[:200]
    path.write_bytes(content)
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        load_searcher(str(path))
