"""The port's telemetry wire (``evotorch_tpu_torch.observability.devicemetrics``)
against the JAX package's, on the CPU.

Tolerance: none. The same counters and scores make the same int32 wire,
value for value: the counter and histogram columns are integers, and the
health block is compared on scores whose float32 sums are exact in any
order (multiples of 1/4 of modest size). On arbitrary scores the block's
sums may differ in their last bit with the summation order, so there the
decoded floats agree to ``rtol=1e-6``. The host decoders are the same
numpy code and give the same figures on the same wire.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.observability import devicemetrics as jax_dm
from evotorch_tpu_torch.observability import devicemetrics as dm

COUNTERS = dict(env_steps=1_234_567, episodes=10_000, capacity=2_000_000, lane_width=2048, refill_events=7952, queue_wait=31, nonfinite=3)


def test_constants_equal_jax():
    for name in (
        "TELEMETRY_WIDTH",
        "GROUP_TELEMETRY_WIDTH",
        "HEALTH_WIDTH",
        "HEALTH_TELEMETRY_WIDTH",
        "QUEUE_WAIT_BUCKETS",
        "QUEUE_WAIT_BUCKET_EDGES",
        "TELEMETRY_SCHEMA_VERSION",
    ):
        assert getattr(dm, name) == getattr(jax_dm, name), name
    assert dm._SLOTS == jax_dm._SLOTS
    assert dm._BUCKET_UPPER_EDGES == jax_dm._BUCKET_UPPER_EDGES
    assert dm.HEALTH_TELEMETRY_WIDTH == 20


def test_pack_eval_telemetry_equals_jax():
    theirs = np.asarray(jax_dm.pack_eval_telemetry(**COUNTERS))
    ours = dm.pack_eval_telemetry(**COUNTERS)
    assert ours.dtype == torch.int32 and ours.shape == (7,)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # device scalars of any integer dtype (a bool sum is int64) become int32
    mixed = dict(COUNTERS, episodes=torch.ones(10_000, dtype=torch.bool).sum(), queue_wait=torch.tensor(31, dtype=torch.int64))
    np.testing.assert_array_equal(dm.pack_eval_telemetry(**mixed).numpy(), theirs)


def test_pack_group_telemetry_equals_jax():
    counts = dm.pack_eval_telemetry(**COUNTERS)[None]
    hist = torch.tensor([[5, 0, 3, 1, 0, 0, 2, 9]])
    ours = dm.pack_group_telemetry(counts, hist)
    theirs = np.asarray(jax_dm.pack_group_telemetry(jnp.asarray(counts.numpy()), jnp.asarray(hist.numpy())))
    assert ours.shape == (1, 15) and ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        dm.pack_group_telemetry(counts).numpy(), np.asarray(jax_dm.pack_group_telemetry(jnp.asarray(counts.numpy())))
    )


def test_health_block_and_append_equal_jax():
    rng = np.random.default_rng(0)
    scores = (np.round(rng.normal(scale=40, size=257) * 4) / 4).astype(np.float32)  # exact sums in any order
    ours = dm.compute_health_block(torch.from_numpy(scores))
    theirs = np.asarray(jax_dm.compute_health_block(jnp.asarray(scores)))
    assert ours.shape == (1, 5) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    wire = dm.pack_group_telemetry(dm.pack_eval_telemetry(**COUNTERS)[None])
    appended = dm.append_health_block(wire, ours)
    jax_appended = np.asarray(jax_dm.append_health_block(jnp.asarray(wire.numpy()), jnp.asarray(theirs)))
    assert appended.shape == (1, 20) and appended.dtype == torch.int32
    np.testing.assert_array_equal(appended.numpy(), jax_appended)


def test_health_block_on_arbitrary_scores():
    scores = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    ours = dm.compute_health_block(torch.from_numpy(scores)).numpy()
    theirs = np.asarray(jax_dm.compute_health_block(jnp.asarray(scores)))
    np.testing.assert_array_equal(ours[:, [0, 3, 4]], theirs[:, [0, 3, 4]])  # count, min, max: exact
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dm.compute_health_block(torch.zeros(0)).numpy(), np.zeros((1, 5), np.float32))


def test_queue_wait_bucket_index_equals_jax():
    waits = np.arange(0, 200, dtype=np.int32)
    ours = dm.queue_wait_bucket_index(torch.from_numpy(waits).long())
    theirs = np.asarray(jax_dm.queue_wait_bucket_index(jnp.asarray(waits)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert ours[0] == 0 and ours[1] == 1 and ours[63] == 6 and ours[64] == 7 and ours[199] == 7


def _wire():
    counts = dm.pack_eval_telemetry(**COUNTERS)[None]
    hist = torch.tensor([[3, 4, 0, 0, 1, 0, 0, 2]])
    scores = torch.tensor([1.5, -2.0, 7.25, 0.0])
    return dm.append_health_block(dm.pack_group_telemetry(counts, hist), dm.compute_health_block(scores))


def test_decoders_equal_jax_and_round_trip():
    wire = _wire()
    ours, theirs = dm.GroupTelemetry.from_array(wire), jax_dm.GroupTelemetry.from_array(wire.numpy())
    np.testing.assert_array_equal(ours.data, theirs.data)
    np.testing.assert_array_equal(ours.health, theirs.health)
    assert ours.total() == dm.EvalTelemetry(**dataclass_fields(theirs.total()))
    assert ours.score_stats() == theirs.score_stats()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.queue_wait_quantile(q) == theirs.queue_wait_quantile(q)
    assert ours.starvation_share() == theirs.starvation_share()
    assert ours.nonfinite_share() == theirs.nonfinite_share()
    assert ours.summary() == theirs.summary()
    assert ours.to_rows() == theirs.to_rows()
    np.testing.assert_array_equal(ours.to_wire(), wire.numpy())
    doubled = ours + ours
    jax_doubled = theirs + theirs
    np.testing.assert_array_equal(doubled.data, jax_doubled.data)
    np.testing.assert_array_equal(doubled.health, jax_doubled.health)
    eval_t = dm.EvalTelemetry.from_array(wire)
    assert eval_t.occupancy == jax_dm.EvalTelemetry.from_array(wire.numpy()).occupancy
    assert eval_t.as_status() == jax_dm.EvalTelemetry.from_array(wire.numpy()).as_status()
    assert (eval_t + eval_t).env_steps == 2 * COUNTERS["env_steps"]


def dataclass_fields(obj):
    return {name: getattr(obj, name) for name in dm._SLOTS}


@pytest.mark.parametrize("shape", [(6,), (7,), (2, 14), (2, 15), (2, 20)])
def test_decoders_read_every_width_like_jax(shape):
    rng = np.random.default_rng(sum(shape))
    values = rng.integers(0, 1000, size=shape).astype(np.int32)
    if shape[-1] == 20:
        values[:, 15:] = np.abs(rng.normal(size=(shape[0], 5))).astype(np.float32).view(np.int32)
        values[:, 15] = np.array([3.0, 4.0], np.float32).view(np.int32)  # counts
    ours, theirs = dm.GroupTelemetry.from_array(values), jax_dm.GroupTelemetry.from_array(values)
    np.testing.assert_array_equal(ours.data, theirs.data)
    assert ours.has_health == theirs.has_health
    assert dataclass_fields(dm.EvalTelemetry.from_array(values)) == dataclass_fields(jax_dm.EvalTelemetry.from_array(values))
    assert ours.as_status() == theirs.as_status()
    with pytest.raises(ValueError):
        dm.GroupTelemetry.from_array(np.zeros((2, 9), np.int32))
