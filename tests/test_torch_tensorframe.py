"""``TensorFrame`` and ``Picker`` in the port against the JAX package, on the
CPU, from the same numpy columns: construction and scalar broadcast,
column access and assignment, row picks by mask, index and slice, stable
sorts (ties included), ``nlargest``/``nsmallest``, stacking, ``drop``,
``pick_set`` in its three row forms, ``each`` (vmapped per row), and a
frame of frames under ``vmap`` (the batch form). Every column is held
exactly; sorts on tied keys must give the same order, which holds because
both sorts are stable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.tools import TensorFrame as JFrame
from evotorch_tpu_torch import interop
from evotorch_tpu_torch.tools import TensorFrame as PFrame


def _columns(seed=0, n=9):
    rng = np.random.default_rng(seed)
    return {
        "fitness": rng.integers(0, 4, size=n).astype(np.float32),  # ties
        "values": rng.normal(size=(n, 3)).astype(np.float32),
        "tag": rng.integers(0, 3, size=n).astype(np.int32),
    }


def frames(seed=0, n=9):
    cols = _columns(seed, n)
    return (
        JFrame.create({k: jnp.asarray(v) for k, v in cols.items()}),
        PFrame.create({k: torch.as_tensor(v) for k, v in cols.items()}),
    )


def assert_same(j, p):
    assert tuple(j.columns) == tuple(p.columns)
    for name in j.columns:
        a, b = np.asarray(j[name]), p[name].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_create_access_and_broadcast():
    j, p = frames()
    assert_same(j, p)
    assert len(j) == len(p) == 9
    np.testing.assert_array_equal(p.tag.numpy(), np.asarray(j.tag))
    assert_same(
        JFrame.create(a=jnp.arange(4.0), b=7.0), PFrame.create(a=torch.arange(4.0), b=torch.tensor(7.0))
    )
    with pytest.raises(KeyError):
        p["nope"]
    with pytest.raises(ValueError):
        PFrame.create(a=torch.zeros(3), b=torch.zeros(4))


def test_with_without_drop_and_stack():
    j, p = frames()
    rank = np.arange(9, dtype=np.int32)[::-1].copy()
    assert_same(j.with_columns(rank=jnp.asarray(rank)), p.with_columns(rank=torch.as_tensor(rank)))
    assert_same(j.without_columns("values"), p.without_columns("values"))
    assert_same(j.drop(columns="tag"), p.drop(columns="tag"))
    j2, p2 = frames(seed=1, n=4)
    assert_same(j.vstack(j2), p.vstack(p2))
    extra_j = JFrame.create(tag=jnp.zeros(9, jnp.int32), other=jnp.ones(9))
    extra_p = PFrame.create(tag=torch.zeros(9, dtype=torch.int32), other=torch.ones(9))
    assert_same(j.hstack(extra_j, override=True), p.hstack(extra_p, override=True))
    with pytest.raises(ValueError):
        p.hstack(extra_p)
    with pytest.raises(ValueError):
        p.drop(columns=["missing"])


@pytest.mark.parametrize("descending", [False, True])
def test_stable_sorts_and_top_rows(descending):
    j, p = frames(seed=2, n=30)
    np.testing.assert_array_equal(
        p.argsort("fitness", descending=descending).numpy(), np.asarray(j.argsort("fitness", descending=descending))
    )
    assert_same(j.sort("fitness", descending=descending), p.sort("fitness", descending=descending))
    assert_same(j.nlargest(7, "fitness"), p.nlargest(7, "fitness"))
    assert_same(j.nsmallest(5, "tag"), p.nsmallest(5, "tag"))


def test_picks():
    j, p = frames(seed=3)
    mask = np.random.default_rng(3).random(9) < 0.5
    idx = np.array([4, 0, 4, 8])
    assert_same(j.pick[jnp.asarray(mask)], p.pick[torch.as_tensor(mask)])
    assert_same(j.pick[jnp.asarray(idx)], p.pick[torch.as_tensor(idx)])
    assert_same(j.pick[2:7], p.pick[2:7])
    assert_same(j.pick[jnp.asarray(idx), ["tag", "fitness"]], p.pick[torch.as_tensor(idx), ["tag", "fitness"]])
    assert_same(j.pick[1:3, :], p.pick[1:3, :])
    assert_same(j[jnp.asarray(mask)], p[torch.as_tensor(mask)])
    with pytest.raises(TypeError):
        p.pick[0:2] = p


def test_pick_set_in_each_row_form():
    j, p = frames(seed=4)
    rng = np.random.default_rng(4)
    mask = rng.random(9) < 0.5
    idx = np.array([1, 5, 7])
    new_fit = rng.integers(10, 20, size=9).astype(np.float32)
    assert_same(
        j.pick_set(jnp.asarray(mask), jnp.asarray(new_fit), columns="fitness"),
        p.pick_set(torch.as_tensor(mask), torch.as_tensor(new_fit), columns="fitness"),
    )
    vals = rng.normal(size=(3, 3)).astype(np.float32)
    assert_same(
        j.pick_set(jnp.asarray(idx), {"values": jnp.asarray(vals), "tag": jnp.asarray([9, 9, 9], jnp.int32)}),
        p.pick_set(torch.as_tensor(idx), {"values": torch.as_tensor(vals), "tag": torch.tensor([9, 9, 9], dtype=torch.int32)}),
    )
    assert_same(
        j.pick_set(slice(0, 3), jnp.asarray(new_fit[:3]), columns=["fitness"]),
        p.pick_set(slice(0, 3), torch.as_tensor(new_fit[:3]), columns=["fitness"]),
    )
    # the frame written to is unchanged (functional assignment)
    assert_same(j, p)
    with pytest.raises(KeyError):
        p.pick_set(slice(None), {"nope": torch.zeros(9)})
    with pytest.raises(ValueError):
        p.pick_set(slice(None), torch.zeros(9))


def test_each_and_vmap_over_frames():
    j, p = frames(seed=5)

    def row(r):
        return {"score": r["fitness"] * 2 + r["values"].sum(), "tag": r["tag"] + 1}

    jr = j.each(row, join=True, override=True)
    pr = p.each(row, join=True, override=True)
    assert tuple(jr.columns) == tuple(pr.columns)
    np.testing.assert_array_equal(pr.tag.numpy(), np.asarray(jr.tag))
    # float32 sums of three normals: the same order, 1 ulp at most
    np.testing.assert_allclose(pr.score.numpy(), np.asarray(jr.score), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        p.each(row, override=True)
    # a batch of 4 frames of 6 rows: sorted row-wise under vmap
    cols = np.random.default_rng(6).integers(0, 5, size=(4, 6)).astype(np.float32)
    jb = jax.vmap(lambda f: f.sort("key"))(JFrame.create(key=jnp.asarray(cols), idx=jnp.tile(jnp.arange(6), (4, 1))))
    pb = torch.func.vmap(lambda f: f.sort("key"))(PFrame.create(key=torch.as_tensor(cols), idx=torch.arange(6).repeat(4, 1)))
    np.testing.assert_array_equal(pb.key.numpy(), np.asarray(jb.key))
    np.testing.assert_array_equal(pb.idx.numpy(), np.asarray(jb.idx))


def test_frames_cross_through_interop():
    j, _ = frames(seed=7)
    port = interop.tensorframe_from_numpy({name: np.asarray(j[name]) for name in j.columns}, device="cpu")
    assert_same(j, port)
    back = interop.tensorframe_to_numpy(port)
    assert list(back) == list(j.columns)
