"""The batched structures of ``tools/structures.py`` in the port against the
JAX package, on the CPU: ``CMemory``, ``CDict``, ``CList``, ``CBag`` and
``do_where``, in both batch forms (an explicit ``batch_shape=`` and
``torch.func.vmap`` / ``jax.vmap`` over a stacked unbatched structure),
from the same numpy inputs.

Everything deterministic is held exactly: the stored tensors field by
field (``interop.structure_to_numpy`` against the JAX structure's fields),
every read, and the ``ok`` flags. The values are small integers and the
divisors powers of two, so float32 arithmetic is exact on both sides.
``CBag.pop_`` with a generator (a key in the JAX package) is held by its
invariants and statistically: each pop takes a present key, the counts
drop by one there, and over 4,000 bags the popped keys' frequencies match
the counts' proportions within 5 standard errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evotorch_tpu.tools.structures as JS
import evotorch_tpu_torch.tools.structures as PS
from evotorch_tpu_torch import interop


def _jax_fields(structure) -> dict:
    """A JAX structure as ``interop.structure_to_numpy`` lays out the
    port's: ``kind`` and each field, a nested memory's prefixed."""
    out = {"kind": type(structure).__name__}

    def put(obj, prefix):
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.name == "memory":
                put(value, prefix + "memory.")
            elif isinstance(value, jax.Array):
                out[prefix + f.name] = np.asarray(value)
            else:
                out[prefix + f.name] = value

    put(structure, "")
    return out


def assert_same(jax_structure, port_structure):
    a, b = _jax_fields(jax_structure), interop.structure_to_numpy(port_structure)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def assert_equal_arrays(j, p):
    np.testing.assert_array_equal(np.asarray(p), np.asarray(j))


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


# ---------------------------------------------------------------- CMemory


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 3)])
def test_cmemory_ops_match_jax(batch_shape):
    rng = np.random.default_rng(0)
    jm = JS.CMemory.create(5, 2, batch_shape=batch_shape)
    pm = PS.CMemory.create(5, 2, batch_shape=batch_shape, device="cpu")
    for step in range(12):
        keys = rng.integers(-1, 7, size=batch_shape)  # some out of range: masked
        values = _ints(rng, batch_shape + (2,))
        where = rng.random(batch_shape) < 0.7
        op = ["set_", "add_", "subtract_", "multiply_", "divide_"][step % 5]
        if op == "divide_":
            values = np.float32(2.0) ** rng.integers(-1, 2, size=batch_shape + (2,)).astype(np.float32)
        jm = getattr(jm, op)(jnp.asarray(keys), jnp.asarray(values), where=jnp.asarray(where))
        pm = getattr(pm, op)(torch.as_tensor(keys), torch.as_tensor(values), where=torch.as_tensor(where))
        assert_same(jm, pm)
        probe = rng.integers(-2, 8, size=batch_shape)
        assert_equal_arrays(jm.get(jnp.asarray(probe), default=-9.0), pm.get(torch.as_tensor(probe), default=-9.0))
        assert_equal_arrays(jm[jnp.asarray(probe)], pm[torch.as_tensor(probe)])
    jm = jm.add_circular_(jnp.asarray(np.ones(batch_shape, np.int64)), 3.0, 4.0)
    pm = pm.add_circular_(torch.ones(batch_shape, dtype=torch.int64), 3.0, 4.0)
    assert_same(jm, pm)


def test_cmemory_multi_dim_keys_with_offset_and_gathers():
    rng = np.random.default_rng(1)
    jm = JS.CMemory.create((3, 4), dtype=jnp.int32, key_offset=(1, -2))
    pm = PS.CMemory.create((3, 4), dtype=torch.int32, key_offset=(1, -2), device="cpu")
    for _ in range(6):
        keys = np.stack([rng.integers(0, 5, size=7), rng.integers(-3, 3, size=7)], axis=-1)
        values = rng.integers(-5, 5, size=7).astype(np.int32)
        # a gather-style write of 7 keys at once (duplicates: last write wins)
        k0, k1 = np.unique(keys, axis=0).T
        jm = jm.add_((jnp.asarray(k0), jnp.asarray(k1)), jnp.asarray(values[: len(k0)]))
        pm = pm.add_((torch.as_tensor(k0), torch.as_tensor(k1)), torch.as_tensor(values[: len(k0)]))
        assert_same(jm, pm)
        assert_equal_arrays(jm.get(jnp.asarray(keys), default=-1), pm.get(torch.as_tensor(keys), default=-1))


def test_cmemory_under_vmap_matches_jax_and_the_batched_form():
    rng = np.random.default_rng(2)
    data = _ints(rng, (6, 4, 3))
    keys = rng.integers(-1, 5, size=6)
    values = _ints(rng, (6, 3))
    where = rng.random(6) < 0.6
    j = jax.vmap(lambda m, k, v, w: m.add_(k, v, where=w).set_(k + 1, v * 2))(
        JS.CMemory(data=jnp.asarray(data)), jnp.asarray(keys), jnp.asarray(values), jnp.asarray(where)
    )
    p = torch.func.vmap(lambda m, k, v, w: m.add_(k, v, where=w).set_(k + 1, v * 2))(
        PS.CMemory(data=torch.as_tensor(data)), torch.as_tensor(keys), torch.as_tensor(values), torch.as_tensor(where)
    )
    assert_same(j, p)
    batched = PS.CMemory(data=torch.as_tensor(data), batch_ndim=1)
    batched = batched.add_(torch.as_tensor(keys), torch.as_tensor(values), where=torch.as_tensor(where))
    batched = batched.set_(torch.as_tensor(keys) + 1, torch.as_tensor(values) * 2)
    np.testing.assert_array_equal(batched.data.numpy(), p.data.numpy())
    reads = torch.func.vmap(lambda m, k: m.get(k, default=-1.0))(p, torch.as_tensor(keys))
    assert_equal_arrays(jax.vmap(lambda m, k: m.get(k, default=-1.0))(j, jnp.asarray(keys)), reads)


# ------------------------------------------------------------------ CDict


@pytest.mark.parametrize("batch_shape", [(), (4,)])
def test_cdict_integer_keys_match_jax(batch_shape):
    rng = np.random.default_rng(3)
    jd = JS.CDict.create(5, 2, batch_shape=batch_shape)
    pd = PS.CDict.create(5, 2, batch_shape=batch_shape, device="cpu")
    for step in range(10):
        keys = rng.integers(-1, 6, size=batch_shape)
        values = _ints(rng, batch_shape + (2,))
        where = rng.random(batch_shape) < 0.75
        op = ["set_", "add_", "set_", "multiply_", "subtract_"][step % 5]
        jd = getattr(jd, op)(jnp.asarray(keys), jnp.asarray(values), where=jnp.asarray(where))
        pd = getattr(pd, op)(torch.as_tensor(keys), torch.as_tensor(values), where=torch.as_tensor(where))
        assert_same(jd, pd)
        probe = rng.integers(-1, 6, size=batch_shape)
        assert_equal_arrays(jd.contains(jnp.asarray(probe)), pd.contains(torch.as_tensor(probe)))
        assert_equal_arrays(jd.get(jnp.asarray(probe), default=7.0), pd.get(torch.as_tensor(probe), default=7.0))
    clear = rng.random(batch_shape) < 0.5
    assert_same(jd.clear(jnp.asarray(clear)), pd.clear(torch.as_tensor(clear)))
    assert_same(jd.clear(), pd.clear())


def test_cdict_named_keys_match_jax():
    jd = JS.CDict.create(["alpha", "beta", "gamma"], 3)
    pd = PS.CDict.create(["alpha", "beta", "gamma"], 3, device="cpu")
    jd = jd.set_("beta", jnp.arange(3.0)).add_("gamma", 2.0).set_("alpha", 1.5, where=jnp.asarray(False))
    pd = pd.set_("beta", torch.arange(3.0)).add_("gamma", 2.0).set_("alpha", 1.5, where=torch.tensor(False))
    assert_same(jd, pd)
    for name in ("alpha", "beta", "gamma"):
        assert_equal_arrays(jd.get(name, default=-1.0), pd.get(name, default=-1.0))
        assert bool(jd.contains(name)) == bool(pd.contains(name))
    with pytest.raises(KeyError):
        pd.get("delta")
    with pytest.raises(TypeError):
        PS.CDict.create(3, names=["a"], device="cpu")


# ------------------------------------------------------------------ CList


def _clist_program(module, xp, rng, batch_shape):
    """One fixed sequence of list operations with random masks; the
    structure after each and every value read."""
    device = {} if module is JS else {"device": "cpu"}
    lst = module.CList.create(4, 2, batch_shape=batch_shape, **device)
    states, reads = [], []
    for step in range(14):
        value = xp(_ints(rng, batch_shape + (2,)))
        where = xp(rng.random(batch_shape) < 0.8)
        kind = step % 5
        if kind in (0, 1):
            lst = lst.append_(value, where=where)
        elif kind == 2:
            lst = lst.appendleft_(value, where=where)
        elif kind == 3:
            lst, v = lst.pop_(where=where)
            reads.append(v)
        else:
            lst, v = lst.popleft_(where=where)
            reads.append(v)
        index = xp(rng.integers(-5, 5, size=batch_shape))
        reads.append(lst.get(index, default=-7.0))
        reads.append(lst[-1])
        lst = lst.add_(xp(rng.integers(0, 3, size=batch_shape)), value, where=where)
        states.append(lst)
    lst = lst.clear(where=xp(rng.random(batch_shape) < 0.5))
    states.append(lst)
    return states, reads


@pytest.mark.parametrize("batch_shape", [(), (5,)])
def test_clist_matches_jax(batch_shape):
    j_states, j_reads = _clist_program(JS, jnp.asarray, np.random.default_rng(4), batch_shape)
    p_states, p_reads = _clist_program(PS, torch.as_tensor, np.random.default_rng(4), batch_shape)
    for j, p in zip(j_states, p_states):
        assert_same(j, p)
    for j, p in zip(j_reads, p_reads):
        assert_equal_arrays(j, p)


def test_clist_under_vmap_matches_jax():
    rng = np.random.default_rng(5)
    n = 6
    data = _ints(rng, (n, 4))
    begin = rng.integers(0, 4, size=n).astype(np.int32)
    length = rng.integers(0, 5, size=n).astype(np.int32)
    values = _ints(rng, (n,))
    where = rng.random(n) < 0.7

    def program(lst, v, w):
        lst = lst.append_(v, where=w).appendleft_(v + 1)
        lst, popped = lst.pop_(where=~w)
        return lst, popped, lst.get(-2, default=0.0)

    j = jax.vmap(program)(
        JS.CList(data=jnp.asarray(data), begin=jnp.asarray(begin), length=jnp.asarray(length)),
        jnp.asarray(values),
        jnp.asarray(where),
    )
    p = torch.func.vmap(program)(
        PS.CList(data=torch.as_tensor(data), begin=torch.as_tensor(begin), length=torch.as_tensor(length)),
        torch.as_tensor(values),
        torch.as_tensor(where),
    )
    assert_same(j[0], p[0])
    assert_equal_arrays(j[1], p[1])
    assert_equal_arrays(j[2], p[2])


# ------------------------------------------------------------------- CBag


@pytest.mark.parametrize("batch_shape,capacity", [((), None), ((4,), None), ((4,), 5)])
def test_cbag_push_pop_specific_match_jax(batch_shape, capacity):
    rng = np.random.default_rng(6)
    jb = JS.CBag.create(6, batch_shape=batch_shape, capacity=capacity)
    pb = PS.CBag.create(6, batch_shape=batch_shape, capacity=capacity, device="cpu")
    for step in range(12):
        if step % 3 == 2:
            key = rng.integers(-1, 7, size=batch_shape)
            where = rng.random(batch_shape) < 0.8
            jb, jk, jok = jb.pop_(jnp.asarray(key), where=jnp.asarray(where))
            pb, pk, pok = pb.pop_(torch.as_tensor(key), where=torch.as_tensor(where))
            assert_equal_arrays(jk, pk)
            assert_equal_arrays(jok, pok)
        else:
            keys = rng.integers(-1, 7, size=(2,) + batch_shape)  # two pushes a call
            jb = jb.push_(jnp.asarray(keys))
            pb = pb.push_(torch.as_tensor(keys))
        assert_same(jb, pb)
        assert_equal_arrays(jb.total, pb.total)
    clear = rng.random(batch_shape) < 0.5
    assert_same(jb.clear(where=jnp.asarray(clear)) if batch_shape else jb.clear(), pb.clear(where=torch.as_tensor(clear)) if batch_shape else pb.clear())


def test_cbag_under_vmap_matches_jax():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 3, size=(5, 4)).astype(np.int32)
    push = rng.integers(0, 4, size=5)
    pop = rng.integers(0, 4, size=5)

    def program(bag, k1, k2):
        bag = bag.push_(k1)
        return bag.pop_(k2)

    j = jax.vmap(program)(JS.CBag(counts=jnp.asarray(counts)), jnp.asarray(push), jnp.asarray(pop))
    p = torch.func.vmap(program)(PS.CBag(counts=torch.as_tensor(counts)), torch.as_tensor(push), torch.as_tensor(pop))
    assert_same(j[0], p[0])
    assert_equal_arrays(j[1], p[1])
    assert_equal_arrays(j[2], p[2])


def test_cbag_random_pop_is_proportional_to_the_counts():
    counts = np.array([3, 0, 1, 6], dtype=np.int32)
    n = 4_000
    bag = PS.CBag(counts=torch.as_tensor(np.tile(counts, (n, 1))), batch_ndim=1)
    generator = torch.Generator().manual_seed(0)
    new, picked, ok = bag.pop_(generator)
    assert bool(ok.all())
    picked = picked.numpy()
    assert (counts[picked] > 0).all()  # only present keys are drawn
    expected = counts / counts.sum()
    freq = np.bincount(picked, minlength=4) / n
    assert np.all(np.abs(freq - expected) <= 5 * np.sqrt(expected * (1 - expected) / n) + 1e-12), freq
    # the popped key's count drops by one, nothing else moves
    delta = np.tile(counts, (n, 1)) - new.counts.numpy()
    assert (delta.sum(axis=1) == 1).all() and (delta[np.arange(n), picked] == 1).all()
    # the JAX package's draw has the same distribution
    jbag = JS.CBag(counts=jnp.asarray(np.tile(counts, (n, 1))), batch_ndim=1)
    _, jpicked, jok = jbag.pop_(jax.random.key(0))
    jfreq = np.bincount(np.asarray(jpicked), minlength=4) / n
    assert bool(np.asarray(jok).all())
    assert np.all(np.abs(jfreq - freq) <= 7 * np.sqrt(expected * (1 - expected) / n) + 1e-12)


def test_cbag_random_pop_of_an_empty_bag_is_not_ok():
    bag = PS.CBag.create(3, batch_shape=(2,), device="cpu").push_(torch.tensor([1, -1]))
    new, picked, ok = bag.pop_(torch.Generator().manual_seed(1))
    assert ok.tolist() == [True, False] and int(picked[0]) == 1
    assert new.counts.tolist() == [[0, 0, 0], [0, 0, 0]]


# --------------------------------------------------------- do_where, interop


def test_do_where_matches_jax():
    rng = np.random.default_rng(8)
    a = {"x": _ints(rng, (4, 3)), "y": (_ints(rng, (4,)),)}
    b = {"x": _ints(rng, (4, 3)), "y": (_ints(rng, (4,)),)}
    mask = rng.random(4) < 0.5
    j = JS.do_where(jnp.asarray(mask), jax.tree_util.tree_map(jnp.asarray, a), jax.tree_util.tree_map(jnp.asarray, b))
    p = PS.do_where(torch.as_tensor(mask), torch.utils._pytree.tree_map(torch.as_tensor, a), torch.utils._pytree.tree_map(torch.as_tensor, b))
    assert_equal_arrays(j["x"], p["x"])
    assert_equal_arrays(j["y"][0], p["y"][0])


@pytest.mark.parametrize("kind", ["CMemory", "CDict", "CList", "CBag"])
def test_structures_cross_through_interop(kind):
    rng = np.random.default_rng(9)
    if kind == "CMemory":
        j = JS.CMemory.create(4, 2, batch_shape=(3,)).set_(jnp.asarray([0, 3, 1]), jnp.asarray(_ints(rng, (3, 2))))
    elif kind == "CDict":
        j = JS.CDict.create(["a", "b"], 2).set_("b", jnp.asarray(_ints(rng, (2,))))
    elif kind == "CList":
        j = JS.CList.create(3, batch_shape=(2,)).append_(jnp.asarray([1.0, 2.0])).appendleft_(5.0)
    else:
        j = JS.CBag.create(5, capacity=7).push_(jnp.asarray([1, 1, 4]))
    port = interop.structure_from_numpy(_jax_fields(j), device="cpu")
    assert type(port) is getattr(PS, kind)
    assert_same(j, port)
    again = interop.structure_from_numpy(interop.structure_to_numpy(port), device="cpu")
    assert_same(j, again)


def test_structures_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: PS.CMemory.create(3),
        lambda: PS.CDict.create(3),
        lambda: PS.CList.create(3),
        lambda: PS.CBag.create(3),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
