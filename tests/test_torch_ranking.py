"""Parity of the port's ranking (``evotorch_tpu_torch.tools.ranking`` and the
plain twin of the centered-rank kernel, ``ops.ranking``) with the JAX
package, on the CPU.

Tolerances: centered ranks must equal ``centered_xla`` exactly (both divide
the integer rank by ``n - 1`` in one correctly rounded float32 division).
Against the Pallas kernel in interpret mode the integer ranks must be equal
and the values may differ by one float32 ulp of 0.5 (that kernel's
interpret-mode division rounds differently, as ``tests/test_ops.py``'s
``atol`` already allows). The other shapers are sums and logs, compared at
float32 round-off (``rtol=1e-6``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evotorch_tpu.ops.ranking import fused_centered_rank
from evotorch_tpu.tools import ranking as jax_ranking
from evotorch_tpu_torch.ops import ranking as ops_ranking
from evotorch_tpu_torch.tools import ranking as port_ranking

ULP_HALF = float(np.spacing(np.float32(0.5)))


def _inputs():
    rng = np.random.default_rng(0)
    tied = rng.integers(0, 5, size=64).astype(np.float32)  # many ties
    nan_inf = rng.normal(size=40).astype(np.float32)
    nan_inf[[3, 17, 29]] = np.nan
    nan_inf[[5, 11]] = np.inf
    nan_inf[[7]] = -np.inf
    nan_inf[[8, 9]] = 0.0
    nan_inf[10] = -0.0
    return {
        "random": rng.normal(size=257).astype(np.float32),
        "ties": tied,
        "batched": rng.normal(size=(3, 50)).astype(np.float32),
        "batched_ties": rng.integers(0, 3, size=(2, 4, 9)).astype(np.float32),
        "nan_inf": nan_inf,
        "single": np.asarray([5.0], dtype=np.float32),
        "single_batched": np.asarray([[1.0], [np.nan]], dtype=np.float32),
    }


INPUTS = _inputs()


def _ranks(centered_values, n):
    return np.rint((np.asarray(centered_values, dtype=np.float64) + 0.5) * (n - 1)).astype(np.int64)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("port_fn", ["centered", "kernel_plain"])
def test_centered_equals_centered_xla_exactly(name, higher_is_better, port_fn):
    x = INPUTS[name]
    expected = np.asarray(jax_ranking.centered_xla(jnp.asarray(x), higher_is_better=higher_is_better))
    fn = port_ranking.centered if port_fn == "centered" else ops_ranking.centered_rank
    got = fn(torch.from_numpy(x), higher_is_better=higher_is_better).numpy()
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("port_fn", ["centered", "kernel_plain"])
def test_centered_matches_pallas_interpret(name, higher_is_better, port_fn):
    x = INPUTS[name]
    expected = np.asarray(
        fused_centered_rank(jnp.asarray(x), higher_is_better=higher_is_better, use_pallas=True, interpret=True)
    )
    fn = port_ranking.centered if port_fn == "centered" else ops_ranking.centered_rank
    got = fn(torch.from_numpy(x), higher_is_better=higher_is_better).numpy()
    n = x.shape[-1]
    if n > 1:
        np.testing.assert_array_equal(_ranks(got, n), _ranks(expected, n))
    np.testing.assert_allclose(got, expected, rtol=0, atol=ULP_HALF)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8", "int16", "uint8"])
@pytest.mark.parametrize("higher_is_better", [True, False])
def test_kernel_twin_dtypes_match_pallas_interpret(dtype, higher_is_better):
    values = np.random.default_rng(1).integers(0, 20, size=(2, 33))
    x_jax = jnp.asarray(values).astype(getattr(jnp, dtype))
    x_torch = torch.from_numpy(values).to(getattr(torch, dtype))
    expected = np.asarray(
        fused_centered_rank(x_jax, higher_is_better=higher_is_better, use_pallas=True, interpret=True).astype(jnp.float32)
    )
    got = ops_ranking.centered_rank(x_torch, higher_is_better=higher_is_better)
    assert got.dtype == (x_torch.dtype if x_torch.dtype.is_floating_point else torch.float32)
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(_ranks(got, 33), _ranks(expected, 33))


def _special_row(dtype):
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, size=97).astype(dtype)  # many ties
    x[[0, 13, 40]] = np.nan
    x[[5, 60]] = np.inf
    x[[7, 61]] = -np.inf
    x[[8, 20, 33]] = 0.0
    x[[9, 21, 90]] = -0.0
    x[50] = np.finfo(dtype).max
    x[51] = -np.finfo(dtype).tiny
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("higher_is_better", [True, False])
def test_plain_keys_order_like_stable_argsort(dtype, higher_is_better):
    x = _special_row(dtype)
    values = ops_ranking._signed(torch.from_numpy(x), higher_is_better)
    keys = ops_ranking._order_keys(values)
    np.testing.assert_array_equal(
        torch.argsort(keys, stable=True).numpy(), np.argsort(values.numpy(), kind="stable")
    )
    # -0 and +0 share one key, every NaN has the largest key, above +inf
    zero = values.numpy() == 0
    assert len(set(keys.numpy()[zero].tolist())) == 1
    nan = np.isnan(values.numpy())
    assert np.all(keys.numpy()[nan] == keys.max().item()) and keys.max().item() > keys[~torch.from_numpy(nan)].max().item()


def test_kernel_twin_rejects_int64():
    with pytest.raises(TypeError):
        ops_ranking.centered_rank(torch.arange(5))


@pytest.mark.parametrize("method", ["centered", "linear", "nes", "normalized", "raw"])
@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("guard_nonfinite", [True, False])
def test_rank_dispatcher_matches_jax(method, higher_is_better, guard_nonfinite):
    x = INPUTS["random"].copy()
    if guard_nonfinite:
        x[[2, 9]] = np.nan
        x[4] = -np.inf
    expected = np.asarray(
        jax_ranking.rank(jnp.asarray(x), method, higher_is_better=higher_is_better, guard_nonfinite=guard_nonfinite)
    )
    got = port_ranking.rank(
        torch.from_numpy(x), method, higher_is_better=higher_is_better, guard_nonfinite=guard_nonfinite
    ).numpy()
    if method in ("centered", "linear"):
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)


def test_rank_guard_is_identity_on_finite_rows_and_zero_on_all_nonfinite():
    x = np.stack([INPUTS["random"][:8], np.full(8, np.nan, dtype=np.float32)])
    got = port_ranking._nonfinite_to_worst(torch.from_numpy(x), higher_is_better=True).numpy()
    np.testing.assert_array_equal(got[0], x[0])
    np.testing.assert_array_equal(got[1], np.zeros(8, dtype=np.float32))
    with pytest.raises(ValueError):
        port_ranking.rank(torch.zeros(3), "bogus", higher_is_better=True)
