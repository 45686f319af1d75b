"""Parity of the port's antithetic sampler (``evotorch_tpu_torch.ops.sampling``
and ``distributions``) with the JAX package, on the CPU.

With injected noise the port computes ``eps * sigma`` then ``mu +/- scaled``
in float32 with two roundings; XLA on the CPU contracts the same expression
into one fused multiply-add. So each value must agree with the JAX Pallas
kernel in interpret mode fed the same ``eps`` to within one ulp of the
product plus one ulp of the result (``_assert_within_fma_rounding``). The
JAX package's jitted interpret path draws ``eps`` inside the same program and
XLA fuses the draw with the scale, so against its output the bound is twice
that.
The Philox path is checked against the published Philox4x32-10 known-answer
vectors (Random123) and statistically: the mean and stdev of 10^6 draws
within 5 standard errors of 0 and 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from evotorch_tpu.algorithms.functional import pgpe as jax_pgpe
from evotorch_tpu.algorithms.functional import pgpe_ask as jax_pgpe_ask
from evotorch_tpu.ops import sample_symmetric_gaussian as jax_sample
from evotorch_tpu.ops.sampling import _pallas_kernel_with_noise
from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask
from evotorch_tpu_torch.distributions import SymmetricSeparableGaussian
from evotorch_tpu_torch.ops import sampling


def _assert_within_fma_rounding(got, expected, scaled, *, ulps):
    bound = ulps * (np.spacing(np.abs(scaled).astype(np.float32)) + np.spacing(np.abs(expected).astype(np.float32)))
    assert np.all(np.abs(got - expected) <= bound), float(np.max(np.abs(got - expected) - bound))


@pytest.mark.parametrize("num_solutions,length", [(512, 16), (8, 12305), (6, 7)])
def test_injected_noise_equals_pallas_interpret(num_solutions, length):
    rng = np.random.default_rng(length)
    mu = rng.normal(size=length).astype(np.float32)
    sigma = rng.uniform(0.05, 2.0, size=length).astype(np.float32)
    key = jax.random.key(num_solutions)
    expected = np.asarray(
        jax_sample(key, jnp.asarray(mu), jnp.asarray(sigma), num_solutions, use_pallas=True, interpret=True)
    )
    # the interpret path draws exactly this noise
    eps = np.array(jax.random.normal(key, (num_solutions // 2, length), dtype=jnp.float32))
    got = sampling.sample_symmetric_gaussian(
        torch.from_numpy(mu), torch.from_numpy(sigma), num_solutions, eps=torch.from_numpy(eps)
    ).numpy()
    assert got.shape == expected.shape == (num_solutions, length)
    scaled = np.repeat(eps * sigma, 2, axis=0)
    _assert_within_fma_rounding(got, expected, scaled, ulps=2)
    # the JAX package's injected-noise kernel on exactly this eps
    planes = pl.pallas_call(
        _pallas_kernel_with_noise,
        out_shape=jax.ShapeDtypeStruct((2, num_solutions // 2, length), jnp.float32),
        interpret=True,
    )(jnp.asarray(eps), jnp.asarray(mu), jnp.asarray(sigma))
    direct = np.asarray(planes).transpose(1, 0, 2).reshape(num_solutions, length)
    _assert_within_fma_rounding(got, direct, scaled, ulps=1)


def test_pgpe_ask_with_injected_noise_equals_jax_ask():
    L, popsize = 300, 10
    center = np.random.default_rng(3).normal(size=L).astype(np.float32)
    kw = dict(center_learning_rate=0.1, stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1)
    key = jax.random.key(7)
    expected = np.asarray(jax_pgpe_ask(key, jax_pgpe(center_init=jnp.asarray(center), **kw), popsize=popsize))
    eps = np.asarray(jax.random.normal(key, (popsize // 2, L), dtype=jnp.float32))
    state = pgpe(center_init=torch.from_numpy(center), **kw)
    got = pgpe_ask(None, state, popsize=popsize, eps=torch.from_numpy(eps.copy())).numpy()
    _assert_within_fma_rounding(got, expected, np.repeat(eps * np.float32(0.1), 2, axis=0), ulps=2)


def test_odd_popsize_raises():
    mu, sigma = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError):
        sampling.sample_symmetric_gaussian(mu, sigma, 7, generator=torch.Generator())
    with pytest.raises(ValueError):
        SymmetricSeparableGaussian._sample(torch.Generator(), {"mu": mu, "sigma": sigma}, 5)


def test_exactly_one_noise_source():
    mu, sigma = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError):
        sampling.sample_symmetric_gaussian(mu, sigma, 4)
    with pytest.raises(ValueError):
        sampling.sample_symmetric_gaussian(mu, sigma, 4, generator=torch.Generator(), eps=torch.zeros(2, 3))


_M = 0xFFFFFFFF


@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((_M, _M, _M, _M), (_M, _M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_plain_philox_known_answers(counter, key, expected):
    words = sampling.philox4x32_10(*(torch.tensor([c]) for c in counter), torch.tensor(key[0]), torch.tensor(key[1]))
    assert tuple(int(w) for w in words) == expected


def test_plain_philox_noise_is_standard_normal():
    eps = sampling.philox_normal(torch.tensor([12345, 678]), 1000, 1001).double()
    n = eps.numel()
    assert abs(float(eps.mean())) < 5 / np.sqrt(n)
    assert abs(float(eps.std()) - 1.0) < 5 / np.sqrt(2 * n)
    # neighbouring columns come from one Philox call but are independent draws
    corr = float(torch.corrcoef(torch.stack([eps[:, 0:1000:2].reshape(-1), eps[:, 1:1001:2].reshape(-1)]))[0, 1])
    assert abs(corr) < 5 / np.sqrt(n / 2)


_NOISE = sampling.philox_normal(torch.tensor([987654321, 42]), 500, 4 * 500).double()


@pytest.mark.parametrize("position", [0, 1, 2, 3])
def test_four_normals_per_philox_call_are_standard_normal(position):
    # columns 4q + position: the cosine (0, 2) or sine (1, 3) normal of the
    # first (0, 1) or second (2, 3) Box-Muller pair of each Philox call
    eps = _NOISE[:, position::4].reshape(-1)
    n = eps.numel()
    assert abs(float(eps.mean())) < 5 / np.sqrt(n)
    assert abs(float(eps.std()) - 1.0) < 5 / np.sqrt(2 * n)


@pytest.mark.parametrize("first,second", [(0, 1), (2, 3), (0, 2), (1, 3)])
def test_normals_of_one_philox_call_are_uncorrelated(first, second):
    # (0, 1) and (2, 3): cosine and sine of one Box-Muller pair
    a, b = _NOISE[:, first::4].reshape(-1), _NOISE[:, second::4].reshape(-1)
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) < 5 / np.sqrt(a.numel())


@pytest.mark.parametrize("num_solutions,length", [(2, 1), (2, 3), (6, 4), (6, 5), (10, 6), (4, 7)])
def test_antithetic_rows_sum_to_two_mu_exactly(num_solutions, length):
    sigma = torch.linspace(0.1, 3.0, length)
    seed = torch.tensor([length, num_solutions])
    at_zero = sampling.sample_symmetric_gaussian(torch.zeros(length), sigma, num_solutions, seed=seed)
    assert at_zero.shape == (num_solutions, length)
    assert torch.equal(at_zero[0::2] + at_zero[1::2], torch.zeros(num_solutions // 2, length))
    # around a non-zero mu the rows are mu +/- the same scaled noise
    mu = torch.linspace(-2.0, 2.0, length)
    got = sampling.sample_symmetric_gaussian(mu, sigma, num_solutions, seed=seed)
    scaled = at_zero[0::2]
    assert torch.equal(got[0::2], mu + scaled) and torch.equal(got[1::2], mu - scaled)


def test_generator_path_is_antithetic_and_reproducible():
    mu = torch.zeros(33)
    sigma = torch.full((33,), 0.5)
    a = sampling.sample_symmetric_gaussian(mu, sigma, 40, generator=torch.Generator().manual_seed(1))
    b = sampling.sample_symmetric_gaussian(mu, sigma, 40, generator=torch.Generator().manual_seed(1))
    c = sampling.sample_symmetric_gaussian(mu, sigma, 40, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[0::2] + a[1::2], torch.zeros(20, 33))
