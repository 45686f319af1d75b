"""The CUDA kernels of ``evotorch_tpu_torch`` against their plain PyTorch
versions, on the card. These tests need a CUDA device and ``nvcc``; each
decides inside the test (never at import) and skips without a card.

Run them on a machine with the card:
``python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
root ``conftest.py`` imports JAX, which that machine need not have).
``chip_smoke.py`` holds the kernels to the same checks at the flagship shapes.

Tolerances: the ranking kernel must equal its plain version exactly; the
sampling kernel too (same Philox counters, and the scale and +/- are
written so that nvcc cannot contract them into an FMA).
"""

import pytest
import torch

from evotorch_tpu_torch.ops import ranking, sampling


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2,), (7,), (1000,), (3, 257), (2, 2, 300)])
@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int16])
def test_centered_rank_kernel_equals_plain(device, shape, higher_is_better, dtype):
    g = torch.Generator(device=device).manual_seed(shape[-1])
    x = torch.randint(-5, 5, shape, generator=g, device=device).to(dtype)  # many ties
    if dtype.is_floating_point and shape[-1] > 4:
        x[..., 1] = float("nan")
        x[..., 3] = float("inf")
    before = ranking.centered_rank.launches
    got = ranking.centered_rank(x, higher_is_better=higher_is_better)
    assert ranking.centered_rank.launches == before + 1
    assert torch.equal(got, ranking.centered_rank_plain(x, higher_is_better=higher_is_better))


@pytest.mark.cuda
def test_centered_rank_kernel_rejects_int64(device):
    with pytest.raises(TypeError):
        ranking.centered_rank(torch.arange(5, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("num_solutions,length", [(2, 1), (6, 7), (64, 12305), (10, 513)])
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
