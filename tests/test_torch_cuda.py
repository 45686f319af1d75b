"""The CUDA kernels of ``evotorch_tpu_torch`` against their plain PyTorch
versions, on the card. These tests need a CUDA device and ``nvcc``; each
decides inside the test (never at import) and skips without a card.

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
