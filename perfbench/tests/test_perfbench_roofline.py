"""The yardstick's counts: bytes, operations, peaks and their printing."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import roofline  # noqa: E402
from perfbench.reference.mlp_policy import MLP  # noqa: E402


def test_sampling_bytes_at_the_flagship():
    # the population written once, mu and sigma read once, the 16-byte seed
    nbytes = roofline.sampling_bytes(10_000, 12_305)
    assert nbytes == 10_000 * 12_305 * 4 + 2 * 12_305 * 4 + 16
    assert round(nbytes / 1e6, 1) == 492.3
    assert roofline.roofline_share(0.147e-3, nbytes=nbytes) == pytest.approx(100 * nbytes / 3.35e12 / 0.147e-3)


def test_ranking_bytes_count_no_comparisons():
    assert roofline.ranking_bytes(10_000) == 80_000
    # ~17 us for 80 KB is about 0.14% of the roofline
    assert roofline.roofline_share(17e-6, nbytes=80_000) == pytest.approx(0.1405, rel=1e-3)


def test_mlp_flops_of_the_12305_parameter_policy():
    sizes = [109, 64, 64, 17]
    assert MLP(sizes).parameter_count == 12_305
    assert MLP(sizes).macs() * 2 == 2 * (109 * 64 + 64 * 64 + 64 * 17) == 24_320


def test_a_tiny_share_prints_non_zero():
    share = roofline.roofline_share(1.0, flops=67e12 * 1e-8)
    assert share == pytest.approx(1e-6)
    line = json.dumps({"metrics": {"gen_mfu": {"value": share, "unit": "%"}}})
    assert float(json.loads(line)["metrics"]["gen_mfu"]["value"]) > 0
    assert "e-0" in line  # printed with its digits, not rounded to 0.0


def test_a_share_needs_a_time():
    with pytest.raises(ValueError):
        roofline.roofline_share(0.0, nbytes=1)
