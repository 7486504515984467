"""The frozen count arithmetic against hand-worked values."""
from __future__ import annotations

import math

import pytest

from perfbench import counts
from perfbench.reference import decoder, mlp
from perfbench.tests.conftest import ROOT
from perfbench.harness import load_json

OLMO = load_json(ROOT / "perfbench" / "configs" / "olmo-1b.json")
MLP = load_json(ROOT / "perfbench" / "configs" / "paper_mlp.json")


def test_olmo_size_and_padding():
    d = sum(math.prod(s) for _, s, _ in decoder.leaves(OLMO))
    assert d == 1_176_764_416
    assert counts.pad_len(d) == d          # a multiple of 16,384


def test_mlp_size_and_padding():
    d = sum(math.prod(s) for _, s, _ in mlp.leaves(MLP))
    assert d == 25_450 and counts.pad_len(d) == 32_768


def test_exchange_bytes_and_bits_a_round():
    d = 1_176_764_416
    assert counts.exchange_bytes(d, 2) == 132 * d          # 155.3 GB
    assert counts.exchange_bytes(d, 2) / 1e9 == pytest.approx(155.33, abs=0.01)
    assert counts.round_bits(d, 2) == (18_828_230_720, 9_414_115_360)
    assert counts.round_bits(25_450, 16) == (16 * 262_176, 262_176)


def test_model_flops():
    mm = counts.lm_matmul_params(16, 2048, 16, 16, 128, 8192, 50_304)
    assert mm == 1_176_764_416       # tied: the head is the embedding
    assert counts.lm_flops_per_token(16, 2048, mm, 128) == \
        6 * mm + 12 * 16 * 2048 * 128
    assert mlp.flops_per_row(MLP, {}) == 6 * 25_450


def test_peaks():
    assert counts.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert counts.peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert counts.PEAK_FLOPS == {"float32": 67e12, "tf32": 495e12,
                                 "bfloat16": 989e12}
    with pytest.raises(ValueError):
        counts.peak_bytes_per_s("cpu")
