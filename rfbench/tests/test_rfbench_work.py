"""The byte and operation counts of K1 and K5 against the hand count from
their shapes: their bounds at the measured sizes on the H100's peaks."""

import pytest

from rfbench import harness, peaks
from rfbench.metrics import k1_roofline, k5_roofline


def test_k1_bound_at_the_flagship():
    sizes = harness.load_sizes("flagship_rx")
    cell = harness.load_cell("flagship_rx.host")
    nbytes, ops = k1_roofline.work(sizes, cell)
    n = 128 * 131072
    # J0 = 4, J2 = 24, H_carry = 96 * 8 + 32 = 800; taps (5 x 8) + (25 x 4)
    assert nbytes == 8 * n + 8 * 128 * 800 + 4 * (40 + 100) + 8 * n // 32 + 12 * 128
    assert ops == n * (12 + 4 * 5 + 4 * 25 / 8)
    s, by = peaks.bound_s(nbytes, ops)
    assert by == "bytes" and 0.0413e-3 <= s <= 0.0416e-3


def test_k5_bound_at_4096_channels():
    sizes = harness.load_sizes("channelizer_4096")
    cell = harness.load_cell("channelizer_4096.device")
    nbytes, ops = k5_roofline.work(sizes, cell)
    M, K, F = 4096, 8, 2048
    assert nbytes == (8 * F * M + 4 * (K * M + M + 7 * M) + 8 * (K - 1) * M
                      + 4 * F * M + 4 * (F // 16) * M + 2 * 4 * 7 * M)
    # per 4 channels SSB 20 + CW 29 + AM 19 + NFM 27 operations a frame
    assert ops == pytest.approx(4 * K * F * M + 5 * F * M * 12 + F * 1024 * 95)
    s, by = peaks.bound_s(nbytes, ops)
    assert by == "bytes" and s == pytest.approx(0.0309e-3, abs=0.00005e-3)
