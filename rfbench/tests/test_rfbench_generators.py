"""The traffic generator is deterministic in the seed, gives every seed the
same sizes, and puts each channel's signal where its channel is tuned."""

import numpy as np
import pytest
import torch

from rfbench import harness, signals
from rfbench.tests.tiny import tiny


def _pool(cell_name, seed):
    cell, sizes = tiny(cell_name)
    cfg = harness.module("configs", cell["config"])
    return signals.make_pool(cfg.layout(sizes, cell), cell["signal"], seed, "cpu"), cfg, sizes


@pytest.mark.parametrize("cell", ["flagship_rx.host", "channelizer_4096.device"])
def test_same_seed_same_pool(cell):
    a, _, _ = _pool(cell, 2 ** 31 + 7)
    b, _, _ = _pool(cell, 2 ** 31 + 7)
    c, _, _ = _pool(cell, 2 ** 31 + 8)
    assert torch.equal(a, b)
    assert a.shape == c.shape and a.dtype == c.dtype == torch.complex64
    assert not torch.equal(a, c)


def test_lines_are_deterministic():
    rng = lambda: np.random.default_rng(5)  # noqa: E731
    args = ([0, 1, 2, 3], [0.0, 1e4, -2e4, 3e4], [0, 1, 2, 3], 1.536e6, 65536,
            harness.load_cell("flagship_rx.host")["signal"])
    a, b = signals.channel_lines(*args, rng()), signals.channel_lines(*args, rng())
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_flagship_rows_carry_their_channels():
    pool, cfg, sizes = _pool("flagship_rx.host", 3)
    x = pool.transpose(0, 1).reshape(pool.shape[1], -1)  # (C, pool samples)
    spec = torch.fft.fft(x, dim=-1).abs()
    N = x.shape[-1]
    peak_hz = np.fft.fftfreq(N, 1.0 / sizes["fs_in"])[spec.argmax(dim=-1).numpy()]
    assert np.all(np.abs(peak_hz - cfg.freqs_hz(sizes)) < 4000.0)


def test_channelizer_channels_carry_power():
    pool, cfg, sizes = _pool("channelizer_4096.device", 3)
    x = pool.reshape(-1)
    M = sizes["num_channels"]
    spec = torch.fft.fft(x).abs() ** 2
    # bins grouped by channel: each centre +- half a channel
    per_ch = torch.roll(spec, spec.numel() // (2 * M)).reshape(M, -1).sum(dim=-1)
    assert float(per_ch.min()) > 0.3 * float(per_ch.median())


def test_nfm_bessel_lines_sum_to_one():
    j = signals._bessel_lines(2.4, 12)
    assert abs(np.sum(j ** 2) - 1.0) < 1e-9
