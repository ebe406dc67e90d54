"""The one traffic generator: a pool of distinct IQ blocks, made on the device
from a seed, in which every channel carries a signal of its own mode at its
own centre above Gaussian noise.

The signal is synthesised as a line spectrum over the whole pool (n blocks
of T samples) and brought to time by one inverse FFT, so each line sits on a
bin of the pool's length and the pool repeats without a seam. By mode:

- SSB: a tone ``ssb_tone_hz`` above the centre (LSB: below);
- CW: a carrier ``cw_offset_hz`` from the centre;
- AM: a carrier with two sidebands of depth ``am_depth`` at ``am_tone_hz``;
- NFM: a carrier frequency-modulated by a tone of ``nfm_tone_hz`` with a
  peak deviation of ``nfm_peak_dev_hz`` (its Bessel lines), so that the
  discriminator always has a carrier to lock to.

Each channel draws its amplitude (``amplitude`` spread by
``amplitude_spread_db``), tone, offset and phases from the seed; the noise
is complex Gaussian with an rms of ``noise_rms``. Every seed gives the same
sizes and the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SSB, CW, AM, NFM, LSB = 0, 1, 2, 3, 4


def _bessel_lines(beta: float, k_max: int) -> np.ndarray:
    """J_k(beta) for k in [-k_max, k_max]: the Fourier series of
    e^{j beta sin theta}, taken by an FFT of 256 points."""
    P = 256
    th = 2.0 * np.pi * np.arange(P) / P
    c = np.fft.fft(np.exp(1j * beta * np.sin(th))) / P
    k = np.arange(-k_max, k_max + 1)
    return c[k % P].real


def channel_lines(modes, centers_hz, rows, fs: float, N: int, recipe: dict,
                  rng: np.random.Generator):
    """The pool's spectral lines: (row, bin, complex amplitude) arrays."""
    out_r, out_b, out_a = [], [], []
    grid = N / fs

    def uniform(key):
        lo, hi = recipe[key]
        return rng.uniform(lo, hi)

    spread = recipe.get("amplitude_spread_db", 0.0)
    for mode, fc, row in zip(modes, centers_hz, rows):
        A = recipe["amplitude"] * 10.0 ** (rng.uniform(-0.5, 0.5) * spread / 20.0)
        c = int(round(fc * grid))
        if mode in (SSB, LSB):
            off = int(round(uniform("ssb_tone_hz") * grid)) * (1 if mode == SSB else -1)
            bins, amps = [c + off], [A]
        elif mode == CW:
            bins, amps = [c + int(round(uniform("cw_offset_hz") * grid))], [A]
        elif mode == AM:
            fm = max(1, int(round(uniform("am_tone_hz") * grid)))
            d = recipe["am_depth"] / 2.0
            bins, amps = [c - fm, c, c + fm], [A * d, A, A * d]
        elif mode == NFM:
            fm_bins = max(1, int(round(uniform("nfm_tone_hz") * grid)))
            beta = uniform("nfm_peak_dev_hz") / (fm_bins / grid)
            k_max = int(math.ceil(beta)) + 6
            k = np.arange(-k_max, k_max + 1)
            bins, amps = list(c + k * fm_bins), list(A * _bessel_lines(beta, k_max))
        else:
            raise ValueError(f"no signal recipe for mode {mode}")
        ph = np.exp(2j * np.pi * rng.uniform(0.0, 1.0, len(bins)))
        out_r += [row] * len(bins)
        out_b += [b % N for b in bins]
        out_a += list(np.asarray(amps) * ph)
    return np.asarray(out_r, np.int64), np.asarray(out_b, np.int64), np.asarray(out_a)


def make_pool(layout: dict, recipe: dict, seed: int, device) -> torch.Tensor:
    """(n_blocks, rows, T) complex64 on ``device``: the pool of distinct
    blocks for ``layout`` ({"rows", "fs", "T", "n_blocks", "centers_hz",
    "row_of", "modes"}), drawn from ``seed``."""
    rows, T, n = layout["rows"], layout["T"], layout["n_blocks"]
    N = n * T
    rng = np.random.default_rng(seed)
    r, b, a = channel_lines(layout["modes"], layout["centers_hz"], layout["row_of"],
                            layout["fs"], N, recipe, rng)
    dev = torch.device(device)
    spec = torch.zeros((rows, N), dtype=torch.complex64, device=dev)
    spec.index_put_((torch.as_tensor(r, device=dev), torch.as_tensor(b, device=dev)),
                    torch.as_tensor(a.astype(np.complex64), device=dev), accumulate=True)
    x = torch.fft.ifft(spec, dim=-1) * N
    del spec
    g = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    s = recipe["noise_rms"] / math.sqrt(2.0)
    x += torch.complex(torch.randn((rows, N), generator=g, device=dev) * s,
                       torch.randn((rows, N), generator=g, device=dev) * s)
    return x.reshape(rows, n, T).transpose(0, 1).contiguous()
