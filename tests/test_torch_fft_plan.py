"""The host side of the port's FFT (``radioframe_torch/kernels/fft_plan.py``),
whose index maps ``csrc/channelizer.cuh`` ``rf::fft`` mirrors: the radix
plan, the per-pass twiddle table and the plain executor that runs the
kernel's passes thread by thread.

The executor is held against ``torch.fft.fft`` and numpy at every power of
two from 2 to 8192 (1e-5 of the output's scale: float32 rounding over at
most four passes), and, under the existing polyphase at M = 64 and 256,
against the JAX package's K3 (``FusedPfbDft`` in Pallas interpret mode) at
the port's 2e-4-of-scale plane tolerance. The exchange layout is checked
for shared-memory bank conflicts, as the kernel reads and writes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.kernels.pfb_dft import FusedPfbDft as JPfbDft
from radioframe_torch.kernels import fft_plan as fp
from radioframe_torch.kernels.pfb_dft import FusedPfbDft
from radioframe_torch.ops.pfb import polyphase_frames

torch.set_num_threads(2)

SIZES = [1 << n for n in range(1, 14)]
TOL = 1e-5         # of the output's scale
PLANE_TOL = 2e-4   # of the planes' scale, as chip_smoke.py holds K3


def _c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("N", SIZES)
def test_executor_matches_torch_fft_and_numpy(N):
    x = _c64(np.random.default_rng(N), 3, N)
    y = fp.plain_fft(torch.from_numpy(x)).numpy()
    scale = float(np.abs(np.fft.fft(x)).max())
    np.testing.assert_allclose(y, np.fft.fft(x.astype(np.complex128)), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(y, torch.fft.fft(torch.from_numpy(x)).numpy(), rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("N", SIZES)
def test_plan_and_twiddle_table(N):
    """Radices multiply to N with one small radix first; the table holds rows
    b < 4 of e^{-2 pi i 2^b k / (16 Ns)}, k < Ns, for each pass after the
    first, at float32 rounding of the float64 values."""
    radices = fp.plan(N)
    assert int(np.prod(radices)) == N
    assert all(r == fp.POINTS for r in radices[1:]) and radices[0] <= fp.POINTS
    assert fp.threads(N) * fp.points_per_thread(N) == N
    tw = fp.twiddles(N)
    assert tw.dtype == np.complex64
    off = 0
    for ns in fp.pass_spans(N)[1:]:
        for b in range(4):
            want = np.exp(-2j * np.pi * (1 << b) * np.arange(ns) / (16 * ns))
            np.testing.assert_allclose(tw[off:off + ns], want, rtol=0, atol=1e-7)
            off += ns
    assert off == len(tw)


@pytest.mark.parametrize("N", [n for n in SIZES if n >= 256])
def test_exchange_is_free_of_bank_conflicts(N):
    """Every exchange write (pass output j R' + ... as the kernel stores it)
    and read (t + T s) puts a half-warp's 8-byte accesses on distinct banks
    of the padded buffer, and stays inside ``exchange_points(N)``."""
    T, P = fp.threads(N), fp.points_per_thread(N)
    radices, spans = fp.plan(N), fp.pass_spans(N)
    for R, ns in list(zip(radices, spans))[:-1]:
        Q = P // R
        for half in range(0, T, 16):
            t = np.arange(half, half + 16)
            for q in range(Q):
                j = t + T * q
                for r in range(R):
                    slots = fp.smem_index((j // ns) * ns * R + j % ns + r * ns)
                    assert len(set(slots % 16)) == 16, (R, ns, q, r)
                    assert slots.max() < fp.exchange_points(N)
            for s in range(P):
                assert len(set(fp.smem_index(t + T * s) % 16)) == 16


@pytest.mark.parametrize("M", [64, 256])
def test_executor_under_the_polyphase_matches_jax_k3(M):
    """The executor over the port's polyphase frames against the reference's
    K3 (Pallas, interpret mode), two streamed blocks."""
    rng = np.random.default_rng(M + 7)
    j, t = JPfbDft(M, 8, interpret=True), FusedPfbDft(M, 8)
    step_j = jax.jit(lambda tl, x: j.call_planes(tl, x, native=False))
    tail_j, tail_t = j.init_state(1), t.init_state(1)
    for _ in range(2):
        x = _c64(rng, 32 * M)
        (yr_j, yi_j), tail_j = step_j(tail_j, jnp.asarray(x[None]))
        K = t.K
        fr = torch.cat([tail_t[0].real, torch.from_numpy(x.real.copy())]).reshape(-1, M)
        fi = torch.cat([tail_t[0].imag, torch.from_numpy(x.imag.copy())]).reshape(-1, M)
        y = fp.plain_fft(torch.complex(*polyphase_frames(t.h, fr, fi)), t.tw).numpy()
        scale = float(np.abs(np.asarray(yr_j) + 1j * np.asarray(yi_j)).max())
        np.testing.assert_allclose(y.real, np.asarray(yr_j), rtol=0, atol=PLANE_TOL * scale)
        np.testing.assert_allclose(y.imag, np.asarray(yi_j), rtol=0, atol=PLANE_TOL * scale)
        tail_t = torch.from_numpy(x[None, -(K - 1) * M:])
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
