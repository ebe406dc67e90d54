"""radioframe_torch K1 (fused NCO + two-stage polyphase decimation + input
power) against radioframe.kernels.fused_frontend2.FusedFrontend2 run in
Pallas interpret mode, at C=4 and T=2*16384 per block with the flagship
stage plan (CIC(8,4) then the 97-tap compensating FIR decimating by 4).

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.kernels.fused_frontend2 import FusedFrontend2 as JFused
from radioframe.ops import filter_design as FD
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.kernels import fused_frontend2 as tff
from radioframe_torch.ops.nco import freq_word

torch.set_num_threads(2)

C = 4
T = 2 * 16384
FS = 1_536_000.0


@pytest.fixture(scope="module")
def stage_taps():
    cfg = RxConfig(fs_in=FS, channels=C,
                   stages=(CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)))
    return JChain(cfg)._stage_taps


def _pair(stage_taps, int16: bool):
    scale = 2.0 ** -15 if int16 else 1.0
    jf = JFused(stage_taps[0], 8, stage_taps[1], 4, interpret=True, input_scale=scale)
    tf = tff.FusedFrontend2(stage_taps[0], 8, stage_taps[1], 4, input_scale=scale)
    return jf, tf


@pytest.fixture(scope="module")
def j_step():
    return jax.jit(lambda f, st, xr, xi, w: f.step_planes(st, xr, xi, w, return_power=True),
                   static_argnums=0)


def _planes(rng, int16: bool, rows: int = C):
    if int16:
        x = np.clip(np.round(rng.standard_normal((2, rows, T)) * 8000.0), -32768, 32767)
        return x.astype(np.int16)
    return rng.standard_normal((2, rows, T)).astype(np.float32)


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_plain_matches_jax_kernel_streamed(stage_taps, j_step, rng, int16):
    jf, tf = _pair(stage_taps, int16)
    assert (tf.H_carry, tf.J0, tf.J2, tf.decim) == (jf.H_carry, jf.J0, jf.J2, jf.decim) \
        == (800, 4, 24, 32)
    np.testing.assert_array_equal(tf.w1.numpy(), jf.w1)
    np.testing.assert_array_equal(tf.w2.numpy(), jf.w2)
    words = freq_word(np.array([1e5, -3e5, 0.0, 7.1e5]), FS)
    words[0] = 2 ** 31 - 7  # near the int32 edge: acc + word*T wraps every block
    st_t, st_j = tf.init_state(C), jf.init_state(C)
    for _ in range(3):
        xr, xi = _planes(rng, int16)
        st_t, y_t, p_t = tf.step_planes(st_t, torch.from_numpy(xr), torch.from_numpy(xi),
                                        torch.from_numpy(words), return_power=True)
        st_j, y_j, p_j = j_step(jf, st_j, jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(words))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=5e-5)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
        np.testing.assert_array_equal(st_t["acc"].numpy(), np.asarray(st_j["acc"]))
        np.testing.assert_array_equal(st_t["tail"].numpy(), np.asarray(st_j["tail"]))
    assert tf.launches == 0  # CPU tensors take the plain version


def test_wideband_broadcast_and_complex_views(stage_taps, j_step, rng):
    """A shared (1, T) input fans out to all channels, and the complex-input
    form (strided view_as_real planes) equals the plane form."""
    jf, tf = _pair(stage_taps, False)
    words = freq_word(np.array([2e5, -2e5, 5e4, -5e4]), FS)
    xr, xi = _planes(rng, False, rows=1)
    st_t, y_t, p_t = tf.step_planes(tf.init_state(C), torch.from_numpy(xr),
                                    torch.from_numpy(xi), torch.from_numpy(words),
                                    return_power=True)
    _, y_j, p_j = j_step(jf, jf.init_state(C), jnp.asarray(xr), jnp.asarray(xi),
                         jnp.asarray(words))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=5e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
    assert tuple(st_t["tail"].shape) == (C, tf.H_carry)
    iq = torch.complex(torch.from_numpy(xr), torch.from_numpy(xi))
    st_c, y_c = tf.step(tf.init_state(C), iq, torch.from_numpy(words))
    torch.testing.assert_close(y_c, y_t, rtol=0, atol=0)
    torch.testing.assert_close(st_c["tail"], st_t["tail"], rtol=0, atol=0)


def test_single_stage_matches_jax(rng):
    taps = FD.cic_equivalent_taps(8, 4, 1)
    jf = JFused(taps, 8, interpret=True)
    tf = tff.FusedFrontend2(taps, 8)
    assert (tf.decim, tf.H_carry) == (jf.decim, jf.H_carry) == (8, 32)
    words = freq_word(np.linspace(-10e3, 10e3, C), 192e3)
    st_t, st_j = tf.init_state(C), jf.init_state(C)
    step = jax.jit(jf.step)
    for _ in range(2):
        x = (rng.standard_normal((C, 2048)) + 1j * rng.standard_normal((C, 2048)))
        x = x.astype(np.complex64)
        st_t, y_t = tf.step(st_t, torch.from_numpy(x), torch.from_numpy(words))
        st_j, y_j = step(st_j, jnp.asarray(x), jnp.asarray(words))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=5e-6)
        np.testing.assert_array_equal(st_t["acc"].numpy(), np.asarray(st_j["acc"]))


def test_rejects_bad_blocks(stage_taps):
    _, tf = _pair(stage_taps, False)
    st = tf.init_state(C)
    w = torch.zeros(C, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 32"):
        tf.step_planes(st, torch.zeros(C, T + 16), torch.zeros(C, T + 16), w)
    with pytest.raises(ValueError, match="at least 800"):
        tf.step_planes(st, torch.zeros(C, 512), torch.zeros(C, 512), w)
    with pytest.raises(ValueError, match="float32 or int16"):
        tf.step_planes(st, torch.zeros(C, T, dtype=torch.float64),
                       torch.zeros(C, T, dtype=torch.float64), w)
    with pytest.raises(ValueError, match="do not fit"):
        tf.step_planes(st, torch.zeros(3, T), torch.zeros(3, T), w)
