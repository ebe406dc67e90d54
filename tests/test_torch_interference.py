"""The RX options: the port's SpectralNR, NoiseBlanker, AutoNotch, vad and
Vad, and RxChain with each option and with all of them, against the JAX
package on the same numpy inputs.

Tolerances: outputs 1e-5 of their scale; states rtol 1e-5 or 1e-5 of the
leaf's scale (a minimum-statistics estimate can sit on a near-zero FFT
magnitude, whose relative error two FFT libraries do not bound); VAD
flags equal. The chain on the flagship stage plan at C=4 (K1's plain
route), three blocks of 2 x min_block with an FM signal in the NFM channel:
audio 2e-4 after block 0 (block 0 carries the cold-start AGC, NR and VAD
transients), NFM rows modulo fs/deviation = 19.2; the option states as
above; the VAD flags equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jrun

from radioframe.core import config as jcfg
from radioframe.ops import interference as jint
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.convert import state_from_numpy, state_to_numpy
from radioframe_torch.core import config as tcfg
from radioframe_torch.io import fixtures as FX
from radioframe_torch.ops import interference as tint
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain

torch.set_num_threads(2)

C, FS = 4, 1_536_000.0
MODES = np.array([0, 1, 2, 3], np.int32)  # SSB, CW, AM, NFM
FREQS = np.array([1e5, -2.5e5, 4e4, 6.5e5])
OPTIONS = {
    "nb": dict(nb_enabled=True),
    "nr": dict(nr_enabled=True),
    "notch": dict(notch_enabled=True),
    "vad": dict(vad_enabled=True),
    "vad nr": dict(vad_enabled=True, nr_enabled=True),
    "deemphasis": dict(nfm_deemphasis_s=531e-6),
    "squelch": dict(squelch_enabled=True),
    "all": dict(nb_enabled=True, nr_enabled=True, notch_enabled=True, vad_enabled=True,
                nfm_deemphasis_s=531e-6, squelch_enabled=True),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _voice_and_carrier(rng, C_, n, carrier: float = 0.8):
    """Voice-like audio with gaps, a steady carrier and noise, complex."""
    v = np.stack([FX.voicelike_audio(48_000.0, n, seed=s) for s in range(C_)])
    gate = (np.arange(n) // 2048) % 2  # 50% duty: quiet frames for the floors
    t = np.arange(n) / 48_000.0
    x = v * gate + carrier * np.exp(2j * np.pi * 1500.3 * t) + 0.05 * (
        rng.standard_normal((C_, n)) + 1j * rng.standard_normal((C_, n)))
    return x.astype(np.complex64)


def _close(got, want, tol=1e-5):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale)


# --- the ops -------------------------------------------------------------------------------


@pytest.mark.parametrize("gated", [False, True], ids=["no vad", "vad gated"])
def test_spectral_nr_matches_jax(rng, gated):
    x = _voice_and_carrier(rng, 2, 256 * 32)
    voice = (rng.random((2, 32)) < 0.5) if gated else None
    voice_all = np.ones((2, 32), bool)
    t, j = tint.SpectralNR(256), jint.SpectralNR(256)
    est0 = np.full((2, 256), 3.0, np.float32)
    for v in (voice, voice_all) if gated else (None,):
        y, est = t(_t(est0), _t(x), voice=None if v is None else _t(v))
        y_j, est_j = jrun(lambda e, x: j(e, x, voice=None if v is None else jnp.asarray(v)),
                          est0, x)
        _close(y.numpy(), np.asarray(y_j))
        _state_close(est.numpy(), np.asarray(est_j), "est")
    if gated:  # every frame voiced: the estimate freezes
        np.testing.assert_array_equal(est.numpy(), est0)


def test_noise_blanker_matches_jax(rng):
    x = (0.1 * (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))))
    x = x.astype(np.complex64)
    hits = rng.integers(100, 4000, 25)
    x[0, hits] += 30.0
    t, j = tint.NoiseBlanker(threshold=4.0), jint.NoiseBlanker(threshold=4.0)
    y, p = t(torch.zeros(2), _t(x))
    y_j, p_j = jrun(lambda x: j(j.init_state(2), x), x)
    np.testing.assert_array_equal(y.numpy() == 0, np.asarray(y_j) == 0)
    _close(y.numpy(), np.asarray(y_j))
    _state_close(p.numpy(), np.asarray(p_j), "power")
    assert np.all(np.abs(y.numpy()[0, hits]) < 1e-6)


def test_auto_notch_matches_jax(rng):
    x = _voice_and_carrier(rng, 2, 256 * 64)
    t, j = tint.AutoNotch(nfft=256, ema=0.5), jint.AutoNotch(nfft=256, ema=0.5)
    ema, ema_j = t.init_state(2, "cpu"), j.init_state(2)
    for _ in range(2):  # the EMA locks onto the persistent tone
        y, ema = t(ema, _t(x))
        y_j, ema_j = jrun(j, ema_j, x)
        _close(y.numpy(), np.asarray(y_j))
        _state_close(ema.numpy(), np.asarray(ema_j), "ema")
    f = np.abs(np.fft.fft(y.numpy()[0]))
    f_in = np.abs(np.fft.fft(x[0]))
    k = int(round(1500.3 / 48_000.0 * x.shape[-1]))
    assert f[k] < 0.1 * f_in[k]  # the carrier is notched


@pytest.mark.parametrize("kind", ["vad", "Vad"])
def test_vad_matches_jax(rng, kind):
    x = _voice_and_carrier(rng, 3, 256 * 40, carrier=0.0)
    if kind == "vad":
        flags = tint.vad(_t(x))
        flags_j = jrun(lambda x: jint.vad(x), x)
    else:
        t, j = tint.Vad(256), jint.Vad(256)
        floor = np.array([1e6, 1e-3, 5.0], np.float32)
        flags, fl = t(_t(floor), _t(x))
        flags_j, fl_j = jrun(j, floor, x)
        _state_close(fl.numpy(), np.asarray(fl_j), "floor")
    assert flags.dtype == torch.bool and flags.shape == (3, 40)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(flags_j))
    assert 0 < flags.numpy().sum() < flags.numel()  # the case decides some of each


def test_frame_length_is_checked():
    with pytest.raises(ValueError, match="multiple of nfft=256"):
        tint.SpectralNR(256)(torch.zeros((1, 256)), torch.zeros((1, 300), dtype=torch.complex64))


# --- the chain -----------------------------------------------------------------------------


def _cfg(mod, **kw):
    return mod.RxConfig(fs_in=FS, channels=C,
                        stages=(mod.CicStage(R=8, N=4),
                                mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                        ols_hop=512, fuse_frontend=True, fuse_frontend_depth=2,
                        enabled_modes=(0, 1, 2, 3), **kw)


def _nfm_phase(rng, n: int) -> np.ndarray:
    """A voice-band FM phase at fs_in (2.5 kHz peak deviation): a carrier
    that the auto-notch sees as a spread band, not a steady line (a bare
    carrier would be notched, leaving the discriminator on noise)."""
    m = np.convolve(rng.standard_normal(n + 255), np.ones(256) / 16.0, mode="valid")
    m /= np.abs(m).max()
    return np.cumsum(2 * np.pi * 2500.0 / FS * m)


def _blocks(T: int, blocks: int = 3):
    rng = np.random.default_rng(5)
    n = np.arange(blocks * T)
    fm = 4.0 * np.exp(1j * (2 * np.pi * FREQS[3] * n / FS + _nfm_phase(rng, blocks * T)))
    out = []
    for b in range(blocks):
        x = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
        x[3] += fm[b * T:(b + 1) * T].astype(np.complex64)  # the NFM channel's signal
        out.append(x)
    return out


def _state_close(got, want, key):
    """A state leaf within rtol 1e-5, or 1e-5 of the leaf's scale."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=key)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_rx_chain_with_option_matches_jax(option):
    """Block 0 from the initial states on both (its audio carries the
    cold-start transients and is not held); then the port continues from the
    JAX chain's state, carried across by ``state_from_numpy``, for two
    blocks held to the bounds."""
    kw = OPTIONS[option]
    j, t = JChain(_cfg(jcfg, **kw)), TChain(_cfg(tcfg, **kw))
    assert t.min_block == j.min_block
    T = 2 * t.min_block
    step_j = jax.jit(j.step)
    w, m = freq_word(FREQS, FS), MODES
    st, st_j = t.init_state(), j.init_state(C)
    for blk, x in enumerate(_blocks(T)):
        st, a, aux = t.step(st, _t(x), _t(w), _t(m))
        st_j, a_j, aux_j = step_j(st_j, jnp.asarray(x), jnp.asarray(w), jnp.asarray(m))
        assert set(aux) == set(aux_j) and a.shape == (C, T // 32)
        assert bool(torch.isfinite(a).all())
        if blk > 0:
            d = a.numpy() - np.asarray(a_j)
            d[3] -= 19.2 * np.round(d[3] / 19.2)
            np.testing.assert_allclose(d, 0.0, atol=2e-4)
        if "vad_active" in aux_j:
            np.testing.assert_array_equal(aux["vad_active"].numpy(),
                                          np.asarray(aux_j["vad_active"]))
        if blk == 0:
            st = state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    got, want = state_to_numpy(st), jax.tree.map(np.asarray, st_j)
    for k in ("nb", "nr", "vad", "notch", "squelch"):
        if isinstance(want[k], tuple):
            assert got[k] == ()
        else:
            _state_close(got[k], want[k], k)
    assert len(got["deemph"]) == len(want["deemph"])
    for a_, b_ in zip(got["deemph"], want["deemph"]):
        _state_close(a_, b_, "deemph")
