"""The port's panorama (ops/spectrum.py: Spectrum, ZoomSpectrum,
snap_to_peak) and RxChain's emit_spectrum, Radio.waterfall and Radio.snap
against the JAX package on the same numpy inputs.

Tolerances: dB lines within 1e-2 dB (the channelizer waterfall's bound).
After a decimating chain, stopband bins sit 80-100 dB under the passband,
where the two packages' float32 FIRs differ by more than the signal left
there; those lines are held within 1e-2 dB over the 60 dB below each line's
peak, a waterfall's displayed range. Snap offsets exact (an argmax over the
same bins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.api.radio import Radio as JRadio
from radioframe.core import config as jcfg
from radioframe.ops import spectrum as jspec
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.api.radio import Radio as TRadio
from radioframe_torch.core import config as tcfg
from radioframe_torch.ops import spectrum as tspec
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain

torch.set_num_threads(2)

C = 3
DB_TOL = 1e-2


def _lines_close(db_t, db_j, span_db=60.0):
    """dB lines within DB_TOL over the span_db below each line's peak."""
    db_t, db_j = np.asarray(db_t), np.asarray(db_j)
    shown = db_j >= db_j.max(axis=-1, keepdims=True) - span_db
    assert shown.mean() > 0.3  # the passband is most of what is held
    np.testing.assert_allclose(db_t[shown], db_j[shown], atol=DB_TOL)


def _iq(rng, T, rows=C):
    return (rng.standard_normal((rows, T)) + 1j * rng.standard_normal((rows, T))).astype(np.complex64)


@pytest.mark.parametrize("avg", [0.0, 0.7], ids=["raw", "ema"])
def test_spectrum_streaming_matches_jax(rng, avg):
    j, t = jspec.Spectrum(256, avg), tspec.Spectrum(256, avg)
    np.testing.assert_array_equal(t.window.numpy(), j._w)
    prev_j, prev_t = j.init_state(C), t.init_state(C)
    step_j = jax.jit(j.__call__)
    for _ in range(3):
        x = _iq(rng, 256 * 6 + 100)  # a partial frame at the end is dropped
        lines_j, prev_j = step_j(prev_j, jnp.asarray(x))
        lines_t, prev_t = t(prev_t, torch.from_numpy(x))
        assert lines_t.shape == lines_j.shape == (C, 6, 256)
        np.testing.assert_allclose(lines_t.numpy(), np.asarray(lines_j), atol=DB_TOL)
        np.testing.assert_allclose(prev_t.numpy(), np.asarray(prev_j), atol=DB_TOL)


def test_zoom_spectrum_streaming_matches_jax(rng):
    j, t = jspec.ZoomSpectrum(128, zoom=4, avg=0.5), tspec.ZoomSpectrum(128, zoom=4, avg=0.5)
    st_j, st_t = j.init_state(C), t.init_state(C)
    words = freq_word(np.array([1e3, -2.5e3, 7e3]), 48e3)
    step_j = jax.jit(j.__call__)
    for _ in range(2):
        x = _iq(rng, 4 * 128 * 4)
        lines_j, st_j = step_j(st_j, jnp.asarray(x), jnp.asarray(words))
        lines_t, st_t = t(st_t, torch.from_numpy(x), torch.from_numpy(words))
        np.testing.assert_allclose(lines_t.numpy(), np.asarray(lines_j), atol=DB_TOL)
        np.testing.assert_array_equal(st_t["nco"].numpy(), np.asarray(st_j["nco"]))
        np.testing.assert_allclose(st_t["fir"].numpy(), np.asarray(st_j["fir"]), atol=1e-6)
    assert tspec.ZoomSpectrum(64, zoom=1).init_state(C)["fir"] == ()


def test_snap_to_peak_matches_jax(rng):
    db = rng.standard_normal((C, 512)).astype(np.float32)
    db[0, 256 + 9] = 30.0   # inside the window
    db[1, 256 - 40] = 30.0  # outside: the in-window maximum wins
    for search in (1000.0, 5000.0):
        got = tspec.snap_to_peak(torch.from_numpy(db), 48e3, search, 512).numpy()
        want = np.asarray(jspec.snap_to_peak(jnp.asarray(db), 48e3, search, 512))
        np.testing.assert_array_equal(got, want)


def _rx_cfg(mod, **kw):
    return mod.RxConfig(fs_in=192_000.0, channels=C, emit_spectrum=True, spectrum_nfft=256,
                        enabled_modes=(0, 1, 2, 3), **kw)


@pytest.mark.parametrize("avg", [0.0, 0.6], ids=["raw", "ema"])
def test_rx_chain_emit_spectrum_matches_jax(rng, avg):
    j, t = JChain(_rx_cfg(jcfg, spectrum_avg=avg)), TChain(_rx_cfg(tcfg, spectrum_avg=avg))
    assert t.min_block == j.min_block
    words = freq_word(np.array([1e4, -3e4, 5e4]), 192e3)
    mode = np.array([0, 2, 3], np.int32)
    step_j = jax.jit(j.step)
    st_j, st_t = j.init_state(C), t.init_state(C)
    for blk in range(4):  # 4 frames a block
        x = _iq(rng, 2 * j.min_block)
        st_j, _, aux_j = step_j(st_j, jnp.asarray(x), jnp.asarray(words), jnp.asarray(mode))
        st_t, _, aux_t = t.step(st_t, torch.from_numpy(x), torch.from_numpy(words),
                                torch.from_numpy(mode))
        if avg and blk < 3:  # the EMA's -120 dB seed compresses the first lines' range
            continue
        _lines_close(aux_t["spectrum"].numpy(), aux_j["spectrum"])
        _lines_close(st_t["spec"].numpy(), st_j["spec"])


def test_radio_waterfall_and_snap_match_jax(rng):
    """A tone 700 Hz off the tuned frequency: snap retunes both radios by the
    same bin offset; waterfall lines and metrics agree."""
    rj, rt = JRadio(_rx_cfg(jcfg)), TRadio(_rx_cfg(tcfg), device="cpu")
    assert rt.waterfall() is None
    fs, T = 192_000.0, 2 * rj.chain.min_block
    n = np.arange(T)
    tone = np.exp(2j * np.pi * 20_700.0 * n / fs)
    x = (0.01 * _iq(rng, T, rows=1)[0] + tone).astype(np.complex64)
    for r in (rj, rt):
        r.tune(0, 20_000.0)
        r.set_mode(0, "ssb")
        r.process(x)
    _lines_close(rt.waterfall(), rj.waterfall())
    assert set(rt.metrics()) == set(rj.metrics()) and "spectrum" not in rt.metrics()
    f_j, f_t = rj.snap(0, search_hz=2000.0), rt.snap(0, search_hz=2000.0)
    assert f_t == f_j and abs(f_t - 20_700.0) <= 48_000.0 / 256


def test_snap_without_spectrum_raises():
    r = TRadio(tcfg.RxConfig(channels=1), device="cpu")
    with pytest.raises(ValueError, match="emit_spectrum"):
        r.snap(0)
