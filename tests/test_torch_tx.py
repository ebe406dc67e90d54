"""Config 4 on one device: the port's Biquad, BiquadCascade, FirInterpolator,
cic_interpolator, TxChain and DuplexChain against the JAX package (and scipy
and the golden model) on the same numpy inputs, with the parameters
carried across by ``convert.load_tx_params``.

Tolerances: one biquad section 1e-4 and a cascade 1e-3 against scipy
(tests/test_biquad.py), the port against JAX to the same bounds, streaming
against one block 1e-5 of the output's scale; interpolators 1e-4 against
the golden model (tests/test_tx_chain.py) and 1e-5 against JAX; TX IQ 5e-4
on unit-scale IQ (tests/test_sharded_tx.py: the NFM phase integrator's scan
order differs, ~1e-4 rad), the FM phase as phasors 2e-3; TX streaming
against one block 1e-5, the NFM row 1e-4 (exp(j*phase) of a float32 phase
integral, which sums the block's rounding); duplex RX audio 2e-4 after
block 0, NFM rows modulo fs/deviation = 19.2. Loopback SNRs above the reference's bars (SSB 25 dB, AM and NFM
15 dB)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jrun, jwrap
from scipy import signal

from radioframe.core import config as jcfg
from radioframe.core import presets as jpresets
from radioframe.golden import model as G
from radioframe.ops import biquad as jbq
from radioframe.ops import interp as jinterp
from radioframe.pipelines.duplex import DuplexChain as JDuplex
from radioframe.pipelines.tx_chain import TxChain as JTx
from radioframe_torch.convert import (load_reference_params, load_tx_params, state_from_numpy,
                                      state_to_numpy)
from radioframe_torch.core import config as tcfg
from radioframe_torch.core import presets as tpresets
from radioframe_torch.diag.metrics import audio_snr_db
from radioframe_torch.io import fixtures as FX
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import filter_design as FD
from radioframe_torch.ops.biquad import Biquad, BiquadCascade
from radioframe_torch.ops.interp import FirInterpolator, cic_interpolator
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.duplex import DuplexChain
from radioframe_torch.pipelines.tx_chain import TxChain

torch.set_num_threads(2)

EQ = ((300.0, 3.0, 1.0), (2500.0, 6.0, 2.0))
SOS = {
    "butter section": signal.butter(2, 0.2, output="sos"),
    "butter cascade": signal.butter(6, [0.05, 0.3], btype="band", output="sos"),
    "peaking eq": FD.peaking_eq_sos(EQ, 48_000.0),
    "deemphasis": FD.deemphasis_sos(531e-6, 48_000.0),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- biquads ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SOS))
def test_biquad_cascade_vs_scipy_and_jax(rng, name):
    sos = SOS[name]
    tol = 1e-4 if len(sos) == 1 else 1e-3
    x = rng.standard_normal((3, 800)).astype(np.float32)
    casc, jcasc = BiquadCascade(sos), jbq.BiquadCascade(sos)
    y, st = casc(casc.init_state(3), _t(x))
    y_j, st_j = jrun(lambda x: jcasc(jcasc.init_state(3), x), x)
    np.testing.assert_allclose(y.numpy(), signal.sosfilt(sos, x.astype(np.float64), axis=-1),
                               atol=tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=tol)
    for a, b in zip(st, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


def test_biquad_section_buffers_match_reference():
    sos = SOS["peaking eq"][0]
    t, j = Biquad(sos[:3], sos[3:]), jbq.Biquad(sos[:3], sos[3:])
    np.testing.assert_array_equal(t.A.numpy(), j.A)
    np.testing.assert_array_equal(t.B.numpy(), j.B)
    assert float(t.b0) == float(np.float32(j.b0))


@pytest.mark.parametrize("name", ["butter lowpass", "butter cascade", "peaking eq"])
def test_biquad_streaming(rng, name):
    """Three blocks against one, to 1e-5 of the output's scale (the
    reference's butter(4, 0.1) case has a scale below 1)."""
    sos = signal.butter(4, 0.1, output="sos") if name == "butter lowpass" else SOS[name]
    casc = BiquadCascade(sos)
    x = _t(rng.standard_normal((2, 600)).astype(np.float32))
    whole, st_whole = casc(casc.init_state(2), x)
    st, outs = casc.init_state(2), []
    for blk in torch.split(x, 200, dim=-1):
        y, st = casc(st, blk)
        outs.append(y)
    tol = 1e-5 * max(1.0, float(whole.abs().max()))
    torch.testing.assert_close(torch.cat(outs, dim=-1), whole, rtol=0, atol=tol)
    for a, b in zip(st, st_whole):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


# --- interpolators ------------------------------------------------------------------------


def _cx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_interpolator_vs_golden_and_jax(rng):
    L = 4
    taps = FD.interp_taps(64 * L + 1, L, 192_000.0, 3000.0)
    op, jop = FirInterpolator(taps, L), jinterp.FirInterpolator(taps, L)
    x = _cx(rng, (2, 256))
    y, tail = op(op.init_state(2), _t(x))
    y_j, tail_j = jrun(lambda x: jop(jop.init_state(2), x), x)
    np.testing.assert_array_equal(op.w.numpy(), jop._w)
    for c in range(2):
        ref, _ = G.interpolate(x[c].astype(np.complex128), L, taps)
        np.testing.assert_allclose(y.numpy()[c], ref[: y.shape[-1]], atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(tail_j))


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["fir L=5", "fir L=8 compensated",
                                                  "cic L=32 N=4"])
def test_tx_adc_plan_stage_vs_jax(rng, stage):
    """Each stage of tx_adc_61m44's plan at C=2, two streamed blocks."""
    t, j = TxChain(tpresets.tx_adc_61m44(channels=2)), JTx(jpresets.tx_adc_61m44(channels=2))
    op, jop = t.interps[stage], j.interps[stage]
    np.testing.assert_allclose(op.w.numpy(), jop._w, rtol=1e-6, atol=1e-9)
    load_tx_params(t, _tx_params(j))
    np.testing.assert_array_equal(op.w.numpy(), jop._w)
    st, st_j = op.init_state(2), jop.init_state(2)
    step = jwrap(jop)
    scale = 1.0
    for _ in range(2):
        x = _cx(rng, (2, 512))
        y, st = op(st, _t(x))
        y_j, st_j = step(st_j, x)
        scale = max(scale, float(np.abs(y_j).max()))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5 * scale)
        np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    if stage == 2:
        ref = cic_interpolator(32, 4)
        np.testing.assert_array_equal(ref.w.numpy(), op.w.numpy())


def test_interpolator_streaming(rng):
    op = FirInterpolator(FD.interp_taps(97, 3, 144_000.0, 3000.0), 3)
    x = _t(_cx(rng, (1, 300)))
    whole, _ = op(op.init_state(1), x)
    st, outs = op.init_state(1), []
    for blk in torch.split(x, 100, dim=-1):
        y, st = op(st, blk)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=-1), whole, rtol=0, atol=1e-5)


# --- the transmit chain ----------------------------------------------------------------


def _tx_params(j) -> dict:
    return {"ssb_H": j.ssb_bpf._H, "interp_w": [ip._w for ip in j.interps],
            "eq": [(b.A, b.B, b.b0) for b in j.mic_eq.sections] if j.mic_eq else (),
            "comp_decay": j.comp_decay, "fm_k": j.fm_k}


def _same_structure(t_tree, j_tree):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in j_tree:
            _same_structure(t_tree[k], j_tree[k])
    elif isinstance(j_tree, tuple):
        assert isinstance(t_tree, tuple) and len(t_tree) == len(j_tree)
        for a, b in zip(t_tree, j_tree):
            _same_structure(a, b)
    else:
        assert t_tree.shape == j_tree.shape and t_tree.dtype == j_tree.dtype


def _phasor_close(a, b, tol=2e-3):
    assert np.abs(np.exp(1j * a) - np.exp(1j * b)).max() < tol


def _tx_state_close(t, j):
    _same_structure(t, j)
    np.testing.assert_array_equal(t["nco"], j["nco"])
    _phasor_close(t["fm_phase"], j["fm_phase"])
    np.testing.assert_allclose(t["dc"], j["dc"], atol=1e-5)
    np.testing.assert_allclose(t["comp"], j["comp"], rtol=1e-5)
    np.testing.assert_allclose(t["ssb"], j["ssb"], atol=5e-4)
    for a, b in zip(t["eq"], j["eq"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for a, b in zip(t["interp"], j["interp"]):
        np.testing.assert_allclose(a, b, atol=5e-4)


class _TxPair:
    C = 5  # one channel of each mode: SSB, CW, AM, NFM, LSB

    def __init__(self, eq):
        kw = dict(channels=self.C, mic_eq_bands=eq)
        self.j, self.t = JTx(jpresets.tx_adc_61m44(**kw)), TxChain(tpresets.tx_adc_61m44(**kw))
        load_tx_params(self.t, _tx_params(self.j))
        self.step_j = jax.jit(self.j.step)
        self.words = freq_word(np.linspace(-20e6, 20e6, self.C), 61.44e6)
        self.modes = np.arange(self.C, dtype=np.int32)


@pytest.fixture(scope="module", params=[(), EQ], ids=["no eq", "mic eq"])
def tx_pair(request):
    return _TxPair(request.param)


def _audio(rng, C, Ta):
    return (0.3 * rng.standard_normal((C, Ta))).astype(np.float32)


def test_tx_chain_matches_jax(tx_pair, rng):
    """tx_adc_61m44's plan (L=1280) in all five modes, two blocks."""
    p = tx_pair
    st, st_j = p.t.init_state(), p.j.init_state(p.C)
    w, m = _t(p.words), _t(p.modes)
    for _ in range(2):
        a = _audio(rng, p.C, p.t.min_block)
        st, iq = p.t.step(st, _t(a), w, m)
        st_j, iq_j = p.step_j(st_j, jnp.asarray(a), jnp.asarray(p.words), jnp.asarray(p.modes))
        assert iq.shape == (p.C, p.t.min_block * 1280) and iq.dtype == torch.complex64
        assert bool(torch.isfinite(torch.view_as_real(iq)).all())
        np.testing.assert_allclose(iq.numpy(), np.asarray(iq_j), atol=5e-4)
    _tx_state_close(state_to_numpy(st), jax.tree.map(np.asarray, st_j))


def test_tx_streaming_matches_one_block(tx_pair, rng):
    p = tx_pair
    a = _t(_audio(rng, p.C, 2 * p.t.min_block))
    w, m = _t(p.words), _t(p.modes)
    st_one, iq_one = p.t.step(p.t.init_state(), a, w, m)
    st, outs = p.t.init_state(), []
    for blk in torch.split(a, p.t.min_block, dim=-1):
        st, iq = p.t.step(st, blk, w, m)
        outs.append(iq)
    d = (torch.cat(outs, dim=-1) - iq_one).abs().amax(dim=-1)
    nfm = torch.from_numpy(p.modes == demod_op.NFM)
    assert float(d[~nfm].max()) <= 1e-5, d
    # the NFM row is exp(j*phase) of the f32 phase integral, which sums the
    # block's rounding
    assert float(d[nfm].max()) <= 1e-4, d
    torch.testing.assert_close(st["nco"], st_one["nco"], rtol=0, atol=0)


def test_tx_state_structure_matches_reference(tx_pair):
    _same_structure(state_to_numpy(tx_pair.t.init_state()),
                    jax.tree.map(np.asarray, tx_pair.j.init_state(tx_pair.C)))


def test_tx_state_round_trip(tx_pair, rng):
    """A JAX state carried into the port continues the JAX stream."""
    p = tx_pair
    w, m = jnp.asarray(p.words), jnp.asarray(p.modes)
    st_j, _ = p.step_j(p.j.init_state(p.C), jnp.asarray(_audio(rng, p.C, 512)), w, m)
    a = _audio(rng, p.C, 512)
    _, iq_j = p.step_j(st_j, jnp.asarray(a), w, m)
    st = state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    _, iq = p.t.step(st, _t(a), _t(p.words), _t(p.modes))
    np.testing.assert_allclose(iq.numpy(), np.asarray(iq_j), atol=5e-4)


def test_load_tx_params(tx_pair):
    p = tx_pair
    t = TxChain(p.t.cfg)
    with torch.no_grad():
        for buf in t.buffers():
            if buf.is_floating_point() or buf.is_complex():
                buf.mul_(0.5)
    load_tx_params(t, _tx_params(p.j))
    for a, b in zip(t.buffers(), p.t.buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="polyphase"):
        load_tx_params(t, dict(_tx_params(p.j), interp_w=[]))


def test_tx_block_length_and_unknown_mode():
    t = TxChain(tcfg.TxConfig(channels=2))
    with pytest.raises(ValueError, match="multiple of 512"):
        t.step(t.init_state(), torch.zeros((2, 500)), torch.zeros(2, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32))
    # a code outside the bank transmits nan + 0j, as the reference's stack fill
    _, iq = t.step(t.init_state(), torch.full((2, 512), 0.1), torch.zeros(2, dtype=torch.int32),
                   torch.tensor([0, 5], dtype=torch.int32))
    assert bool(torch.isfinite(iq[0].real).all()) and bool(torch.isnan(iq[1].real).all())


# --- full duplex --------------------------------------------------------------------------


def _duplex_cfgs(mod, C):
    rx = mod.RxConfig(fs_in=1_536_000.0, channels=C,
                      stages=(mod.CicStage(R=8, N=4),
                              mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                      ols_hop=512, fuse_frontend=True, fuse_frontend_depth=2,
                      enabled_modes=(0, 1, 2, 3))
    tx = mod.TxConfig(fs_out=1_536_000.0, channels=C, interp_stages=(4, mod.CicStage(R=8, N=4)))
    return rx, tx


def test_duplex_matches_jax(rng):
    """bench.py's duplex configuration at C=4: RX through K1's plain route
    (depth 2), TX FIR(4) + CIC(8, 4); two blocks."""
    C = 4
    j, t = JDuplex(*_duplex_cfgs(jcfg, C)), DuplexChain(*_duplex_cfgs(tcfg, C))
    load_tx_params(t.tx, _tx_params(j.tx))
    load_reference_params(t.rx, {"stage_taps": j.rx._stage_taps, "w1": j.rx.fused.w1,
                                 "w2": j.rx.fused.w2, "H": j.rx.mode_bank._H,
                                 "release": j.rx.agc_bank.release, "alpha": j.rx.agc_bank.alpha,
                                 "target": j.rx.agc_bank.target,
                                 "max_gain": j.rx.agc_bank.max_gain})
    T = 2 * t.rx.min_block
    freqs = np.array([1e5, -2.5e5, 4e4, 6.5e5])
    words = freq_word(freqs, 1_536_000.0)
    modes = np.arange(C, dtype=np.int32)
    step_j = jax.jit(j.step)
    st, st_j = t.init_state(), j.init_state(C)
    for blk in range(2):
        iq = _cx(rng, (C, T))
        iq[3] += 4.0 * np.exp(2j * np.pi * freqs[3] * (blk * T + np.arange(T)) / 1_536_000.0)
        audio = _audio(rng, C, T // 32)
        args = (words, modes, words, modes)
        st, a, tx_iq, aux = t.step(st, _t(iq), _t(audio), *map(_t, args))
        st_j, a_j, tx_j, aux_j = step_j(st_j, jnp.asarray(iq), jnp.asarray(audio),
                                        *map(jnp.asarray, args))
        assert tx_iq.shape == (C, T) and a.shape == (C, T // 32)
        np.testing.assert_allclose(tx_iq.numpy(), np.asarray(tx_j), atol=5e-4)
        if blk > 0:
            d = a.numpy() - np.asarray(a_j)
            d[3] -= 19.2 * np.round(d[3] / 19.2)
            np.testing.assert_allclose(d, 0.0, atol=2e-4)
        np.testing.assert_allclose(aux["power_in"].numpy(), np.asarray(aux_j["power_in"]),
                                   rtol=1e-5)
    st_t, st_jn = state_to_numpy(st), jax.tree.map(np.asarray, st_j)
    _same_structure(st_t, st_jn)
    _tx_state_close(st_t["tx"], st_jn["tx"])
    np.testing.assert_array_equal(st_t["rx"]["nco"], st_jn["rx"]["nco"])


def _loopback(mode_name, audio, off, neutral_agc=False):
    """tests/test_tx_chain.py's loopback on the port: transmit at ``off``
    with the RX input zero, then feed the TX IQ into a fresh duplex's RX
    tuned to ``off``; returns the demodulated audio."""
    agc = tcfg.AgcConfig(target=1e9, max_gain=1.0) if neutral_agc else tcfg.AgcConfig()
    dpx = DuplexChain(tcfg.RxConfig(channels=1, agc=agc),
                      tcfg.TxConfig(channels=1, compressor_max_gain=1.0))
    Ta = audio.shape[-1]
    w = _t(freq_word([off], 192_000.0).astype(np.int32))
    m = torch.tensor([demod_op.MODE_NAMES[mode_name]], dtype=torch.int32)
    a = _t(audio[None, :].astype(np.float32))
    _, _, tx_iq, _ = dpx.step(dpx.init_state(), torch.zeros((1, 4 * Ta), dtype=torch.complex64),
                              a, w, m, w, m)
    _, rx_audio, _, _ = dpx.step(dpx.init_state(), tx_iq, torch.zeros_like(a), w, m, w, m)
    return rx_audio.numpy()[0]


@pytest.mark.parametrize("mode", ["ssb", "am", "nfm"])
def test_loopback(mode):
    """TX -> RX on the CPU: SNR above the reference's bars."""
    n = 96 * 2048 // 4
    t = np.arange(n) / 48_000.0
    settle = 16 * 1024
    if mode == "ssb":
        audio = FX.voicelike_audio(48_000.0, n)
        out = _loopback("ssb", audio, 25_000.0, neutral_agc=True)
        # the reference: the audio through the TX and RX SSB bandpass
        bpf = FD.complex_bandpass_taps(513, 300.0, 2700.0, 48_000.0)
        ref, _ = G.ols_filter(audio.astype(np.complex128), bpf)
        ref, _ = G.ols_filter(ref, bpf)
        snr = audio_snr_db(4.0 * np.real(ref)[settle:], out[settle:], trim=1024)
        bar = 25.0
    else:
        tone, off = (600.0, -30_000.0) if mode == "am" else (1000.0, 40_000.0)
        audio = ((0.6 if mode == "am" else 0.5) * np.sin(2 * np.pi * tone * t)).astype(np.float32)
        out = _loopback(mode, audio, off)
        snr = audio_snr_db(audio[settle:], out[settle:], trim=1024)
        bar = 15.0
    assert snr > bar, f"{mode} loopback SNR {snr:.1f} dB"


def test_duplex_state_is_rx_and_tx():
    C = 2
    dpx = DuplexChain(*_duplex_cfgs(tcfg, C))
    st = dpx.init_state()
    assert set(st) == {"rx", "tx"}
    _same_structure(state_to_numpy(st),
                    jax.tree.map(np.asarray, JDuplex(*_duplex_cfgs(jcfg, C)).init_state(C)))
    assert dpx.tx.cfg.interp == dpx.rx.cfg.decim == 32
