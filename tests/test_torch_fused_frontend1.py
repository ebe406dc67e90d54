"""radioframe_torch K2 (fused NCO + one polyphase decimation) and its K8 cost
variants against the JAX package: radioframe.kernels.fused_frontend run in
Pallas interpret mode, the probe kernels of tools/probe_fused.py, and the
depth-1 RxChain.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Tolerances: front-end outputs 5e-4 (the reference's on-chip
front-end bound), accumulators and raw tails bit-equal; chain audio 2e-4
after block 0, NFM rows modulo fs/deviation = 19.2."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from radioframe.api.radio import Radio as JRadio
from radioframe.core import config as jcfg
from radioframe.kernels.fused_frontend import FusedFrontend as JFused
from radioframe.ops import filter_design as FD
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.api.radio import Radio as TRadio
from radioframe_torch.convert import load_reference_params
from radioframe_torch.core import config as tcfg
from radioframe_torch.kernels.fused_frontend import VARIANTS, FusedFrontend, plain_fused_frontend
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 5e-4
CHAIN_TOL = 2e-4
FS = 1_536_000.0
MODES = np.array([0, 1, 2, 3], np.int32)  # SSB, CW, AM, NFM


def _iq(rng, C, T):
    return (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)


def _taps(R, L):
    return FD.cic_equivalent_taps(R, 4, 1) if L == 29 else FD.lowpass_taps(L, 0.4 / R, 1.0)


def _words(C):
    w = freq_word(np.linspace(-0.3, 0.3, C) * 48e3, 192e3)
    w[0] = 2 ** 31 - 7  # acc + word*T wraps every block
    return w


# --- the kernel's plain version against the reference kernel ------------------------------


@pytest.mark.parametrize("R,L,C,T", [
    (8, 29, 4, 2048),     # CIC(8,4)-equivalent taps
    (4, 97, 3, 1024),     # long FIR, a channel count the reference pads to 128
    (2, 7, 128, 512),     # short taps, full lane width
])
def test_plain_matches_jax_kernel_streamed(rng, R, L, C, T):
    taps = _taps(R, L)
    jf, tf = JFused(taps, R, interpret=True), FusedFrontend(taps, R)
    assert (tf.J0, tf.H) == (jf.J0, jf.H)
    np.testing.assert_array_equal(tf.w1.numpy(), jf.w2)
    words = _words(C)
    st_t, st_j = tf.init_state(C), jf.init_state(C)
    step = jax.jit(jf.step)
    for _ in range(3):
        x = _iq(rng, C, T)
        st_t, y_t = tf.step(st_t, torch.from_numpy(x), torch.from_numpy(words))
        st_j, y_j = step(st_j, jnp.asarray(x), jnp.asarray(words))
        assert y_t.shape == (C, T // R) and y_t.dtype == torch.complex64
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
        np.testing.assert_array_equal(st_t["acc"].numpy(), np.asarray(st_j["acc"]))
        np.testing.assert_array_equal(st_t["tail"].numpy(), np.asarray(st_j["tail"]))
    assert tf.launches == 0  # CPU tensors take the plain version


def test_wideband_input_matches_jax(rng):
    """A shared (1, T) input fans out across per-channel NCO words, in the
    complex and in the plane form."""
    taps = FD.cic_equivalent_taps(4, 4, 1)
    jf, tf = JFused(taps, 4, interpret=True), FusedFrontend(taps, 4)
    C = 5
    words = freq_word(np.linspace(1e3, 9e3, C), 192e3)
    x = _iq(rng, 1, 1024)
    st_j, y_j = jax.jit(jf.step)(jf.init_state(C), jnp.asarray(x), jnp.asarray(words))
    st_t, y_t = tf.step(tf.init_state(C), torch.from_numpy(x), torch.from_numpy(words))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    np.testing.assert_array_equal(st_t["tail"].numpy(), np.asarray(st_j["tail"]))
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    st_p, y_p = tf.step_planes(tf.init_state(C), xr, xi, torch.from_numpy(words))
    torch.testing.assert_close(y_p, y_t, rtol=0, atol=0)
    torch.testing.assert_close(st_p["acc"], st_t["acc"], rtol=0, atol=0)


def test_boundary_correction_matches_jax(rng):
    R, C = 8, 4
    taps = FD.cic_equivalent_taps(R, 4, 1)
    jf, tf = JFused(taps, R, interpret=True), FusedFrontend(taps, R)
    words = _words(C)
    acc = rng.integers(-2 ** 31, 2 ** 31, C, dtype=np.int32)
    tail = _iq(rng, C, tf.H)
    got = tf.boundary_correction(torch.from_numpy(acc), torch.from_numpy(words),
                                 torch.from_numpy(tail))
    want = jf.boundary_correction(jnp.asarray(acc), jnp.asarray(words), jnp.asarray(tail))
    assert got.shape == (C, tf.J0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("R,L", [(8, 29), (4, 97)])
def test_boundary_correction_linearity(rng, R, L):
    """y(tail | block) == y(0 | block) + boundary_correction(tail), and the
    outputs past J0 do not depend on the tail."""
    tf = FusedFrontend(_taps(R, L), R)
    C, T = 4, 64 * R
    words = torch.from_numpy(_words(C))
    x = torch.from_numpy(_iq(rng, C, T))
    acc = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, C, dtype=np.int32))
    tail = torch.from_numpy(_iq(rng, C, tf.H))
    _, y_full = tf.step({"acc": acc, "tail": tail}, x, words)
    _, y_zero = tf.step({"acc": acc, "tail": torch.zeros_like(tail)}, x, words)
    got = y_zero.clone()
    got[:, : tf.J0] += tf.boundary_correction(acc, words, tail)
    torch.testing.assert_close(got, y_full, rtol=0, atol=3e-5)
    torch.testing.assert_close(y_zero[:, tf.J0:], y_full[:, tf.J0:], rtol=0, atol=0)


def test_rejects_bad_blocks():
    tf = FusedFrontend(FD.cic_equivalent_taps(8, 4, 1), 8)
    C = 4
    st = tf.init_state(C)
    w = torch.zeros(C, dtype=torch.int32)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype)  # noqa: E731
    with pytest.raises(ValueError, match="multiple of 8"):
        tf.step_planes(st, z(C, 1028), z(C, 1028), w)
    with pytest.raises(ValueError, match="at least 32"):
        tf.step_planes(st, z(C, 16), z(C, 16), w)
    with pytest.raises(ValueError, match="float32"):
        tf.step_planes(st, z(C, 1024, dtype=torch.int16), z(C, 1024, dtype=torch.int16), w)
    with pytest.raises(ValueError, match="do not fit"):
        tf.step_planes(st, z(3, 1024), z(3, 1024), w)
    with pytest.raises(ValueError, match="variant"):
        tf.step_planes(st, z(C, 1024), z(C, 1024), w, variant="fast")
    with pytest.raises(ValueError, match="whole tiles"):
        tf.step_planes(st, z(C, 1032), z(C, 1032), w, variant="no_tr")
    with pytest.raises(ValueError, match="real taps"):
        FusedFrontend(np.ones(5) * 1j, 2)


# --- K8: the probe's cost variants --------------------------------------------------------


@pytest.fixture(scope="module")
def probe():
    """tools/probe_fused.py, imported with JAX's compilation-cache settings
    restored (the probe points the cache at a directory of its own)."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    spec = importlib.util.spec_from_file_location("probe_fused", ROOT / "tools" / "probe_fused.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return mod


def _probe_call(probe, variant, xr, xi, tails, word, acc, w2, grid):
    """The probe's pallas_call of ``_mk_kernel(variant)``, in interpret mode
    on ``grid`` tiles; returns y (C, grid*TM) complex."""
    TM, Cp, W, H = probe.TM, probe.Cp, probe.W, tails.shape[2]
    out = pl.pallas_call(
        probe._mk_kernel(variant),
        grid=(grid,),
        in_specs=[pl.BlockSpec((Cp, W), lambda i: (0, i)),
                  pl.BlockSpec((Cp, W), lambda i: (0, i)),
                  pl.BlockSpec((1, 2, H, Cp), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, Cp), lambda i: (0, 0)),
                  pl.BlockSpec((1, Cp), lambda i: (0, 0)),
                  pl.BlockSpec((probe.J0 + 1, probe.R, 1), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 2, TM, Cp), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, 2, TM, Cp), jnp.float32),
        interpret=True,
    )(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(tails), jnp.asarray(word)[None],
      jnp.asarray(acc)[None], jnp.asarray(w2)[:, :, None])
    y = np.asarray(out).transpose(1, 0, 2, 3).reshape(2, grid * TM, Cp)
    return (y[0] + 1j * y[1]).T


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_plain_matches_probe(probe, rng, variant):
    """Each variant's plain version computes what the probe's kernel computes
    at K8's shapes (R=8, J0=4, C=128) on two tiles, the no_tr read included."""
    R, C, grid = probe.R, probe.Cp, 2
    T = grid * probe.W
    tf = FusedFrontend(FD.cic_equivalent_taps(R, 4, 1), R)
    assert (tf.J0, tf.w1.shape) == (probe.J0, (probe.J0 + 1, R))
    xr, xi = rng.standard_normal((2, C, T)).astype(np.float32)
    tail = _iq(rng, C, tf.H)
    word = rng.integers(-2 ** 30, 2 ** 30, C, dtype=np.int32)
    acc = rng.integers(-2 ** 31, 2 ** 31, C, dtype=np.int32)
    # the probe's per-tile raw history, time-major: the tail, then the H
    # samples before tile 1
    x = xr + 1j * xi
    hist = np.stack([tail, x[:, probe.W - tf.H: probe.W]])  # (grid, C, H)
    tails = np.stack([hist.real, hist.imag], axis=1).transpose(0, 1, 3, 2).astype(np.float32)
    want = _probe_call(probe, variant, xr, xi, tails, word, acc, tf.w1.numpy(), grid)
    got, _ = plain_fused_frontend(tf, torch.from_numpy(xr), torch.from_numpy(xi),
                                  torch.from_numpy(tail), torch.from_numpy(acc),
                                  torch.from_numpy(word), variant)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * scale)


def test_full_variant_is_the_step(rng):
    tf = FusedFrontend(FD.cic_equivalent_taps(8, 4, 1), 8)
    C, T = 4, 2048
    xr, xi = (torch.from_numpy(a) for a in rng.standard_normal((2, C, T)).astype(np.float32))
    words = torch.from_numpy(_words(C))
    st = tf.init_state(C)
    _, y = tf.step_planes(st, xr, xi, words)
    _, y_full = tf.step_planes(st, xr, xi, words, variant="full")
    torch.testing.assert_close(y_full, y, rtol=0, atol=0)
    y_plain, p_plain = plain_fused_frontend(tf, xr, xi, st["tail"], st["acc"], words)
    torch.testing.assert_close(y_plain, y, rtol=0, atol=0)
    _, _, power = tf.step_planes(st, xr, xi, words, return_power=True)
    torch.testing.assert_close(power, p_plain, rtol=0, atol=0)
    assert tf.launches == 0 and not any(tf.variant_launches.values())


# --- the depth-1 chain ----------------------------------------------------------------------


def _cfg(mod, stages, fs_in, depth=1):
    return mod.RxConfig(fs_in=fs_in, channels=4, stages=stages, ols_hop=512,
                        fuse_frontend=True, fuse_frontend_depth=depth, enabled_modes=(0, 1, 2, 3))


def _plans(mod):
    """(stages, fs_in): the flagship plan at depth 1, and the FIR(R=3) plan
    whose non-power-of-two second stage falls back to depth 1 at depth 2."""
    return {"depth1": ((mod.CicStage(R=8, N=4),
                        mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)), FS),
            "fir_r3": ((mod.CicStage(R=8, N=4),
                        mod.FirStage(R=3, numtaps=97, passband_hz=15_000.0)), 1_152_000.0)}


def _audio_close(a_t, a_j, atol=CHAIN_TOL):
    d = np.asarray(a_t) - np.asarray(a_j)
    d[MODES == 3] -= 19.2 * np.round(d[MODES == 3] / 19.2)
    np.testing.assert_allclose(d, 0.0, atol=atol)


@pytest.mark.parametrize("plan", ["depth1", "fir_r3"])
def test_depth1_chain_matches_jax(rng, plan):
    stages_j, fs = _plans(jcfg)[plan]
    stages_t, _ = _plans(tcfg)[plan]
    depth = 1 if plan == "depth1" else 2
    j, t = JChain(_cfg(jcfg, stages_j, fs, depth)), TChain(_cfg(tcfg, stages_t, fs, depth))
    assert j.fused_stages == t.fused_stages == 1
    assert isinstance(t.fused, FusedFrontend) and t.min_block == j.min_block
    T = 2 * j.min_block
    words = freq_word(np.array([1e5, -2.5e5, 4e4, 6.5e5]) * fs / FS, fs)
    st_t, st_j = t.init_state(), j.init_state()
    j_step = jax.jit(j.step)
    for blk in range(3):
        x = _iq(rng, 4, T)
        st_t, a_t, aux_t = t.step(st_t, torch.from_numpy(x), torch.from_numpy(words),
                                  torch.from_numpy(MODES))
        st_j, a_j, aux_j = j_step(st_j, jnp.asarray(x), jnp.asarray(words), jnp.asarray(MODES))
        assert a_t.shape == a_j.shape
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            _audio_close(a_t.numpy(), a_j)
        np.testing.assert_allclose(aux_t["power_in"].numpy(), np.asarray(aux_j["power_in"]),
                                   rtol=1e-5)
    np.testing.assert_array_equal(st_t["nco"].numpy(), np.asarray(st_j["nco"]))
    assert len(st_t["decim"]) == len(st_j["decim"])
    for a, b in zip(st_t["decim"], st_j["decim"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert t.fused.launches == 0


def test_radio_wideband_block_depth1(rng):
    """Radio.process with a 1-D block reaches K2 as one shared row."""
    stages_j, _ = _plans(jcfg)["depth1"]
    stages_t, _ = _plans(tcfg)["depth1"]
    rj, rt = JRadio(_cfg(jcfg, stages_j, FS)), TRadio(_cfg(tcfg, stages_t, FS), device="cpu")
    names = ("ssb", "cw", "am", "nfm")
    for ch, f in enumerate((1e5, -2.5e5, 4e4, 6.5e5)):
        for r in (rj, rt):
            r.tune(ch, f)
            r.set_mode(ch, names[ch])
    for blk in range(3):
        x = _iq(rng, 1, 32768)[0]
        a_t, a_j = rt.process(x), rj.process(x)
        assert a_t.shape == (4, 1024)
        if blk > 0:
            _audio_close(a_t, a_j)
    assert tuple(rt.state["decim"][0].shape) == (4, rt.chain.fused.H)


def test_load_reference_params_depth1(rng):
    """The JAX depth-1 chain's single polyphase table (its ``w2``, stage 1's)
    lands in K2's ``w1``; a scrambled chain gives back the outputs."""
    stages_j, _ = _plans(jcfg)["depth1"]
    stages_t, _ = _plans(tcfg)["depth1"]
    j = JChain(_cfg(jcfg, stages_j, FS))
    params = {"stage_taps": j._stage_taps, "w2": j.fused.w2, "H": j.mode_bank._H,
              "release": j.agc_bank.release, "alpha": j.agc_bank.alpha,
              "target": j.agc_bank.target, "max_gain": j.agc_bank.max_gain}
    ref, t = TChain(_cfg(tcfg, stages_t, FS)), TChain(_cfg(tcfg, stages_t, FS))
    with torch.no_grad():
        for buf in t.buffers():
            if buf.is_floating_point() or buf.is_complex():
                buf.mul_(0.5)
    load_reference_params(t, params)
    np.testing.assert_array_equal(t.fused.w1.numpy(), j.fused.w2)
    x = torch.from_numpy(_iq(rng, 4, 16384))
    w = torch.from_numpy(freq_word(np.array([1e5, -2.5e5, 4e4, 6.5e5]), FS))
    m = torch.from_numpy(MODES)
    _, a_load, _ = t.step(t.init_state(), x, w, m)
    _, a_ref, _ = ref.step(ref.init_state(), x, w, m)
    torch.testing.assert_close(a_load, a_ref, rtol=0, atol=0)
