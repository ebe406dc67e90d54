"""The port's receive slice (RxChain, Radio, convert) against the JAX
RxChain on the flagship stage plan at C=4, T=2*16384 per block.

Tolerances: audio to 2e-4 after block 0 (block 0 carries the cold-start AGC
transient, where max gain magnifies ulp differences); NFM rows compared
modulo fs/deviation = 19.2, the size of an atan2 branch flip at ±pi; AGC
envelope state compared without NFM rows, whose AGC output is discarded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.api.radio import Radio as JRadio
from radioframe.core import config as jcfg
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.api.radio import Radio as TRadio
from radioframe_torch.convert import load_reference_params, state_from_numpy, state_to_numpy
from radioframe_torch.core import config as tcfg
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain

torch.set_num_threads(2)

C = 4
FS = 1_536_000.0
MODES = np.array([0, 1, 2, 3], np.int32)  # SSB, CW, AM, NFM
NFM_ROWS = MODES == 3
FREQS = np.array([1e5, -2.5e5, 4e4, 6.5e5])


def _cfg(fused: bool, mod, **kw):
    """The flagship RxConfig from ``mod``, the reference's config module or
    the port's: each chain is built from its own package's types."""
    return mod.RxConfig(fs_in=FS, channels=C,
                        stages=(mod.CicStage(R=8, N=4),
                                mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                        ols_hop=512, fuse_frontend=fused, fuse_frontend_depth=2,
                        enabled_modes=(0, 1, 2, 3), **kw)


class _Pair:
    def __init__(self, fused: bool, **kw):
        cfg = _cfg(fused, jcfg, **kw)
        self.j = JChain(cfg)
        self.t = TChain(_cfg(fused, tcfg, **kw))
        self.T = 2 * self.j.min_block
        assert self.t.min_block == self.j.min_block == 16384
        self.j_step = jax.jit(self.j.step)
        self.j_step_i16 = jax.jit(self.j.step_i16) if cfg.int16_ingest else None
        self.words = freq_word(FREQS, FS)


@pytest.fixture(scope="module")
def fused():
    return _Pair(True)


@pytest.fixture(scope="module")
def dense():
    return _Pair(False)


def _iq(rng, T, rows=C):
    return (rng.standard_normal((rows, T)) + 1j * rng.standard_normal((rows, T))).astype(np.complex64)


def _audio_close(a_t, a_j, atol=2e-4):
    d = np.asarray(a_t) - np.asarray(a_j)
    d[NFM_ROWS] -= 19.2 * np.round(d[NFM_ROWS] / 19.2)
    np.testing.assert_allclose(d, 0.0, atol=atol)


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


def _states_close(st_t, st_j):
    t = state_to_numpy(st_t)
    j = jax.tree.map(np.asarray, st_j)
    _same_structure(t, j)
    np.testing.assert_array_equal(t["nco"], j["nco"])
    np.testing.assert_array_equal(t["demod"]["cw_phase"], j["demod"]["cw_phase"])
    for a, b in zip(t["decim"], j["decim"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(t["bpf"], j["bpf"], atol=1e-4)
    np.testing.assert_allclose(t["demod"]["am_dc"], j["demod"]["am_dc"], atol=1e-4)
    np.testing.assert_allclose(t["demod"]["nfm_last"], j["demod"]["nfm_last"], atol=1e-4)
    for k in ("env", "lpf"):
        np.testing.assert_allclose(t["agc"][k][~NFM_ROWS], j["agc"][k][~NFM_ROWS], rtol=1e-4)
    np.testing.assert_array_equal(t["spec"], j["spec"])


def _run_both(pair, rng, blocks, st_t=None, st_j=None):
    st_t = pair.t.init_state(C) if st_t is None else st_t
    st_j = pair.j.init_state(C) if st_j is None else st_j
    w, m = pair.words, MODES
    for blk in range(blocks):
        x = _iq(rng, pair.T)
        st_t, a_t, aux_t = pair.t.step(st_t, torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(m))
        st_j, a_j, aux_j = pair.j_step(st_j, jnp.asarray(x), jnp.asarray(w), jnp.asarray(m))
        assert a_t.shape == a_j.shape == (C, pair.T // 32)
        if blk > 0:
            _audio_close(a_t.numpy(), a_j)
        np.testing.assert_allclose(aux_t["power_in"].numpy(), np.asarray(aux_j["power_in"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(aux_t["agc_gain_last"].numpy()[~NFM_ROWS],
                                   np.asarray(aux_j["agc_gain_last"])[~NFM_ROWS], rtol=1e-3)
    return st_t, st_j


@pytest.mark.parametrize("which", ["fused", "dense"])
def test_slice_matches_jax(request, rng, which):
    pair = request.getfixturevalue(which)
    assert (pair.t.fused is not None) == (which == "fused") and pair.t.fused_stages == (
        2 if which == "fused" else 0)
    st_t, st_j = _run_both(pair, rng, 3)
    _states_close(st_t, st_j)


def test_state_handoff_from_jax(fused, rng):
    """Two blocks in JAX, the state carried over with state_from_numpy, then
    block 3 in both."""
    st_j = fused.j.init_state(C)
    for _ in range(2):
        x = _iq(rng, fused.T)
        st_j, _, _ = fused.j_step(st_j, jnp.asarray(x), jnp.asarray(fused.words),
                                  jnp.asarray(MODES))
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    _same_structure(state_to_numpy(st_t), jax.tree.map(np.asarray, st_j))
    x = _iq(rng, fused.T)
    st_t, a_t, _ = fused.t.step(st_t, torch.from_numpy(x), torch.from_numpy(fused.words),
                                torch.from_numpy(MODES))
    st_j, a_j, _ = fused.j_step(st_j, jnp.asarray(x), jnp.asarray(fused.words),
                                jnp.asarray(MODES))
    _audio_close(a_t.numpy(), a_j)
    _states_close(st_t, st_j)


def test_int16_ingest_matches_jax(rng):
    pair = _Pair(True, int16_ingest=True)
    st_t, st_j = pair.t.init_state(C), pair.j.init_state(C)
    w, m = pair.words, MODES
    for blk in range(3):
        q = np.clip(np.round(rng.standard_normal((2, C, pair.T)) * 8000.0), -32768, 32767)
        q = q.astype(np.int16)
        st_t, a_t, aux_t = pair.t.step_i16(st_t, torch.from_numpy(q[0]), torch.from_numpy(q[1]),
                                           torch.from_numpy(w), torch.from_numpy(m))
        st_j, a_j, aux_j = pair.j_step_i16(st_j, jnp.asarray(q[0]), jnp.asarray(q[1]),
                                           jnp.asarray(w), jnp.asarray(m))
        if blk > 0:
            _audio_close(a_t.numpy(), a_j)
        np.testing.assert_allclose(aux_t["power_in"].numpy(), np.asarray(aux_j["power_in"]),
                                   rtol=1e-5)
    np.testing.assert_array_equal(st_t["decim"][0].numpy(), np.asarray(st_j["decim"][0]))
    with pytest.raises(ValueError, match="int16"):
        pair.t.step(st_t, torch.zeros(C, pair.T, dtype=torch.complex64),
                    torch.from_numpy(w), torch.from_numpy(m))


@pytest.mark.parametrize("shared", [False, True], ids=["per_channel", "wideband"])
def test_radio_process_matches_jax(rng, shared):
    rj, rt = JRadio(_cfg(True, jcfg)), TRadio(_cfg(True, tcfg), device="cpu")
    names = ("ssb", "cw", "am", "nfm")
    for ch in range(C):
        for r in (rj, rt):
            r.tune(ch, FREQS[ch])
            r.set_mode(ch, names[ch])
    assert [rt.mode(ch) for ch in range(C)] == list(names)
    assert rt.frequency(3) == rj.frequency(3)
    T = 2 * 16384
    for blk in range(3):
        x = _iq(rng, T, rows=1)[0] if shared else _iq(rng, T)
        a_t, a_j = rt.process(x), rj.process(x)
        assert isinstance(a_t, np.ndarray) and a_t.shape == (C, T // 32)
        if blk > 0:
            _audio_close(a_t, a_j)
    mt, mj = rt.metrics(), rj.metrics()
    assert set(mt) == set(mj)
    np.testing.assert_allclose(mt["power_in"], mj["power_in"], rtol=1e-5)


@pytest.mark.parametrize("which", ["fused", "dense"])
def test_streaming_split_equals_one_block(request, rng, which):
    """Two blocks of T == one block of 2T in the port, state carried."""
    pair = request.getfixturevalue(which)
    x = _iq(rng, 2 * pair.T)
    w, m = torch.from_numpy(pair.words), torch.from_numpy(MODES)
    st_one, a_one, _ = pair.t.step(pair.t.init_state(C), torch.from_numpy(x), w, m)
    st = pair.t.init_state(C)
    outs = []
    for b in np.split(x, 2, axis=-1):
        st, a, _ = pair.t.step(st, torch.from_numpy(b), w, m)
        outs.append(a.numpy())
    got = np.concatenate(outs, axis=-1)
    # warm-up window: the AGC sits near max gain while the OLS fills
    _audio_close(got[:, 512:], a_one.numpy()[:, 512:], atol=2e-5)
    np.testing.assert_array_equal(st["nco"].numpy(), st_one["nco"].numpy())
    np.testing.assert_allclose(st["bpf"].numpy(), st_one["bpf"].numpy(), atol=1e-6)


def test_load_reference_params(fused, rng):
    """The JAX chain's parameter arrays, loaded into a port chain whose
    buffers were scrambled, give back the buffers and the outputs."""
    j = fused.j
    params = {"stage_taps": j._stage_taps, "w1": j.fused.w1, "w2": j.fused.w2,
              "H": j.mode_bank._H, "release": j.agc_bank.release, "alpha": j.agc_bank.alpha,
              "target": j.agc_bank.target, "max_gain": j.agc_bank.max_gain}
    t = TChain(_cfg(True, tcfg))
    with torch.no_grad():
        for buf in t.buffers():
            if buf.is_floating_point() or buf.is_complex():
                buf.mul_(0.5)
    load_reference_params(t, params)
    np.testing.assert_array_equal(t.fused.w1.numpy(), j.fused.w1)
    np.testing.assert_array_equal(t.mode_bank._H.numpy(), j.mode_bank._H)
    np.testing.assert_array_equal(t.agc_bank.release.numpy(), j.agc_bank.release)
    x = torch.from_numpy(_iq(rng, fused.T))
    w, m = torch.from_numpy(fused.words), torch.from_numpy(MODES)
    _, a_load, _ = t.step(t.init_state(C), x, w, m)
    _, a_ref, _ = fused.t.step(fused.t.init_state(C), x, w, m)
    torch.testing.assert_close(a_load, a_ref, rtol=0, atol=0)
    bad = dict(params, stage_taps=params["stage_taps"][:1])
    with pytest.raises(ValueError, match="stage taps"):
        load_reference_params(t, bad)
