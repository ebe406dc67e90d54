"""radioframe_torch K6 (fused overlap-save mode filter + demod bank + AGC)
against the JAX package: radioframe.kernels.ols_demod.FusedOlsDemod run in
Pallas interpret mode, and the fuse_backend RxChain against the JAX fused
and dense chains, with the bounds of tests/test_rx_chain.py
TestFusedBackend.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Tolerances: audio 3e-4 after block 0 (block 0 carries the
cold-start AGC transient), NFM rows modulo fs/deviation = 19.2 (an atan2
branch flip); AGC envelope without NFM rows (their AGC output is discarded);
carry rows 2e-4 of each row's scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import config as jcfg
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.convert import state_to_numpy
from radioframe_torch.core import config as tcfg
from radioframe_torch.core import presets as tpresets
from radioframe_torch.diag import timing
from radioframe_torch.kernels.ols_demod import FusedOlsDemod
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain

torch.set_num_threads(2)

FS = 1_536_000.0
FS_AUDIO = 48_000.0
NFM = 3
PERIOD = FS_AUDIO / 2500.0  # fs / nfm deviation = 19.2
ATOL = 3e-4


def _cfg(mod, C, attack, **kw):
    """TestFusedBackend's configuration from ``mod`` (either package's config
    module), fused back end unless ``fuse_backend=False`` is given."""
    agc_modes = (mod.AgcConfig(release_s=0.5, attack_s=0.002 if attack else 0.0),) * 6
    base = dict(fs_in=FS, channels=C,
                stages=(mod.CicStage(R=8, N=4),
                        mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                ols_hop=512, enabled_modes=(0, 1, 2, 3), agc_modes=agc_modes,
                fuse_backend=True)
    base.update(kw)
    return mod.RxConfig(**base)


def _modes(C):
    return (np.arange(C) % 4).astype(np.int32)


def _wrap(d, modes):
    d = np.array(d, copy=True)
    rows = modes == NFM
    d[rows] -= PERIOD * np.round(d[rows] / PERIOD)
    return d


def _iq_fixture(rng, C, T, fs):
    """Per-channel tones, an FM carrier on NFM rows, and a light noise floor,
    so that every demod sees a well-conditioned signal (TestFusedBackend's)."""
    t = np.arange(T) / fs
    iq = np.zeros((C, T), np.complex64)
    for c in range(C):
        if c % 4 == NFM:
            iq[c] = np.exp(1j * 2 * np.pi * np.cumsum(2000.0 * np.sin(2 * np.pi * 1000.0 * t)) / fs)
        else:
            iq[c] = np.exp(2j * np.pi * (1000.0 + 37.0 * c) * t)
    iq += 0.05 * (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
    return iq.astype(np.complex64)


# --- the kernel's plain version against the reference kernel ------------------------------


@pytest.mark.parametrize("attack", [False, True])
def test_plain_matches_jax_kernel(rng, attack):
    C, Ta = 8, 1024
    j = JChain(_cfg(jcfg, C, attack))
    jk = j.backend_kernel
    tk = FusedOlsDemod(jk.nfft, jk.hop, C, FS_AUDIO, 2500.0, enabled=(0, 1, 2, 3),
                       attack_alphas=tuple(j.agc_bank.alpha.tolist()))
    assert tk.attack_alphas == jk.attack_alphas and bool(tk.attack_alphas) == attack
    modes = _modes(C)
    h_sel = np.asarray(j.mode_bank._H)[modes]
    rel, al, tgt, mg = (np.asarray(a) for a in j.agc_bank.per_channel(jnp.asarray(modes)))
    cw_word = np.full(C, j.cw_tone_word, np.int32)
    L1 = jk.nfft - jk.hop
    tail_j = jnp.zeros((C, L1), jnp.complex64)
    tail_t = torch.zeros((C, L1), dtype=torch.complex64)
    st0 = np.zeros((7, C), np.float32)
    st0[2] = 1.0  # nfm_last starts at 1 + 0j, as demod.bank_init
    st_j, st_t = jnp.asarray(st0), torch.from_numpy(st0)
    cw_acc = np.zeros(C, np.int32)
    call_j = jax.jit(jk.__call__)
    for blk in range(3):
        x = _iq_fixture(rng, C, Ta, FS_AUDIO)
        args = (x, h_sel, modes, cw_word, cw_acc, rel, al, tgt, mg)
        a_j, st_j, tail_j = call_j(tail_j, *map(jnp.asarray, args), st_j)
        a_t, st_t, tail_t = tk(tail_t, *(torch.from_numpy(np.array(a)) for a in args), st_t)
        assert a_t.shape == (C, Ta) and st_t.shape == (7, C)
        if blk > 0:
            np.testing.assert_allclose(_wrap(a_t.numpy() - np.asarray(a_j), modes), 0.0,
                                       atol=ATOL)
        s_t, s_j = st_t.numpy(), np.asarray(st_j)
        scale = np.maximum(np.abs(s_j).max(axis=1, keepdims=True), 1.0)
        keep = np.ones((7, C), bool)
        keep[4:6, modes == NFM] = False  # the envelope of an NFM row latches branch flips
        np.testing.assert_allclose(np.where(keep, (s_t - s_j) / scale, 0.0), 0.0, atol=2e-4)
        np.testing.assert_array_equal(s_t[6], s_j[6])  # power row passed through
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
        cw_acc = ((cw_acc.astype(np.int64) + cw_word.astype(np.int64) * Ta + 2 ** 31) % 2 ** 32
                  - 2 ** 31).astype(np.int32)
    assert tk.launches == 0


def test_streaming_split_equals_one_block(rng):
    """Two blocks of Ta == one block of 2 Ta, the 7-row carry and the OLS
    tail handed over."""
    C, Ta = 4, 1024
    tk = FusedOlsDemod(1024, 512, C, FS_AUDIO, 2500.0, enabled=(0, 1, 2, 3))
    t = TChain(_cfg(tcfg, C, True))
    modes = torch.from_numpy(_modes(C))
    h_sel = t.mode_bank._H[modes.long()]
    rel, al, tgt, mg = t.agc_bank.per_channel(modes)
    cw_word = torch.full((C,), t.cw_tone_word, dtype=torch.int32)
    x = torch.from_numpy(_iq_fixture(rng, C, 2 * Ta, FS_AUDIO))
    st0 = torch.zeros((7, C))
    st0[2] = 1.0
    tail0 = torch.zeros((C, 512), dtype=torch.complex64)
    a_one, st_one, tail_one = tk(tail0, x, h_sel, modes, cw_word, torch.zeros(C, dtype=torch.int32),
                                 rel, al, tgt, mg, st0)
    a1, st1, tail1 = tk(tail0, x[:, :Ta], h_sel, modes, cw_word,
                        torch.zeros(C, dtype=torch.int32), rel, al, tgt, mg, st0)
    acc = (cw_word.to(torch.int64) * Ta).to(torch.int32)
    a2, st2, tail2 = tk(tail1, x[:, Ta:], h_sel, modes, cw_word, acc, rel, al, tgt, mg, st1)
    got = torch.cat([a1, a2], dim=-1).numpy()
    np.testing.assert_allclose(_wrap(got - a_one.numpy(), _modes(C)), 0.0, atol=2e-5)
    torch.testing.assert_close(tail2, tail_one, rtol=0, atol=0)
    np.testing.assert_allclose(st2.numpy()[:4], st_one.numpy()[:4], atol=1e-5)


def test_kernel_rejects_bad_shapes():
    with pytest.raises(ValueError, match="power of two"):
        FusedOlsDemod(1000, 500, 4, FS_AUDIO, 2500.0)
    with pytest.raises(ValueError, match="hop"):
        FusedOlsDemod(1024, 1024, 4, FS_AUDIO, 2500.0)
    with pytest.raises(ValueError, match="dft_precision"):
        FusedOlsDemod(1024, 512, 4, FS_AUDIO, 2500.0, dft_precision="bf16")
    with pytest.raises(AssertionError, match="SAM"):
        FusedOlsDemod(1024, 512, 4, FS_AUDIO, 2500.0, enabled=(0, 5))
    k = FusedOlsDemod(1024, 512, 4, FS_AUDIO, 2500.0)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 512"):
        k(torch.zeros((4, 512), dtype=torch.complex64), torch.zeros((4, 700), dtype=torch.complex64),
          torch.zeros((4, 1024), dtype=torch.complex64), z, z, z, *([torch.zeros(4)] * 4),
          torch.zeros((7, 4)))


# --- the fuse_backend chain ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["instant", "attack"])
def chains(request):
    """(port fused chain, JAX fused chain, JAX dense chain, C)."""
    C, attack = 8, request.param
    t = TChain(_cfg(tcfg, C, attack))
    jf = JChain(_cfg(jcfg, C, attack))
    jd = JChain(_cfg(jcfg, C, attack, fuse_backend=False))
    assert t.backend_kernel is not None and jf.backend_kernel is not None
    return t, jf, jd, C


def _run(chain_t, chain_j, C, rng, blocks=3):
    """Step both chains on the same fixture; returns (audio pairs after block
    0, final port state, final JAX state)."""
    T = chain_j.min_block
    words = freq_word(np.zeros(C), FS)
    modes = _modes(C)
    st_t, st_j = chain_t.init_state(C), chain_j.init_state(C)
    step_j = jax.jit(chain_j.step)
    outs = []
    for i, b in enumerate(np.split(_iq_fixture(rng, C, blocks * T, FS), blocks, axis=-1)):
        st_t, a_t, aux_t = chain_t.step(st_t, torch.from_numpy(np.ascontiguousarray(b)),
                                        torch.from_numpy(words), torch.from_numpy(modes))
        st_j, a_j, aux_j = step_j(st_j, jnp.asarray(b), jnp.asarray(words), jnp.asarray(modes))
        np.testing.assert_allclose(aux_t["power_in"].numpy(), np.asarray(aux_j["power_in"]),
                                   rtol=1e-5)
        if i > 0:  # filter/AGC warm-up: near-zero signals x max_gain amplify fp noise
            outs.append((a_t.numpy(), np.asarray(a_j)))
    return outs, st_t, jax.tree.map(np.asarray, st_j)


@pytest.mark.parametrize("ref", ["fused", "dense"])
def test_fused_chain_matches_jax(chains, rng, ref):
    t, jf, jd, C = chains
    outs, st_t, st_j = _run(t, jf if ref == "fused" else jd, C, rng)
    modes = _modes(C)
    for a_t, a_j in outs:
        np.testing.assert_allclose(_wrap(a_t - a_j, modes), 0.0, atol=ATOL)
    st_t = state_to_numpy(st_t)
    keep = modes != NFM
    np.testing.assert_allclose(st_t["agc"]["env"][keep], st_j["agc"]["env"][keep],
                               atol=3e-4, rtol=1e-5)
    np.testing.assert_array_equal(st_t["demod"]["cw_phase"], st_j["demod"]["cw_phase"])
    np.testing.assert_allclose(st_t["bpf"], st_j["bpf"], atol=1e-5)
    assert t.backend_kernel.launches == 0


def test_fused_chain_state_structure(chains):
    t, jf, _, C = chains

    def shape_tree(tree):
        if isinstance(tree, dict):
            return {k: shape_tree(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(shape_tree(v) for v in tree)
        return (tuple(np.shape(tree)), np.asarray(tree).dtype)

    assert shape_tree(state_to_numpy(t.init_state(C))) == shape_tree(
        jax.tree.map(np.asarray, jf.init_state(C)))


def test_fused_chain_accepts_five_channels(rng):
    """C = 5 is not a multiple of 128: the port has no lane gate."""
    t, j = TChain(_cfg(tcfg, 5, False)), JChain(_cfg(jcfg, 5, False))
    outs, _, _ = _run(t, j, 5, rng, blocks=2)
    for a_t, a_j in outs:
        assert a_t.shape == (5, 512)
        np.testing.assert_allclose(_wrap(a_t - a_j, _modes(5)), 0.0, atol=ATOL)


def test_fused_backend_with_depth1_front_end(rng):
    """The slice configuration: K2 and K6 in one step, against JAX."""
    kw = dict(fuse_frontend=True, fuse_frontend_depth=1)
    t, j = TChain(_cfg(tcfg, 4, False, **kw)), JChain(_cfg(jcfg, 4, False, **kw))
    assert t.fused_stages == 1 and t.backend_kernel is not None
    outs, _, _ = _run(t, j, 4, rng, blocks=2)
    for a_t, a_j in outs:
        np.testing.assert_allclose(_wrap(a_t - a_j, _modes(4)), 0.0, atol=ATOL)


def test_b3_precision_is_fp32(rng):
    """dft_precision="b3" computes what "highest" computes in the port."""
    C = 4
    x = _iq_fixture(rng, C, 16384, FS)
    words, modes = torch.zeros(C, dtype=torch.int32), torch.from_numpy(_modes(C))
    outs = []
    for prec in ("highest", "b3"):
        t = TChain(_cfg(tcfg, C, False, backend_dft_precision=prec))
        assert t.backend_kernel.dft_precision == prec
        outs.append(t.step(t.init_state(), torch.from_numpy(x), words, modes)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (dict(enabled_modes=None), "enabled_modes"),           # SAM implicitly present
    (dict(enabled_modes=(0, 1, 5)), "enabled_modes"),
    (dict(agc_modes=None, agc=jcfg.AgcConfig(hang_s=0.1)), "hang"),
    (dict(agc_modes=None, agc=jcfg.AgcConfig(release_s=0.001)), "release"),
])
def test_guards_refuse_what_the_reference_refuses(change, match):
    with pytest.raises(AssertionError, match=match):
        JChain(dataclasses.replace(_cfg(jcfg, 4, False), **change))
    tchange = {k: (tcfg.AgcConfig(**dataclasses.asdict(v)) if k == "agc" else v)
               for k, v in change.items()}
    with pytest.raises(ValueError, match=match):
        TChain(dataclasses.replace(_cfg(tcfg, 4, False), **tchange))



# --- the back end RxChain chooses -----------------------------------------------------------


def _flagship(C, **kw):
    """The flagship receiver (presets.wideband_1536k with K1 and modes 0-3) at C rows."""
    base = dict(fuse_frontend=True, fuse_frontend_depth=2, ols_hop=512,
                enabled_modes=(0, 1, 2, 3))
    return tpresets.wideband_1536k(C, **{**base, **kw})


@pytest.mark.parametrize("change,reason", [
    ({}, None),
    (dict(enabled_modes=None), "enabled_modes"),  # SAM among the modes
    (dict(agc=tcfg.AgcConfig(hang_s=0.01)), "hang"),
    (dict(agc=tcfg.AgcConfig(release_s=0.001)), "release"),
    (dict(nb_enabled=True), "nb"),
    (dict(nr_enabled=True), "nr"),
    (dict(notch_enabled=True), "notch"),
    (dict(vad_enabled=True), "vad"),
    (dict(squelch_enabled=True), "squelch"),
    (dict(nfm_deemphasis_s=531e-6), "deemph"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_back_path_choice(rng, change, reason):
    """The flagship's configuration runs K6 on a CUDA device and the composed
    ops on the CPU; each condition that K6 refuses gives the composed ops on
    either device, and ``back_path`` names it. ``step_back`` notes the path
    for the trace, and on the CPU it is the composed back end bit for bit."""
    C = 8
    chain = TChain(_flagship(C, **change))
    if reason is None:
        assert chain.backend_kernel is not None
        assert chain._back_path("cuda", C) == "k6"
        assert chain._back_path("cuda", C + 1) == "composed:shape"
        assert chain.back_path == "composed:device"
        assert TChain(_flagship(C, fuse_backend=True)).back_path == "k6"
    else:
        assert chain.backend_kernel is None
        assert chain._back_path("cuda", C) == chain.back_path == f"composed:{reason}"
    fst, bst = chain.split_state(chain.init_state())
    iq = torch.from_numpy(_iq_fixture(rng, C, chain.min_block, FS))
    words = torch.from_numpy(freq_word(np.zeros(C), FS))
    modes = torch.from_numpy(_modes(C))
    _, x, pw = chain.step_front(fst, iq, words)
    with timing.noting() as notes:
        _, audio, aux = chain.step_back(bst, x, modes, pw)
    assert notes == {"back_path": chain.back_path}
    _, audio_c, aux_c = chain._step_back_composed(bst, x, modes, pw)
    torch.testing.assert_close(audio, audio_c, rtol=0, atol=0)
    torch.testing.assert_close(aux["agc_gain_last"], aux_c["agc_gain_last"], rtol=0, atol=0)


def test_chain_form_matches_composed_back_end(rng):
    """K6 in the chain's form (its plain version on the CPU: the gathers, the
    carry, the CW phase and the last gain around ``plain_ols_demod``)
    against the composed ``step_back`` of the same chain, at the flagship's
    shape cut to C = 8, over 6 blocks from a cold start: audio within 2e-4
    from block 1 (block 0 carries the AGC's cold start; NFM rows modulo
    fs/deviation), the carry (the AGC env without the NFM rows, whose
    envelope latches branch flips), the CW phase and the last gain."""
    C, blocks = 8, 6
    chain = TChain(_flagship(C, fuse_backend=True))
    T = 2 * chain.min_block
    modes_np = _modes(C)
    words = torch.from_numpy(freq_word(np.zeros(C), FS))
    modes = torch.from_numpy(modes_np)
    keep = torch.from_numpy(modes_np != NFM)
    fst, st_k = chain.split_state(chain.init_state())
    st_c = dict(st_k)
    for blk, b in enumerate(np.split(_iq_fixture(rng, C, blocks * T, FS), blocks, axis=-1)):
        fst, x, pw = chain.step_front(fst, torch.from_numpy(np.ascontiguousarray(b)), words)
        st_k, a_k, aux_k = chain.step_back(st_k, x, modes, pw)
        st_c, a_c, aux_c = chain._step_back_composed(st_c, x, modes, pw)
        assert a_k.shape == a_c.shape == (C, T // 32)
        if blk > 0:
            np.testing.assert_allclose(_wrap((a_k - a_c).numpy(), modes_np), 0.0, atol=2e-4)
        dk, dc = st_k["demod"], st_c["demod"]
        torch.testing.assert_close(dk["cw_phase"], dc["cw_phase"], rtol=0, atol=0)
        torch.testing.assert_close(dk["am_dc"], dc["am_dc"], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(dk["nfm_last"], dc["nfm_last"], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(st_k["bpf"], st_c["bpf"], rtol=0, atol=0)
        for k in ("env", "lpf"):
            torch.testing.assert_close(st_k["agc"][k][keep], st_c["agc"][k][keep],
                                       rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(aux_k["agc_gain_last"][keep], aux_c["agc_gain_last"][keep],
                                   rtol=1e-4, atol=0)
    assert chain.backend_kernel.launches == 0
