"""The port's config-5 channelizer against the JAX package at small M:
PfbChannelizer, the plain versions of K3 (pfb_dft), K4 (demod_agc) and K5
(channelizer_one) against the Pallas kernels in interpret mode, the
ChannelizerChain in its forms, the hang route, Monitor, the configuration
checks, the state handoff and the parameter loader.

Tolerances: PFB planes atol 2e-4, rtol 1e-4 (tests/test_channelizer.py).
Audio 2e-4, and 2e-3 against the reference's bf16x3 ("b3") DFT, its own
channelizer bound; the first block is held after the PFB's K warm-up frames
(near-zero partial frames under the AGC's max gain magnify ulps). NFM rows
are compared modulo fs_channel/deviation = 6.0, the size of an atan2 branch
flip. Waterfall 1e-2 dB, channel power rtol 1e-4, carries and state leaves
atol 2e-4 (2e-3 for b3) with rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.api.monitor import Monitor as JMonitor
from radioframe.core import config as jcfg
from radioframe.kernels.channelizer_one import FusedChannelizerOne as JOne
from radioframe.kernels.demod_agc import FusedDemodAgc as JDemod
from radioframe.kernels.pfb_dft import FusedPfbDft as JPfbDft
from radioframe.ops.agc import AgcBank as JAgcBank
from radioframe.ops.pfb import PfbChannelizer as JPfb
from radioframe.pipelines import channelizer as jch
from radioframe_torch.api.monitor import Monitor as TMonitor
from radioframe_torch.convert import load_channelizer_params, state_from_numpy, state_to_numpy
from radioframe_torch.core import config as tcfg
from radioframe_torch.diag.metrics import audio_snr_db
from radioframe_torch.kernels.channelizer_one import FusedChannelizerOne
from radioframe_torch.kernels.demod_agc import FusedDemodAgc
from radioframe_torch.kernels.pfb_dft import FusedPfbDft
from radioframe_torch.ops.pfb import PfbChannelizer
from radioframe_torch.pipelines import channelizer as tch

torch.set_num_threads(2)

M = 64
FS_CH = 15_000.0
NFM_PERIOD = 6.0  # 15 kHz / 2.5 kHz
ATTACK = (dict(release_s=0.5, attack_s=0.002), dict(release_s=0.25, attack_s=0.001),
          dict(release_s=0.8, attack_s=0.005), dict(), dict(release_s=0.5, attack_s=0.002),
          dict(release_s=0.8, attack_s=0.005))
HANG = (dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.25, hang_s=0.005),
        dict(release_s=0.8, attack_s=0.005, hang_s=0.02), dict(),
        dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.8, hang_s=0.02))


def _configs(agc_modes=None, agc=None, **kw):
    """The same channelizer configuration as (JAX, port) config objects."""
    kw = dict(dict(fs_in=FS_CH * M, num_channels=M, emit_spectrum=True, waterfall_from_pfb=True,
                   waterfall_frame_avg=4, enabled_modes=(0, 1, 2, 3)), **kw)
    out = []
    for mod, ch in ((jcfg, jch), (tcfg, tch)):
        extra = {}
        if agc_modes is not None:
            extra["agc_modes"] = tuple(mod.AgcConfig(**a) for a in agc_modes)
        if agc is not None:
            extra["agc"] = mod.AgcConfig(**agc)
        out.append(ch.ChannelizerConfig(**kw, **extra))
    return out


def _wideband(rng, T):
    return (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)


def _audio_close(a_t, a_j, nfm_rows, atol=2e-4, skip=0):
    """(M, F) audio; NFM rows modulo NFM_PERIOD; the first ``skip`` frames
    not held."""
    d = (np.asarray(a_t) - np.asarray(a_j))[:, skip:]
    d[nfm_rows] -= NFM_PERIOD * np.round(d[nfm_rows] / NFM_PERIOD)
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


def _states_close(st_t, st_j, atol=2e-4):
    t, j = state_to_numpy(st_t), jax.tree.map(np.asarray, st_j)
    _same_structure(t, j)
    np.testing.assert_array_equal(t["demod"]["cw_phase"], j["demod"]["cw_phase"])
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5)


def _carry0():
    st = np.zeros((7, M), np.float32)
    st[2] = 1.0  # nfm_last starts at 1 + 0j
    return st


# --- PfbChannelizer and K3 ----------------------------------------------------------


def test_pfb_channelizer_matches_jax(rng):
    j, t = JPfb(M, 8), PfbChannelizer(M, 8)
    np.testing.assert_array_equal(t.h.numpy(), j._h)
    x = _wideband(rng, 96 * M)
    y_j, tail_j = jax.jit(j.__call__)(j.init_state(1), jnp.asarray(x[None]))
    y_t, tail_t = t(t.init_state(1), torch.from_numpy(x[None]))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
    st, outs = t.init_state(1), []
    for blk in np.split(x, 3):  # streaming: three blocks equal one
        y, st = t(st, torch.from_numpy(blk[None]))
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1), np.asarray(y_j), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("m", [32, 64, 256])
def test_pfb_dft_plain_matches_jax_kernel(rng, m):
    j, t = JPfbDft(m, 8, interpret=True), FusedPfbDft(m, 8)
    step_j = jax.jit(lambda tl, x: j.call_planes(tl, x, native=False))
    tail_j, tail_t = j.init_state(1), t.init_state(1)
    for _ in range(2):
        x = _wideband(rng, 32 * m)
        (yr_j, yi_j), tail_j = step_j(tail_j, jnp.asarray(x[None]))
        (yr_t, yi_t), tail_t = t.call_planes(tail_t, torch.from_numpy(x[None]))
        np.testing.assert_allclose(yr_t.numpy(), np.asarray(yr_j), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(yi_t.numpy(), np.asarray(yi_j), atol=2e-4, rtol=1e-4)
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
    assert t.launches == 0


# --- K4 and K5 -------------------------------------------------------------------------

KERNEL_CASES = [("instant", None, True), ("attack", ATTACK, True), ("demod_only", None, False)]


def _kernel_inputs(agc_modes, modes):
    cfgs = (tuple(jcfg.AgcConfig(**a) for a in agc_modes) if agc_modes
            else (jcfg.AgcConfig(),) * 6)
    bank = JAgcBank(cfgs, FS_CH)
    rel, al, tgt, mg = (np.array(v) for v in bank.per_channel(jnp.asarray(modes)))
    word = np.full(M, 1234567, np.int32)
    return bank, (modes, word, rel, al, tgt, mg)


def _kernel_outputs_close(out_t, out_j, modes, blk, apply_agc):
    audio_t, power_t, wf_t, st_t = (o.numpy() for o in out_t)
    audio_j, power_j, wf_j, st_j = (np.asarray(o) for o in out_j)
    if blk > 0:
        _audio_close(audio_t.T, audio_j.T, modes == 3)
    db = lambda w: 10 * np.log10(np.maximum(w, 1e-24))
    np.testing.assert_allclose(db(wf_t), db(wf_j), atol=1e-2)
    np.testing.assert_allclose(power_t, power_j, rtol=1e-4)
    rows = [0, 1, 2, 3, 4, 5] if apply_agc else [0, 1, 2, 3]
    np.testing.assert_allclose(st_t[rows], st_j[rows], atol=2e-4, rtol=1e-5)
    if not apply_agc:  # demod only: the AGC rows pass through
        np.testing.assert_array_equal(st_t[4:6], st_j[4:6])


@pytest.mark.parametrize("label,agc_modes,apply_agc", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_demod_agc_plain_matches_jax_kernel(rng, label, agc_modes, apply_agc):
    modes = (np.arange(M) % 5).astype(np.int32)
    bank, (mode, word, rel, al, tgt, mg) = _kernel_inputs(agc_modes, modes)
    kw = dict(wf_avg=4, enabled=(0, 1, 2, 3, 4), apply_agc=apply_agc)
    j = JDemod(M, FS_CH, 2500.0, attack_alphas=tuple(bank.alpha.tolist()), interpret=True, **kw)
    t = FusedDemodAgc(M, FS_CH, 2500.0, **kw)
    pfb = FusedPfbDft(M, 8)
    j_call = jax.jit(j.__call__)
    tail, st_j, st_t, acc = pfb.init_state(1), _carry0(), torch.from_numpy(_carry0()), 0
    for blk in range(2):
        (yr, yi), tail = pfb.call_planes(tail, torch.from_numpy(_wideband(rng, 32 * M)[None]))
        cw_acc = np.full(M, acc, np.int32)
        args = (mode, word, cw_acc, rel, al, tgt, mg)
        out_j = j_call(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()),
                       *map(jnp.asarray, args), jnp.asarray(st_j))
        out_t = t(yr, yi, *map(torch.from_numpy, args), st_t)
        _kernel_outputs_close(out_t, out_j, modes, blk, apply_agc)
        st_j, st_t = np.asarray(out_j[3]), out_t[3]
        acc = int(np.int64(acc + 1234567 * 32).astype(np.int32))
    assert t.launches == 0


@pytest.mark.parametrize("label,agc_modes,apply_agc", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_channelizer_one_plain_matches_jax_kernel(rng, label, agc_modes, apply_agc):
    modes = (np.arange(M) % 5).astype(np.int32)
    bank, (mode, word, rel, al, tgt, mg) = _kernel_inputs(agc_modes, modes)
    kw = dict(wf_avg=4, enabled=(0, 1, 2, 3, 4), apply_agc=apply_agc)
    j = JOne(M, 8, FS_CH, 2500.0, attack_alphas=tuple(bank.alpha.tolist()), interpret=True, **kw)
    t = FusedChannelizerOne(M, 8, FS_CH, 2500.0, **kw)
    # the JAX kernel works in its native (k1, k2) channel order
    nat = lambda v: jch.native_order(jnp.asarray(v), j.M1, j.M2)
    chan = lambda v: np.asarray(jch.channel_order(v, j.M1, j.M2))
    j_call = jax.jit(j.call_planes)
    tail_j, tail_t = np.zeros((1, 7 * M), np.complex64), t.init_tail()
    st_j, st_t, acc = _carry0(), torch.from_numpy(_carry0()), 0
    for blk in range(2):
        x = rng.standard_normal((2, 32 * M)).astype(np.float32)
        cw_acc = np.full(M, acc, np.int32)
        args = (mode, word, cw_acc, rel, al, tgt, mg)
        audio, power, wf, st_out = j_call(jnp.asarray(tail_j), jnp.asarray(x[0]),
                                          jnp.asarray(x[1]), *map(nat, args), nat(st_j))
        out_j = (chan(audio), chan(power), chan(wf), chan(st_out))
        out_t = t.call_planes(tail_t, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                              *map(torch.from_numpy, args), st_t)
        _kernel_outputs_close(out_t, out_j, modes, blk, apply_agc)
        st_j, st_t = out_j[3], out_t[3]
        tail_j = (x[0] + 1j * x[1])[None, -7 * M:].astype(np.complex64)
        tail_t = torch.from_numpy(tail_j)
        acc = int(np.int64(acc + 1234567 * 32).astype(np.int32))
    assert t.launches == 0


EMIT_CASES = [("instant", None), ("attack", ATTACK)]


@pytest.mark.parametrize("label,agc_modes", EMIT_CASES, ids=[c[0] for c in EMIT_CASES])
def test_channelizer_one_emit_env_matches_jax_kernel(rng, label, agc_modes):
    """K5's emit_env variant (demod only, AM off): the release env from a
    zero-seeded carry row 4, chained over two blocks, against the JAX kernel
    in interpret mode. env, audio and the carry rows within 2e-4 of each
    one's scale (NFM audio modulo 6.0); attack and gain not applied."""
    modes = np.array([0, 1, 3, 4])[np.arange(M) % 4].astype(np.int32)
    bank, (mode, word, rel, al, tgt, mg) = _kernel_inputs(agc_modes, modes)
    kw = dict(wf_avg=4, enabled=(0, 1, 3, 4), apply_agc=False, emit_env=True)
    j = JOne(M, 8, FS_CH, 2500.0, attack_alphas=tuple(bank.alpha.tolist()), interpret=True, **kw)
    t = FusedChannelizerOne(M, 8, FS_CH, 2500.0, **kw)
    nat = lambda v: jch.native_order(jnp.asarray(v), j.M1, j.M2)
    chan = lambda v: np.asarray(jch.channel_order(v, j.M1, j.M2))
    j_call = jax.jit(j.call_planes)
    tail = np.zeros((1, 7 * M), np.complex64)
    st_j, st_t, acc = _carry0(), torch.from_numpy(_carry0()), 0
    for blk in range(2):
        x = rng.standard_normal((2, 32 * M)).astype(np.float32)
        args = (mode, word, np.full(M, acc, np.int32), rel, al, tgt, mg)
        out_j = [chan(o) for o in j_call(jnp.asarray(tail), jnp.asarray(x[0]), jnp.asarray(x[1]),
                                          *map(nat, args), nat(st_j))]
        out_t = [o.numpy() for o in t.call_planes(torch.from_numpy(tail), torch.from_numpy(x[0]),
                                                  torch.from_numpy(x[1]),
                                                  *map(torch.from_numpy, args), st_t)]
        assert len(out_t) == len(out_j) == 5 and out_t[4].shape == (32, M)
        scale = lambda a: max(1.0, float(np.abs(a).max()))  # noqa: E731
        _audio_close(out_t[0].T, out_j[0].T, modes == 3, atol=2e-4 * scale(out_j[0]))
        np.testing.assert_allclose(out_t[4], out_j[4], atol=2e-4 * scale(out_j[4]))
        for r in range(6):
            np.testing.assert_allclose(out_t[3][r], out_j[3][r], atol=2e-4 * scale(out_j[3][r]),
                                       err_msg=f"carry row {r}")
        np.testing.assert_array_equal(out_t[3][4], out_t[4][-1])  # row 4: the last env
        np.testing.assert_array_equal(out_t[3][5], st_t[5].numpy())  # attack row untouched
        st_j, st_t = out_j[3], torch.from_numpy(out_t[3])
        tail = (x[0] + 1j * x[1])[None, -7 * M:].astype(np.complex64)
        acc = int(np.int64(acc + 1234567 * 32).astype(np.int32))
    assert t.launches == 0


@pytest.mark.parametrize("kw,match", [(dict(enabled=(0, 1, 3)), "apply_agc"),
                                      (dict(enabled=(0, 1, 2, 3), apply_agc=False), "AM")])
def test_channelizer_one_emit_env_gates(kw, match):
    """The reference's two correctness gates are ValueErrors in the port too."""
    with pytest.raises(ValueError, match=match):
        JOne(M, 8, FS_CH, 2500.0, emit_env=True, interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        FusedChannelizerOne(M, 8, FS_CH, 2500.0, emit_env=True, **kw)


# --- ChannelizerChain ------------------------------------------------------------------

FORMS = {
    "dense_panorama": dict(waterfall_from_pfb=False, spectrum_nfft=256),
    "dense": {},
    "fuse_pfb": dict(fuse_pfb=True),
    "two_kernel": dict(fuse_pfb=True, fuse_demod=True),
    "single_pass": dict(fuse_pfb=True, fuse_demod=True, fuse_single_pass=True),
    "single_pass_b3": dict(fuse_pfb=True, fuse_demod=True, fuse_single_pass=True,
                           dft_precision="b3"),
}


def _run_chains(rng, j, t, blocks=2, atol=2e-4):
    """Step the JAX and port chains over the same blocks and hold audio,
    waterfall and channel power; returns the two states."""
    mode = (np.arange(M) % 4).astype(np.int32)
    T = 4 * j.min_block
    assert t.min_block == j.min_block
    step_j = jax.jit(j.step)
    st_j, st_t = jax.jit(j.init_state)(), t.init_state()
    for blk in range(blocks):
        x = _wideband(rng, T)
        st_j, a_j, x_j = step_j(st_j, jnp.asarray(x), jnp.asarray(mode))
        st_t, a_t, x_t = t.step(st_t, torch.from_numpy(x), torch.from_numpy(mode))
        assert a_t.shape == a_j.shape == (M, T // M)
        _audio_close(a_t.numpy(), a_j, mode == 3, atol=atol, skip=8 if blk == 0 else 0)
        np.testing.assert_allclose(x_t["waterfall"].numpy(), np.asarray(x_j["waterfall"]),
                                   atol=1e-2)
        np.testing.assert_allclose(x_t["channel_power"].numpy(),
                                   np.asarray(x_j["channel_power"]), rtol=1e-4)
    return st_t, st_j


@pytest.mark.parametrize("form", list(FORMS))
def test_chain_matches_jax(rng, form):
    cj, ct = _configs(**FORMS[form])
    j, t = jch.ChannelizerChain(cj), tch.ChannelizerChain(ct)
    assert (t.demod_kernel is None) == (j.demod_kernel is None)
    assert (t.one_kernel is None) == (getattr(j, "one_kernel", None) is None)
    atol = 2e-3 if form.endswith("b3") else 2e-4
    st_t, st_j = _run_chains(rng, j, t, atol=atol)
    _states_close(st_t, st_j, atol=atol)
    for k in (t.pfb, t.demod_kernel, t.one_kernel):
        assert getattr(k, "launches", 0) == 0  # CPU tensors take the plain versions


@pytest.mark.parametrize("single", [False, True], ids=["two_kernel", "single_pass"])
def test_hang_route_matches_jax(rng, single):
    cj, ct = _configs(agc_modes=HANG, fuse_pfb=True, fuse_demod=True, fuse_single_pass=single)
    j, t = jch.ChannelizerChain(cj), tch.ChannelizerChain(ct)
    assert t.agc_in_torch and t.agc_bank.hist_len > 0 and not t.demod_kernel.apply_agc
    st_t, st_j = _run_chains(rng, j, t)
    _states_close(st_t, st_j)


def test_step_planes_matches_step(rng):
    t = tch.ChannelizerChain(_configs(**FORMS["single_pass"])[1])
    x = _wideband(rng, 2 * t.min_block)
    mode = torch.arange(M, dtype=torch.int32) % 4
    st1, a1, x1 = t.step(t.init_state(), torch.from_numpy(x), mode)
    st2, a2, x2 = t.step_planes(t.init_state(), torch.from_numpy(x.real.copy()),
                                torch.from_numpy(x.imag.copy()), mode)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(x1["waterfall"], x2["waterfall"], rtol=0, atol=0)
    torch.testing.assert_close(st1["pfb"], st2["pfb"], rtol=0, atol=0)


# --- the audio's layout: K5 channel-major in the single-pass chain ----------------------

LAYOUT_AGC = {"agc": None, "hang": HANG}


@pytest.mark.parametrize("agc", list(LAYOUT_AGC))
def test_single_pass_channel_major_matches_two_kernel(rng, agc):
    """The single-pass chain asks K5 for channel-major (M, F) audio and does
    not transpose it; the two-kernel chain transposes K4's (F, M). On CPU
    tensors both run the same plain K3 and K4, so audio, channel power,
    waterfall and every state leaf are bit-equal over 3 blocks of SSB, CW, AM
    and NFM channels, with M = 64 != F = 32: an F read from the audio's
    other axis would scale channel_power and advance the CW phase carried
    into the next block by M frames. The hang route (demod-only kernels, the
    AgcBank after them) takes the same (M, F) audio."""
    kw = {} if LAYOUT_AGC[agc] is None else dict(agc_modes=LAYOUT_AGC[agc])
    one = tch.ChannelizerChain(_configs(**FORMS["single_pass"], **kw)[1])
    two = tch.ChannelizerChain(_configs(**FORMS["two_kernel"], **kw)[1])
    assert one.agc_in_torch == (agc == "hang") == two.agc_in_torch
    asked = []
    call_planes = one.one_kernel.call_planes

    def spy(*args, **kwargs):
        asked.append(kwargs.get("channel_major", False))
        out = call_planes(*args, **kwargs)
        assert out[0].shape == (M, args[1].shape[-1] // M) and out[0].is_contiguous()
        return out

    one.one_kernel.call_planes = spy
    mode = torch.arange(M, dtype=torch.int32) % 4  # SSB, CW, AM, NFM
    T = 32 * M
    st1, st2 = one.init_state(), two.init_state()
    for _ in range(3):
        x = torch.from_numpy(_wideband(rng, T))
        st1, a1, x1 = one.step(st1, x, mode)
        st2, a2, x2 = two.step(st2, x, mode)
        assert a1.shape == (M, 32) and a1.is_contiguous()
        torch.testing.assert_close(a1, a2, rtol=0, atol=0)
        for k in ("channel_power", "waterfall"):
            torch.testing.assert_close(x1[k], x2[k], rtol=0, atol=0)
        for a, b in zip(jax.tree.leaves(state_to_numpy(st1)), jax.tree.leaves(state_to_numpy(st2))):
            np.testing.assert_array_equal(a, b)
    assert asked == [True] * 3


@pytest.mark.parametrize("label,agc_modes,apply_agc", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_channelizer_one_channel_major_is_frame_major_transposed(rng, label, agc_modes,
                                                                 apply_agc):
    """``call_planes(..., channel_major=True)`` on CPU tensors: contiguous
    (M, F) audio equal to the frame-major audio transposed, and the same
    power, waterfall and carry, over two chained blocks with M != F."""
    modes = (np.arange(M) % 5).astype(np.int32)
    _, args = _kernel_inputs(agc_modes, modes)
    t = FusedChannelizerOne(M, 8, FS_CH, 2500.0, wf_avg=4, enabled=(0, 1, 2, 3, 4),
                            apply_agc=apply_agc)
    consts = [torch.from_numpy(a) for a in (args[0], args[1], np.zeros(M, np.int32), *args[2:])]
    tail, st = t.init_tail(), torch.from_numpy(_carry0())
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((2, 32 * M)).astype(np.float32))
        fm = t.call_planes(tail, x[0], x[1], *consts, st)
        cm = t.call_planes(tail, x[0], x[1], *consts, st, channel_major=True)
        assert fm[0].shape == (32, M) and cm[0].shape == (M, 32) and cm[0].is_contiguous()
        torch.testing.assert_close(cm[0], fm[0].T, rtol=0, atol=0)
        for a, b in zip(cm[1:], fm[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        st, tail = fm[3], torch.complex(x[0, -7 * M:], x[1, -7 * M:])[None]
    assert t.launches == 0 and not any(t.variant_launches.values())


def test_frame_major_forms_keep_frame_major(rng):
    """K3 -> K4 and K5's emit_env keep (F, M): the two-kernel chain hands K4's
    frame-major audio to its transpose, emit_env returns (F, M) audio and env
    and refuses channel-major."""
    two = tch.ChannelizerChain(_configs(**FORMS["two_kernel"])[1])
    shapes = []
    demod = two.demod_kernel.forward

    def spy(*args, **kwargs):
        out = demod(*args, **kwargs)
        shapes.append(tuple(out[0].shape))
        return out

    two.demod_kernel.forward = spy
    mode = torch.arange(M, dtype=torch.int32) % 4
    _, audio, _ = two.step(two.init_state(), torch.from_numpy(_wideband(rng, 32 * M)), mode)
    assert shapes == [(32, M)] and audio.shape == (M, 32)
    modes = np.array([0, 1, 3, 4])[np.arange(M) % 4].astype(np.int32)
    _, args = _kernel_inputs(None, modes)
    t = FusedChannelizerOne(M, 8, FS_CH, 2500.0, wf_avg=4, enabled=(0, 1, 3, 4),
                            apply_agc=False, emit_env=True)
    consts = [torch.from_numpy(a) for a in (args[0], args[1], np.zeros(M, np.int32), *args[2:])]
    x = torch.from_numpy(rng.standard_normal((2, 32 * M)).astype(np.float32))
    out = t.call_planes(t.init_tail(), x[0], x[1], *consts, torch.from_numpy(_carry0()))
    assert out[0].shape == out[4].shape == (32, M)
    with pytest.raises(ValueError, match="frame-major"):
        t.call_planes(t.init_tail(), x[0], x[1], *consts, torch.from_numpy(_carry0()),
                      channel_major=True)


def test_monitor_matches_jax(rng):
    cj, ct = _configs(**FORMS["single_pass"])
    mj, mt = JMonitor(cj), TMonitor(ct, device="cpu")
    names = ("ssb", "cw", "am", "nfm")
    for c in range(M):
        for m in (mj, mt):
            m.set_mode(c, names[c % 4])
    assert [mt.mode(c) for c in range(4)] == list(names)
    assert mt.channel_frequency(40) == mj.channel_frequency(40) and mt.num_channels == M
    assert mt.waterfall() is None and mt.channel_power() is None
    for blk in range(2):
        x = _wideband(rng, 4 * mt.chain.min_block)
        a_t, a_j = mt.process(x), mj.process(x)
        assert isinstance(a_t, np.ndarray) and a_t.shape == a_j.shape
        _audio_close(a_t, a_j, np.arange(M) % 4 == 3, skip=8 if blk == 0 else 0)
        np.testing.assert_allclose(mt.waterfall(), mj.waterfall(), atol=1e-2)
        np.testing.assert_allclose(mt.channel_power(), mj.channel_power(), rtol=1e-4)
    assert mt.chain.one_kernel.launches == 0


class _TwoAxisMesh:
    """Stands in for a (2, 2) mesh: Monitor refuses it before any collective."""

    device = torch.device("cpu")

    def size(self, name):
        return 2


def test_monitor_unported_options_raise(tmp_path):
    """A mesh must shard time alone. Checkpointing (ROADMAP P11) is ported:
    save and load round-trip here, and tests/test_torch_checkpoint.py holds
    the resume bit-exact."""
    ct = _configs(**FORMS["single_pass"])[1]
    with pytest.raises(ValueError, match="channel axis"):
        TMonitor(ct, device="cpu", mesh=_TwoAxisMesh())
    m = TMonitor(ct, device="cpu")
    m.set_mode(3, "nfm")
    m.save(str(tmp_path), epoch=5)
    m2 = TMonitor(ct, device="cpu")
    assert m2.load(str(tmp_path)) == 5 and m2.mode(3) == "nfm"


def test_am_channel_snr_acceptance():
    """An AM tone at channel 37's center demodulates above 15 dB through the
    port's single-pass chain (tests/test_channelizer.py, the same signal)."""
    t = tch.ChannelizerChain(_configs(**FORMS["single_pass"])[1])
    F = 4096
    tt = np.arange(F) / FS_CH
    tone = 0.7 * np.sin(2 * np.pi * 1000.0 * tt)
    up = np.repeat((1.0 + 0.8 * tone).astype(np.complex128), M)
    wide = (up * np.exp(2j * np.pi * (37 * FS_CH) * (np.arange(F * M) / (FS_CH * M))))
    mode = torch.full((M,), 2, dtype=torch.int32)
    _, audio, aux = t.step(t.init_state(), torch.from_numpy(wide.astype(np.complex64)), mode)
    snr = audio_snr_db(tone[512:], audio.numpy()[37][512:], trim=128)
    assert snr > 15.0, f"single-pass channelized AM SNR {snr:.1f} dB"
    assert int(torch.argmax(aux["channel_power"])) == 37


# --- configuration checks ----------------------------------------------------------------

FUSED = dict(fuse_pfb=True, fuse_demod=True)
INVALID = {
    "frame_avg_not_pow2": (dict(FUSED, waterfall_frame_avg=3), ValueError, "power of two"),
    "frame_avg_over_tile_cap": (dict(FUSED, num_channels=4096, fs_in=FS_CH * 4096,
                                     waterfall_frame_avg=128), ValueError, "frame-tile cap"),
    "fast_release": (dict(FUSED, agc=dict(release_s=1e-4)), ValueError, "release"),
    "single_pass_without_fuse_demod": (dict(fuse_pfb=True, fuse_single_pass=True),
                                       AssertionError, "fuse_demod"),
    "fuse_demod_without_fuse_pfb": (dict(fuse_demod=True), AssertionError, "PFB"),
    "fuse_demod_without_pfb_waterfall": (dict(FUSED, waterfall_from_pfb=False,
                                              waterfall_frame_avg=1), AssertionError,
                                         "waterfall"),
    "fuse_demod_with_sam": (dict(FUSED, enabled_modes=None), AssertionError, "SAM"),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_configs_raise_like_jax(case):
    kw, exc, match = INVALID[case]
    kw = dict(kw)
    agc = kw.pop("agc", None)
    cj, ct = _configs(agc=agc, **kw)
    with pytest.raises(exc):
        jch.ChannelizerChain(cj)
    with pytest.raises(exc, match=match):
        tch.ChannelizerChain(ct)


def test_block_length_must_fit_min_block(rng):
    cj, ct = _configs(**FUSED)
    j, t = jch.ChannelizerChain(cj), tch.ChannelizerChain(ct)
    bad = _wideband(rng, t.min_block + 64)
    with pytest.raises(AssertionError):
        j.step(j.init_state(), bad, jnp.zeros((M,), jnp.int32))
    with pytest.raises(AssertionError, match="multiple of"):
        t.step(t.init_state(), torch.from_numpy(bad), torch.zeros(M, dtype=torch.int32))
    with pytest.raises(AssertionError, match="fuse_single_pass"):
        t.step_planes(t.init_state(), torch.zeros(t.min_block), torch.zeros(t.min_block),
                      torch.zeros(M, dtype=torch.int32))


def test_dft_precision_refuses_unknown():
    with pytest.raises(KeyError):
        JPfbDft(M, 8, interpret=True, dft_precision="bf16")
    with pytest.raises(ValueError, match="dft_precision"):
        FusedPfbDft(M, 8, dft_precision="bf16")


# --- convert: state handoff and parameters --------------------------------------------------


def test_state_handoff_from_jax_and_back(rng):
    """JAX block 1 -> convert -> port block 2 -> convert back -> JAX block 3
    equals three JAX blocks."""
    cj, ct = _configs(**FORMS["single_pass"])
    j, t = jch.ChannelizerChain(cj), tch.ChannelizerChain(ct)
    mode = (np.arange(M) % 4).astype(np.int32)
    step_j = jax.jit(j.step)
    xs = [_wideband(rng, 4 * j.min_block) for _ in range(3)]
    st_j, _, _ = step_j(jax.jit(j.init_state)(), jnp.asarray(xs[0]), jnp.asarray(mode))
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    _same_structure(state_to_numpy(st_t), jax.tree.map(np.asarray, st_j))
    st_j, a_j, _ = step_j(st_j, jnp.asarray(xs[1]), jnp.asarray(mode))
    st_t, a_t, _ = t.step(st_t, torch.from_numpy(xs[1]), torch.from_numpy(mode))
    _audio_close(a_t.numpy(), a_j, mode == 3)
    _states_close(st_t, st_j)
    back = jax.tree.map(jnp.asarray, state_to_numpy(st_t))
    _, a_back, _ = step_j(back, jnp.asarray(xs[2]), jnp.asarray(mode))
    _, a_ref, _ = step_j(st_j, jnp.asarray(xs[2]), jnp.asarray(mode))
    _audio_close(np.asarray(a_back), a_ref, mode == 3)


def test_load_channelizer_params(rng):
    cj, ct = _configs(**FORMS["single_pass"])
    j, t, ref = jch.ChannelizerChain(cj), tch.ChannelizerChain(ct), tch.ChannelizerChain(ct)
    with torch.no_grad():
        for buf in t.buffers():
            if buf.is_floating_point():
                buf.mul_(0.5)
    load_channelizer_params(t, {"h": j.pfb._h, "release": j.agc_bank.release,
                                "alpha": j.agc_bank.alpha, "target": j.agc_bank.target,
                                "max_gain": j.agc_bank.max_gain})
    np.testing.assert_array_equal(t.pfb.h.numpy(), j.pfb._h)
    np.testing.assert_array_equal(t.one_kernel.h.numpy(), j.pfb._h)
    np.testing.assert_array_equal(t.agc_bank.release.numpy(), j.agc_bank.release)
    x = torch.from_numpy(_wideband(rng, 2 * t.min_block))
    mode = torch.arange(M, dtype=torch.int32) % 4
    _, a_load, _ = t.step(t.init_state(), x, mode)
    _, a_ref, _ = ref.step(ref.init_state(), x, mode)
    torch.testing.assert_close(a_load, a_ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        load_channelizer_params(t, {"h": j.pfb._h[:4], "release": j.agc_bank.release,
                                    "alpha": j.agc_bank.alpha, "target": j.agc_bank.target,
                                    "max_gain": j.agc_bank.max_gain})
