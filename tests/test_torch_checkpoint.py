"""Checkpoint and resume (core/checkpoint.py, Radio.save/load,
Monitor.save/load) and the fault-recovery cases of tests/test_fault.py, on
the port.

Resumes are bit-exact: a fresh Radio or Monitor that loads a checkpoint and
runs the blocks after it gives the same audio (and waterfall) as the one
that saved it. Schema migrations are checked leaf for leaf against the JAX
package's own ``_migrate_v1_to_v2`` on the same numpy tree (it is pure
numpy). Fault recovery keeps the reference's bar: the audio SNR after a
dropped block above 25 dB."""

import numpy as np
import pytest
import torch

from radioframe.core.checkpoint import CURRENT_VERSION as J_CURRENT_VERSION
from radioframe.core.checkpoint import _migrate_v1_to_v2 as j_migrate_v1_to_v2
from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import Radio
from radioframe_torch.convert import state_to_numpy
from radioframe_torch.core import checkpoint as ck
from radioframe_torch.core import presets
from radioframe_torch.core.config import RxConfig
from radioframe_torch.diag.metrics import audio_snr_db
from radioframe_torch.io import fixtures as FX
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.channelizer import ChannelizerConfig
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)

FS = 192_000.0
RADIO_CONFIGS = {
    "dense": RxConfig(channels=1),
    "k1 depth 2": RxConfig(channels=1, fuse_frontend=True, fuse_frontend_depth=2),
}


def _monitor_config(form: str):
    if form == "dense":  # tests/test_api_aux.py's Monitor
        M = 16
        return ChannelizerConfig(fs_in=15_000.0 * M, num_channels=M, emit_spectrum=True,
                                 waterfall_from_pfb=True, spectrum_avg=0.0)
    return presets.channelizer_61m44(32, fs_in=32 * 15_000.0)  # K5's plain route


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same_tree(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _mk_radio(cfg):
    r = Radio(cfg, device="cpu")
    r.tune(0, 37_000.0)
    r.set_mode(0, "ssb")
    return r


@pytest.mark.parametrize("name", list(RADIO_CONFIGS))
def test_radio_bit_exact_stream_resume(tmp_path, name):
    cfg = RADIO_CONFIGS[name]
    iq, _ = FX.ssb_capture(FS, 4 * 8192, 37_000.0)
    blocks = np.split(iq, 4)
    r = _mk_radio(cfg)
    r.process(blocks[0])
    r.process(blocks[1])
    ckdir = str(tmp_path / "ck")
    r.save(ckdir, epoch=2)
    a3, a4 = r.process(blocks[2]), r.process(blocks[3])

    r2 = Radio(cfg, device="cpu")
    assert r2.load(ckdir) == 2
    assert r2.frequency(0) == 37_000.0 and r2.mode(0) == "ssb"
    np.testing.assert_array_equal(a3, r2.process(blocks[2]))
    np.testing.assert_array_equal(a4, r2.process(blocks[3]))


@pytest.mark.parametrize("form", ["dense", "k5"])
def test_monitor_bit_exact_stream_resume(tmp_path, form):
    cfg = _monitor_config(form)
    m = Monitor(cfg, device="cpu")
    T = 16 * m.chain.min_block
    rng = np.random.default_rng(7)
    blocks = np.split((rng.standard_normal(4 * T) + 1j * rng.standard_normal(4 * T))
                      .astype(np.complex64), 4)
    m.set_mode_all("am")
    m.set_mode(3, "nfm")
    m.process(blocks[0])
    m.process(blocks[1])
    ckdir = str(tmp_path / "ck")
    m.save(ckdir, epoch=2)
    a3 = m.process(blocks[2])
    wf3 = m.waterfall()
    a4 = m.process(blocks[3])

    m2 = Monitor(cfg, device="cpu")
    assert m2.load(ckdir) == 2
    assert m2.mode(3) == "nfm" and m2.mode(0) == "am"
    np.testing.assert_array_equal(a3, m2.process(blocks[2]))
    np.testing.assert_array_equal(wf3, m2.waterfall())
    np.testing.assert_array_equal(a4, m2.process(blocks[3]))


def test_load_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _mk_radio(RADIO_CONFIGS["dense"]).load(str(tmp_path / "empty"))


# --- schema versions and migrations ----------------------------------------------------------


def _stepped():
    """A two-channel chain's state after one block (numpy leaves), and the
    chain's step inputs."""
    chain = RxChain(RxConfig(channels=2, ols_hop=512))
    words = torch.from_numpy(nco.freq_word(np.array([10e3, -20e3]), FS))
    mode = torch.tensor([demod_op.SSB, demod_op.NFM], dtype=torch.int32)
    rng = np.random.default_rng(11)
    iq = torch.from_numpy((rng.standard_normal((2, 2048))
                           + 1j * rng.standard_normal((2, 2048))).astype(np.complex64))
    with torch.no_grad():
        st, _, _ = chain.step(chain.init_state(2), iq, words, mode)
    return chain, st, (iq, words, mode)


def _forge_v1(state):
    """The round-1 layout: a scalar AGC envelope, no deemph key."""
    old = dict(state_to_numpy(state))
    old["agc"] = old["agc"]["env"]
    old.pop("deemph")
    return old


def test_schema_constants_match_reference():
    assert ck.CURRENT_VERSION == J_CURRENT_VERSION == 2
    assert set(ck.MIGRATIONS) == {1}


@pytest.mark.parametrize("versioned", [True, False], ids=["v1", "unversioned"])
def test_v1_state_migrates(tmp_path, versioned):
    """A v1 snapshot (versioned, or a raw round-1 one with no version) is
    migrated to the current layout, leaf for leaf as the reference's own
    migration migrates the same numpy tree; the stream then continues
    bit-exactly (lpf is inert at instant attack)."""
    chain, st, (iq, words, mode) = _stepped()
    forged = _forge_v1(st)
    c = ck.StreamCheckpointer(str(tmp_path / "ck"))
    if versioned:
        c.save(0, forged, version=1)
    else:
        ck.write_tree(c._path(0), forged, version=None)
    restored = c.restore(0, chain.init_state(2))
    want = j_migrate_v1_to_v2(forged)
    assert len(_leaves(restored)) == len(_leaves(want))
    for a, b in zip(_leaves(restored), _leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert restored["deemph"] == () and restored["agc"]["hist"] == ()
    assert torch.equal(restored["agc"]["env"], st["agc"]["env"])
    assert torch.equal(restored["nco"], st["nco"])
    with torch.no_grad():
        _, a, _ = chain.step(st, iq, words, mode)
        _, b, _ = chain.step(restored, iq, words, mode)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no migration"):
        c.restore(0, chain.init_state(2), migrations={})


def test_current_version_roundtrip_unchanged(tmp_path):
    chain, st, _ = _stepped()
    c = ck.StreamCheckpointer(str(tmp_path / "ck"))
    payload = {"state": st, "freqs": np.array([1.5, -2.25]), "modes": np.array([0, 3], np.int32)}
    c.save(7, payload)
    like = {"state": chain.init_state(2), "freqs": np.zeros(2), "modes": np.zeros(2, np.int32)}
    _same_tree(c.restore(7, like), payload)
    version, raw = ck.read_tree(c._path(7))
    assert version == ck.CURRENT_VERSION and set(raw) == {"state", "freqs", "modes"}
    with pytest.raises(ValueError, match="shape"):
        c.restore(7, {**like, "freqs": np.zeros(3)})
    with pytest.raises(ValueError, match="keys"):
        c.restore(7, {"state": like["state"]})


# --- fault recovery (tests/test_fault.py) -------------------------------------------------------


def test_dropped_block_recovers():
    """A dropped (zeroed) block mutes briefly; the SNR recovers after it."""
    n = 96 * 2048
    iq, truth = FX.ssb_capture(FS, n, 37_000.0)
    r = _mk_radio(RADIO_CONFIGS["dense"])
    outs = []
    for i, b in enumerate(np.split(iq, 12)):
        outs.append(r.process(np.zeros_like(b) if i == 6 else b)[0])  # block 6 lost
    Ta = outs[0].shape[-1]
    post = np.concatenate(outs[8:], axis=-1)
    snr = audio_snr_db(truth[8 * Ta:][: len(post)], post, trim=1024)
    assert snr > 25.0, f"post-fault SNR {snr:.1f} dB"
    assert np.all(np.isfinite(np.concatenate(outs, axis=-1)))


def test_corrupt_block_does_not_poison_stream(tmp_path):
    """A NaN-corrupted block shows in the output; restoring the epoch before
    it and replaying leaves no NaN in the stream."""
    iq, _ = FX.ssb_capture(FS, 8 * 8192, 37_000.0)
    blocks = np.split(iq, 8)
    r = _mk_radio(RADIO_CONFIGS["dense"])
    for b in blocks[:4]:
        r.process(b)
    r.save(str(tmp_path), epoch=4)
    bad = blocks[4].copy()
    bad[100:200] = np.nan
    assert not np.all(np.isfinite(r.process(bad)))
    r2 = _mk_radio(RADIO_CONFIGS["dense"])
    r2.load(str(tmp_path))
    for b in blocks[4:]:
        assert np.all(np.isfinite(r2.process(b)))


def test_checkpoint_survives_config_roundtrip(tmp_path):
    """Epoch listing and latest_epoch with several snapshots; the epoch
    directories are named as the reference names them."""
    iq, _ = FX.ssb_capture(FS, 2 * 8192, 37_000.0)
    r = _mk_radio(RADIO_CONFIGS["dense"])
    r.process(iq[:8192])
    d = str(tmp_path / "ck")
    r.save(d, epoch=1)
    r.process(iq[8192:])
    assert r.save(d, epoch=2).endswith("epoch_000000000002")
    s = ck.StreamCheckpointer(d)
    assert s.epochs() == [1, 2] and s.latest_epoch() == 2
