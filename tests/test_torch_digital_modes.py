"""The port's digital modes (``radioframe_torch/ops/fec.py``, ``ft8.py``,
``wspr.py``, ``data/``) against the JAX package's, on inputs made from a
seed with numpy.

- The host halves, copied from the reference, give equal outputs: the
  codes (``H``, the staircase, the general encoder, GF(2) inverse, checks),
  the convolutional code and its stack decoder, the CRC, both packers,
  ``encode_symbols`` and ``modulate`` of FT8 and WSPR, WSPR's energies and
  decode.
- The batched min-sum equals the JAX one bit for bit in hard bits and
  ``ok`` (batch 16, 10 and 40 iterations; noisy codewords, and integer
  LLRs whose ties and zeros exercise the tie rules).
- FT8's tone energies within 1e-5 of their scale and LLRs within 1e-4 of
  theirs, real audio and complex baseband; ``sync_search`` the same
  (start, f0); decodes clean, at noise sigma 2, and batched.
- The table drop-in flips the PROVISIONAL flags and malformed tables raise
  (after tests/test_digital_kat.py, with the port's ``data`` directory
  monkeypatched); ``Radio.capabilities()`` equals the JAX one's dict.

FT8 and WSPR run at the reference tests' scaled rates (fs/sps = the tone
spacing), so a message is 40,448 and 165,888 samples."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.ops import fec as jfec
from radioframe.ops import ft8 as jft8
from radioframe.ops import wspr as jwspr
from radioframe_torch import data as tables
from radioframe_torch.ops import fec, ft8, wspr

torch.set_num_threads(2)

FT8_FS, FT8_SPS, FT8_F0 = 3200.0, 512, 800.0
WSPR_FS, WSPR_SPS, WSPR_F0 = 1500.0, 1024, 400.0
FT8_MSGS = [("CQ", "K1ABC", "FN42"), ("CQ", "W9W", "EM69"),
            ("K1ABC", "GM4XYZ", "IO87"), ("QRZ", "K1ABC", "FN42")]


def _ft8_audio(msg, rng=None, sigma=0.0):
    a = ft8.modulate(ft8.encode_symbols(*msg), fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
    return a + sigma * rng.standard_normal(len(a)) if sigma else a


# --- the host copies ---------------------------------------------------------------------------


def test_codes_match_reference(rng):
    assert np.array_equal(ft8.H, jft8.H)
    for args in ((91, 83, 3, 7), (50, 30, 2, 1)):
        assert np.array_equal(fec.ldpc_staircase(*args), jfec.ldpc_staircase(*args))
    msgs = rng.integers(0, 2, (8, 91)).astype(np.uint8)
    cw = fec.ldpc_encode(ft8.H, msgs)
    assert np.array_equal(cw, jfec.ldpc_encode(jft8.H, msgs))
    bad = cw ^ (rng.random(cw.shape) < 0.02).astype(np.uint8)
    assert fec.ldpc_check(ft8.H, cw).all()
    assert np.array_equal(fec.ldpc_check(ft8.H, bad), jfec.ldpc_check(jft8.H, bad))
    while True:
        H = (rng.random((83, 174)) < 0.06).astype(np.uint8)
        H[np.arange(83), 91 + np.arange(83)] = 1
        try:
            inv = jfec.gf2_inv(H[:, 91:])
            break
        except ValueError:
            with pytest.raises(ValueError, match="singular"):
                fec.gf2_inv(H[:, 91:])
    assert np.array_equal(fec.gf2_inv(H[:, 91:]), inv)
    assert np.array_equal(fec.ldpc_encode_general(H, msgs), jfec.ldpc_encode_general(H, msgs))
    assert fec.ldpc_check(H, fec.ldpc_encode_general(H, msgs, inv)).all()


def test_conv_code_and_crc_match_reference(rng):
    msg = rng.integers(0, 2, 50).astype(np.uint8)
    padded = np.concatenate([msg, np.zeros(31, np.uint8)])
    coded = fec.conv_encode(padded, wspr.POLYS, 32)
    assert np.array_equal(coded, jfec.conv_encode(padded, jwspr.POLYS, 32))
    llr = 3.0 * (1.0 - 2.0 * coded.astype(np.float64)) + 1.5 * rng.standard_normal(len(coded))
    dec = fec.conv_stack_decode(llr, wspr.POLYS, 50, 32)
    assert dec is not None and np.array_equal(dec, msg)
    assert np.array_equal(dec, jfec.conv_stack_decode(llr, jwspr.POLYS, 50, 32))
    for _ in range(4):
        bits = rng.integers(0, 2, 82).astype(np.uint8)
        assert fec.crc_msb(bits, ft8.CRC_POLY, 14) == jfec.crc_msb(bits, jft8.CRC_POLY, 14)
    assert ft8.crc14(bits[:77]) == jft8.crc14(bits[:77])


@pytest.mark.parametrize("msg", FT8_MSGS + [("DE", "GM4XYZ", "AA00")])
def test_ft8_host_half_matches_reference(msg):
    bits = ft8.pack_message(*msg)
    assert np.array_equal(bits, jft8.pack_message(*msg))
    assert ft8.unpack_message(bits) == jft8.unpack_message(bits) == msg
    tones = ft8.encode_symbols(*msg)
    assert np.array_equal(tones, jft8.encode_symbols(*msg))
    for kw in ({}, dict(fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)):
        assert np.array_equal(ft8.modulate(tones, **kw), jft8.modulate(tones, **kw))
    assert np.array_equal(ft8.tone_basis(FT8_FS, FT8_F0, FT8_SPS),
                          jft8.tone_basis(FT8_FS, FT8_F0, FT8_SPS))


@pytest.mark.parametrize("msg", [("K1ABC", "FN42", 37), ("GM4XYZ", "IO87", 30),
                                 ("W9W", "EM69", 23)])
def test_wspr_host_copy_matches_reference(msg):
    bits = wspr.pack_message(*msg)
    assert np.array_equal(bits, jwspr.pack_message(*msg))
    assert wspr.unpack_message(bits) == msg
    sym = wspr.encode_symbols(*msg)
    assert np.array_equal(sym, jwspr.encode_symbols(*msg))
    assert np.array_equal(sym & 1, wspr.SYNC) and np.array_equal(wspr.SYNC, jwspr.SYNC)
    audio = wspr.modulate(sym, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS)
    assert np.array_equal(audio, jwspr.modulate(sym, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS))
    e = wspr.symbol_energies(audio, WSPR_FS, WSPR_F0, 0, WSPR_SPS)
    assert np.array_equal(e, jwspr.symbol_energies(audio, WSPR_FS, WSPR_F0, 0, WSPR_SPS))
    assert wspr.sync_metric(e) == jwspr.sync_metric(e)


def test_wspr_round_trip_clean():
    sym = wspr.encode_symbols("K1ABC", "FN42", 37)
    audio = wspr.modulate(sym, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS)
    assert wspr.decode(audio, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS,
                       search_offsets=0) == ("K1ABC", "FN42", 37)


# --- the min-sum decoder -----------------------------------------------------------------------


def _noisy_llrs(rng, form: str):
    info = rng.integers(0, 2, (16, 91)).astype(np.uint8)
    cw = fec.ldpc_encode(ft8.H, info)
    sign = 1.0 - 2.0 * cw.astype(np.float32)
    if form == "gaussian":
        return cw, (2.0 * sign + 1.6 * rng.standard_normal(cw.shape)).astype(np.float32)
    # integer LLRs with zeros: ties in every row's minimum, sign(0) in play
    return cw, (sign * rng.integers(0, 4, cw.shape)).astype(np.float32)


@pytest.mark.parametrize("iters", [10, 40])
@pytest.mark.parametrize("form", ["gaussian", "integer ties"])
def test_minsum_matches_jax(rng, form, iters):
    cw, llr = _noisy_llrs(rng, form)
    hj, oj = jfec.ldpc_decode_minsum(ft8.H, llr, iters=iters)
    ht, ot = fec.ldpc_decode_minsum(ft8.H, torch.from_numpy(llr), iters=iters)
    assert ht.dtype == torch.int8 and ot.dtype == torch.bool and ht.shape == (16, 174)
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    assert np.array_equal(ot.numpy(), np.asarray(oj))
    if form == "gaussian":
        assert 0 < int(ot.sum()) < 16  # some converge, some do not: both paths held
        assert np.array_equal(ht.numpy()[ot.numpy()], cw[ot.numpy()])


def test_minsum_corrects_flipped_bits():
    """tests/test_digital_modes.py's case and bar: 6 hard flips a codeword
    (inside this code's reliable radius), 40 iterations, its seed."""
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (8, 91)).astype(np.uint8)
    cw = fec.ldpc_encode(ft8.H, info)
    llr = 4.0 * (1.0 - 2.0 * cw.astype(np.float32))
    for b in range(8):
        llr[b, rng.choice(174, 6, replace=False)] *= -1.0
    hard, ok = fec.ldpc_decode_minsum(ft8.H, torch.from_numpy(llr), iters=40)
    assert bool(ok.all()) and np.array_equal(hard.numpy(), cw)


# --- FT8 on torch ------------------------------------------------------------------------------


def _batch(rng, complex_: bool, lead: int = 0):
    """The four messages at noise sigma 2, after ``lead`` samples of noise."""
    auds = np.stack([_ft8_audio(m, rng, 2.0) for m in FT8_MSGS])
    if complex_:  # an analytic form: the same tones with a quadrature partner
        auds = auds + 1j * np.stack([_ft8_audio(m, rng, 0.5) for m in FT8_MSGS])
    auds = np.concatenate([2.0 * rng.standard_normal((4, lead)), auds], axis=1)
    return auds.astype(np.complex64 if complex_ else np.float32)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_ft8_energies_and_llrs_match_jax(rng, complex_):
    x = _batch(rng, complex_, lead=96)
    basis = ft8.tone_basis(FT8_FS, FT8_F0, FT8_SPS)
    for start in (0, 96):
        ej = np.asarray(jft8.symbol_energies(x, basis, start, FT8_SPS))
        et = ft8.symbol_energies(x, basis, start, FT8_SPS, device="cpu")
        assert et.dtype == torch.float32 and et.shape == (4, 79, 8)
        np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-5 * np.abs(ej).max())
        lj = np.asarray(jft8.soft_bits(jnp.asarray(ej)))
        lt = ft8.soft_bits(torch.from_numpy(ej.copy())).numpy()
        assert lt.shape == (4, 174)
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4 * np.abs(lj).max())
        # the reference's sync_metric takes one channel's (79, 8) at a time
        np.testing.assert_allclose(ft8.sync_metric(torch.from_numpy(ej.copy())).numpy(),
                                   [float(jft8.sync_metric(jnp.asarray(e))) for e in ej],
                                   rtol=1e-6)


def test_ft8_decode_clean_and_noisy(rng):
    kw = dict(fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS, device="cpu")
    assert ft8.decode(_ft8_audio(FT8_MSGS[0]), **kw) == FT8_MSGS[0]
    assert ft8.decode(_ft8_audio(FT8_MSGS[2], rng, 2.0), **kw) == FT8_MSGS[2]
    assert ft8.decode(torch.from_numpy(_ft8_audio(FT8_MSGS[1], rng, 2.0)), fs=FT8_FS,
                      f0=FT8_F0, sps=FT8_SPS) == FT8_MSGS[1]
    with pytest.raises(TypeError, match="device="):
        ft8.decode(_ft8_audio(FT8_MSGS[0]), fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)


def test_ft8_batched_decode(rng):
    """Four noisy channels decode in one dense min-sum program."""
    basis = ft8.tone_basis(FT8_FS, FT8_F0, FT8_SPS)
    e = ft8.symbol_energies(_batch(rng, False), basis, 0, FT8_SPS, device="cpu")
    info, ok = ft8.decode_llrs(ft8.soft_bits(e))
    assert bool(ok.all()) and info.shape == (4, 91)
    for bits, msg in zip(info.numpy(), FT8_MSGS):
        assert ft8.unpack_message(bits[:77]) == msg
        assert int("".join(map(str, bits[77:])), 2) == ft8.crc14(bits[:77])


def test_ft8_sync_search_matches_jax(rng):
    pad = np.concatenate([0.1 * rng.standard_normal(FT8_SPS), _ft8_audio(FT8_MSGS[0])])
    kw = dict(fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS, time_steps=6, freq_steps=3)
    s, fhat, m = ft8.sync_search(pad, **kw, device="cpu")
    sj, fj, mj = jft8.sync_search(pad, **kw)
    assert (s, fhat) == (sj, fj) == (FT8_SPS, FT8_F0)
    assert abs(m - mj) <= 1e-6
    assert ft8.decode(pad, fs=FT8_FS, f0=FT8_F0, start=s, sps=FT8_SPS, device="cpu") == \
        FT8_MSGS[0]


# --- the table drop-in and the capabilities -----------------------------------------------------


def test_ft8_tables_dropin_flips_flag(tmp_path, monkeypatch):
    H = fec.ldpc_staircase(91, 83, col_weight=3, seed=7)
    np.savez(tmp_path / "ft8_tables.npz", ldpc_h=H, crc_poly=np.uint32(0x2757))
    monkeypatch.setattr(tables, "_DIR", str(tmp_path))
    try:
        mod = importlib.reload(ft8)
        assert mod.INTEROP_PROVISIONAL is True  # the packing needs ft8_kats.npz too
        assert mod.PROVISIONAL_ITEMS == ("77-bit packing offsets",)
        assert np.array_equal(mod.H, H) and mod._HP_INV is not None
        tones = mod.encode_symbols("CQ0ABC", "DE1XYZ", "JO62")
        audio = mod.modulate(tones, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
        assert mod.decode(audio, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS, device="cpu") == \
            ("CQ0ABC", "DE1XYZ", "JO62")
        np.savez(tmp_path / "ft8_kats.npz", call_to=np.array(["CQ"]))
        mod = importlib.reload(ft8)
        assert mod.INTEROP_PROVISIONAL is False and mod.PROVISIONAL_ITEMS == ()
    finally:
        monkeypatch.undo()
        importlib.reload(ft8)
    assert ft8.INTEROP_PROVISIONAL is True and np.array_equal(ft8.H, jft8.H)


def test_wspr_tables_dropin_flips_flag(tmp_path, monkeypatch, rng):
    sync = (rng.random(162) < 0.5).astype(np.uint8)
    np.savez(tmp_path / "wspr_tables.npz", sync=sync)
    monkeypatch.setattr(tables, "_DIR", str(tmp_path))
    try:
        mod = importlib.reload(wspr)
        assert mod.INTEROP_PROVISIONAL is False and mod.PROVISIONAL_ITEMS == ()
        assert np.array_equal(mod.SYNC, sync)
        audio = mod.modulate(mod.encode_symbols("K1ABC", "FN42", 37), fs=WSPR_FS, f0=WSPR_F0,
                             sps=WSPR_SPS)
        assert mod.decode(audio, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS, search_offsets=0) == \
            ("K1ABC", "FN42", 37)
    finally:
        monkeypatch.undo()
        importlib.reload(wspr)
    assert wspr.INTEROP_PROVISIONAL is True and np.array_equal(wspr.SYNC, jwspr.SYNC)


@pytest.mark.parametrize("name,arrays,match", [
    ("ft8_tables", dict(ldpc_h=np.zeros((83, 170), np.uint8), crc_poly=np.uint32(0x2757)),
     "shape"),
    ("ft8_tables", dict(ldpc_h=np.zeros((83, 174), np.uint8), crc_poly=np.uint32(0x2757)),
     "singular"),
    ("ft8_tables", dict(ldpc_h=fec.ldpc_staircase(91, 83, seed=7), crc_poly=np.uint32(1 << 14)),
     "14-bit"),
    ("wspr_tables", dict(sync=np.zeros(161, np.uint8)), "binary vector"),
    ("wspr_tables", dict(sync=np.full(162, 2, np.uint8)), "binary vector"),
])
def test_malformed_tables_raise(tmp_path, monkeypatch, name, arrays, match):
    np.savez(tmp_path / f"{name}.npz", **arrays)
    monkeypatch.setattr(tables, "_DIR", str(tmp_path))
    with pytest.raises(ValueError, match=match):
        getattr(tables, name)()
    assert tables.load_npz("absent") is None


def test_capabilities_match_reference():
    from radioframe.api.radio import Radio as JRadio
    from radioframe.core.config import RxConfig as JRxConfig
    from radioframe_torch.api.radio import Radio
    from radioframe_torch.core.config import RxConfig

    caps = Radio(RxConfig(channels=1), device="cpu").capabilities()
    assert caps == JRadio(JRxConfig(channels=1)).capabilities()
    assert caps["ft8"] and caps["wspr"] and "ft8_interop" in caps and "wspr_interop" in caps
