"""radioframe_torch.ops against radioframe.ops on the same numpy inputs:
NCO, scans, FIR/CIC decimators, the OLS bank, the demod bank and the AGC."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import config as jcfg
from radioframe.ops import agc as j_agc
from radioframe.ops import demod as j_demod
from radioframe.ops import filter_design as FD
from radioframe.ops import fir as j_fir
from radioframe.ops import nco as j_nco
from radioframe.ops import ols as j_ols
from radioframe.ops import scans as j_scans
from radioframe_torch.core import config as tcfg
from radioframe_torch.ops import agc as t_agc
from radioframe_torch.ops import demod as t_demod
from radioframe_torch.ops import fir as t_fir
from radioframe_torch.ops import nco as t_nco
from radioframe_torch.ops import ols as t_ols
from radioframe_torch.ops import scans as t_scans

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iq(rng, C, T):
    return (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)


class TestNco:
    def test_freq_word_matches_reference(self):
        f = np.linspace(-7.9e5, 7.9e5, 41)
        np.testing.assert_array_equal(t_nco.freq_word(f, 1.536e6), j_nco.freq_word(f, 1.536e6))

    @pytest.mark.parametrize("fs", [192_000.0, 1.536e6])
    def test_word_to_freq_matches_reference(self, rng, fs):
        words = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 32, dtype=np.int64),
                                [-2 ** 31, -1, 0, 1, 2 ** 31 - 1]]).astype(np.int32)
        np.testing.assert_array_equal(t_nco.word_to_freq(words, fs), j_nco.word_to_freq(words, fs))
        f = np.linspace(-0.49 * fs, 0.49 * fs, 17)
        np.testing.assert_allclose(t_nco.word_to_freq(t_nco.freq_word(f, fs), fs), f,
                                   atol=fs / 2.0 ** 32)

    @pytest.mark.parametrize("T", [4096, 1000])  # factorized form, direct form
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_osc(self, rng, T, sign):
        word = rng.integers(-2 ** 31, 2 ** 31, size=6).astype(np.int32)
        acc = rng.integers(-2 ** 31, 2 ** 31, size=6).astype(np.int32)
        got = t_nco._osc(_t(word), _t(acc), T, sign).numpy()
        want = np.asarray(jax.jit(j_nco._osc, static_argnums=(2, 3))(
            jnp.asarray(word), jnp.asarray(acc), T, sign))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_mix_down_up_acc_wraps_bit_exact(self, rng):
        # words near +-2^31 and a long block: acc + word*T wraps many times
        word = np.array([2 ** 31 - 1, -2 ** 31, 123456789, -987654321], np.int32)
        acc = np.array([2 ** 31 - 5, -2 ** 31 + 3, 0, 17], np.int32)
        x = _iq(rng, 4, 2048)
        for t_fn, j_fn in ((t_nco.mix_down, j_nco.mix_down), (t_nco.mix_up, j_nco.mix_up)):
            y_t, acc_t = t_fn(_t(x), _t(word), _t(acc))
            y_j, acc_j = j_fn(jnp.asarray(x), jnp.asarray(word), jnp.asarray(acc))
            assert acc_t.dtype == torch.int32
            np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)

    @pytest.mark.parametrize("offset", [0, 3 * 2048, 2 ** 20 + 7])
    def test_mix_at_offset_matches_reference(self, rng, offset):
        """mix_down_at/mix_up_at (the time-sharded chain's oscillator segment)
        against the reference's, the offset wrapping the accumulator; the
        segment at offset k equals samples k.. of one unsharded mix."""
        word = np.array([2 ** 31 - 1, -2 ** 31, 123456789, -987654321], np.int32)
        acc = np.array([2 ** 31 - 5, -2 ** 31 + 3, 0, 17], np.int32)
        x = _iq(rng, 4, 2048)
        for t_fn, j_fn in ((t_nco.mix_down_at, j_nco.mix_down_at),
                           (t_nco.mix_up_at, j_nco.mix_up_at)):
            y_t = t_fn(_t(x), _t(word), _t(acc), offset)
            y_j = j_fn(jnp.asarray(x), jnp.asarray(word), jnp.asarray(acc), jnp.int32(offset))
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        whole, _ = t_nco.mix_down(_t(np.concatenate([x, x], axis=-1)), _t(word), _t(acc))
        seg = t_nco.mix_down_at(_t(x), _t(word), _t(acc), 2048)
        np.testing.assert_allclose(seg.numpy(), whole.numpy()[:, 2048:], atol=1e-5)


class TestScans:
    def test_generic_affine_and_maxdecay(self, rng):
        a = rng.uniform(0.5, 1.0, (3, 777)).astype(np.float32)
        b = rng.standard_normal((3, 777)).astype(np.float32)
        v = np.abs(b)
        s0 = rng.standard_normal(3).astype(np.float32)
        got = t_scans.affine_scan(_t(a), _t(b), _t(s0)).numpy()
        want = np.asarray(jax.jit(j_scans.affine_scan)(jnp.asarray(a), jnp.asarray(b),
                                                       jnp.asarray(s0)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        got = t_scans.maxdecay_scan(_t(a), _t(v), _t(np.abs(s0))).numpy()
        want = np.asarray(jax.jit(j_scans.maxdecay_scan)(jnp.asarray(a), jnp.asarray(v),
                                                         jnp.asarray(np.abs(s0))))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("T", [1024, 200])  # chunked path, fallback path
    def test_const_affine(self, rng, T):
        a = np.array([0.0, 0.95, 0.995, 0.9999], np.float32)
        b = rng.standard_normal((4, T)).astype(np.float32)
        s0 = rng.standard_normal(4).astype(np.float32)
        assert t_scans.affine_const_ok(a) == j_scans.affine_const_ok(a) is True
        got = t_scans.affine_scan_const(_t(a), _t(b), _t(s0)).numpy()
        want = np.asarray(jax.jit(j_scans.affine_scan_const)(jnp.asarray(a), jnp.asarray(b),
                                                             jnp.asarray(s0)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_const_maxdecay(self, rng):
        a = np.array([0.9999, 0.99995, 0.99999], np.float32)
        v = np.abs(rng.standard_normal((3, 2048))).astype(np.float32)
        s0 = np.array([5.0, 0.0, 1.0], np.float32)
        assert t_scans.maxdecay_const_ok(a, 2048) == j_scans.maxdecay_const_ok(a, 2048) is True
        assert t_scans.maxdecay_const_ok([0.9], 2048) == j_scans.maxdecay_const_ok([0.9], 2048)
        got = t_scans.maxdecay_scan_const(_t(a), _t(v), _t(s0)).numpy()
        want = np.asarray(jax.jit(j_scans.maxdecay_scan_const)(jnp.asarray(a), jnp.asarray(v),
                                                               jnp.asarray(s0)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestFir:
    @pytest.mark.parametrize("kind", ["real", "complex", "cic"])
    def test_streaming_decimator(self, rng, kind):
        if kind == "real":
            taps, R = FD.lowpass_taps(97, 15_000.0, 192_000.0), 4
        elif kind == "complex":
            taps, R = FD.complex_bandpass_taps(65, 300.0, 2700.0, 48_000.0), 2
        else:
            taps, R = None, 8
        dj = j_fir.cic_decimator(8, 4) if taps is None else j_fir.FirDecimator(taps, R)
        dt = t_fir.cic_decimator(8, 4) if taps is None else t_fir.FirDecimator(taps, R)
        tail_t, tail_j = dt.init_state(3), dj.init_state(3)
        assert tuple(tail_t.shape) == tuple(tail_j.shape)
        for _ in range(3):
            x = _iq(rng, 3, 1024)
            y_t, tail_t = dt(tail_t, _t(x))
            y_j, tail_j = dj(tail_j, jnp.asarray(x))
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-6)
            np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))


class TestOls:
    def _taps(self):
        fa = 48_000.0
        return [FD.complex_bandpass_taps(513, 300.0, 2700.0, fa),
                FD.complex_bandpass_taps(513, -250.0, 250.0, fa),
                FD.complex_bandpass_taps(513, -5000.0, 5000.0, fa),
                FD.complex_bandpass_taps(513, -8000.0, 8000.0, fa),
                FD.complex_bandpass_taps(513, -2700.0, -300.0, fa)]

    def test_bank_and_apply_selected(self, rng):
        bj = j_ols.OverlapSaveBank(self._taps(), hop=512)
        bt = t_ols.OverlapSaveBank(self._taps(), hop=512)
        assert (bt.nfft, bt.hop) == (bj.nfft, bj.hop) == (1024, 512)
        row = np.array([0, 1, 2, 3, 4, 2], np.int32)
        st_t, st_j = bt.init_state(6), bj.init_state(6)
        for _ in range(2):
            x = _iq(rng, 6, 2048)
            y_t, _ = bt(st_t, _t(x))
            y_j, _ = bj(st_j, jnp.asarray(x))
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)
            y_t, st_t = bt.apply_selected(st_t, _t(x), _t(row))
            y_j, st_j = bj.apply_selected(st_j, jnp.asarray(x), jnp.asarray(row))
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)
            np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))

    def test_single_filter_streaming(self, rng):
        taps = FD.complex_bandpass_taps(129, -5000.0, 5000.0, 48_000.0)
        fj, ft = j_ols.OverlapSave(taps), t_ols.OverlapSave(taps)
        assert ft.hop == fj.hop
        x = _iq(rng, 2, 4 * ft.hop)
        y_t, _ = ft(ft.init_state(2), _t(x))
        y_j, _ = fj(fj.init_state(2), jnp.asarray(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)


class TestDemod:
    @pytest.mark.parametrize("enabled", [None, (0, 1, 2, 3)])
    def test_bank_apply_all_modes(self, rng, enabled):
        C, T, fs = 12, 1024, 48_000.0
        mode = np.arange(C, dtype=np.int32) % 6
        cw_word = np.full(C, j_nco.freq_word(600.0, fs), np.int32)
        st_t, st_j = t_demod.bank_init(C, "cpu"), j_demod.bank_init(C)
        j_bank = jax.jit(functools.partial(j_demod.bank_apply, fs=fs, nfm_deviation_hz=2500.0,
                                           enabled=enabled))
        for blk in range(3):
            x = (0.3 * _iq(rng, C, T) + 1.0).astype(np.complex64)  # carrier + noise
            a_t, st_t = t_demod.bank_apply(st_t, _t(x), _t(mode), _t(cw_word), fs, 2500.0,
                                           enabled=enabled)
            a_j, st_j = j_bank(st_j, jnp.asarray(x), jnp.asarray(mode), jnp.asarray(cw_word))
            np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=2e-4, rtol=1e-4)
            for k in st_j:
                np.testing.assert_allclose(_n(st_t[k]), np.asarray(st_j[k]), atol=1e-4,
                                           err_msg=k)
        np.testing.assert_array_equal(t_demod.filter_index(_t(mode)).numpy(),
                                      np.asarray(j_demod.filter_index(jnp.asarray(mode))))

    def test_dc_block_and_squelch(self, rng):
        x = rng.standard_normal((3, 512)).astype(np.float32) + 2.0
        st = rng.standard_normal((2, 3)).astype(np.float32)
        y_t, s_t = t_demod.dc_block(_t(st), _t(x))
        y_j, s_j = jax.jit(j_demod.dc_block)(jnp.asarray(st), jnp.asarray(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-4)
        noise = np.array([0.1, 2.0, 0.4], np.float32)
        g_t, n_t, o_t = t_demod.squelch(_t(noise), _t(x), 0.5)
        g_j, n_j, o_j = j_demod.squelch(jnp.asarray(noise), jnp.asarray(x), 0.5)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j))
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-6)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))

    @pytest.mark.parametrize("T", [1024, 100])
    def test_exp_neg_affine(self, rng, T):
        a = rng.uniform(-3, 3, 4).astype(np.float32)
        w = rng.uniform(-0.2, 0.2, 4).astype(np.float32)
        got = t_demod._exp_neg_affine(_t(a), _t(w), T).numpy()
        want = np.asarray(j_demod._exp_neg_affine(jnp.asarray(a), jnp.asarray(w), T))
        np.testing.assert_allclose(got, want, atol=2e-5)


class TestAgc:
    @pytest.mark.parametrize("modes_cfg", ["per_mode", "single"])
    def test_bank_streaming(self, rng, modes_cfg):
        fs = 48_000.0
        bj, bt = (mod.AgcBank(cfg.DEFAULT_AGC_MODES if modes_cfg == "per_mode"
                              else (cfg.AgcConfig(),) * 6, fs)
                  for mod, cfg in ((j_agc, jcfg), (t_agc, tcfg)))
        assert bt.distinct_W == bj.distinct_W and bt.hist_len == bj.hist_len
        C, T = 12, 1024
        mode = np.arange(C, dtype=np.int32) % 6
        st_t, st_j = bt.init_state(C), bj.init_state(C)
        j_apply = jax.jit(bj.apply)
        for blk in range(3):
            # bursts then quiet: exercises attack, hang hold and release
            amp = np.where(np.arange(T) < T // 3, 1.0, 0.05) * (blk + 1)
            x = (rng.standard_normal((C, T)) * amp).astype(np.float32)
            y_t, st_t, g_t = bt(st_t, _t(x), _t(mode))
            y_j, st_j, g_j = j_apply(st_j, jnp.asarray(x), jnp.asarray(mode))
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4)
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)
            for k in ("env", "lpf"):
                np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]), rtol=1e-5)
            if bt.hist_len:
                np.testing.assert_array_equal(st_t["hist"].numpy(), np.asarray(st_j["hist"]))
            else:
                assert st_t["hist"] == () and st_j["hist"] == ()

    def test_tables_and_helpers(self):
        bj = j_agc.AgcBank(jcfg.DEFAULT_AGC_MODES, 48e3)
        bt = t_agc.AgcBank(tcfg.DEFAULT_AGC_MODES, 48e3)
        for k in ("release", "alpha", "target", "max_gain"):
            np.testing.assert_array_equal(getattr(bt, k).numpy(), getattr(bj, k))
        np.testing.assert_array_equal(bt.win_index.numpy(), bj.win_index)
        assert t_agc.release_decay(0.5, 48e3) == j_agc.release_decay(0.5, 48e3)
        assert t_agc.attack_alpha(0.002, 48e3) == j_agc.attack_alpha(0.002, 48e3)
        assert t_agc.hang_samples(0.02, 48e3) == j_agc.hang_samples(0.02, 48e3)

    @pytest.mark.parametrize("W", [1, 7, 64, 300])
    def test_sliding_max(self, rng, W):
        T = 256
        xp = rng.standard_normal((3, T + W - 1)).astype(np.float32)
        got = t_agc.sliding_max(_t(xp), T, W).numpy()
        want = np.asarray(j_agc.sliding_max(jnp.asarray(xp), T, W))
        np.testing.assert_array_equal(got, want)

    def test_module_apply(self, rng):
        x = (rng.standard_normal((3, 2048)) * 0.3).astype(np.float32)
        env0 = np.array([0.0, 0.5, 2.0], np.float32)
        for decay in (0.9999, 0.9):  # const path, generic path
            y_t, e_t, g_t = t_agc.apply(_t(env0), _t(x), decay, 0.5)
            y_j, e_j, g_j = jax.jit(j_agc.apply, static_argnums=(2, 3))(
                jnp.asarray(env0), jnp.asarray(x), decay, 0.5)
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
