"""Guards on the port's boundaries: no JAX and nothing of the JAX package
behind any module of radioframe_torch, its root scripts or its example
scripts; the port's copies of the reference's host modules (configs,
presets, filter design, fixtures, metrics, the golden model, WAV I/O, the
band plan, the decoders, the native transport's C source, CAT's mode
tables, the digital modes' host halves and table loader) equal to their
originals; the kernel wrappers' CPU route; the
explicit device; the RxConfig options that the fused back end refuses, as
the reference's assertions do."""

import dataclasses
import os
import pkgutil
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import radioframe_torch
from radioframe.core import config as jcfg
from radioframe.core import presets as jpresets
from radioframe.diag import metrics as jmetrics
from radioframe.io import fixtures as jfx
from radioframe.ops import filter_design as jfd
from radioframe.pipelines import channelizer as jch
from radioframe.pipelines import rx_chain as jrx
from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import Radio
from radioframe_torch.core import config as tcfg
from radioframe_torch.core import presets as tpresets
from radioframe_torch.device import resolve
from radioframe_torch.diag import metrics as tmetrics
from radioframe_torch.io import fixtures as tfx
from radioframe_torch.kernels.channelizer_one import FusedChannelizerOne
from radioframe_torch.kernels.demod_agc import FusedDemodAgc
from radioframe_torch.kernels.fused_frontend import FusedFrontend
from radioframe_torch.kernels.ols_demod import FusedOlsDemod
from radioframe_torch.kernels.pfb_dft import FusedPfbDft
from radioframe_torch.ops import filter_design as tfd
from radioframe_torch.pipelines import channelizer as tch
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = tcfg.RxConfig(fs_in=1_536_000.0, channels=128,
                         stages=(tcfg.CicStage(R=8, N=4),
                                 tcfg.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                         ols_hop=512, fuse_frontend=True, fuse_frontend_depth=2,
                         enabled_modes=(0, 1, 2, 3))
PORT_MODULES = sorted(m.name for m in pkgutil.walk_packages(radioframe_torch.__path__,
                                                            "radioframe_torch."))
# the scripts at the root, the port's examples, and the rank bodies that spawned
# ranks import from tests/
PORT_MODULES += ["chip_smoke", "probe_channelizer", "probe_fft", "probe_frontend",
                 "examples.torch_rx_demo", "examples.torch_transceiver_demo",
                 "examples.torch_cat_tcp_demo", "examples.torch_channelizer_demo",
                 "examples.torch_duplex_demo", "examples.torch_golden_rx_demo",
                 "examples.torch_monitor_demo", "torch_shard_ranks"]


def _python(code: str, *args, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this guard checks the no-card behaviour")


# --- imports ------------------------------------------------------------------------------

_FOREIGN = ("import sys, importlib\n"
            "importlib.import_module(sys.argv[1])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('radioframe', 'jax', 'jaxlib'))\n"
            "print(','.join(bad) or 'clean')")


@pytest.fixture(scope="module")
def import_reports():
    """Each module imported alone in a fresh interpreter (four at a time):
    {module: (returncode, stdout, stderr)}."""
    def run(module):
        out = _python(_FOREIGN, module)
        return out.returncode, out.stdout.strip(), out.stderr[-2000:]
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(zip(PORT_MODULES, pool.map(run, PORT_MODULES)))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_module_imports_nothing_of_the_reference(import_reports, module):
    rc, out, err = import_reports[module]
    assert rc == 0 and out == "clean", (out, err)


@pytest.mark.parametrize("module", [
    "radioframe_torch.api.radio",
    "radioframe_torch.convert",
    "chip_smoke",
])
def test_import_pulls_in_no_jax(module):
    code = (f"import sys, {module}\n"
            "from radioframe_torch.pipelines.rx_chain import RxChain\n"
            "from radioframe_torch.core.config import CicStage, FirStage, RxConfig\n"
            "RxChain(RxConfig(fs_in=1_536_000.0, channels=128, stages=(CicStage(R=8, N=4),"
            " FirStage(R=4, numtaps=97, passband_hz=15_000.0)), fuse_frontend=True,"
            " fuse_frontend_depth=2))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('radioframe', 'jax', 'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')")
    out = _python(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# --- the port's copies of the reference's host modules --------------------------------------


def _value(v):
    """Dataclass instances (also inside tuples) as (class name, dict), so two
    packages' classes compare by value."""
    if dataclasses.is_dataclass(v):
        return type(v).__name__, dataclasses.asdict(v)
    return tuple(map(_value, v)) if isinstance(v, tuple) else v


def _fields(cls):
    """(name, default) of each field, default factories called."""
    out = []
    for f in dataclasses.fields(cls):
        d = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        out.append((f.name, _value(d)))
    return out


@pytest.mark.parametrize("name", ["CicStage", "FirStage", "AgcConfig", "ModeFilters",
                                  "RxConfig", "TxConfig", "MeshConfig", "ChannelizerConfig"])
def test_config_copies_match_reference(name):
    j = getattr(jch if name == "ChannelizerConfig" else jcfg, name)
    t = getattr(tch if name == "ChannelizerConfig" else tcfg, name)
    assert _fields(t) == _fields(j)
    for prop in ("decim", "fs_audio", "interp", "num_devices", "fs_channel"):
        if hasattr(j, prop) and name not in ("CicStage", "FirStage"):
            assert getattr(t(), prop) == getattr(j(), prop)
    assert [dataclasses.asdict(a) for a in tcfg.DEFAULT_AGC_MODES] == \
        [dataclasses.asdict(a) for a in jcfg.DEFAULT_AGC_MODES]


@pytest.mark.parametrize("fn,args", [
    ("cic_equivalent_taps", (8, 4, 1)),
    ("cic_equivalent_taps", (32, 4, 2)),
    ("lowpass_taps", (97, 15_000.0, 192_000.0)),
    ("compensated_decim_taps", (97, 192_000.0, 15_000.0, 21_600.0, 8, 4)),
    ("complex_bandpass_taps", (513, 300.0, 2700.0, 48_000.0)),
    ("real_bandpass_taps", (257, 300.0, 2700.0, 48_000.0)),
    ("interp_taps", (1025, 32, 1_536_000.0, 3000.0)),
    ("pfb_prototype_taps", (64, 8)),
    ("pfb_prototype_taps", (4096, 8, "hann")),
    ("compensated_interp_taps", (65, 8, 1_920_000.0, 21_600.0, 32, 4)),
    ("compensated_interp_taps", (65, 4, 192_000.0, 21_600.0, 8, 4, 1, 1_536_000.0)),
    ("peaking_eq_sos", (((300.0, 3.0, 1.0), (2500.0, 6.0, 2.0)), 48_000.0)),
    ("deemphasis_sos", (531e-6, 48_000.0)),
])
def test_filter_design_copy_matches_reference(fn, args):
    assert np.array_equal(getattr(tfd, fn)(*args), getattr(jfd, fn)(*args))


@pytest.mark.parametrize("preset,kw", [
    ("capture_192k", dict(channels=2)),
    ("wideband_1536k", dict(channels=64, fuse_frontend=True)),
    ("adc_61m44", {}),
    ("channelizer_61m44", dict(num_channels=4096)),
    ("channelizer_61m44", dict(num_channels=256, fused=False)),
    ("tx_adc_61m44", dict(channels=64)),
    ("tx_adc_61m44", dict(channels=8, mic_eq_bands=((300.0, 3.0, 1.0),))),
])
def test_preset_copies_match_reference(preset, kw):
    t, j = getattr(tpresets, preset)(**kw), getattr(jpresets, preset)(**kw)
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("capture,kw", [
    ("ssb_capture", dict(carrier_offset_hz=100_000.0, snr_db=30.0, seed=3)),
    ("cw_capture", dict(carrier_offset_hz=-50_000.0)),
    ("am_capture", dict(carrier_offset_hz=-200_000.0)),
    ("nfm_capture", dict(carrier_offset_hz=300_000.0, snr_db=20.0, seed=5)),
])
def test_fixture_copies_match_reference(capture, kw):
    (iq_t, truth_t), (iq_j, truth_j) = (getattr(fx, capture)(1_536_000.0, 32 * 1024, **kw)
                                        for fx in (tfx, jfx))
    assert np.array_equal(iq_t, iq_j) and np.array_equal(truth_t, truth_j)


def test_wav_copy_matches_reference(tmp_path, rng):
    """Each package reads what the other writes, the same bytes and values."""
    from radioframe.io import wav as jwav
    from radioframe_torch.io import wav as twav

    iq = (0.3 * (rng.standard_normal(999) + 1j * rng.standard_normal(999))).astype(np.complex64)
    mono = (0.4 * rng.standard_normal(777)).astype(np.float32)
    for data, fs, scale in ((iq, 192_000.0, None), (mono, 48_000.0, 1.0)):
        pt, pj = tmp_path / "t.wav", tmp_path / "j.wav"
        twav.write_wav(str(pt), data, fs, scale)
        jwav.write_wav(str(pj), data, fs, scale)
        assert pt.read_bytes() == pj.read_bytes()
        (xt, ft), (xj, fj) = twav.read_wav(str(pj)), jwav.read_wav(str(pt))
        assert ft == fj == fs and xt.dtype == xj.dtype and np.array_equal(xt, xj)


def test_band_plan_copy_matches_reference():
    from radioframe.api import bands as jbands
    from radioframe_torch.api import bands as tbands

    assert [dataclasses.astuple(b) for b in tbands.BAND_PLAN] == \
        [dataclasses.astuple(b) for b in jbands.BAND_PLAN]
    assert _fields(tbands.Band) == _fields(jbands.Band)


def test_cat_mode_tables_match_reference():
    from radioframe.api import cat as jcat
    from radioframe_torch.api import cat as tcat

    assert tcat.MODE_TO_DIGIT == jcat.MODE_TO_DIGIT
    assert tcat.DIGIT_TO_MODE == jcat.DIGIT_TO_MODE


def test_native_source_is_byte_equal():
    assert (ROOT / "radioframe_torch/native/iqtransport.c").read_bytes() == \
        (ROOT / "radioframe/native/iqtransport.c").read_bytes()


def test_decoders_copy_matches_reference():
    from radioframe.ops import decoders as jdec
    from radioframe_torch.ops import decoders as tdec

    fs = 8_000.0
    env = tdec.cw_encode_envelope("CQ DE TEST 5NN", fs, wpm=22.0)
    assert np.array_equal(env, jdec.cw_encode_envelope("CQ DE TEST 5NN", fs, wpm=22.0))
    tone = env * np.sin(2 * np.pi * 600.0 * np.arange(len(env)) / fs)
    assert tdec.cw_decode(tone, fs, 600.0) == jdec.cw_decode(tone, fs, 600.0) == "CQ DE TEST 5NN"
    assert np.array_equal(tdec.tone_envelope(tone, fs, 600.0), jdec.tone_envelope(tone, fs, 600.0))
    fsk = tdec.rtty_encode("RYRY 123", fs)
    assert np.array_equal(fsk, jdec.rtty_encode("RYRY 123", fs))
    assert tdec.rtty_decode(fsk, fs) == jdec.rtty_decode(fsk, fs)


@pytest.mark.parametrize("module", ["ops.fec", "ops.ft8", "ops.wspr", "data"])
def test_digital_modes_copies_match_reference(module):
    """The port's digital-mode modules have the reference's functions and
    module constants, equal (tests/test_torch_digital_modes.py holds the
    functions' outputs)."""
    import importlib
    import inspect

    j = importlib.import_module(f"radioframe.{module}")
    t = importlib.import_module(f"radioframe_torch.{module}")
    names = lambda m: sorted(n for n, f in inspect.getmembers(m, inspect.isfunction)  # noqa: E731
                             if f.__module__ == m.__name__)
    assert names(t) == names(j) or module == "ops.ft8" and set(names(t)) - set(names(j)) == {"_on"}
    consts = [n for n, v in vars(j).items() if n.isupper() and not n.startswith("_")
              and not inspect.ismodule(v)]
    for n in consts:
        a, b = getattr(t, n), getattr(j, n)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, n


_GOLDEN_CALLS = [
    ("nco_mix", lambda x, r: (x, 1234.5, 48_000.0, 0.3)),
    ("fir_state_init", lambda x, r: (r.standard_normal(17),)),
    ("fir_decimate", lambda x, r: (x, r.standard_normal(17), 3)),
    ("cic_decimate_integrator_comb", lambda x, r: (x.real, 4, 3)),
    ("cic_decimate", lambda x, r: (x, 4, 3)),
    ("ols_filter", lambda x, r: (x, r.standard_normal(33))),
    ("agc", lambda x, r: (x.real, 0.999)),
    ("agc_full", lambda x, r: (x.real, 0.999, 0.1, 8)),
    ("dc_block", lambda x, r: (x.real,)),
    ("demod_ssb", lambda x, r: (x,)),
    ("demod_cw", lambda x, r: (x, 600.0, 48_000.0)),
    ("demod_am", lambda x, r: (x,)),
    ("demod_sam", lambda x, r: (x, 48_000.0)),
    ("squelch", lambda x, r: (x.real,)),
    ("demod_nfm", lambda x, r: (x, 48_000.0, 2500.0)),
    ("mod_ssb", lambda x, r: (x.real, r.standard_normal(33) + 1j * r.standard_normal(33))),
    ("mod_am", lambda x, r: (x.real,)),
    ("mod_fm", lambda x, r: (x.real, 48_000.0, 2500.0)),
    ("interpolate", lambda x, r: (x, 4, r.standard_normal(33))),
    ("spectrum", lambda x, r: (x, 64)),
    ("pfb_channelize", lambda x, r: (x, 16, r.standard_normal(128))),
    ("spectral_nr", lambda x, r: (x,)),
    ("noise_blanker", lambda x, r: (x,)),
    ("auto_notch", lambda x, r: (x,)),
    ("vad_stream", lambda x, r: (x.real,)),
]


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(map(_eq, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_eq(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_golden_model_copy_matches_reference():
    """Every function of golden/model.py gives the same output as the
    reference's on the same inputs; the copy has the same functions."""
    import inspect

    from radioframe.golden import model as jg
    from radioframe_torch.golden import model as tg

    names = lambda m: sorted(n for n, f in inspect.getmembers(m, inspect.isfunction)  # noqa: E731
                             if f.__module__ == m.__name__)
    assert names(tg) == names(jg) and sorted(n for n, _ in _GOLDEN_CALLS) == names(tg)
    for name, make in _GOLDEN_CALLS:
        r = np.random.default_rng(17)
        x = r.standard_normal(1024) + 1j * r.standard_normal(1024)
        args = make(x, r)
        assert _eq(getattr(tg, name)(*args), getattr(jg, name)(*args)), name


def test_metrics_copy_matches_reference(rng):
    ref = rng.standard_normal(4096)
    out = np.roll(ref, 7) * 0.8 + 0.01 * rng.standard_normal(4096)
    assert tmetrics.audio_snr_db(ref, out) == jmetrics.audio_snr_db(ref, out)
    assert tmetrics.power_db(out) == jmetrics.power_db(out)
    assert np.array_equal(tmetrics.fractional_delay(ref, 0.3), jmetrics.fractional_delay(ref, 0.3))
    assert np.array_equal(tfx.voicelike_audio(48_000.0, 2048), jfx.voicelike_audio(48_000.0, 2048))


# --- kernel wrappers, devices, unported options ---------------------------------------------


def test_kernel_wrapper_takes_plain_route_on_cpu():
    chain = RxChain(dataclasses.replace(FLAGSHIP, channels=2))
    T = chain.min_block
    st = chain.init_state()
    st, audio, _ = chain.step(st, torch.ones((2, T), dtype=torch.complex64),
                              torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    assert audio.shape == (2, T // 32) and bool(torch.isfinite(audio).all())
    assert chain.fused.launches == 0


@pytest.mark.parametrize("kernel", ["pfb_dft", "demod_agc", "channelizer_one"])
def test_channelizer_wrappers_take_plain_route_on_cpu(rng, kernel):
    M, F = 32, 16
    x = torch.from_numpy(rng.standard_normal((2, F * M)).astype(np.float32))
    consts = (torch.arange(M, dtype=torch.int32) % 5, torch.full((M,), 99, dtype=torch.int32),
              torch.zeros(M, dtype=torch.int32), torch.full((M,), 0.999), torch.zeros(M),
              torch.full((M,), 0.5), torch.full((M,), 1e4))
    st = torch.zeros((7, M))
    if kernel == "pfb_dft":
        k = FusedPfbDft(M, 8)
        (yr, yi), tail = k.step_planes(k.init_state(1), x[0], x[1])
        out = (yr, yi, tail)
    elif kernel == "demod_agc":
        k = FusedDemodAgc(M, 15e3, 2500.0, wf_avg=4)
        out = k(x[0].reshape(F, M), x[1].reshape(F, M), *consts, st)
    else:
        k = FusedChannelizerOne(M, 8, 15e3, 2500.0, wf_avg=4)
        out = k.call_planes(k.init_tail(), x[0], x[1], *consts, st)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert k.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "pfb_dft":
            k.step_planes(k.init_state(1), x[0].to("meta"), x[1].to("meta"))
        elif kernel == "demod_agc":
            k(x[0].reshape(F, M).to("meta"), x[1].reshape(F, M).to("meta"), *consts, st)
        else:
            k.call_planes(k.init_tail(), x[0].to("meta"), x[1].to("meta"), *consts, st)


@pytest.mark.parametrize("kernel", ["fused_frontend", "ols_demod"])
def test_flagship_wrappers_take_plain_route_on_cpu(rng, kernel):
    """K2 and K6 take their plain versions for CPU tensors, count no launch
    there, and refuse a device that is neither."""
    C = 4
    if kernel == "fused_frontend":
        k = FusedFrontend(tfd.cic_equivalent_taps(8, 4, 1), 8)
        x = torch.from_numpy(rng.standard_normal((2, C, 1024)).astype(np.float32))
        w = torch.zeros(C, dtype=torch.int32)
        call = lambda a, b: k.step_planes(k.init_state(C), a, b, w)[1]  # noqa: E731
    else:
        k = FusedOlsDemod(1024, 512, C, 48_000.0, 2500.0, enabled=(0, 1, 2, 3))
        x = torch.from_numpy(rng.standard_normal((2, C, 1024)).astype(np.float32))
        ints = torch.arange(C, dtype=torch.int32) % 4
        consts = (ints, torch.full((C,), 99, dtype=torch.int32), torch.zeros(C, dtype=torch.int32),
                  torch.full((C,), 0.9999), torch.zeros(C), torch.full((C,), 0.5),
                  torch.full((C,), 1e4))
        call = lambda a, b: k(torch.zeros((C, 512), dtype=torch.complex64),  # noqa: E731
                              torch.complex(a, b), torch.ones((C, 1024), dtype=torch.complex64),
                              *consts, torch.zeros((7, C), device=a.device))[0]
    assert bool(torch.isfinite(call(x[0], x[1])).all())
    assert k.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        call(x[0].to("meta"), x[1].to("meta"))


def test_device_is_explicit():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radio(FLAGSHIP, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve("meta")
    with pytest.raises(TypeError):
        Radio(FLAGSHIP)  # no default device
    assert resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_transceiver_device_is_explicit():
    from radioframe_torch.api.transceiver import Transceiver

    rx, tx = tcfg.RxConfig(channels=2), tcfg.TxConfig(channels=2)
    with pytest.raises(TypeError):
        Transceiver(rx, tx)  # no default device
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transceiver(rx, tx, device="cuda")


def test_monitor_device_is_explicit():
    cfg = tpresets.channelizer_61m44(64)
    with pytest.raises(TypeError):
        Monitor(cfg)  # no default device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Monitor(cfg, device="cuda")
    assert Monitor(cfg, device="cpu").chain.device == torch.device("cpu")


@pytest.mark.parametrize("change,match", [
    (dict(nb_enabled=True), "nb_enabled"),
    (dict(nr_enabled=True), "nr_enabled"),
    (dict(notch_enabled=True), "notch_enabled"),
    (dict(vad_enabled=True), "vad_enabled"),
    (dict(nfm_deemphasis_s=531e-6), "nfm_deemphasis_s"),
    (dict(squelch_enabled=True), "squelch_enabled"),
])
def test_fused_backend_refuses_options(change, match):
    """Each option runs in the dense back end and is refused by the fused
    one (K6), as the reference's fuse_backend assertions refuse it."""
    chain = RxChain(dataclasses.replace(FLAGSHIP, channels=2, **change))
    assert chain.backend_kernel is None
    with pytest.raises(ValueError, match=f"fuse_backend: {match}"):
        RxChain(dataclasses.replace(FLAGSHIP, fuse_backend=True, **change))
    with pytest.raises(AssertionError, match="fuse_backend"):
        jrx.RxChain(dataclasses.replace(_jax_config(FLAGSHIP), fuse_backend=True, **change))


def _jax_config(cfg):
    """The reference's RxConfig with the same values as the port's ``cfg``."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["stages"] = tuple(getattr(jcfg, type(s).__name__)(**dataclasses.asdict(s))
                         for s in cfg.stages)
    kw["agc"] = jcfg.AgcConfig(**dataclasses.asdict(cfg.agc))
    kw["mode_filters"] = jcfg.ModeFilters(**dataclasses.asdict(cfg.mode_filters))
    return jcfg.RxConfig(**kw)


def test_sharded_biquads_are_ported():
    """shard/halo.py's sharded biquads run (one rank: the local scan)."""
    from radioframe_torch.ops.biquad import BiquadCascade
    from radioframe_torch.shard.halo import sharded_biquad, sharded_biquad_cascade

    class _One:
        size, index = 1, 0

    casc = BiquadCascade(tfd.deemphasis_sos(531e-6, 48_000.0))
    x = torch.ones((2, 64))
    y, st = sharded_biquad_cascade(casc, casc.init_state(2), x, _One())
    y_ref, st_ref = casc(casc.init_state(2), x)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    y1, _ = sharded_biquad(casc.sections[0], st_ref[0], x, _One())
    assert bool(torch.isfinite(y1).all())


def test_radio_unported_methods_raise(tmp_path):
    """No method of the port raises NotImplementedError any more: the
    digital modes' capabilities() and save/load under a mesh are ported
    (tests/test_torch_digital_modes.py, tests/test_torch_mesh_checkpoint.py);
    an unsharded save and load round-trip."""
    r = Radio(dataclasses.replace(FLAGSHIP, channels=2), device="cpu")
    assert r.waterfall() is None  # emit_spectrum off
    assert r.capabilities()["ft8"] and r.capabilities()["wspr"]
    assert r.load(r.save(str(tmp_path), epoch=3).rsplit(os.sep, 1)[0]) == 3
    raising = [str(p.relative_to(ROOT)) for p in (ROOT / "radioframe_torch").rglob("*.py")
               if "NotImplementedError" in p.read_text()]
    assert not raising, raising


def test_radio_capabilities_names_its_roadmap_item():
    """The reference's capabilities() names the digital modes' PROVISIONAL
    tables: the port's reads its own ft8/wspr modules and names the same
    items (the drop-in that clears them is ROADMAP's two-directory note)."""
    from radioframe_torch.ops import ft8, wspr
    from radioframe_torch.ops.demod import MODE_NAMES

    caps = Radio(dataclasses.replace(FLAGSHIP, channels=2), device="cpu").capabilities()
    assert caps["modes"] == sorted(dict(MODE_NAMES))
    for key, mod in (("ft8_interop", ft8), ("wspr_interop", wspr)):
        assert (key in caps) == mod.INTEROP_PROVISIONAL
        if key in caps:
            assert caps[key] == "PROVISIONAL: " + ", ".join(mod.PROVISIONAL_ITEMS)



def test_chip_smoke_fails_without_card():
    _no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available() is false" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
