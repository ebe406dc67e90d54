"""Deterministic synthetic IQ fixtures (the port's copy of
``radioframe/io/fixtures.py`` on the port's copy of the golden model;
``tests/test_torch_guards.py`` holds the captures equal to the originals').

Each capture generator returns (iq, truth), truth being the clean
modulating audio (or keying envelope) for SNR scoring. Pure numpy/scipy.
"""

from __future__ import annotations

import numpy as np

from radioframe_torch.golden.model import (fir_decimate, interpolate, mod_am, mod_fm,
                                           mod_ssb, nco_mix)
from radioframe_torch.ops import filter_design as FD

# --- captures ------------------------------------------------------------------


def _rng(seed):
    return np.random.default_rng(seed)


def add_noise(iq: np.ndarray, snr_db: float, seed: int = 0) -> np.ndarray:
    """Complex AWGN at given SNR relative to iq's mean power."""
    r = _rng(seed)
    p_sig = np.mean(np.abs(iq) ** 2)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    n = np.sqrt(p_noise / 2.0) * (r.standard_normal(len(iq)) + 1j * r.standard_normal(len(iq)))
    return iq + n


def tone_audio(fs: float, n: int, freqs=(700.0, 1900.0), amps=(0.5, 0.35)) -> np.ndarray:
    t = np.arange(n) / fs
    a = np.zeros(n)
    for f, amp in zip(freqs, amps):
        a += amp * np.sin(2.0 * np.pi * f * t)
    return a


def voicelike_audio(fs: float, n: int, seed: int = 1) -> np.ndarray:
    """Band-limited (300–2700 Hz) noise — a stand-in for speech."""
    r = _rng(seed)
    w = r.standard_normal(n + 512)
    taps = FD.real_bandpass_taps(257, 300.0, 2700.0, fs)
    y, _ = fir_decimate(w.astype(np.complex128), taps, 1)
    y = np.real(y[512:])
    return 0.5 * y / (np.max(np.abs(y)) + 1e-12)


def ssb_capture(fs_iq: float, n_iq: int, carrier_offset_hz: float,
                audio: np.ndarray | None = None, fs_audio: float = 48000.0,
                snr_db: float | None = None, seed: int = 0):
    """USB SSB signal at +carrier_offset_hz inside an fs_iq-wide IQ capture:
    audio -> one-sided complex BPF (300..2700) -> interpolate to fs_iq -> mix
    up to the offset. Returns (iq, audio_truth)."""
    L = int(round(fs_iq / fs_audio))
    if abs(L * fs_audio - fs_iq) >= 1e-6:
        raise ValueError("fs_iq must be an integer multiple of fs_audio")
    n_audio = n_iq // L
    if audio is None:
        audio = tone_audio(fs_audio, n_audio)
    audio = audio[:n_audio]
    bpf = FD.complex_bandpass_taps(257, 300.0, 2700.0, fs_audio)
    analytic, _ = mod_ssb(audio, bpf)
    itaps = FD.interp_taps(32 * L + 1, L, fs_iq, 3000.0)
    up, _ = interpolate(analytic, L, itaps)
    iq, _ = nco_mix(up, -carrier_offset_hz, fs_iq)  # mix UP to the offset
    iq = iq[:n_iq]
    if snr_db is not None:
        iq = add_noise(iq, snr_db, seed)
    return iq, audio


def cw_capture(fs_iq: float, n_iq: int, carrier_offset_hz: float, wpm: float = 20.0,
               snr_db=None, seed=0):
    """On-off keyed carrier at +offset; returns (iq, keying_envelope@fs_iq)."""
    dit = int(fs_iq * 1.2 / wpm)  # PARIS timing: dit = 1.2/wpm seconds
    pattern = []  # 'CQ' in morse: -.-. --.-
    for sym in "-.-. --.-":
        if sym == ".":
            pattern += [1] * dit + [0] * dit
        elif sym == "-":
            pattern += [1] * (3 * dit) + [0] * dit
        else:
            pattern += [0] * (2 * dit)
    env = np.array((pattern * (n_iq // max(len(pattern), 1) + 1))[:n_iq], dtype=np.float64)
    edge = max(int(0.005 * fs_iq), 1)  # raised-cosine key shaping (5 ms)
    kernel = 0.5 * (1 - np.cos(np.pi * np.arange(1, edge + 1) / edge))
    kernel = np.diff(np.concatenate([[0.0], kernel]))
    shaped = np.clip(np.convolve(env, kernel, mode="same"), 0.0, 1.0)
    iq, _ = nco_mix(shaped.astype(np.complex128), -carrier_offset_hz, fs_iq)
    if snr_db is not None:
        iq = add_noise(iq, snr_db, seed)
    return iq, shaped


def am_capture(fs_iq, n_iq, carrier_offset_hz, audio=None, fs_audio=48000.0, depth=0.8,
               snr_db=None, seed=0):
    L = int(round(fs_iq / fs_audio))
    n_audio = n_iq // L
    if audio is None:
        audio = tone_audio(fs_audio, n_audio, freqs=(600.0,), amps=(0.8,))
    audio = audio[:n_audio]
    base = mod_am(audio, depth)
    itaps = FD.interp_taps(32 * L + 1, L, fs_iq, 4000.0)
    up, _ = interpolate(base, L, itaps)
    iq, _ = nco_mix(up, -carrier_offset_hz, fs_iq)
    iq = iq[:n_iq]
    if snr_db is not None:
        iq = add_noise(iq, snr_db, seed)
    return iq, audio


def nfm_capture(fs_iq, n_iq, carrier_offset_hz, audio=None, fs_audio=48000.0,
                deviation_hz=2500.0, snr_db=None, seed=0):
    L = int(round(fs_iq / fs_audio))
    n_audio = n_iq // L
    if audio is None:
        audio = tone_audio(fs_audio, n_audio, freqs=(1000.0,), amps=(0.7,))
    audio = audio[:n_audio]
    # FM modulate at audio rate then interpolate (deviation << fs_audio/2)
    base, _ = mod_fm(audio, fs_audio, deviation_hz)
    itaps = FD.interp_taps(32 * L + 1, L, fs_iq, 8000.0)
    up, _ = interpolate(base, L, itaps)
    iq, _ = nco_mix(up, -carrier_offset_hz, fs_iq)
    iq = iq[:n_iq]
    if snr_db is not None:
        iq = add_noise(iq, snr_db, seed)
    return iq, audio
