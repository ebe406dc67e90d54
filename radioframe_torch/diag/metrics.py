"""Scoring + observability helpers (the port's copy of
``radioframe/diag/metrics.py``; ``tests/test_torch_guards.py`` holds the
two equal).

The acceptance metric is "SNR delta vs reference audio" bounded at 1 dB
(BASELINE.json north_star; SURVEY.md §4.2 #3). ``audio_snr_db`` aligns delay
and gain before scoring so linear-phase filter latency doesn't count as error.
"""

from __future__ import annotations

import numpy as np


def align(ref: np.ndarray, out: np.ndarray, max_lag: int | None = None):
    """Find the lag of ``out`` relative to ``ref`` by cross-correlation.

    Returns (ref_trim, out_trim) of equal length, aligned.
    """
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    n = min(len(ref), len(out))
    if max_lag is None:
        max_lag = n // 2
    # FFT cross-correlation
    nfft = 1 << int(np.ceil(np.log2(len(ref) + len(out))))
    R = np.fft.rfft(ref, nfft)
    O = np.fft.rfft(out, nfft)
    xc = np.fft.irfft(R * np.conj(O), nfft)
    lags = np.concatenate([np.arange(0, max_lag), np.arange(-max_lag, 0)])
    vals = np.concatenate([xc[:max_lag], xc[-max_lag:]])
    lag = int(lags[np.argmax(np.abs(vals))])  # out[n] ~ ref[n + lag]
    if lag >= 0:
        ref_a, out_a = ref[lag:], out
    else:
        ref_a, out_a = ref, out[-lag:]
    m = min(len(ref_a), len(out_a))
    return ref_a[:m], out_a[:m]


def fractional_delay(x: np.ndarray, tau: float) -> np.ndarray:
    """Delay ``x`` by fractional ``tau`` samples via FFT linear phase."""
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    X = np.fft.rfft(x, nfft)
    f = np.fft.rfftfreq(nfft)
    y = np.fft.irfft(X * np.exp(-2j * np.pi * f * tau), nfft)
    return y[:n]


def _snr_of(r: np.ndarray, o: np.ndarray) -> float:
    g = np.dot(r, o) / max(np.dot(o, o), 1e-30)
    err = r - g * o
    p_sig, p_err = np.dot(r, r), np.dot(err, err)
    if p_err <= 0:
        return np.inf
    return float(10.0 * np.log10(max(p_sig, 1e-30) / p_err))


def audio_snr_db(ref: np.ndarray, out: np.ndarray, trim: int = 2048) -> float:
    """SNR of ``out`` vs ``ref`` after delay alignment and optimal gain.

    Alignment is sub-sample (decimation chains have fractional group delay at
    the output rate, e.g. an even-length CIC at 4x the audio rate); a golden
    chain would otherwise be unfairly scored ~19 dB from misalignment alone.
    ``trim`` samples are dropped at both ends (filter warm-up transients).
    """
    r, o = align(ref, out)
    if trim and len(r) > 2 * trim:
        r, o = r[trim:-trim], o[trim:-trim]
    if len(r) == 0:
        return -np.inf
    # refine over fractional lag in [-1, 1] (integer part already removed)
    taus = np.linspace(-1.0, 1.0, 41)
    snrs = [_snr_of(r, fractional_delay(o, t)) for t in taus]
    i = int(np.argmax(snrs))
    # local parabolic refinement
    best_t, best = taus[i], snrs[i]
    for t in np.linspace(best_t - 0.05, best_t + 0.05, 21):
        s = _snr_of(r, fractional_delay(o, t))
        if s > best:
            best_t, best = t, s
    return best


def power_db(x) -> float:
    x = np.asarray(x)
    return float(10.0 * np.log10(np.mean(np.abs(x) ** 2) + 1e-30))
