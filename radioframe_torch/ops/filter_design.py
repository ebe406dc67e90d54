"""Host-side filter design, pure numpy/scipy (the port's copy of the
functions of ``radioframe/ops/filter_design.py`` that the port calls;
``tests/test_torch_guards.py`` holds their taps equal to the originals').

All design happens on the host at config time; the device only ever sees
dense tap arrays.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import signal


def cic_equivalent_taps(R: int, N: int, M: int = 1, norm: bool = True) -> np.ndarray:
    """FIR taps identical to an N-stage CIC decimator: the N-fold
    convolution of a boxcar of length R*M (H(z) = ((1-z^-RM)/(1-z^-1))^N).

    Returns taps of length N*(R*M-1)+1, normalized to unit DC gain when
    ``norm`` (raw DC gain is (R*M)**N).
    """
    box = np.ones(R * M, dtype=np.float64)
    taps = functools.reduce(np.convolve, [box] * N)
    if norm:
        taps = taps / taps.sum()
    return taps


def cic_droop(freqs_norm: np.ndarray, R: int, N: int, M: int = 1) -> np.ndarray:
    """|H| of the (DC-normalized) CIC at normalized input freqs (cycles/sample)."""
    f = np.asarray(freqs_norm, dtype=np.float64)
    num = np.sinc(f * R * M)
    den = np.sinc(f)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(den) < 1e-30, 1.0, (num / den)) ** N
    return np.abs(h)


def lowpass_taps(numtaps: int, cutoff_hz: float, fs: float, window: str = "hamming") -> np.ndarray:
    """Linear-phase lowpass FIR (anti-alias / channel filter)."""
    return signal.firwin(numtaps, cutoff_hz, fs=fs, window=window).astype(np.float64)


def compensated_decim_taps(
    numtaps: int,
    fs_in: float,
    passband_hz: float,
    stopband_hz: float,
    cic_R: int,
    cic_N: int,
    cic_M: int = 1,
    cic_input_fs: float | None = None,
) -> np.ndarray:
    """Anti-alias decimation FIR with inverse-sinc CIC droop compensation:
    1/droop(f) in the passband (droop at the CIC's input rate), a linear
    ramp to 0 at ``stopband_hz``. ``cic_input_fs`` defaults to
    fs_in * cic_R (this FIR directly follows the CIC)."""
    if cic_input_fs is None:
        cic_input_fs = fs_in * cic_R
    npts = 512
    f = np.linspace(0.0, fs_in / 2.0, npts)
    gain = np.zeros(npts)
    pb = f <= passband_hz
    droop = cic_droop(f[pb] / cic_input_fs, cic_R, cic_N, cic_M)
    gain[pb] = 1.0 / np.maximum(droop, 1e-3)
    tr = (f > passband_hz) & (f < stopband_hz)
    if tr.any():
        edge_gain = gain[pb][-1] if pb.any() else 1.0
        gain[tr] = edge_gain * (1.0 - (f[tr] - passband_hz) / (stopband_hz - passband_hz))
    taps = signal.firwin2(numtaps, f, gain, fs=fs_in)
    return taps.astype(np.float64)


def complex_bandpass_taps(
    numtaps: int, f_lo: float, f_hi: float, fs: float, window: str = "hamming"
) -> np.ndarray:
    """One-sided (analytic) bandpass: a real lowpass of cutoff (f_hi-f_lo)/2
    modulated to (f_hi+f_lo)/2 passes only [f_lo, f_hi] of complex IQ."""
    bw = f_hi - f_lo
    fc = 0.5 * (f_hi + f_lo)
    proto = signal.firwin(numtaps, bw / 2.0, fs=fs, window=window)
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    return (proto * np.exp(2j * np.pi * fc * n / fs)).astype(np.complex128)


def real_bandpass_taps(numtaps: int, f_lo: float, f_hi: float, fs: float) -> np.ndarray:
    return signal.firwin(numtaps, [f_lo, f_hi], fs=fs, pass_zero=False).astype(np.float64)


def interp_taps(numtaps: int, L: int, fs_out: float, passband_hz: float) -> np.ndarray:
    """Interpolation (zero-stuff) anti-image FIR with gain L; the -6 dB
    cutoff sits midway between the passband and the first image edge."""
    image_edge = fs_out / L - passband_hz
    cutoff = 0.5 * (passband_hz + image_edge)
    return (L * signal.firwin(numtaps, cutoff, fs=fs_out)).astype(np.float64)


def compensated_interp_taps(
    numtaps: int,
    L: int,
    fs_out: float,
    passband_hz: float,
    cic_L: int,
    cic_N: int,
    cic_M: int = 1,
    cic_output_fs: float | None = None,
) -> np.ndarray:
    """Anti-image interpolation FIR with inverse-sinc pre-compensation for a
    downstream CIC interpolator (the mirror of compensated_decim_taps):
    passband gain L/droop(f), droop at the CIC's output rate, so the cascade
    is flat in-band. ``cic_output_fs`` defaults to fs_out * cic_L (the CIC
    directly follows)."""
    if cic_output_fs is None:
        cic_output_fs = fs_out * cic_L
    npts = 512
    f = np.linspace(0.0, fs_out / 2.0, npts)
    gain = np.zeros(npts)
    pb = f <= passband_hz
    droop = cic_droop(f[pb] / cic_output_fs, cic_L, cic_N, cic_M)
    gain[pb] = 1.0 / np.maximum(droop, 1e-3)
    image_edge = fs_out / L - passband_hz
    cutoff = 0.5 * (passband_hz + image_edge)
    tr = (f > passband_hz) & (f < cutoff)
    if tr.any():
        edge = gain[pb][-1] if pb.any() else 1.0
        gain[tr] = edge * (1.0 - (f[tr] - passband_hz) / (cutoff - passband_hz))
    taps = signal.firwin2(numtaps, f, gain, fs=fs_out)
    return (L * taps).astype(np.float64)


def peaking_eq_sos(bands, fs: float) -> np.ndarray:
    """RBJ-cookbook peaking-EQ biquad cascade for the TX mic equalizer.

    ``bands``: iterable of (center_hz, gain_db, Q). Returns the scipy sos
    layout (n_sections, 6) for ops/biquad.BiquadCascade."""
    sos = []
    for f0, gain_db, q in bands:
        A = 10.0 ** (gain_db / 40.0)
        w0 = 2.0 * np.pi * f0 / fs
        alpha = np.sin(w0) / (2.0 * q)
        c = np.cos(w0)
        b = np.array([1.0 + alpha * A, -2.0 * c, 1.0 - alpha * A])
        a = np.array([1.0 + alpha / A, -2.0 * c, 1.0 - alpha / A])
        sos.append(np.concatenate([b / a[0], a / a[0]]))  # a0-normalized sos
    return np.asarray(sos, dtype=np.float64)


def deemphasis_sos(tau_s: float, fs: float) -> np.ndarray:
    """FM de-emphasis one-pole lowpass (time constant tau, e.g. 531 us for
    amateur NFM) as a single sos section: y = (1-a) x + a y[n-1]."""
    a = float(np.exp(-1.0 / (fs * tau_s)))
    return np.asarray([[1.0 - a, 0.0, 0.0, 1.0, -a, 0.0]], dtype=np.float64)


def pfb_prototype_taps(num_channels: int, taps_per_channel: int,
                       window: str = "hamming") -> np.ndarray:
    """Prototype lowpass for a polyphase filterbank channelizer: cutoff at
    half a channel width (1/(2M) cycles/sample), length M*taps_per_channel,
    scaled to a DC gain of M."""
    M = num_channels
    numtaps = M * taps_per_channel
    taps = signal.firwin(numtaps, 1.0 / M, window=window)
    return (taps / taps.sum() * M).astype(np.float64)
