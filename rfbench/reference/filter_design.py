"""Filter design for the plain references, in numpy and scipy: a frozen copy
of the design functions that the measured configurations use, so that the
reference derives every tap from the configuration without importing the
program.

Taps are float64 (complex128 for the analytic band-passes).
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import signal


def cic_equivalent_taps(R: int, N: int, M: int = 1) -> np.ndarray:
    """The N-stage CIC decimator as a FIR: the N-fold convolution of a boxcar
    of R*M ones, scaled to unit DC gain (length N*(R*M-1)+1)."""
    box = np.ones(R * M, dtype=np.float64)
    taps = functools.reduce(np.convolve, [box] * N)
    return taps / taps.sum()


def cic_droop(freqs_norm: np.ndarray, R: int, N: int, M: int = 1) -> np.ndarray:
    """|H| of the DC-normalised CIC at normalised input frequencies."""
    f = np.asarray(freqs_norm, dtype=np.float64)
    num = np.sinc(f * R * M)
    den = np.sinc(f)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(den) < 1e-30, 1.0, num / den) ** N
    return np.abs(h)


def compensated_decim_taps(numtaps: int, fs_in: float, passband_hz: float,
                           stopband_hz: float, cic_R: int, cic_N: int,
                           cic_M: int = 1) -> np.ndarray:
    """Decimation FIR after a CIC: 1/droop in the passband (the droop at the
    CIC's input rate fs_in * cic_R), a linear ramp to 0 at the stopband."""
    cic_input_fs = fs_in * cic_R
    npts = 512
    f = np.linspace(0.0, fs_in / 2.0, npts)
    gain = np.zeros(npts)
    pb = f <= passband_hz
    gain[pb] = 1.0 / np.maximum(cic_droop(f[pb] / cic_input_fs, cic_R, cic_N, cic_M), 1e-3)
    tr = (f > passband_hz) & (f < stopband_hz)
    if tr.any():
        edge = gain[pb][-1] if pb.any() else 1.0
        gain[tr] = edge * (1.0 - (f[tr] - passband_hz) / (stopband_hz - passband_hz))
    return signal.firwin2(numtaps, f, gain, fs=fs_in).astype(np.float64)


def lowpass_taps(numtaps: int, cutoff_hz: float, fs: float) -> np.ndarray:
    """Linear-phase Hamming low-pass."""
    return signal.firwin(numtaps, cutoff_hz, fs=fs, window="hamming").astype(np.float64)


def complex_bandpass_taps(numtaps: int, f_lo: float, f_hi: float, fs: float) -> np.ndarray:
    """Analytic band-pass that passes [f_lo, f_hi] of complex IQ: a Hamming
    low-pass of cutoff (f_hi - f_lo)/2 moved to the band's centre."""
    proto = signal.firwin(numtaps, (f_hi - f_lo) / 2.0, fs=fs, window="hamming")
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    return (proto * np.exp(2j * np.pi * 0.5 * (f_hi + f_lo) * n / fs)).astype(np.complex128)


def pfb_prototype_taps(num_channels: int, taps_per_channel: int) -> np.ndarray:
    """The polyphase filterbank's prototype: a Hamming low-pass cut at half a
    channel, M*K taps, scaled to a DC gain of M."""
    M = num_channels
    taps = signal.firwin(M * taps_per_channel, 1.0 / M, window="hamming")
    return taps / taps.sum() * M
