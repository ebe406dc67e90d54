"""Demodulators (SSB/CW/AM/NFM/SAM) + DC blocker + squelch, batched over
channels (counterpart of ``radioframe/ops/demod.py``).

The demod bank evaluates every enabled mode densely and selects per channel
by a masked sum, so one program serves mixed-mode channel populations with
no data-dependent control flow. Per-sample recursions use ops/scans.py.
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.ops import nco
from radioframe_torch.ops.scans import affine_const_ok, affine_scan, affine_scan_const

# mode codes (used as per-channel selector in the bank)
SSB, CW, AM, NFM, LSB, SAM = 0, 1, 2, 3, 4, 5
MODE_NAMES = {"ssb": SSB, "usb": SSB, "cw": CW, "am": AM, "nfm": NFM,
              "lsb": LSB, "sam": SAM}
DC_POLE = 0.995  # the AM/SAM DC block's pole (kDcPole in kernels/csrc/channelizer.cuh)


# --- DC blocker ------------------------------------------------------------


def dc_block_init(num_channels: int, device) -> torch.Tensor:
    # state: (x_prev, y_prev) per channel
    return torch.zeros((2, num_channels), dtype=torch.float32, device=device)


def dc_block(state, x, pole: float = DC_POLE):
    """y[n] = x[n] - x[n-1] + pole*y[n-1] on (C, T) real blocks."""
    xprev = torch.cat([state[0][:, None], x[:, :-1]], dim=-1)
    b = x - xprev
    if affine_const_ok([pole]):  # static — pole is a python float
        y = affine_scan_const(torch.full(x.shape[:-1], pole, dtype=torch.float32,
                                         device=x.device), b, state[1])
    else:
        y = affine_scan(torch.full_like(x, pole), b, state[1])
    return y, torch.stack([x[:, -1], y[:, -1]])


# --- individual demods -----------------------------------------------------


def demod_ssb(x):
    return 2.0 * x.real


_EXP_GROUP = 64


def _exp_neg_affine(a, w, T: int):
    """e^{-j(a + w·n)} for n in [0, T), float phases, factorized into coarse x
    fine grids (T/K + K sin/cos per channel); the coarse phase is wrapped
    mod 2π before cos/sin."""
    C = int(torch.broadcast_shapes(a.shape, w.shape)[0])
    K = _EXP_GROUP
    dev = a.device

    def cis_neg(ang):
        return torch.complex(torch.cos(ang), -torch.sin(ang))

    if T % K != 0 or T < 2 * K:
        n = torch.arange(T, dtype=torch.float32, device=dev)
        return cis_neg(a[:, None] + w[:, None] * n[None, :])
    M = T // K
    m = torch.arange(M, dtype=torch.float32, device=dev)
    k = torch.arange(K, dtype=torch.float32, device=dev)
    coarse = torch.remainder(a[:, None] + (w * K)[:, None] * m[None, :],
                             float(np.float32(2.0 * np.pi)))
    fine = w[:, None] * k[None, :]
    return (cis_neg(coarse)[:, :, None] * cis_neg(fine)[:, None, :]).reshape(C, T)


def demod_cw(phase_acc, x, tone_word):
    """Beat-tone shift via the DDS NCO (mix *up* by tone_hz); returns (y, acc)."""
    y, acc = nco.mix_up(x, tone_word, phase_acc)
    return 2.0 * y.real, acc


def demod_am(dc_state, x, pole: float = DC_POLE):
    return dc_block(dc_state, torch.abs(x), pole)


def demod_sam(dc_state, carrier_acc, x, fs: float):
    """Synchronous AM: block-wise carrier recovery + coherent detection.

    The residual carrier is the angle of the lag-1 autocorrelation; the
    block is derotated with phase continuity carried in ``carrier_acc``
    ((2, C): accumulated phase, last residual rad/sample), aligned to the
    mean phasor, then Re{} and DC-blocked.
    Returns (audio, new_dc_state, new_carrier_acc)."""
    C, T = x.shape
    r1 = torch.sum(x[:, 1:] * torch.conj(x[:, :-1]), dim=-1)
    w = torch.atan2(r1.imag, r1.real)  # rad/sample
    derot = x * _exp_neg_affine(carrier_acc[0], w, T)
    mean = torch.sum(derot, dim=-1)
    mean = mean / torch.clamp_min(torch.abs(mean), 1e-9)
    coherent = (derot * torch.conj(mean)[:, None]).real
    audio, new_dc = dc_block(dc_state, coherent)
    two_pi = float(np.float32(2.0 * np.pi))
    new_acc = torch.stack([torch.remainder(carrier_acc[0] + w * T, two_pi), w])
    return audio, new_dc, new_acc


def squelch(noise_state, audio, threshold: float = 0.5, pole: float = 0.5):
    """FM squelch: gate audio on the discriminator's HF noise, mean |d audio/dt|
    smoothed by a per-block one-pole. Returns (gated, new_noise_state, open (C,))."""
    hf = torch.mean(torch.abs(torch.diff(audio, dim=-1)), dim=-1)
    smoothed = pole * noise_state + (1.0 - pole) * hf
    is_open = smoothed < threshold
    return audio * is_open[:, None], smoothed, is_open


def demod_nfm(last, x, fs: float, deviation_hz: float):
    """y[n] = angle(x[n] conj(x[n-1])) * fs/(2π·dev); state = previous sample."""
    xprev = torch.cat([last[:, None], x[:, :-1]], dim=-1)
    d = x * torch.conj(xprev)
    scale = float(np.float32(fs / (2.0 * np.pi * deviation_hz)))
    return torch.atan2(d.imag, d.real) * scale, x[:, -1]


# --- demod bank ------------------------------------------------------------


def bank_init(num_channels: int, device) -> dict:
    return {
        "cw_phase": nco.init_state(num_channels, device),
        "am_dc": dc_block_init(num_channels, device),
        "nfm_last": torch.ones((num_channels,), dtype=torch.complex64, device=device),
        "sam_dc": dc_block_init(num_channels, device),
        "sam_carrier": torch.zeros((2, num_channels), dtype=torch.float32, device=device),
    }


def filter_index(mode):
    """Mode code -> mode-filter bank row (SAM shares the AM filter)."""
    return torch.where(mode == SAM, AM, mode).to(torch.int32)


def bank_apply(state, x, mode, cw_tone_word, fs: float, nfm_deviation_hz: float = 2500.0,
               enabled: tuple | None = None):
    """Run the demod bank, select per channel by ``mode`` (C,) int.

    ``enabled`` statically restricts which demods run (None = all six);
    disabled modes' states pass through unchanged and channels selecting a
    disabled mode produce silence. Selection is a masked sum (one mask hot
    per channel), so no (6, C, T) array is materialized.
    Returns (audio (C, T) float32, new_state)."""
    en = frozenset(range(SAM + 1)) if enabled is None else frozenset(map(int, enabled))
    m = mode[:, None]
    sel = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    cw_phase, am_dc = state["cw_phase"], state["am_dc"]
    nfm_last = state["nfm_last"]
    sam_dc, sam_carrier = state["sam_dc"], state["sam_carrier"]
    if en & {SSB, LSB}:
        # LSB demod is the same 2*Re after its (negative-band) mode filter;
        # the mask honors the subset per mode
        mask = torch.zeros_like(m, dtype=torch.bool)
        if SSB in en:
            mask = mask | (m == SSB)
        if LSB in en:
            mask = mask | (m == LSB)
        sel = sel + torch.where(mask, demod_ssb(x), 0.0)
    if CW in en:
        y_cw, cw_phase = demod_cw(state["cw_phase"], x, cw_tone_word)
        sel = sel + torch.where(m == CW, y_cw, 0.0)
    if AM in en:
        y_am, am_dc = demod_am(state["am_dc"], x)
        sel = sel + torch.where(m == AM, y_am, 0.0)
    if NFM in en:
        y_nfm, nfm_last = demod_nfm(state["nfm_last"], x, fs, nfm_deviation_hz)
        sel = sel + torch.where(m == NFM, y_nfm, 0.0)
    if SAM in en:
        y_sam, sam_dc, sam_carrier = demod_sam(state["sam_dc"], state["sam_carrier"], x, fs)
        sel = sel + torch.where(m == SAM, y_sam, 0.0)
    new_state = {"cw_phase": cw_phase, "am_dc": am_dc, "nfm_last": nfm_last,
                 "sam_dc": sam_dc, "sam_carrier": sam_carrier}
    return sel, new_state
