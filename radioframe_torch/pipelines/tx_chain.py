"""TxChain — the DUC transmit block program (counterpart of
``radioframe/pipelines/tx_chain.py``):

    (state, audio (C, Ta), freq_words (C,), mode (C,)) -> (state, iq (C, Ta*L))

- speech processor: DC block, optional mic EQ (a peaking biquad cascade),
  compressor (instant attack, exponential release toward a target);
- modulator bank, run dense and selected per channel: SSB (the one-sided
  complex bandpass by overlap-save), CW (the audio as keying envelope), AM
  (1 + depth*audio), NFM (a phase integrator: the affine scan with a = 1
  and the carried phase), LSB (the conjugate of the SSB signal);
- the interpolation stages (FIR stages, the one before a CIC stage with the
  CIC's inverse-sinc droop folded in, then CIC stages), then the mix up by
  the TX DDS NCO.

Taps, polyphase matrices, the SSB response and the biquad coefficients are
buffers, so ``TxChain(cfg).to(device)`` places the chain; the state is a
plain dict with the reference's keys and leaves.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.core import compiled
from radioframe_torch.core.config import CicStage, TxConfig
from radioframe_torch.ops import agc as agc_op
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import filter_design as FD
from radioframe_torch.ops import nco
from radioframe_torch.ops.biquad import BiquadCascade
from radioframe_torch.ops.interp import FirInterpolator, cic_interpolator
from radioframe_torch.ops.ols import OverlapSave
from radioframe_torch.ops.scans import affine_scan

TWO_PI = 2.0 * np.pi
N_TX_MODES = 5  # SSB, CW, AM, NFM, LSB: the modulator bank's branches


def select_mode(mode, branches):
    """Each channel's row of the branch its mode selects: ``branches`` in
    mode-code order, each (C, Ta) complex64. A code outside the bank gives
    nan + 0j, as the reference's ``take_along_axis`` fill does."""
    out = torch.full_like(branches[0], complex(float("nan"), 0.0))
    m = mode[:, None]
    for code, y in enumerate(branches):
        out = torch.where(m == code, y, out)
    return out


def fm_phasor(phase):
    """exp(j*phase) of a float32 phase, complex64."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


class TxChain(nn.Module):
    """Builds the modulators and interpolators from a TxConfig; ``step`` is
    the block program."""

    def __init__(self, cfg: TxConfig):
        super().__init__()
        self.cfg = cfg
        mf = cfg.mode_filters
        self.ssb_bpf = OverlapSave(
            FD.complex_bandpass_taps(mf.numtaps, mf.ssb_lo, mf.ssb_hi, cfg.fs_audio), hop=512)
        # interpolation plan: ints are FIR stages, CicStage entries CIC
        # interpolators; a FIR stage right before a CIC pre-compensates the
        # CIC's passband droop
        interps = []
        fs = cfg.fs_audio
        stages = tuple(cfg.interp_stages)
        for i, st in enumerate(stages):
            if isinstance(st, CicStage):
                interps.append(cic_interpolator(st.R, st.N, st.M))
                fs *= st.R
                continue
            L = int(st)
            fs_out = fs * L
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            if isinstance(nxt, CicStage):
                taps = FD.compensated_interp_taps(
                    cfg.numtaps_per_stage, L, fs_out, 0.5 * cfg.fs_audio * 0.9,
                    cic_L=nxt.R, cic_N=nxt.N, cic_M=nxt.M)
            else:
                taps = FD.interp_taps(cfg.numtaps_per_stage, L, fs_out, 0.5 * fs * 0.9)
            interps.append(FirInterpolator(taps, L))
            fs = fs_out
        if abs(fs - cfg.fs_out) >= 1e-6:
            raise ValueError(f"interpolation plan ends at {fs} Hz, not fs_out {cfg.fs_out}")
        self.interps = nn.ModuleList(interps)
        self._comp_decay = agc_op.release_decay(cfg.compressor_release_s, cfg.fs_audio)
        self.mic_eq = (BiquadCascade(FD.peaking_eq_sos(cfg.mic_eq_bands, cfg.fs_audio))
                       if cfg.mic_eq_bands else None)
        # phase step per unit audio for NFM (rad/sample at the audio rate)
        self._fm_k = TWO_PI * cfg.nfm_deviation_hz / cfg.fs_audio
        self.min_block = int(np.lcm(self.ssb_bpf.hop, 1))

    @property
    def device(self) -> torch.device:
        return self.ssb_bpf._H.device

    # the step reads these floats by value: a new value invalidates the
    # captured steps (core/compiled.py)
    @property
    def comp_decay(self) -> float:
        return self._comp_decay

    @comp_decay.setter
    def comp_decay(self, value: float) -> None:
        self._comp_decay = value
        compiled.invalidate()

    @property
    def fm_k(self) -> float:
        return self._fm_k

    @fm_k.setter
    def fm_k(self, value: float) -> None:
        self._fm_k = value
        compiled.invalidate()

    def init_state(self, num_channels: int | None = None) -> dict:
        C = self.cfg.channels if num_channels is None else num_channels
        dev = self.device
        return {
            "dc": demod_op.dc_block_init(C, dev),
            "eq": self.mic_eq.init_state(C) if self.mic_eq is not None else (),
            "comp": agc_op.init_state(C, dev),
            "ssb": self.ssb_bpf.init_state(C),
            "fm_phase": torch.zeros((C,), dtype=torch.float32, device=dev),
            "interp": tuple(ip.init_state(C) for ip in self.interps),
            "nco": nco.init_state(C, dev),
        }

    def _check_block(self, Ta: int) -> None:
        if Ta % self.min_block:
            raise ValueError(f"audio block length {Ta} must be a multiple of {self.min_block}")

    def modulate(self, audio, a, y_ssb, phase, mode):
        """The bank's five branches from the raw audio (CW keying), the
        processed audio ``a``, the SSB filter's output and the NFM phase,
        selected per channel."""
        y_cw = torch.clamp(audio, 0.0, 1.0).to(torch.complex64)  # keying envelope
        y_am = (1.0 + self.cfg.am_depth * a).to(torch.complex64)
        # LSB = the conjugate of the USB analytic signal (real audio mirror)
        return select_mode(mode, (y_ssb, y_cw, y_am, fm_phasor(phase), torch.conj(y_ssb)))

    def step(self, state, audio, freq_words, mode):
        """(state, audio (C, Ta) f32, freq_words (C,) i32, mode (C,) i32)
        -> (state, iq (C, Ta * interp) c64)."""
        cfg = self.cfg
        self._check_block(audio.shape[-1])
        # speech processor: DC block, mic EQ, compressor
        a, dc_state = demod_op.dc_block(state["dc"], audio)
        eq_state = state["eq"]
        if self.mic_eq is not None:
            a, eq_state = self.mic_eq(state["eq"], a)
        a, comp_env, _ = agc_op.apply(state["comp"], a, self.comp_decay,
                                      target=cfg.compressor_target,
                                      max_gain=cfg.compressor_max_gain)
        y_ssb, ssb_tail = self.ssb_bpf(state["ssb"], a.to(torch.complex64))
        # NFM: the phase integrator as an affine scan with a = 1, from the
        # carried phase; the carry wraps by floor mod, as jnp.mod
        dphi = self.fm_k * a
        phase = affine_scan(torch.ones_like(dphi), dphi, state["fm_phase"])
        x = self.modulate(audio, a, y_ssb, phase, mode)
        tails = []
        for ip, tail in zip(self.interps, state["interp"]):
            x, t = ip(tail, x)
            tails.append(t)
        iq, nco_acc = nco.mix_up(x, freq_words, state["nco"])
        new_state = {
            "dc": dc_state,
            "eq": eq_state,
            "comp": comp_env,
            "ssb": ssb_tail,
            "fm_phase": torch.remainder(phase[:, -1], float(np.float32(TWO_PI))),
            "interp": tuple(tails),
            "nco": nco_acc,
        }
        return new_state, iq
