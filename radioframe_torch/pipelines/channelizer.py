"""Channelizer pipeline — wideband IQ -> M channels -> per-channel demod/AGC
+ wideband waterfall (counterpart of ``radioframe/pipelines/channelizer.py``;
BASELINE config 5):

    (state, wideband (T,), mode (M,)) -> (state, audio (M, T/M), aux)

Four forms, chosen by the config as in the reference:
  - dense: ``ops/pfb.PfbChannelizer``, the demod bank and the ``AgcBank``;
  - ``fuse_pfb``: the K3 kernel in place of the PFB, the rest dense;
  - ``fuse_demod``: K3 planes into the K4 demod+AGC kernel;
  - ``fuse_single_pass``: the K5 kernel, wideband planes in, audio out.
With hang AGC (``hang_s > 0``) the kernels run demod-only and the dense
``AgcBank`` applies the gain (the hang route).

The kernels work in channel order, so no per-channel vector or state is
permuted. Configuration checks raise the reference's exception types
(``AssertionError`` where the reference asserts) so that the port accepts
and refuses the same configurations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from radioframe_torch.core.config import AgcConfig
from radioframe_torch.kernels.channelizer_one import FusedChannelizerOne
from radioframe_torch.kernels.demod_agc import FusedDemodAgc
from radioframe_torch.kernels.pfb_dft import FusedPfbDft, next_tail
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.ops.agc import AgcBank
from radioframe_torch.ops.pfb import PfbChannelizer
from radioframe_torch.ops.spectrum import Spectrum


@dataclass(frozen=True)
class ChannelizerConfig:
    """The reference's ``ChannelizerConfig``, field for field and default for
    default (``tests/test_torch_guards.py`` holds the two equal)."""

    fs_in: float = 61_440_000.0      # wideband input rate
    num_channels: int = 4096
    taps_per_channel: int = 8
    agc: AgcConfig = field(default_factory=AgcConfig)
    agc_modes: tuple | None = None   # optional per-mode AGC profiles (len 6)
    cw_tone_hz: float = 600.0
    nfm_deviation_hz: float = 2500.0
    spectrum_nfft: int = 4096
    spectrum_avg: float = 0.0        # EMA waterfall averaging (dense panorama)
    emit_spectrum: bool = True
    # the waterfall from the PFB output itself: linear power averaged over
    # waterfall_frame_avg frames, then dB
    waterfall_from_pfb: bool = False
    waterfall_frame_avg: int = 1
    enabled_modes: tuple | None = None  # static demod subset (None = all six)
    fuse_pfb: bool = False              # K3
    dft_precision: str = "highest"      # "highest" or "b3"; FP32 in the port either way
    fuse_single_pass: bool = False      # K5 (needs fuse_demod)
    fuse_demod: bool = False            # K4 (needs fuse_pfb and waterfall_from_pfb)

    @property
    def fs_channel(self) -> float:
        return self.fs_in / self.num_channels


def pfb_waterfall_lines(chans, frame_avg: int):
    """PFB output (M, F) -> waterfall lines (F/avg, M) in dB, low..high
    frequency order (channel c sits at +c*fs/M; a roll by M/2 is fftshift)."""
    M, F = chans.shape
    p = chans.real ** 2 + chans.imag ** 2
    pa = p.reshape(M, F // frame_avg, frame_avg).mean(dim=-1)
    db = 10.0 * torch.log10(torch.clamp_min(pa, 1e-24))
    return torch.roll(db, M // 2, dims=0).T


def _pack_backend_state(demod_state, agc_state):
    """Demod/AGC dicts -> the (7, M) carry rows the kernels seed."""
    d = demod_state
    return torch.stack([d["am_dc"][0], d["am_dc"][1], d["nfm_last"].real, d["nfm_last"].imag,
                        agc_state["env"], agc_state["lpf"], torch.zeros_like(agc_state["env"])])


def fused_backend_apply(call, agc_bank, cw_tone_word: int, demod_state, agc_state, mode,
                        frames: int):
    """One back-end kernel launch over ``frames`` frames with the per-channel
    state and modes of its M_local channels: ``call(mode, cw_word, cw_acc,
    rel, al, tgt, mg, st_in)`` is K4 on frame-major planes (F, M_local) or K5
    on wideband planes, for the unsharded chain and, on its M/D-channel slice,
    the sharded two-kernel form. Returns (audio, power_sum (M_local,),
    wf_power (F/avg, M_local), demod_state', agc_state'), audio in the layout
    ``call`` writes: (F, M_local), or (M_local, F) from K5 asked for
    channel-major (so F is given, not read from the audio)."""
    st_in = _pack_backend_state(demod_state, agc_state)
    cw_word = torch.full(mode.shape, cw_tone_word, dtype=torch.int32, device=st_in.device)
    rel, al, tgt, mg = agc_bank.per_channel(mode)
    audio, power_sum, wfp, st_out = call(mode, cw_word, demod_state["cw_phase"], rel, al, tgt,
                                         mg, st_in)
    new_demod, new_agc = _unpack_backend_state(st_out, demod_state, cw_word, frames)
    return audio, power_sum, wfp, new_demod, new_agc


def _unpack_backend_state(st_out, demod_state, cw_word, F: int):
    """(7, M) kernel carry rows -> (demod_state', agc_state')."""
    new_demod = {
        "cw_phase": nco.wrap_i32(demod_state["cw_phase"].to(torch.int64)
                                 + cw_word.to(torch.int64) * F),
        "am_dc": torch.stack([st_out[0], st_out[1]]),
        "nfm_last": torch.complex(st_out[2], st_out[3]),
        "sam_dc": demod_state["sam_dc"],
        "sam_carrier": demod_state["sam_carrier"],
    }
    return new_demod, {"hist": (), "env": st_out[4], "lpf": st_out[5]}


class ChannelizerChain(nn.Module):
    """(state, wideband (T,), mode (M,)) -> (state, audio (M, T/M), aux)."""

    def __init__(self, cfg: ChannelizerConfig):
        super().__init__()
        self.cfg = cfg
        M, K = cfg.num_channels, cfg.taps_per_channel
        if cfg.fuse_pfb:
            self.pfb = FusedPfbDft(M, K, dft_precision=cfg.dft_precision)
        else:
            self.pfb = PfbChannelizer(M, K)
        self.spectrum = Spectrum(cfg.spectrum_nfft, cfg.spectrum_avg)
        n_modes = demod_op.SAM + 1
        mode_cfgs = cfg.agc_modes if cfg.agc_modes is not None else (cfg.agc,) * n_modes
        self.agc_bank = AgcBank(mode_cfgs, cfg.fs_channel)
        self.cw_tone_word = int(nco.freq_word(cfg.cw_tone_hz, cfg.fs_channel))
        if cfg.waterfall_from_pfb and cfg.spectrum_avg != 0.0:
            raise AssertionError("waterfall_from_pfb uses linear frame averaging "
                                 "(waterfall_frame_avg), not the dB-domain EMA")
        self.min_block = M * max(K, 1)
        if cfg.waterfall_from_pfb and cfg.waterfall_frame_avg > 1:
            self.min_block = int(np.lcm(self.min_block, M * cfg.waterfall_frame_avg))
        self.agc_in_torch = False  # the hang route: kernels demod-only, AgcBank after
        self.demod_kernel = None
        self.one_kernel = None
        if cfg.fuse_single_pass and not cfg.fuse_demod:
            raise AssertionError("fuse_single_pass requires fuse_demod=True (it fuses the "
                                 "demod back end into the PFB pass)")
        if cfg.fuse_demod:
            if not cfg.fuse_pfb:
                raise AssertionError("fuse_demod consumes the PFB kernel's planes")
            if not (cfg.emit_spectrum and cfg.waterfall_from_pfb):
                raise AssertionError("fuse_demod emits the waterfall from the kernel's power pass")
            en = cfg.enabled_modes if cfg.enabled_modes is not None else tuple(range(n_modes))
            if demod_op.SAM in en:
                raise AssertionError("fuse_demod: SAM needs whole-block stats; use the dense bank")
            # hang's sliding-window max needs the whole hang window of |audio|
            # history: with hang the kernels run demod-only and the dense
            # AgcBank applies the gain, carrying its history across blocks
            self.agc_in_torch = self.agc_bank.hist_len > 0
            self.demod_kernel = FusedDemodAgc(
                M, cfg.fs_channel, cfg.nfm_deviation_hz, wf_avg=cfg.waterfall_frame_avg,
                enabled=en, apply_agc=not self.agc_in_torch)
            if cfg.fuse_single_pass:
                self.one_kernel = FusedChannelizerOne(
                    M, K, cfg.fs_channel, cfg.nfm_deviation_hz, wf_avg=cfg.waterfall_frame_avg,
                    enabled=en, dft_precision=cfg.dft_precision,
                    apply_agc=not self.agc_in_torch)
            release = self.agc_bank._release_table
            if not self.agc_in_torch and not self.demod_kernel.release_ok(release):
                raise ValueError(
                    "fuse_demod: AGC release too fast for the reference's in-kernel rescale "
                    f"(min decay {float(release.min()):.4f} over {self.demod_kernel.max_tf}-frame "
                    "tiles); lengthen release_s or disable fuse_demod (dense bank is exact)")

    @property
    def device(self) -> torch.device:
        return self.pfb.h.device

    def init_state(self) -> dict:
        M = self.cfg.num_channels
        # no spec state when the waterfall derives from the PFB output
        spec = (() if self.cfg.waterfall_from_pfb or not self.cfg.emit_spectrum
                else self.spectrum.init_state(1))
        return {"pfb": self.pfb.init_state(1), "demod": demod_op.bank_init(M, self.device),
                "agc": self.agc_bank.init_state(M), "spec": spec}

    def _check_block(self, T: int) -> None:
        if T % self.min_block:
            raise AssertionError(f"block length {T} must be a multiple of {self.min_block} "
                                 "(num_channels x taps/waterfall_frame_avg lcm)")

    def step_planes(self, state, wr, wi, mode):
        """Plane-input block step (single-pass path only): wr/wi (T,) float32
        I/Q planes, as an ADC stream arrives."""
        if self.one_kernel is None:
            raise AssertionError("step_planes requires fuse_single_pass=True")
        self._check_block(wr.shape[-1])
        return self._step_fused(state, (wr, wi), mode)

    def step(self, state, wideband, mode):
        cfg = self.cfg
        M = cfg.num_channels
        self._check_block(wideband.shape[-1])
        if self.demod_kernel is not None:
            return self._step_fused(state, wideband, mode)
        chans, pfb_tail = self.pfb(state["pfb"], wideband[None, :])
        chans = chans[0]  # (M, F)
        cw_word = torch.full((M,), self.cw_tone_word, dtype=torch.int32, device=chans.device)
        audio, demod_state = demod_op.bank_apply(
            state["demod"], chans, mode, cw_word, cfg.fs_channel, cfg.nfm_deviation_hz,
            enabled=cfg.enabled_modes)
        agc_audio, agc_state, _ = self.agc_bank(state["agc"], audio, mode)
        audio = torch.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
        aux = {"channel_power": torch.mean(chans.real ** 2 + chans.imag ** 2, dim=-1)}
        spec_prev = state["spec"]
        if cfg.emit_spectrum:
            if cfg.waterfall_from_pfb:
                aux["waterfall"] = pfb_waterfall_lines(chans, cfg.waterfall_frame_avg)
            else:
                lines, spec_prev = self.spectrum(state["spec"], wideband[None, :])
                aux["waterfall"] = lines[0]  # (F_spec, nfft)
        new_state = {"pfb": pfb_tail, "demod": demod_state, "agc": agc_state, "spec": spec_prev}
        return new_state, audio, aux

    def _step_fused(self, state, wideband, mode):
        """The kernel paths: K5 on wideband planes, writing (M, F) audio, or
        K3 planes into K4, whose (F, M) audio is transposed. The (M, F)
        complex channel matrix is never formed."""
        M = self.cfg.num_channels
        if self.one_kernel is not None:
            if isinstance(wideband, tuple):
                wr, wi = wideband
            else:
                planes = torch.view_as_real(wideband)
                wr, wi = planes[:, 0], planes[:, 1]
            F = wr.shape[-1] // M
            call = functools.partial(self.one_kernel.call_planes, state["pfb"], wr, wi,
                                     channel_major=True)
            pfb_tail = next_tail(state["pfb"], wr, wi)
        else:
            F = wideband.shape[-1] // M
            (yr, yi), pfb_tail = self.pfb.call_planes(state["pfb"], wideband[None, :])
            call = functools.partial(self.demod_kernel, yr, yi)
        audio, power_sum, wfp, new_demod, new_agc = fused_backend_apply(
            call, self.agc_bank, self.cw_tone_word, state["demod"], state["agc"], mode, F)
        if self.one_kernel is None:
            audio = audio.T.contiguous()  # K4's (F, M) -> (M, F)
        if self.agc_in_torch:  # hang route: the kernel emitted pre-gain audio
            agc_audio, new_agc, _ = self.agc_bank(state["agc"], audio, mode)
            audio = torch.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
        db = 10.0 * torch.log10(torch.clamp_min(wfp, 1e-24))
        aux = {"channel_power": power_sum / F, "waterfall": torch.roll(db, M // 2, dims=-1)}
        new_state = {"pfb": pfb_tail, "demod": new_demod, "agc": new_agc, "spec": state["spec"]}
        return new_state, audio, aux
