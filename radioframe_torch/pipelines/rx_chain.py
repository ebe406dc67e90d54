"""RxChain — the receive block program (counterpart of
``radioframe/pipelines/rx_chain.py``):

    (state, iq (C, T), freq_words (C,), mode (C,)) -> (state, audio, aux)

NCO mix and decimation (``step_front``: the fused K1 kernel at depth 2, K2
at depth 1, whose input power sums give ``power_in``, or the dense mix + FIR
decimators with a power pass of their own), then the options and stages of
``step_back``: the noise blanker, the OLS mode-filter bank, the auto-notch,
the VAD, the spectral NR, the demod bank, the NFM de-emphasis, the per-mode
AGC, the NFM squelch and, with ``emit_spectrum``, the panorama.

The back end is one K6 launch (the bank, the demod and the AGC: the same
FP32 contract) wherever the configuration admits it and the block is on a
CUDA card, and the composed ops elsewhere: on the CPU, unless
``fuse_backend`` insists on K6 there too, and for a configuration K6
refuses (an option, NFM de-emphasis, SAM or every mode enabled, a hang AGC,
a release too fast for the reference's tile, an nfft K6 cannot take).
``fuse_backend`` raises that refusal, as the reference's assertions do.
``back_path`` says which back end runs, and why not K6; ``step_back`` notes
it for the trace (``diag.timing.note``).
Per-channel frequency and mode are runtime tensors. The taps, polyphase
weights, OLS responses, AGC tables and spectrum window are buffers, so ``RxChain(cfg).to(device)`` places the whole chain; the state is
a plain dict with the reference's keys and leaves, built on the chain's
device by ``init_state``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.core.config import CicStage, FirStage, RxConfig
from radioframe_torch.diag.timing import note
from radioframe_torch.kernels.fused_frontend import FusedFrontend
from radioframe_torch.kernels.demod_agc import release_decays_ok
from radioframe_torch.kernels.fused_frontend2 import FusedFrontend2
from radioframe_torch.kernels.ols_demod import FusedOlsDemod
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import filter_design as FD
from radioframe_torch.ops import nco
from radioframe_torch.ops.agc import AgcBank
from radioframe_torch.ops.biquad import BiquadCascade
from radioframe_torch.ops.fir import FirDecimator, cic_decimator
from radioframe_torch.ops.interference import AutoNotch, NoiseBlanker, SpectralNR, Vad
from radioframe_torch.ops.ols import OverlapSaveBank
from radioframe_torch.ops.spectrum import Spectrum

OPTION_KEYS = ("nb", "nr", "vad", "notch", "squelch", "deemph")
# the paths of ``RxChain.back_path``
K6_PATH = "k6"
COMPOSED = "composed:"


def _option_refusal(cfg: RxConfig) -> tuple[str, str] | None:
    """(reason, error) of the first option that runs between the stages K6
    fuses (the interference and squelch stages, NFM de-emphasis), or None:
    K6 refuses them, as the reference's fuse_backend assertions do."""
    for on, key, what in ((cfg.nb_enabled, "nb", "nb_enabled"),
                          (cfg.nr_enabled, "nr", "nr_enabled"),
                          (cfg.notch_enabled, "notch", "notch_enabled"),
                          (cfg.vad_enabled, "vad", "vad_enabled"),
                          (cfg.squelch_enabled, "squelch", "squelch_enabled")):
        if on:
            return key, (f"fuse_backend: {what} (the interference and squelch stages) "
                         "re-splits the fusion; use the dense path when it is enabled")
    if cfg.nfm_deemphasis_s != 0.0:
        return "deemph", ("fuse_backend: nfm_deemphasis_s (NFM de-emphasis) runs outside the "
                          "kernel; disable it or use the dense path")
    return None


class RxChain(nn.Module):
    """Builds ops and taps from an RxConfig; ``step`` is the block program."""

    FRONT_KEYS = ("nco", "decim")

    def __init__(self, cfg: RxConfig):
        super().__init__()
        self.cfg = cfg
        decimators = []
        fs = cfg.fs_in
        prev_cic: CicStage | None = None
        self._stage_taps = []  # real taps per stage (what the fused kernel folds)
        for st in cfg.stages:
            if isinstance(st, CicStage):
                self._stage_taps.append(FD.cic_equivalent_taps(st.R, st.N, st.M))
                decimators.append(cic_decimator(st.R, st.N, st.M))
                prev_cic = st
                fs /= st.R
            elif isinstance(st, FirStage):
                stop = st.stopband_hz if st.stopband_hz is not None else 0.45 * fs / st.R
                if prev_cic is not None:
                    taps = FD.compensated_decim_taps(
                        st.numtaps, fs, st.passband_hz, stop,
                        cic_R=prev_cic.R, cic_N=prev_cic.N, cic_M=prev_cic.M,
                        cic_input_fs=fs * prev_cic.R)
                else:
                    taps = FD.lowpass_taps(st.numtaps, min(st.passband_hz, stop), fs)
                self._stage_taps.append(taps)
                decimators.append(FirDecimator(taps, st.R))
                prev_cic = None
                fs /= st.R
            else:
                raise TypeError(f"unknown stage {st!r}")
        if abs(fs - cfg.fs_audio) >= 1e-6:
            raise ValueError(f"stage plan ends at {fs} Hz, not fs_audio {cfg.fs_audio}")
        self.decimators = nn.ModuleList(decimators)
        # fused NCO + the first two decimators (depth 2, kernel K1) or the
        # first one (depth 1, kernel K2) in place of nco.mix_down + them
        self.fused = None
        self.fused_stages = 0
        if cfg.fuse_frontend and decimators:
            R2 = decimators[1].R if len(decimators) > 1 else 0
            if (cfg.fuse_frontend_depth >= 2 and len(decimators) >= 2
                    and not np.iscomplexobj(self._stage_taps[1])
                    and R2 > 1 and (R2 & (R2 - 1)) == 0):
                self.fused = FusedFrontend2(
                    self._stage_taps[0], decimators[0].R, self._stage_taps[1], R2,
                    input_scale=(2.0 ** -15 if cfg.int16_ingest else 1.0))
                self.fused_stages = 2
            else:
                if cfg.int16_ingest:
                    raise ValueError("int16_ingest requires the depth-2 fused front end "
                                     "(fuse_frontend_depth=2 with a real-tap pow2-R "
                                     "second stage)")
                self.fused = FusedFrontend(self._stage_taps[0], decimators[0].R)
                self.fused_stages = 1
        if cfg.int16_ingest and self.fused_stages != 2:
            raise ValueError("int16_ingest requires fuse_frontend=True with "
                             "fuse_frontend_depth=2")
        mf = cfg.mode_filters
        fa = cfg.fs_audio
        self.mode_bank = OverlapSaveBank(
            [
                FD.complex_bandpass_taps(mf.numtaps, mf.ssb_lo, mf.ssb_hi, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.cw_halfwidth, mf.cw_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.am_halfwidth, mf.am_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.nfm_halfwidth, mf.nfm_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.ssb_hi, -mf.ssb_lo, fa),  # LSB
            ],
            hop=cfg.ols_hop,
        )
        self.spectrum = Spectrum(cfg.spectrum_nfft, cfg.spectrum_avg)
        # per-mode attack/release/hang AGC; a single AgcConfig fans out to
        # all 6 mode slots when agc_modes is unset
        n_modes = demod_op.SAM + 1
        mode_cfgs = cfg.agc_modes if cfg.agc_modes is not None else (cfg.agc,) * n_modes
        if len(mode_cfgs) != n_modes:
            raise ValueError(f"agc_modes needs {n_modes} entries, got {len(mode_cfgs)}")
        self.agc_bank = AgcBank(mode_cfgs, fa)
        self.cw_tone_word = int(nco.freq_word(cfg.cw_tone_hz, fa))
        self.nb = NoiseBlanker(cfg.nb_threshold) if cfg.nb_enabled else None
        self.nr = SpectralNR(cfg.nr_nfft) if cfg.nr_enabled else None
        self.notch = AutoNotch(cfg.notch_nfft) if cfg.notch_enabled else None
        # VAD frames share nr_nfft so its flags align with NR's frames
        self.vad = (Vad(cfg.nr_nfft, cfg.vad_energy_ratio, cfg.vad_flatness_max)
                    if cfg.vad_enabled else None)
        # NFM de-emphasis: a one-pole section, the complement of TX pre-emphasis
        self.deemph = (BiquadCascade(FD.deemphasis_sos(cfg.nfm_deemphasis_s, fa))
                       if cfg.nfm_deemphasis_s > 0.0 else None)
        # the fused OLS + demod + AGC back end (kernel K6), where the
        # configuration admits it; _k6_refusal names what refuses it
        self.backend_kernel, self._k6_refusal = self._build_backend(cfg, fa)
        # minimum input block: every stage's constraint pulled back to fs_in
        r = 1
        lcm = 1
        for dec in decimators:
            lcm = np.lcm(lcm, r * dec.R)
            r *= dec.R
        lcm = int(np.lcm(lcm, r * self.mode_bank.hop))
        if cfg.emit_spectrum:
            lcm = int(np.lcm(lcm, r * cfg.spectrum_nfft))
        if cfg.nr_enabled or cfg.vad_enabled:
            lcm = int(np.lcm(lcm, r * cfg.nr_nfft))
        if cfg.notch_enabled:
            lcm = int(np.lcm(lcm, r * cfg.notch_nfft))
        self.min_block = lcm

    def _build_backend(self, cfg: RxConfig, fa: float):
        """(K6, None) where the configuration admits K6, else (None, the
        reason). ``fuse_backend`` raises the refusal (the reference's
        asserts become ValueErrors) and K6's own errors."""
        en = cfg.enabled_modes
        refusal = _option_refusal(cfg)
        if refusal is None and (en is None or demod_op.SAM in en):
            refusal = "enabled_modes", ("fuse_backend needs enabled_modes without SAM "
                                        "(whole-block carrier statistics need the dense bank)")
        if refusal is None and self.agc_bank.hist_len:
            refusal = "hang", ("fuse_backend AGC has no hang support; set hang_s=0 or use the "
                               "dense path")
        if refusal is None and not release_decays_ok(self.agc_bank._release_table,
                                                     self.mode_bank.hop):
            refusal = "release", ("fuse_backend: AGC release too fast for the reference's "
                                  "in-kernel rescale over hop-length tiles; lengthen release_s")
        if refusal is not None:
            if cfg.fuse_backend:
                raise ValueError(refusal[1])
            return None, refusal[0]
        try:
            return FusedOlsDemod(
                self.mode_bank.nfft, self.mode_bank.hop, cfg.channels, fa, cfg.nfm_deviation_hz,
                enabled=en, attack_alphas=tuple(self.agc_bank._alpha_table.tolist()),
                dft_precision=cfg.backend_dft_precision), None
        except (ValueError, AssertionError):  # an nfft or a precision K6 cannot take
            if cfg.fuse_backend:
                raise
            return None, "shape"

    @property
    def device(self) -> torch.device:
        return self.mode_bank._H.device

    @property
    def back_path(self) -> str:
        """The back end ``step_back`` runs for a block of the configured
        channels on the chain's device: "k6", or "composed:<reason>", the
        first condition that refused K6 (an option's key, "enabled_modes",
        "hang", "release", "shape", or "device": on the CPU without
        ``fuse_backend``)."""
        return self._back_path(self.device, self.cfg.channels)

    def _back_path(self, device, channels: int) -> str:
        if self._k6_refusal is not None:
            return COMPOSED + self._k6_refusal
        if self.cfg.fuse_backend:
            return K6_PATH
        if torch.device(device).type != "cuda":
            return COMPOSED + "device"
        if channels != self.backend_kernel.C:
            return COMPOSED + "shape"
        return K6_PATH

    # -- state ---------------------------------------------------------------

    def init_state(self, num_channels: int | None = None) -> dict:
        C = self.cfg.channels if num_channels is None else num_channels
        dev = self.device
        if self.fused is not None:
            decim0 = (self.fused.init_state(C)["tail"],)
            rest = self.decimators[self.fused_stages:]
        else:
            decim0 = (self.decimators[0].init_state(C),) if len(self.decimators) else ()
            rest = self.decimators[1:]
        return {
            "nco": nco.init_state(C, dev),
            "decim": decim0 + tuple(d.init_state(C) for d in rest),
            "bpf": self.mode_bank.init_state(C),
            "demod": demod_op.bank_init(C, dev),
            "agc": self.agc_bank.init_state(C),
            "spec": self.spectrum.init_state(C),
            "nb": self.nb.init_state(C, dev) if self.nb else (),
            "nr": self.nr.init_state(C, dev) if self.nr else (),
            "vad": self.vad.init_state(C, dev) if self.vad else (),
            "notch": self.notch.init_state(C, dev) if self.notch else (),
            "squelch": (torch.zeros((C,), dtype=torch.float32, device=dev)
                        if self.cfg.squelch_enabled else ()),
            "deemph": self.deemph.init_state(C) if self.deemph is not None else (),
        }

    def split_state(self, state):
        """Full state dict -> (front_state, back_state)."""
        f = {k: state[k] for k in self.FRONT_KEYS}
        b = {k: v for k, v in state.items() if k not in self.FRONT_KEYS}
        return f, b

    # -- the block program ---------------------------------------------------

    def _check_block(self, T: int) -> None:
        if T % self.min_block:
            raise ValueError(f"block length {T} must be a multiple of {self.min_block}")

    def power_scale(self, T: int) -> float:
        """Factor from the fused kernel's raw power sum to mean |x|^2 in
        normalized units for a block of T samples."""
        return float(np.float32(self.fused.input_scale ** 2 / T))

    def step_front(self, fstate, iq, freq_words):
        """Full-rate stage: (fstate, iq (C,T) or (1,T) c64, words (C,) i32)
        -> (fstate, x (C, T/decim) c64, power_in (C,) or (1,) f32)."""
        self._check_block(iq.shape[-1])
        if self.cfg.int16_ingest:
            # the kernel's taps carry the 2**-15 count scale: normalized
            # complex input here would come out attenuated 32768x
            raise ValueError("chain built with int16_ingest=True: feed int16 count planes "
                             "via step_i16/step_front_i16")
        if self.fused is not None:
            fst = {"acc": fstate["nco"], "tail": fstate["decim"][0]}
            # K1 and K2 sum the input power as they read it: no second pass
            fst, x, pwsum = self.fused.step(fst, iq, freq_words, return_power=True)
            pw = pwsum * self.power_scale(iq.shape[-1])
            nco_acc = fst["acc"]
            tails = [fst["tail"]]
            rest = zip(self.decimators[self.fused_stages:], fstate["decim"][1:])
        else:
            x, nco_acc = nco.mix_down(iq, freq_words, fstate["nco"])
            pw = torch.mean(torch.abs(iq) ** 2, dim=-1)
            tails = []
            rest = zip(self.decimators, fstate["decim"])
        for d, tail in rest:
            x, t = d(tail, x)
            tails.append(t)
        return {"nco": nco_acc, "decim": tuple(tails)}, x, pw

    def step_front_i16(self, fstate, xr, xi, freq_words):
        """int16 ADC ingest (cfg.int16_ingest): xr/xi are (C, T) int16 count
        planes; the kernel reads 2-byte words and the 2**-15 scale is folded
        into its stage-1 taps."""
        if not self.cfg.int16_ingest:
            raise ValueError("chain not built with int16_ingest")
        self._check_block(xr.shape[-1])
        fst = {"acc": fstate["nco"], "tail": fstate["decim"][0]}
        fst, x, pwsum = self.fused.step_planes(fst, xr, xi, freq_words, return_power=True)
        tails = [fst["tail"]]
        for d, tail in zip(self.decimators[self.fused_stages:], fstate["decim"][1:]):
            x, t = d(tail, x)
            tails.append(t)
        pw = pwsum * self.power_scale(xr.shape[-1])
        return {"nco": fst["acc"], "decim": tuple(tails)}, x, pw

    def step_back(self, state, x, mode, power_in):
        """Audio-rate stage: (bstate, x (C, T/decim) c64, mode (C,) i32,
        power_in (C,) f32) -> (bstate, audio, aux), through K6 or the
        composed ops as ``back_path`` says (for x's device and rows)."""
        path = self._back_path(x.device, x.shape[0])
        note(back_path=path)
        return self._step_back(state, x, mode, power_in, path == K6_PATH)

    def _step_back_composed(self, state, x, mode, power_in):
        """``step_back`` through the composed ops whatever ``back_path``
        says: what K6 is held against, on the card too."""
        return self._step_back(state, x, mode, power_in, False)

    def _step_back(self, state, x, mode, power_in, fused: bool):
        cfg = self.cfg
        opt = {k: state[k] for k in OPTION_KEYS}
        aux = {}
        if fused:
            audio, bpf_tail, demod_state, agc_env, gain_last = self._back_fused(state, x, mode)
        else:
            audio, bpf_tail, demod_state, agc_env, gain_last = self._back_dense(
                state, x, mode, opt, aux)
        aux.update(agc_gain_last=gain_last,
                   power_in=power_in.to(torch.float32).expand(mode.shape))
        spec_prev = state["spec"]
        if cfg.emit_spectrum:  # panorama of the decimated, pre-filter channel
            aux["spectrum"], spec_prev = self.spectrum(state["spec"], x)
        new_state = {"bpf": bpf_tail, "demod": demod_state, "agc": agc_env,
                     "spec": spec_prev, **opt}
        return new_state, audio, aux

    def _back_dense(self, state, x, mode, opt, aux):
        """The composed back end with the options; updates the option states
        in ``opt`` and puts the VAD flags in ``aux``. Returns (audio, bpf
        tail, demod state, agc state, last gain)."""
        cfg = self.cfg
        cw_word = torch.full(mode.shape, self.cw_tone_word, dtype=torch.int32, device=x.device)
        if self.nb:  # impulse excision before the mode filter rings them out
            x, opt["nb"] = self.nb(state["nb"], x)
        # per-channel mode filter, selected in the frequency domain
        sel, bpf_tail = self.mode_bank.apply_selected(state["bpf"], x,
                                                      demod_op.filter_index(mode))
        if self.notch:
            sel, opt["notch"] = self.notch(state["notch"], sel)
        voice = None
        if self.vad:  # flags from the signal NR sees (after the filter and notch)
            voice, opt["vad"] = self.vad(state["vad"], sel)
            aux["vad_active"] = voice  # (C, F) per-frame flags
        if self.nr:
            sel, opt["nr"] = self.nr(state["nr"], sel, voice=voice)
        audio, demod_state = demod_op.bank_apply(
            state["demod"], sel, mode, cw_word, cfg.fs_audio, cfg.nfm_deviation_hz,
            enabled=cfg.enabled_modes)
        nfm = (mode == demod_op.NFM)[:, None]
        if self.deemph is not None:  # dense, selected for the NFM channels
            de, opt["deemph"] = self.deemph(state["deemph"], audio)
            audio = torch.where(nfm, de, audio)
        # AGC on SSB/CW/AM; FM audio is deviation-scaled and bypasses it
        agc_audio, agc_env, agc_gain = self.agc_bank(state["agc"], audio, mode)
        audio = torch.where(nfm, audio, agc_audio)
        if cfg.squelch_enabled:
            gated, opt["squelch"], _ = demod_op.squelch(state["squelch"], audio,
                                                        cfg.squelch_threshold)
            audio = torch.where(nfm, gated, audio)
        return audio, bpf_tail, demod_state, agc_env, agc_gain[:, -1]

    def _back_fused(self, state, x, mode):
        """The OLS window, the DFT, each channel's response row, the inverse,
        the demod bank and the AGC in one K6 launch, which reads the bank's
        response table, the per-mode AGC tables and the state where they lie.
        Returns (audio, bpf tail, demod state, agc state, last gain)."""
        ab = self.agc_bank
        return self.backend_kernel.call_chain(
            state["bpf"], x, self.mode_bank._H, mode,
            (ab.release, ab.alpha, ab.target, ab.max_gain), self.cw_tone_word,
            state["demod"], state["agc"])

    def step(self, state, iq, freq_words, mode):
        """(state, iq (C,T) c64, freq_words (C,) i32, mode (C,) i32)
        -> (state, audio (C, T/decim) f32, aux dict)."""
        fstate, bstate = self.split_state(state)
        fstate, x, pw = self.step_front(fstate, iq, freq_words)
        bstate, audio, aux = self.step_back(bstate, x, mode, pw)
        return {**fstate, **bstate}, audio, aux

    def step_i16(self, state, xr, xi, freq_words, mode):
        """Full RX block step from int16 count planes (see step_front_i16)."""
        fstate, bstate = self.split_state(state)
        fstate, x, pw = self.step_front_i16(fstate, xr, xi, freq_words)
        bstate, audio, aux = self.step_back(bstate, x, mode, pw)
        return {**fstate, **bstate}, audio, aux
