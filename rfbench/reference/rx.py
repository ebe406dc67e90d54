"""The plain reference of the multichannel RX chain (BASELINE config 2 at the
flagship's shape): per channel a DDS mix to baseband, a CIC and a
compensating FIR decimator, an overlap-save bank of analytic mode filters,
the demod bank and the AGC; every channel's 48 kHz audio and the input power.

Written from the configuration's numbers alone (``sizes``, a configuration
file's contents): taps, tuning words and tables are designed here again.
"""

from __future__ import annotations

import numpy as np
import torch

from rfbench.reference import filter_design as fd
from rfbench.reference import plain
from rfbench.reference.plain import Precision


class RxReference:
    """The chain for ``sizes``; ``step`` runs one block."""

    def __init__(self, sizes: dict, freqs_hz, modes, device):
        self.s = sizes
        self.device = torch.device(device)
        fs = sizes["fs_in"]
        cic, fir = sizes["stages"]
        self.R1, self.R2 = cic["R"], fir["R"]
        self.h1 = fd.cic_equivalent_taps(cic["R"], cic["N"], cic["M"])
        fs1 = fs / cic["R"]
        stop = fir["stopband_hz"] if fir.get("stopband_hz") else 0.45 * fs1 / fir["R"]
        self.h2 = fd.compensated_decim_taps(fir["numtaps"], fs1, fir["passband_hz"], stop,
                                            cic["R"], cic["N"], cic["M"])
        self.fs_audio = fs1 / fir["R"]
        mf = sizes["mode_filters"]
        fa = self.fs_audio
        bands = [(mf["ssb_lo"], mf["ssb_hi"]), (-mf["cw_halfwidth"], mf["cw_halfwidth"]),
                 (-mf["am_halfwidth"], mf["am_halfwidth"]),
                 (-mf["nfm_halfwidth"], mf["nfm_halfwidth"]), (-mf["ssb_hi"], -mf["ssb_lo"])]
        self.L = mf["numtaps"]
        self.hop = sizes["ols_hop"]
        self.nfft = self.hop + self.L - 1
        taps = [fd.complex_bandpass_taps(self.L, lo, hi, fa) for lo, hi in bands]
        self.H = np.stack([np.fft.fft(t, self.nfft) for t in taps])  # (5, nfft)
        self.word = plain.freq_word(np.asarray(freqs_hz, np.float64), fs)
        self.cw_word = plain.freq_word(sizes["cw_tone_hz"], fa)
        self.modes = np.asarray(modes, np.int64)
        self.C = len(self.modes)

    def init_state(self, start_block: int, T: int, p: Precision) -> dict:
        """The state at the start of block ``start_block`` of blocks of T
        samples: the DDS and BFO accumulators worked out from the block count,
        the filter histories, the demods and the AGC fresh."""
        C, dev = self.C, self.device
        Ta = T // (self.R1 * self.R2)
        zeros = lambda n: torch.zeros((C, n), dtype=p.cplx, device=dev)  # noqa: E731
        st = plain.demod_init(C, start_block, Ta, np.full(C, self.cw_word), dev, p)
        st.update(acc=torch.as_tensor(plain.advance(0, self.word, start_block * T), device=dev),
                  raw=zeros(len(self.h1) - 1), s1=zeros(len(self.h2) - 1), ols=zeros(self.L - 1))
        return st

    def step(self, st: dict, iq: torch.Tensor, p: Precision):
        """(state, iq (C, T) complex) -> (state, {"audio": (C, T/32),
        "power_in": (C,)})."""
        C, T = iq.shape
        dev = self.device
        x = p.r(iq.to(dev))
        word = torch.as_tensor(self.word, device=dev)
        mixed = p.r(x * plain.phasor(st["acc"], word, T, -1.0, p))
        st["acc"] = torch.remainder(st["acc"] + word * T, plain.TWO32)
        y1, st["raw"] = plain.fir_decimate(st["raw"], mixed, self.h1, self.R1, p)
        y2, st["s1"] = plain.fir_decimate(st["s1"], y1, self.h2, self.R2, p)
        sel = self._ols(st, y2, p)
        mode = torch.as_tensor(self.modes, device=dev)
        cw_word = torch.full((C,), int(self.cw_word), dtype=torch.int64, device=dev)
        audio, dm = plain.demod(st, sel, mode, cw_word, self.fs_audio,
                                self.s["nfm_deviation_hz"], p)
        st.update(dm)
        audio = plain.agc_except_nfm(st, audio, mode, self.s["agc"], self.fs_audio, p)
        power = p.r(torch.mean(x.real ** 2 + x.imag ** 2, dim=-1))
        return st, {"audio": audio, "power_in": power}

    def _ols(self, st: dict, x: torch.Tensor, p: Precision) -> torch.Tensor:
        """Each channel through its mode's filter, overlap-save at the hop."""
        C, Ta = x.shape
        xp = torch.cat([st["ols"], x], dim=-1)
        st["ols"] = xp[:, xp.shape[-1] - (self.L - 1):]
        frames = xp.unfold(-1, self.nfft, self.hop)  # (C, Ta / hop, nfft)
        rows = torch.as_tensor(np.where(self.modes == plain.SAM, plain.AM, self.modes),
                               device=self.device)
        H = p.r(torch.as_tensor(self.H, device=self.device))[rows]
        y = torch.fft.ifft(p.r(torch.fft.fft(frames, dim=-1)) * H[:, None, :], dim=-1)
        return p.r(y[..., self.L - 1:].reshape(C, Ta))
