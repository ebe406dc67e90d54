"""The plain reference of the wideband channelizer (BASELINE config 5): a
critically sampled polyphase filterbank of M channels (K taps a branch, an
M-point DFT a frame), the demod bank and the AGC at the channel rate, the
channels' mean power and the waterfall (linear power averaged over frames,
in dB, low to high frequency).

Written from the configuration's numbers alone (``sizes``, a configuration
file's contents): the prototype filter and the tables are designed here
again.
"""

from __future__ import annotations

import numpy as np
import torch

from rfbench.reference import filter_design as fd
from rfbench.reference import plain
from rfbench.reference.plain import Precision


class ChannelizerReference:
    """The channelizer for ``sizes``; ``step`` runs one block."""

    def __init__(self, sizes: dict, modes, device):
        self.s = sizes
        self.device = torch.device(device)
        self.M, self.K = sizes["num_channels"], sizes["taps_per_channel"]
        self.h = fd.pfb_prototype_taps(self.M, self.K).reshape(self.K, self.M)
        self.fs_ch = sizes["fs_in"] / self.M
        self.cw_word = plain.freq_word(sizes["cw_tone_hz"], self.fs_ch)
        self.avg = sizes["waterfall_frame_avg"]
        self.modes = np.asarray(modes, np.int64)

    def init_state(self, start_block: int, T: int, p: Precision) -> dict:
        """The state at the start of block ``start_block``: the BFO
        accumulator worked out from the block count, the rest fresh."""
        F = T // self.M
        st = plain.demod_init(self.M, start_block, F, np.full(self.M, self.cw_word),
                              self.device, p)
        st["tail"] = torch.zeros(((self.K - 1) * self.M,), dtype=p.cplx, device=self.device)
        return st

    def step(self, st: dict, wideband: torch.Tensor, p: Precision):
        """(state, wideband (T,) complex) -> (state, {"audio": (M, F),
        "channel_power": (M,), "waterfall": (F/avg, M)})."""
        M, K = self.M, self.K
        x = p.r(wideband.to(self.device))
        F = x.shape[-1] // M
        xp = torch.cat([st["tail"], x])
        st["tail"] = xp[F * M:]
        frames = xp.reshape(F + K - 1, M)
        h = p.r(torch.as_tensor(self.h, device=self.device))
        u = torch.zeros((F, M), dtype=p.cplx, device=self.device)
        for t in range(K):
            u = u + h[t] * frames[K - 1 - t: K - 1 - t + F]
        chans = p.r(torch.fft.fft(p.r(u), dim=-1)).T  # (M, F): channel c at +c fs/M
        mode = torch.as_tensor(self.modes, device=self.device)
        cw_word = torch.full((M,), int(self.cw_word), dtype=torch.int64, device=self.device)
        audio, dm = plain.demod(st, chans, mode, cw_word, self.fs_ch, self.s["nfm_deviation_hz"],
                                p)
        st.update(dm)
        audio = plain.agc_except_nfm(st, audio, mode, self.s["agc"], self.fs_ch, p)
        pw = p.r(chans.real ** 2 + chans.imag ** 2)
        lines = pw.reshape(M, F // self.avg, self.avg).mean(dim=-1)
        db = 10.0 * torch.log10(torch.clamp_min(lines, 1e-24))
        return st, {"audio": audio, "channel_power": p.r(pw.mean(dim=-1)),
                    "waterfall": torch.roll(db, M // 2, dims=0).T}
