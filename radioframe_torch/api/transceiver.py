"""Transceiver — the PTT/split/RIT/XIT control plane over the full-duplex
chain (counterpart of ``radioframe/api/transceiver.py``).

The duplex chain steps RX and TX every block; PTT is a routing decision:
which half's output is live, with the reference's semantics (RX muted
while transmitting, TX IQ zero while receiving).

The VFO model is the reference's: VFO A/B per channel, split operation (RX
on A, TX on B), and RIT/XIT offsets applied at the frequency-word level so
they never touch the stored VFO frequency. The device is named by the
caller; blocks move to it through a pinned host buffer
(``core/stream.Stager``).
"""

from __future__ import annotations

import numpy as np

from radioframe_torch.api._block import BlockObject
from radioframe_torch.api.bands import BandMemory
from radioframe_torch.api.radio import MODE_BY_NAME, NAME_BY_MODE
from radioframe_torch.core.config import RxConfig, TxConfig
from radioframe_torch.device import resolve
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.duplex import DuplexChain


def s_meter(power_linear: float, full_scale_dbm: float = 0.0) -> str:
    """IQ power -> S-meter reading (S1..S9, then dB over S9).

    S9 = -73 dBm at the antenna (IARU Region 1 technical recommendation);
    digital full scale maps to ``full_scale_dbm``; 6 dB per S-unit below S9.
    """
    if power_linear <= 0.0:
        return "S0"
    dbm = 10.0 * np.log10(power_linear) + full_scale_dbm
    over9 = dbm - (-73.0)
    if over9 >= 0:
        return f"S9+{int(round(over9))}" if over9 >= 0.5 else "S9"
    s = 9 + over9 / 6.0
    return f"S{max(0, int(round(s)))}"


class Transceiver(BlockObject):
    """Multi-channel full-duplex transceiver on ``device``.

    >>> trx = Transceiver(RxConfig(channels=2), TxConfig(channels=2), device="cuda")
    >>> trx.set_band(0, "40m")          # band memory recall
    >>> trx.split(0, True); trx.vfo_b(0, 7_105_000.0)
    >>> trx.ptt(True)
    >>> audio, tx_iq = trx.process(rx_iq, mic_audio)
    """

    def __init__(self, rx_cfg: RxConfig, tx_cfg: TxConfig, *, device):
        if rx_cfg.channels != tx_cfg.channels:
            raise ValueError(f"RX has {rx_cfg.channels} channels, TX {tx_cfg.channels}")
        self.rx_cfg, self.tx_cfg = rx_cfg, tx_cfg
        device = resolve(device)
        C = rx_cfg.channels
        chain = DuplexChain(rx_cfg, tx_cfg).to(device)
        # VFOs and offsets (host side, per channel)
        self._vfo_a = np.zeros(C, np.float64)
        self._vfo_b = np.zeros(C, np.float64)
        self._split = np.zeros(C, bool)
        self._rit = np.zeros(C, np.float64)  # RX incremental tuning (Hz)
        self._xit = np.zeros(C, np.float64)  # TX incremental tuning (Hz)
        self._rx_vfo = np.zeros(C, np.int32)  # receive VFO select: 0=A, 1=B
        self._modes = np.zeros(C, np.int32)
        self._ptt = False
        self.band_memory = BandMemory()
        # the reference's "one jitted program": one graph a block signature
        super().__init__(chain, chain.init_state(C), device=device)

    # -- VFO / band control ----------------------------------------------------

    def tune(self, channel: int, freq_hz: float):
        self._vfo_a[channel] = freq_hz

    def vfo_b(self, channel: int, freq_hz: float):
        self._vfo_b[channel] = freq_hz

    def swap_vfo(self, channel: int):
        a = self._vfo_a[channel]
        self._vfo_a[channel] = self._vfo_b[channel]
        self._vfo_b[channel] = a

    def split(self, channel: int, enabled: bool):
        self._split[channel] = enabled

    def select_rx_vfo(self, channel: int, which: int):
        """Absolute receive-VFO selection (0=A, 1=B): idempotent, unlike
        swap_vfo; CAT FR re-asserts it on every client reconnect."""
        self._rx_vfo[channel] = 1 if which else 0

    def rx_vfo(self, channel: int) -> int:
        return int(self._rx_vfo[channel])

    def rit(self, channel: int, offset_hz: float):
        self._rit[channel] = offset_hz

    def xit(self, channel: int, offset_hz: float):
        self._xit[channel] = offset_hz

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    def set_band(self, channel: int, name: str):
        """Recall the band memory (or the band-plan default) for ``name``;
        stores the current frequency into its own band first (band-stack
        behaviour)."""
        self.band_memory.store(self._vfo_a[channel], self.mode(channel))
        freq, mode = self.band_memory.recall(name)
        self.tune(channel, freq)
        self.set_mode(channel, mode)

    # -- PTT -----------------------------------------------------------------------

    def ptt(self, keyed: bool):
        self._ptt = bool(keyed)

    @property
    def transmitting(self) -> bool:
        return self._ptt

    def rx_frequency(self, channel: int) -> float:
        vfo = self._vfo_b if self._rx_vfo[channel] else self._vfo_a
        return float(vfo[channel] + self._rit[channel])

    def tx_frequency(self, channel: int) -> float:
        vfo = self._vfo_b if self._split[channel] else self._vfo_a
        return float(vfo[channel] + self._xit[channel])

    # -- data plane ----------------------------------------------------------------

    def step_inputs(self) -> tuple:
        """(rx_words, rx_modes, tx_words, tx_modes) for the next block, as
        int32 numpy arrays: the VFO, split and RIT/XIT routing in words, and
        SAM sent as AM (SAM is a receive technique; its transmit form is
        plain AM)."""
        rx_f = np.where(self._rx_vfo != 0, self._vfo_b, self._vfo_a) + self._rit
        tx_f = np.where(self._split, self._vfo_b, self._vfo_a) + self._xit
        tx_modes = np.where(self._modes == demod_op.SAM, demod_op.AM, self._modes)
        return (nco.freq_word(rx_f, self.rx_cfg.fs_in), self._modes.copy(),
                nco.freq_word(tx_f, self.tx_cfg.fs_out), tx_modes.astype(np.int32))

    def process(self, rx_iq, mic_audio):
        """One block. Returns (rx_audio, tx_iq) as numpy; tx_iq is zeros when
        PTT is up, rx_audio is muted while transmitting. The block's work
        queues on the Transceiver's own stream (``Stager``'s)."""
        iq = np.asarray(rx_iq)
        mic = np.asarray(mic_audio)
        if mic.ndim == 1:
            mic = np.broadcast_to(mic[None, :], (self.rx_cfg.channels, mic.shape[0]))

        def finish(rx_audio, tx_iq):
            if self._ptt:
                return np.zeros(tuple(rx_audio.shape), np.float32), self._stager.to_host(tx_iq)
            return self._stager.to_host(rx_audio), np.zeros(tuple(tx_iq.shape), np.complex64)

        return self._block([(iq[None, :] if iq.ndim == 1 else iq, np.complex64),
                            (mic, np.float32)], finish)

    def _controls(self) -> tuple:
        """``step_inputs()``, made again only after a change of the arrays
        it reads."""
        return self._mirror("controls", self._vfo_a, self._vfo_b, self._split, self._rit,
                            self._xit, self._rx_vfo, self._modes,
                            derive=lambda *_: self.step_inputs())

    # -- observability -------------------------------------------------------------

    def s_meter(self, channel: int) -> str:
        if self.last_aux is None:
            return "S0"
        return s_meter(float(self.last_aux["power_in"][channel]))
