"""Radio — the user-facing control plane (counterpart of
``radioframe/api/radio.py``).

A plain Python object owns the chain, its state on the device and the
runtime tuning arrays. Retunes and mode switches update small tensors; the
device is named by the caller and never chosen automatically.

With a ``mesh`` (``shard/mesh.py``) every rank builds the same Radio and
passes the same global block to ``process``: the rank steps its (channel,
time) shard through ``ShardedRxChain`` and returns the global audio,
gathered over the mesh, as the reference's jitted sharded Radio returns the
global array. ``state`` is then the rank's channel slice.
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.api._block import BlockObject
from radioframe_torch.core.config import RxConfig
from radioframe_torch.device import resolve
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.ops.spectrum import snap_to_peak
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.shard.rx import ShardedRxChain

MODE_BY_NAME = dict(demod_op.MODE_NAMES)
# canonical name per code ("usb" is an alias of "ssb")
NAME_BY_MODE = {demod_op.SSB: "ssb", demod_op.CW: "cw", demod_op.AM: "am",
                demod_op.NFM: "nfm", demod_op.LSB: "lsb", demod_op.SAM: "sam"}


class Radio(BlockObject):
    """Multi-channel receiver with runtime tune/mode control.

    >>> r = Radio(RxConfig(channels=4), device="cuda")
    >>> r.tune(0, 37_000.0); r.set_mode(0, "ssb")
    >>> audio = r.process(iq_block)          # (C, T/decim) numpy float32
    """

    def __init__(self, config: RxConfig, *, device, mesh=None):
        self.config = config
        device = resolve(device)
        chain = RxChain(config).to(device)
        self._freqs = np.zeros(config.channels, dtype=np.float64)
        self._modes = np.zeros(config.channels, dtype=np.int32)
        super().__init__(chain, chain.init_state(config.channels), device=device, mesh=mesh,
                         sharded=ShardedRxChain)

    # -- control plane -------------------------------------------------------

    def tune(self, channel: int, freq_hz: float):
        self._freqs[channel] = freq_hz

    def frequency(self, channel: int) -> float:
        return float(self._freqs[channel])

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    # -- data plane ----------------------------------------------------------

    def process(self, iq_block) -> np.ndarray:
        """Feed one IQ block ((T,) shared wideband or (C, T)); returns audio.
        The block's work queues on the Radio's own stream (``Stager``'s), so
        Radios driven from several threads run side by side on one card."""
        iq = np.asarray(iq_block)
        return self._block([(iq[None, :] if iq.ndim == 1 else iq, np.complex64)])

    def _controls(self) -> tuple:
        """The tuning words (made again only after a retune) and the modes."""
        return (self._mirror("words", self._freqs,
                             derive=lambda f: nco.freq_word(f, self.config.fs_in)),
                self._mirror("modes", self._modes))

    def _shard_block(self, iq: np.ndarray) -> np.ndarray:
        """Step this rank's shard of the global block; gather audio and aux."""
        C, T = self.config.channels, iq.shape[-1]
        ch, tm = self.mesh.axis("channel"), self.mesh.axis("time")
        if C % ch.size or T % tm.size:
            raise ValueError(f"block ({C}, {T}) does not split over mesh {self.mesh.shape}")
        cs = slice(ch.index * (C // ch.size), (ch.index + 1) * (C // ch.size))
        ts = slice(tm.index * (T // tm.size), (tm.index + 1) * (T // tm.size))
        words, modes = self._controls()
        x = self._stager.to_device(np.broadcast_to(iq, (C, T))[cs, ts], np.complex64)
        with torch.no_grad():
            self.state, audio, aux = self.sharded.step(self.state, x, words[cs], modes[cs])

        def gather(t, time_dim=None):
            if time_dim is not None:
                t = torch.cat(list(tm.all_gather(t)), dim=time_dim)
            return torch.cat(list(ch.all_gather(t)), dim=0)

        # the panorama's lines and the VAD's flags are per frame: time-sharded
        self.last_aux = {k: gather(v, 1 if k in ("spectrum", "vad_active") else None)
                         for k, v in aux.items()}
        out = self._stager.to_host(gather(audio, 1))
        self.sharded.check()  # K7's flags, read once the block's work is done
        return out

    # -- observability -------------------------------------------------------

    def capabilities(self) -> dict:
        """Feature/interop status map (surfaced in the CLI ``info`` command).

        Flags the digital modes whose code tables are PROVISIONAL stand-ins
        (see ops/ft8.py / ops/wspr.py headers): they round-trip against this
        package's own encoders but do not claim on-air interop until the
        published tables land in ``radioframe_torch/data/``."""
        from radioframe_torch.ops import ft8, wspr

        caps = {"modes": sorted(set(MODE_BY_NAME)), "ft8": True, "wspr": True}
        if ft8.INTEROP_PROVISIONAL:
            caps["ft8_interop"] = "PROVISIONAL: " + ", ".join(ft8.PROVISIONAL_ITEMS)
        if wspr.INTEROP_PROVISIONAL:
            caps["wspr_interop"] = "PROVISIONAL: " + ", ".join(wspr.PROVISIONAL_ITEMS)
        return caps

    def metrics(self) -> dict:
        """Per-channel metrics from the last processed block."""
        if self.last_aux is None:
            return {}
        return {k: v.cpu().numpy() for k, v in self.last_aux.items() if k != "spectrum"}

    def waterfall(self):
        """(C, F, nfft) dB panorama lines of the last block, or None without
        ``emit_spectrum``."""
        if self.last_aux is None or "spectrum" not in self.last_aux:
            return None
        return self.last_aux["spectrum"].cpu().numpy()

    def snap(self, channel: int, search_hz: float = 1000.0):
        """Auto frequency snap: retune to the strongest peak within
        ±search_hz of the current frequency (the panorama is taken after the
        mix, so a peak's bin offset is the tuning error)."""
        wf = self.waterfall()
        if wf is None:
            raise ValueError("Radio.snap needs emit_spectrum=True and a processed block")
        off = snap_to_peak(torch.from_numpy(wf[:, -1, :]), self.config.fs_audio, search_hz,
                           self.config.spectrum_nfft)
        self._freqs[channel] += float(off[channel])
        return self._freqs[channel]

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str, epoch: int = 0) -> str:
        """Checkpoint the stream state, the frequencies and the modes as
        ``epoch`` under ``directory``; returns the epoch's path. Under a mesh
        (a collective) the state is gathered, rank 0 writes the same file an
        unsharded Radio writes, and every rank waits for it."""
        return self._save(directory, epoch, freqs=self._freqs, modes=self._modes)

    def load(self, directory: str, epoch: int | None = None) -> int:
        """Restore a checkpoint (the latest epoch by default); the stream then
        continues bit-exactly. Under a mesh every rank reads the global state
        and keeps its shard. Returns the epoch."""
        return self._restore(directory, epoch, self.chain.init_state(self.config.channels),
                             freqs=self._freqs, modes=self._modes)
