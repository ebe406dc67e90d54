"""Monitor — the every-channel receiver over one wideband stream (counterpart
of ``radioframe/api/monitor.py``; BASELINE config 5).

What ``Radio`` is to the per-channel RX chain, ``Monitor`` is to the PFB
channelizer: one wideband stream in, every channel demodulated out, with
runtime per-channel mode control and the panorama waterfall. The device is
named by the caller and never chosen automatically.

With a ``mesh`` (``make_mesh(channel=1, time=D, device=...)``) every rank
builds the same Monitor and passes the same global block to ``process``:
the rank steps its time slice through ``ShardedChannelizer`` and returns
the global audio, gathered over the mesh, as the reference's sharded
Monitor returns the global array. ``state`` is then the rank's part of the
state tree (``global_state`` gathers it).

>>> from radioframe_torch.core import presets
>>> m = Monitor(presets.channelizer_61m44(4096), device="cuda")
>>> m.set_mode(37, "am"); m.set_mode_all("ssb")
>>> audio = m.process(wideband_block)     # (M, T/M) numpy float32
>>> lines = m.waterfall()                 # dB lines from the last block

``process`` moves the complex block to the card through a pinned host
buffer (``core/stream.Stager``); ``save``/``load`` checkpoint the stream
state with the modes (``core/checkpoint.StreamCheckpointer``).
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.api._block import BlockObject
from radioframe_torch.api.radio import MODE_BY_NAME, NAME_BY_MODE
from radioframe_torch.device import resolve
from radioframe_torch.pipelines.channelizer import ChannelizerChain, ChannelizerConfig
from radioframe_torch.shard.channelizer import ShardedChannelizer


class Monitor(BlockObject):
    """Every-channel receiver over one wideband stream on ``device``."""

    def __init__(self, config: ChannelizerConfig, *, device, mesh=None):
        if mesh is not None and mesh.size("channel") != 1:
            raise ValueError("Monitor(mesh=...) shards one axis, time: the mesh's channel "
                             f"axis must be 1, not {mesh.size('channel')}")
        self.config = config
        device = resolve(device)
        chain = ChannelizerChain(config).to(device)
        self._modes = np.zeros(config.num_channels, dtype=np.int32)
        super().__init__(chain, chain.init_state(), device=device, mesh=mesh,
                         sharded=ShardedChannelizer)

    # -- control plane -------------------------------------------------------

    @property
    def num_channels(self) -> int:
        return self.config.num_channels

    def channel_frequency(self, channel: int) -> float:
        """Center of ``channel`` relative to the wideband center (channel c
        sits at +c*fs/M; channels above M/2 alias to negative offsets)."""
        M = self.config.num_channels
        c = channel if channel < M // 2 else channel - M
        return c * self.config.fs_channel

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]

    def set_mode_all(self, mode: str):
        self._modes[:] = MODE_BY_NAME[mode.lower()]

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    # -- data plane ----------------------------------------------------------

    def process(self, wideband) -> np.ndarray:
        """One block step: wideband (T,) complex, T a multiple of
        ``chain.min_block`` -> (M, T/M) float32 audio. The block crosses to
        the device as complex64; the single-pass chain reads its I and Q
        planes as strided views of it. The block's work queues on the
        Monitor's own stream (``Stager``'s)."""
        return self._block([(np.asarray(wideband), np.complex64)])

    def _controls(self) -> tuple:
        return (self._mirror("modes", self._modes),)

    def _shard_block(self, wideband: np.ndarray) -> np.ndarray:
        local = self._shard_slice(wideband)
        audio, aux = self._shard_step(self._stager.to_device(local))
        return self._stager.to_host(self._shard_gather(audio, aux))

    # the sharded block step in its parts (probe_channelizer.py times each)

    def _shard_slice(self, wideband: np.ndarray) -> np.ndarray:
        """This rank's time slice of the global block, complex64."""
        ta = self.mesh.axis("time")
        T = wideband.shape[-1]
        if T % ta.size:
            raise ValueError(f"block of {T} samples does not split over {ta.size} ranks")
        n = T // ta.size
        return np.ascontiguousarray(wideband[ta.index * n:(ta.index + 1) * n], np.complex64)

    def _shard_step(self, local: torch.Tensor):
        """Step the slice on the device: this rank's (audio, aux)."""
        (modes,) = self._controls()
        with torch.no_grad():
            self.state, audio, aux = self.sharded.step(self.state, local, modes)
        return audio, aux

    def _shard_gather(self, audio, aux) -> torch.Tensor:
        """The global audio (M, T/M) and aux, on every rank (collectives)."""
        with torch.no_grad():
            audio, self.last_aux = self.sharded.gather(audio, aux)
        return audio

    def waterfall(self):
        """dB waterfall lines from the last processed block (or None)."""
        if self.last_aux is None or "waterfall" not in self.last_aux:
            return None
        return self.last_aux["waterfall"].cpu().numpy()

    def channel_power(self):
        """Per-channel mean power from the last processed block (or None)."""
        if self.last_aux is None:
            return None
        return self.last_aux["channel_power"].cpu().numpy()

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str, epoch: int = 0) -> str:
        """Checkpoint the channelizer's stream state (PFB history, demod
        carries, AGC envelopes) and the per-channel modes. Under a mesh (a
        collective) the state is gathered, rank 0 writes the same file an
        unsharded Monitor writes, and every rank waits for it."""
        return self._save(directory, epoch, modes=self._modes)

    def load(self, directory: str, epoch: int | None = None) -> int:
        """Restore a checkpoint (the latest epoch by default); the stream then
        continues bit-exactly. Under a mesh every rank reads the global state
        and keeps its part (the sharded chain's ``state_specs``, the hang
        history's included). Returns the epoch."""
        return self._restore(directory, epoch, self.chain.init_state(), modes=self._modes)
