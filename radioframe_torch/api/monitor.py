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

from radioframe_torch.api.radio import MODE_BY_NAME, NAME_BY_MODE
from radioframe_torch.core.checkpoint import StreamCheckpointer, save_on_rank0
from radioframe_torch.core.compiled import CompiledStep, clone_tree
from radioframe_torch.core.stream import Stager
from radioframe_torch.device import resolve
from radioframe_torch.diag.timing import span
from radioframe_torch.pipelines.channelizer import ChannelizerChain, ChannelizerConfig
from radioframe_torch.shard.channelizer import ShardedChannelizer
from radioframe_torch.shard.mesh import gather_state, shard_state


class Monitor:
    """Every-channel receiver over one wideband stream on ``device``."""

    def __init__(self, config: ChannelizerConfig, *, device, mesh=None):
        self.config = config
        self.device = resolve(device)
        self.mesh = mesh
        self.sharded = None  # the ShardedChannelizer under a mesh
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, Monitor on {self.device}")
            if mesh.size("channel") != 1:
                raise ValueError("Monitor(mesh=...) shards one axis, time: the mesh's channel "
                                 f"axis must be 1, not {mesh.size('channel')}")
        self.chain = ChannelizerChain(config).to(self.device)
        self._modes = np.zeros(config.num_channels, dtype=np.int32)
        self._compiled = None  # the captured step without a mesh
        if mesh is not None:
            self.sharded = ShardedChannelizer(self.chain, mesh)
            self._state = shard_state(self.chain.init_state(), self.sharded.state_specs(), mesh)
        else:
            # the reference's jax.jit(_step_planes): one graph a block signature
            self._compiled = CompiledStep(self.chain.step, self.chain.init_state(),
                                          device=self.device, donate=False,
                                          name="Monitor.process")
        self.last_aux = None
        # the modes on the device: one tensor for the Monitor's life, rewritten
        # in place after a mode change, so the captured step stays bound to it
        self._modes_dev = torch.zeros(config.num_channels, dtype=torch.int32,
                                      device=self.device)
        self._modes_stale = False
        # the Monitor's own stream: its blocks queue there, beside other objects'
        self._stager = Stager(self.device, own_stream=True)

    @property
    def state(self) -> dict:
        """The chain state after the last block (a copy of the captured
        step's buffers; under a mesh, the rank's part)."""
        return self._state if self._compiled is None else self._compiled.state

    @state.setter
    def state(self, tree) -> None:
        """Seen by the next block: copied into the captured step's buffers."""
        if self._compiled is None:
            self._state = tree
        else:
            with self._stager.running():
                self._compiled.state = tree

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
        self._modes_stale = True

    def set_mode_all(self, mode: str):
        self._modes[:] = MODE_BY_NAME[mode.lower()]
        self._modes_stale = True

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    # -- data plane ----------------------------------------------------------

    def process(self, wideband) -> np.ndarray:
        """One block step: wideband (T,) complex, T a multiple of
        ``chain.min_block`` -> (M, T/M) float32 audio. The block crosses to
        the device as complex64; the single-pass chain reads its I and Q
        planes as strided views of it. The block's work queues on the
        Monitor's own stream (``Stager``'s)."""
        with span("api.process", root=True) as sp, self._stager.running():
            if sp:
                sp.stream = self._stager.stream_id()
            wideband = np.asarray(wideband)
            if self.mesh is not None:
                local = self._shard_slice(wideband)
                audio, aux = self._shard_step(self._stager.to_device(local))
                return self._stager.to_host(self._shard_gather(audio, aux))
            x = self._stager.to_device(wideband, np.complex64)
            audio, aux = self._compiled(x, self._device_modes())
            self.last_aux = clone_tree(aux)  # the next replay overwrites the graph's own
            return self._stager.to_host(audio)

    def _device_modes(self) -> torch.Tensor:
        if self._modes_stale:
            self._modes_dev.copy_(torch.from_numpy(self._modes))
            self._modes_stale = False
        return self._modes_dev

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
        with torch.no_grad():
            self.state, audio, aux = self.sharded.step(self.state, local, self._device_modes())
        return audio, aux

    def _shard_gather(self, audio, aux) -> torch.Tensor:
        """The global audio (M, T/M) and aux, on every rank (collectives)."""
        with torch.no_grad():
            audio, self.last_aux = self.sharded.gather(audio, aux)
        return audio

    def global_state(self) -> dict:
        """The whole chain state: ``state`` itself, or under a mesh the
        ranks' parts joined on every rank (a collective)."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.sharded.state_specs(), self.mesh)

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

    def _payload(self, state) -> dict:
        return {"state": state, "modes": self._modes}

    def save(self, directory: str, epoch: int = 0) -> str:
        """Checkpoint the channelizer's stream state (PFB history, demod
        carries, AGC envelopes) and the per-channel modes. Under a mesh (a
        collective) the state is gathered, rank 0 writes the same file an
        unsharded Monitor writes, and every rank waits for it."""
        ck = StreamCheckpointer(directory)
        payload = self._payload(self.global_state())
        if self.mesh is None:
            return ck.save(epoch, payload)
        return save_on_rank0(ck, epoch, payload, self.mesh)

    def load(self, directory: str, epoch: int | None = None) -> int:
        """Restore a checkpoint (the latest epoch by default); the stream then
        continues bit-exactly. Under a mesh every rank reads the global state
        and keeps its part (the sharded chain's ``state_specs``, the hang
        history's included). Returns the epoch."""
        like = self._payload(self.chain.init_state())
        epoch, restored = StreamCheckpointer(directory).restore_epoch(like, epoch)
        self.state = restored["state"]
        if self.mesh is not None:
            self.state = shard_state(self.state, self.sharded.state_specs(), self.mesh)
        self._modes[:] = restored["modes"]
        self._modes_stale = True
        return epoch
