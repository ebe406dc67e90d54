"""Sharded full duplex, BASELINE config 4 over a ("channel", "time") mesh
(counterpart of ``radioframe/shard/duplex.py``): ``ShardedRxChain`` and
``ShardedTxChain`` over one ``DuplexChain``, two block steps in sequence on
each rank."""

from __future__ import annotations

from radioframe_torch.pipelines.duplex import DuplexChain
from radioframe_torch.shard.rx import ShardedRxChain
from radioframe_torch.shard.tx import ShardedTxChain


class ShardedDuplex:
    def __init__(self, dpx: DuplexChain, mesh):
        self.rx = ShardedRxChain(dpx.rx, mesh)
        self.tx = ShardedTxChain(dpx.tx, mesh)
        self.dpx = dpx

    def init_state(self, num_channels: int | None = None) -> dict:
        return self.dpx.init_state(num_channels)

    def state_specs(self) -> dict:
        return {"rx": self.rx.state_specs(), "tx": self.tx.state_specs()}

    def close(self) -> None:
        """Free the RX side's K7 buffers (a collective over the time axis)."""
        self.rx.close()

    def step(self, state, rx_iq, tx_audio, rx_words, rx_mode, tx_words, tx_mode):
        """One rank's full-duplex block: (state, rx_audio, tx_iq, rx_aux), each
        this rank's shard."""
        rx_state, rx_audio, rx_aux = self.rx.step(state["rx"], rx_iq, rx_words, rx_mode)
        tx_state, tx_iq = self.tx.step(state["tx"], tx_audio, tx_words, tx_mode)
        return {"rx": rx_state, "tx": tx_state}, rx_audio, tx_iq, rx_aux
