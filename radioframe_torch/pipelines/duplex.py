"""Full duplex, BASELINE config 4 (counterpart of
``radioframe/pipelines/duplex.py``): the RX DDC chain and the TX DUC chain
both run every block. The reference traces both into one program; here they
are two block steps in sequence on the chain's device and stream.
"""

from __future__ import annotations

from torch import nn

from radioframe_torch.core.config import RxConfig, TxConfig
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.pipelines.tx_chain import TxChain


class DuplexChain(nn.Module):
    def __init__(self, rx_cfg: RxConfig, tx_cfg: TxConfig):
        super().__init__()
        self.rx = RxChain(rx_cfg)
        self.tx = TxChain(tx_cfg)

    def init_state(self, num_channels: int | None = None) -> dict:
        return {"rx": self.rx.init_state(num_channels), "tx": self.tx.init_state(num_channels)}

    def step(self, state, rx_iq, tx_audio, rx_words, rx_mode, tx_words, tx_mode):
        """One full-duplex block: returns (state, rx_audio, tx_iq, rx_aux)."""
        rx_state, rx_audio, rx_aux = self.rx.step(state["rx"], rx_iq, rx_words, rx_mode)
        tx_state, tx_iq = self.tx.step(state["tx"], tx_audio, tx_words, tx_mode)
        return {"rx": rx_state, "tx": tx_state}, rx_audio, tx_iq, rx_aux
