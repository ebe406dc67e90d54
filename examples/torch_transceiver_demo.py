"""Transceiver control-plane demo on the port: CAT protocol + PTT/split
over the duplex chain.

Usage: python examples/torch_transceiver_demo.py [--device cuda|cpu]

Drives the Kenwood-dialect CatServer as rig-control software would
(semicolon-terminated ASCII): tune, set the mode, split, key PTT, read the
S-meter and the IF frame.
"""

import argparse
import sys

import numpy as np

from radioframe_torch.api.cat import CatServer
from radioframe_torch.api.transceiver import Transceiver
from radioframe_torch.core.config import RxConfig, TxConfig
from radioframe_torch.io import fixtures as FX


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    trx = Transceiver(RxConfig(channels=1), TxConfig(channels=1), device=args.device)
    cat = CatServer(trx)

    # a rig-control session
    print("> FA00007100000; MD2; FT1; FB00007105000;   (tune, USB, split)")
    cat.handle("FA00007100000;MD2;FT1;FB00007105000;")
    print(f"  rx {trx.rx_frequency(0)/1e6:.4f} MHz  tx {trx.tx_frequency(0)/1e6:.4f} MHz"
          f"  mode {trx.mode(0)}  split {bool(trx._split[0])}")
    print("> IF;  ->", cat.handle("IF;"))

    # receive a block: SSB signal at the tuned offset (baseband capture)
    iq, _truth = FX.ssb_capture(trx.rx_cfg.fs_in, 8 * trx.chain.rx.min_block, 37_000.0)
    trx.tune(0, 37_000.0)  # retune within the capture
    mic = np.zeros(len(iq) // trx.rx_cfg.decim, np.float32)
    audio, _ = trx.process(iq.astype(np.complex64), mic)
    print(f"RX audio power {10*np.log10(np.mean(audio**2)+1e-30):.1f} dB, "
          f"S-meter {trx.s_meter(0)}  (CAT SM: {cat.handle('SM0;')}) on {trx.device}")

    # key PTT over CAT: RX mutes, TX IQ flows
    cat.handle("TX;")
    mic = FX.voicelike_audio(48_000.0, len(iq) // trx.rx_cfg.decim).astype(np.float32)
    audio_tx, tx_iq = trx.process(iq.astype(np.complex64), mic)
    print(f"PTT keyed: rx_audio muted={not audio_tx.any()}, "
          f"tx power {10*np.log10(np.mean(np.abs(tx_iq)**2)+1e-30):.1f} dB")
    cat.handle("RX;")
    print("> RX;  transmitting =", trx.transmitting)
    return 0


if __name__ == "__main__":
    sys.exit(main())
