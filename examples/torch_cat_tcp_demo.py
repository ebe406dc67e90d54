"""CAT-over-TCP demo on the port.

Usage: python examples/torch_cat_tcp_demo.py [--device cuda|cpu]

Starts a Kenwood-dialect CAT server on a TCP socket while a duplex stream
processes synthetic IQ blocks, then drives it as a rig-control client
(hamlib, wsjtx) would: query the identity, retune, change the mode, key
PTT, all mid-stream. The stream thread is joined with a timeout; a thread
still alive after it is reported and the demo exits 1.
"""

import argparse
import socket
import sys
import threading
import time

import numpy as np

from radioframe_torch.api.cat import CatServer
from radioframe_torch.api.cat_tcp import CatTcpServer
from radioframe_torch.api.transceiver import Transceiver
from radioframe_torch.core.config import RxConfig, TxConfig

JOIN_TIMEOUT_S = 30.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    trx = Transceiver(RxConfig(channels=1), TxConfig(channels=1), device=args.device)
    chain = trx.chain.rx
    B, fs = chain.min_block, trx.rx_cfg.fs_in
    stop = threading.Event()
    errors = []

    def stream():
        rng = np.random.default_rng(0)
        n = 0
        try:
            while not stop.is_set():
                t = (np.arange(B) + n * B) / fs
                iq = (0.3 * np.exp(2j * np.pi * 39_500.0 * t)
                      + 0.01 * (rng.standard_normal(B) + 1j * rng.standard_normal(B)))
                with srv.lock:  # a multi-part command never half-applies to a block
                    audio, _ = trx.process(iq.astype(np.complex64)[None, :],
                                           np.zeros(B // trx.rx_cfg.decim, np.float32))
                n += 1
                if n % 20 == 0:
                    print(f"  [stream] block {n}: rms={np.sqrt(np.mean(audio**2)):.4f} "
                          f"{trx.s_meter(0)}")
        except Exception as e:  # reported below
            errors.append(e)

    with CatTcpServer(CatServer(trx)) as srv:
        print(f"CAT server listening on {srv.host}:{srv.port} (stream on {trx.device})")
        th = threading.Thread(target=stream, daemon=True)
        th.start()
        cli = socket.create_connection((srv.host, srv.port), timeout=5)
        cli.settimeout(5)

        def ask(cmd):
            cli.sendall(cmd.encode())
            if cmd.rstrip(";") not in ("TX", "RX"):  # those answer nothing
                resp = cli.recv(4096).decode()
                print(f"  client> {cmd!r:24} server> {resp!r}")
            else:
                print(f"  client> {cmd!r}")

        try:
            ask("ID;")
            ask("FA00000038500;MD2;IF;")   # tune onto the tone, USB
            time.sleep(0.5)
            ask("SM;")                      # S-meter after the AGC settles
            ask("TX;")                      # key PTT
            time.sleep(0.3)
            ask("IF;")                      # the status shows TX
            ask("RX;")
        finally:
            stop.set()
            cli.close()
            th.join(timeout=JOIN_TIMEOUT_S)
    if errors:
        raise errors[0]
    if th.is_alive():
        print(f"the stream thread is still running {JOIN_TIMEOUT_S:.0f} s after stop",
              file=sys.stderr)
        return 1
    print("done: retune, mode and PTT all took effect mid-stream")
    return 0


if __name__ == "__main__":
    sys.exit(main())
