"""Demo: the port's full-duplex TRX — TX a voice signal and RX it back.

Usage: python examples/torch_duplex_demo.py [--device cuda|cpu]
           [--mode ssb|am|nfm] [--offset HZ] [--rx-offset HZ] [--seconds S]

Drives DuplexChain (BASELINE.json config 4): the TX DUC chain modulates audio
up to +offset inside a 192 kHz IQ spectrum; the RX DDC chain tunes
--rx-offset (default = offset) and demodulates. Prints the TX spectrum peak
and the loopback audio SNR.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--mode", default="ssb", choices=["ssb", "am", "nfm"])
    ap.add_argument("--offset", type=float, default=25_000.0)
    ap.add_argument("--rx-offset", type=float, default=None)
    ap.add_argument("--seconds", type=float, default=1.0, help="audio length (whole blocks)")
    args = ap.parse_args(argv)

    import torch

    from radioframe_torch.core.config import RxConfig, TxConfig
    from radioframe_torch.device import resolve
    from radioframe_torch.diag.metrics import audio_snr_db
    from radioframe_torch.io import fixtures as FX
    from radioframe_torch.ops import demod as demod_op
    from radioframe_torch.ops import nco
    from radioframe_torch.pipelines.duplex import DuplexChain

    dev = resolve(args.device)
    FS, FA = 192_000.0, 48_000.0
    rx_off = args.offset if args.rx_offset is None else args.rx_offset
    n = max(1, int(args.seconds * FA) // 2048) * 2048  # audio samples
    if args.mode == "ssb":
        audio = FX.voicelike_audio(FA, n)
    else:
        t = np.arange(n) / FA
        audio = (0.6 * np.sin(2 * np.pi * 800.0 * t)).astype(np.float32)

    dpx = DuplexChain(RxConfig(channels=1), TxConfig(channels=1, compressor_max_gain=1.0)).to(dev)
    txw = torch.from_numpy(np.asarray([nco.freq_word(args.offset, FS)], np.int32)).to(dev)
    rxw = torch.from_numpy(np.asarray([nco.freq_word(rx_off, FS)], np.int32)).to(dev)
    m = torch.tensor([demod_op.MODE_NAMES[args.mode]], dtype=torch.int32, device=dev)
    mic = torch.from_numpy(np.asarray(audio, np.float32)[None, :]).to(dev)

    with torch.no_grad():
        st = dpx.init_state(1)
        st, _, tx_iq, _ = dpx.step(st, torch.zeros((1, 4 * n), dtype=torch.complex64, device=dev),
                                   mic, rxw, m, txw, m)
        tx = tx_iq[0].cpu().numpy()
        X = np.abs(np.fft.fft(tx))
        f = np.fft.fftfreq(len(tx), 1 / FS)
        peak = f[np.argmax(X)]
        print(f"TX on {dev}: mode={args.mode} requested +{args.offset / 1e3:.1f} kHz, "
              f"spectrum peak at {peak / 1e3:+.2f} kHz, power "
              f"{10 * np.log10(np.mean(np.abs(tx) ** 2)):.1f} dB")

        st2 = dpx.init_state(1)
        st2, rx_audio, _, _ = dpx.step(st2, tx_iq, torch.zeros_like(mic), rxw, m, txw, m)
    out = rx_audio[0].cpu().numpy()
    settle = min(16 * 1024, n // 2)
    snr = audio_snr_db(audio[settle:], out[settle:], trim=1024)
    print(f"RX @ {rx_off / 1e3:+.1f} kHz: loopback audio SNR {snr:.1f} dB "
          f"(vs raw mic audio; AGC + band edges included)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
