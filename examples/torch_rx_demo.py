"""Demo: the port's RxChain over a 4-signal wideband capture, 4 modes at once.

Usage: python examples/torch_rx_demo.py [--device cuda|cpu] [--channels N]
                                        [--snr DB] [--blocks N] [--blocked]

One wideband 192 kHz IQ stream carries SSB/CW/AM/NFM signals; N receiver
channels tune to them at once in one block program (BASELINE configs 1 and
2). With ``--blocked`` the capture streams through ``core.stream.BlockStream``
in blocks of 8 x the chain's minimum block instead of one block. Prints
per-mode audio SNR against the clean modulating audio.
"""

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--blocks", type=int, default=96)
    ap.add_argument("--blocked", action="store_true", help="stream through BlockStream")
    args = ap.parse_args(argv)

    from radioframe_torch.core.config import RxConfig
    from radioframe_torch.core.stream import BlockStream
    from radioframe_torch.device import resolve
    from radioframe_torch.diag.metrics import audio_snr_db
    from radioframe_torch.golden import model as G
    from radioframe_torch.io import fixtures as FX
    from radioframe_torch.ops import demod as demod_op
    from radioframe_torch.ops import filter_design as FD
    from radioframe_torch.ops import nco
    from radioframe_torch.pipelines.rx_chain import RxChain

    dev = resolve(args.device)
    FS = 192_000.0
    C = args.channels
    chain = RxChain(RxConfig(channels=C)).to(dev)
    n = args.blocks * chain.min_block

    print(f"generating fixtures ({n/FS:.2f} s of 192 kHz IQ)...")
    ssb_iq, ssb_truth = FX.ssb_capture(FS, n, 37_000.0, snr_db=args.snr)
    am_iq, am_truth = FX.am_capture(FS, n, 20_000.0, snr_db=args.snr)
    nfm_iq, nfm_truth = FX.nfm_capture(FS, n, -15_000.0, snr_db=args.snr)
    cw_iq, cw_key = FX.cw_capture(FS, n, 70_000.0, snr_db=args.snr)
    wideband = (ssb_iq + am_iq + nfm_iq + cw_iq).astype(np.complex64)

    base_freqs = [37_000.0, 70_000.0, 20_000.0, -15_000.0]
    base_modes = [demod_op.SSB, demod_op.CW, demod_op.AM, demod_op.NFM]
    words = torch.from_numpy(nco.freq_word([base_freqs[i % 4] for i in range(C)], FS)).to(dev)
    mode = torch.tensor([base_modes[i % 4] for i in range(C)], dtype=torch.int32, device=dev)

    def run():
        if args.blocked:
            blk = 8 * chain.min_block
            src = (np.broadcast_to(wideband[i:i + blk], (C, blk)) for i in range(0, n, blk))
            outs, _ = BlockStream(chain.step, chain.init_state(C), device=dev).run(src, words, mode)
            audio = torch.cat(outs, dim=-1)
        else:
            iq = torch.from_numpy(np.broadcast_to(wideband, (C, n)).copy()).to(dev)
            with torch.no_grad():
                _, audio, _ = chain.step(chain.init_state(C), iq, words, mode)
        return audio.cpu().numpy()

    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    audio = run()
    t2 = time.perf_counter()

    settle = 32 * 1024 if audio.shape[-1] >= 48 * 1024 else 0
    print(f"device: {dev}  channels: {C}  {'blocked' if args.blocked else 'one block'}")
    print(f"first run {t1-t0:.2f} s, second run {t2-t1:.3f} s "
          f"({n * C / (t2-t1) / 1e6:.1f} M chan-samples/s)")
    print(f"  SSB @ +37 kHz: {audio_snr_db(ssb_truth, audio[0]):6.1f} dB")
    if C >= 3:
        print(f"  AM  @ +20 kHz: "
              f"{audio_snr_db(am_truth[settle:], audio[2][settle:], trim=1024):6.1f} dB")
    if C >= 4:
        print(f"  NFM @ -15 kHz: "
              f"{audio_snr_db(nfm_truth[settle:], audio[3][settle:], trim=1024):6.1f} dB")
    if C >= 2:
        env = np.abs(audio[1])
        lp = FD.lowpass_taps(65, 100.0, 48_000.0)
        env_s, _ = G.fir_decimate(env.astype(np.complex128), lp, 1)
        key48 = cw_key[::4][: len(env_s)]
        c = np.corrcoef(np.real(env_s), key48)[0, 1]
        print(f"  CW  @ +70 kHz: keying correlation {c:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
