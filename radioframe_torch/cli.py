"""radioframe_torch CLI (counterpart of ``radioframe/cli.py``).

    python -m radioframe_torch.cli rx --wav cap.wav --freq 37000 --mode ssb --out audio.wav
    python -m radioframe_torch.cli tx --wav voice.wav --freq 12000 --mode am --out iq.wav
    python -m radioframe_torch.cli decode --wav audio.wav [--rtty] [--tone HZ]
    python -m radioframe_torch.cli monitor --wav wide.wav --channels 4096
    python -m radioframe_torch.cli cat --port 4532
    python -m radioframe_torch.cli demo [--blocked] [--snr DB]
    python -m radioframe_torch.cli info

Every command that runs a chain takes ``--device`` (default ``cuda``); a
CUDA device on a machine without a card is an error, never a CPU run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# the decimation plan for a capture's sample rate (the presets'); any other
# rate takes RxConfig's default plan
_RX_PLANS = {192_000.0: "capture_192k", 1_536_000.0: "wideband_1536k",
             61_440_000.0: "adc_61m44"}


def rx_config(fs: float, **kw):
    """The RxConfig ``rx`` runs for a capture at ``fs``: the preset plan for
    that rate, one channel, the fused depth-2 front end (K1)."""
    from radioframe_torch.core import presets
    from radioframe_torch.core.config import RxConfig

    kw = dict(channels=1, fuse_frontend=True, fuse_frontend_depth=2, **kw)
    if fs in _RX_PLANS:
        return getattr(presets, _RX_PLANS[fs])(**kw)
    return RxConfig(fs_in=fs, **kw)


def _cmd_info(args):
    import torch

    from radioframe_torch.device import resolve
    from radioframe_torch.pipelines.rx_chain import RxChain
    from radioframe_torch.core.config import RxConfig

    dev = resolve(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"radioframe_torch: torch {torch.__version__}, device {dev} ({name})")
    chain = RxChain(RxConfig())
    print(f"default RX chain: fs_in={chain.cfg.fs_in:.0f} Hz, decim={chain.cfg.decim}, "
          f"audio fs={chain.cfg.fs_audio:.0f} Hz, min block={chain.min_block}")
    from radioframe_torch.ops import ft8, wspr

    for name, mod in (("FT8", ft8), ("WSPR", wspr)):
        if mod.INTEROP_PROVISIONAL:
            print(f"{name}: on-air interop PROVISIONAL "
                  f"(stand-in tables: {', '.join(mod.PROVISIONAL_ITEMS)})")
        else:
            print(f"{name}: published tables loaded")
    return 0


def _cmd_rx(args):
    from radioframe_torch.api.radio import Radio
    from radioframe_torch.io.wav import read_wav, write_wav

    iq, fs = read_wav(args.wav)
    cfg = rx_config(fs, emit_spectrum=args.waterfall is not None)
    r = Radio(cfg, device=args.device)
    r.tune(0, args.freq)
    r.set_mode(0, args.mode)
    chain_min = r.chain.min_block
    n = (len(iq) // chain_min) * chain_min
    if n == 0:
        print(f"capture too short: {len(iq)} < one block ({chain_min})", file=sys.stderr)
        return 1
    audio = r.process(iq[:n])[0]
    write_wav(args.out, audio, cfg.fs_audio)
    m = r.metrics()
    print(f"{args.wav}: {n} IQ samples @ {fs:.0f} Hz -> {len(audio)} audio samples "
          f"@ {cfg.fs_audio:.0f} Hz ({args.mode} @ {args.freq:+.0f} Hz) on {r.device}")
    print(f"input power {10*np.log10(float(m['power_in'][0])+1e-30):.1f} dB, "
          f"AGC gain {float(m['agc_gain_last'][0]):.2f}")
    if args.waterfall:
        wf = r.waterfall()[0]
        np.save(args.waterfall, wf)
        print(f"waterfall ({wf.shape[0]} lines x {wf.shape[1]} bins) -> {args.waterfall}")
    print(f"audio -> {args.out}")
    return 0


def _cmd_decode(args):
    from radioframe_torch.io.wav import read_wav
    from radioframe_torch.ops.decoders import cw_decode, rtty_decode

    audio, fs = read_wav(args.wav)
    if args.rtty:
        text = rtty_decode(audio, fs)
    else:
        text = cw_decode(audio, fs, args.tone)
    print(text)
    return 0


def _cmd_tx(args):
    import torch

    from radioframe_torch.core.config import TxConfig
    from radioframe_torch.device import resolve
    from radioframe_torch.io.wav import read_wav, write_wav
    from radioframe_torch.ops import demod as demod_op
    from radioframe_torch.ops import nco
    from radioframe_torch.pipelines.tx_chain import TxChain

    audio, fs = read_wav(args.wav)
    if np.iscomplexobj(audio):
        print("tx expects a MONO audio WAV", file=sys.stderr)
        return 1
    dev = resolve(args.device)
    tx = TxChain(TxConfig(channels=1, fs_audio=fs, fs_out=fs * 4,
                          mic_eq_bands=tuple(args.eq or ()))).to(dev)
    n = (len(audio) // tx.min_block) * tx.min_block
    if n == 0:
        print(f"audio too short: {len(audio)} < one block ({tx.min_block})", file=sys.stderr)
        return 1
    w = torch.from_numpy(nco.freq_word(np.array([args.freq]), tx.cfg.fs_out)).to(dev)
    mode = torch.tensor([demod_op.MODE_NAMES[args.mode]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        _, iq = tx.step(tx.init_state(1), torch.from_numpy(audio[None, :n]).to(dev), w, mode)
    iq = iq[0].cpu().numpy()
    write_wav(args.out, iq, tx.cfg.fs_out)
    print(f"{args.wav}: {n} audio samples @ {fs:.0f} Hz -> {len(iq)} IQ samples "
          f"@ {tx.cfg.fs_out:.0f} Hz ({args.mode} @ {args.freq:+.0f} Hz) on {dev} -> {args.out}")
    return 0


def _cmd_demo(args):
    import examples.torch_rx_demo as demo  # needs the repo root on the path

    argv = ["--device", args.device] + (["--blocked"] if args.blocked else [])
    if args.snr is not None:
        argv += ["--snr", str(args.snr)]
    return demo.main(argv)


def _cmd_cat(args):
    """Serve the Kenwood-dialect CAT protocol over TCP while a duplex stream
    processes synthetic blocks: a rig-control client (hamlib, wsjtx) can
    connect and tune, set the mode and key it live."""
    import threading
    import time as _time

    from radioframe_torch.api.cat import CatServer
    from radioframe_torch.api.cat_tcp import CatTcpServer
    from radioframe_torch.api.transceiver import Transceiver
    from radioframe_torch.core.config import RxConfig, TxConfig

    trx = Transceiver(RxConfig(channels=1), TxConfig(channels=1), device=args.device)
    chain = trx.chain.rx
    B, fs = chain.min_block, trx.rx_cfg.fs_in
    stop = threading.Event()
    srv = CatTcpServer(CatServer(trx), port=args.port)
    errors = []

    def stream():
        rng = np.random.default_rng(0)
        n = 0
        try:
            while not stop.is_set():
                t = (np.arange(B) + n * B) / fs
                iq = (args.tone_amp * np.exp(2j * np.pi * args.tone * t)
                      + 0.01 * (rng.standard_normal(B) + 1j * rng.standard_normal(B)))
                # hold the CAT dispatch lock for the block so that a multi-part
                # command (FA...;MD...;) never half-applies to a block
                with srv.lock:
                    trx.process(iq.astype(np.complex64)[None, :],
                                np.zeros(B // trx.rx_cfg.decim, np.float32))
                n += 1
        except Exception as e:  # reported by the main thread
            errors.append(e)
            stop.set()

    th = threading.Thread(target=stream, daemon=True)
    th.start()
    with srv:
        print(f"CAT server on {srv.host}:{srv.port}  "
              f"(synthetic tone at {args.tone:+.0f} Hz on {trx.device}; ctrl-C to stop)")
        try:
            while not stop.is_set():
                _time.sleep(0.2)
        except KeyboardInterrupt:
            pass
    stop.set()
    th.join(timeout=10.0)
    if errors:
        raise errors[0]
    if th.is_alive():
        print("the stream thread is still running after 10 s", file=sys.stderr)
        return 1
    return 0


def monitor_config(M: int, fs: float):
    """The ChannelizerConfig ``monitor`` runs: the single-pass K5 form of
    presets.channelizer_61m44 where M is a power of two (the kernels' FFT),
    else the dense formulation with the same output contract (per-channel
    PFB waterfall lines, 16 frames a line)."""
    from radioframe_torch.core import presets

    if M >= 2 and M & (M - 1) == 0:
        return presets.channelizer_61m44(M, fs_in=fs)
    return presets.channelizer_61m44(M, fused=False, fs_in=fs, emit_spectrum=True,
                                     waterfall_from_pfb=True, waterfall_frame_avg=16)


def _cmd_monitor(args):
    """Wideband WAV -> every-channel demod + waterfall (config 5)."""
    from radioframe_torch.api.monitor import Monitor
    from radioframe_torch.io.wav import read_wav, write_wav

    iq, fs = read_wav(args.wav)
    M = args.channels
    if not 0 <= args.channel < M:
        print(f"--channel {args.channel} out of range [0, {M})", file=sys.stderr)
        return 1
    cfg = monitor_config(M, fs)
    mon = Monitor(cfg, device=args.device)
    mon.set_mode_all(args.mode)
    nmin = mon.chain.min_block
    n = (len(iq) // nmin) * nmin
    if n == 0:
        print(f"capture too short: {len(iq)} < one block ({nmin})", file=sys.stderr)
        return 1
    audio = mon.process(iq[:n])
    cp = mon.channel_power()
    top = np.argsort(cp)[::-1][:5]
    print(f"{args.wav}: {n} wideband samples @ {fs:.0f} Hz -> "
          f"{M} channels x {audio.shape[1]} audio samples "
          f"@ {cfg.fs_channel:.0f} Hz on {mon.device}")
    for c in top:
        print(f"  ch {int(c):4d} ({mon.channel_frequency(int(c)):+11.0f} Hz): "
              f"{10 * np.log10(max(float(cp[c]), 1e-30)):6.1f} dB")
    if args.audio_out is not None:
        write_wav(args.audio_out, audio[args.channel], cfg.fs_channel)
        print(f"channel {args.channel} audio -> {args.audio_out}")
    if args.waterfall is not None:
        np.save(args.waterfall, mon.waterfall())
        print(f"waterfall -> {args.waterfall}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="radioframe_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")

    sub.add_parser("info", parents=[dev], help="environment + default chain info")

    rx = sub.add_parser("rx", parents=[dev], help="demodulate a WAV IQ capture")
    rx.add_argument("--wav", required=True)
    rx.add_argument("--freq", type=float, required=True, help="carrier offset Hz")
    rx.add_argument("--mode", default="ssb", choices=["ssb", "cw", "am", "nfm"])
    rx.add_argument("--out", default="audio.wav")
    rx.add_argument("--waterfall", default=None, help="save waterfall .npy")

    dec = sub.add_parser("decode", help="decode CW/RTTY from audio WAV")
    dec.add_argument("--wav", required=True)
    dec.add_argument("--rtty", action="store_true")
    dec.add_argument("--tone", type=float, default=600.0)

    tx = sub.add_parser("tx", parents=[dev],
                        help="modulate a mono audio WAV to an IQ WAV (DUC)")
    tx.add_argument("--wav", required=True, help="mono audio WAV input")
    tx.add_argument("--freq", type=float, default=0.0, help="TX carrier offset Hz")
    tx.add_argument("--mode", default="ssb", choices=["ssb", "lsb", "cw", "am", "nfm"])
    tx.add_argument("--out", default="tx_iq.wav")
    tx.add_argument("--eq", type=lambda s: tuple(float(v) for v in s.split(",")),
                    nargs="*", help="mic EQ bands as freq,gain_db,Q triples")

    demo = sub.add_parser("demo", parents=[dev], help="run the 4-mode synthetic demo")
    demo.add_argument("--blocked", action="store_true")
    demo.add_argument("--snr", type=float, default=None)

    mon = sub.add_parser("monitor", parents=[dev],
                         help="channelize a wideband IQ WAV: every-channel demod")
    mon.add_argument("--wav", required=True, help="wideband IQ WAV input")
    mon.add_argument("--channels", type=int, default=64)
    mon.add_argument("--mode", default="ssb", choices=["ssb", "cw", "am", "nfm", "lsb"])
    mon.add_argument("--channel", type=int, default=0, help="channel for --audio-out")
    mon.add_argument("--audio-out", default=None, help="save one channel's audio WAV")
    mon.add_argument("--waterfall", default=None, help="save waterfall .npy")

    cat = sub.add_parser("cat", parents=[dev], help="serve CAT over TCP with a live stream")
    cat.add_argument("--port", type=int, default=4532, help="0 = ephemeral")
    cat.add_argument("--tone", type=float, default=39_000.0)
    cat.add_argument("--tone-amp", type=float, default=0.3)

    args = ap.parse_args(argv)
    return {"info": _cmd_info, "rx": _cmd_rx, "tx": _cmd_tx, "decode": _cmd_decode,
            "demo": _cmd_demo, "cat": _cmd_cat, "monitor": _cmd_monitor}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
