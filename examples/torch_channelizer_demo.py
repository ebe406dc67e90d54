"""Demo: the port's PFB channelizer — wideband in, waterfall PNG + per-channel
audio out.

Usage: python examples/torch_channelizer_demo.py [--device cuda|cpu]
           [--channels 64] [--frames 16384] [--out waterfall.png] [--dense]

Synthesizes a wideband capture holding several signals (an AM carrier, an FM
station, keyed CW), channelizes it with the polyphase filterbank,
demodulates every channel at once and writes the wideband waterfall as a
grayscale PNG (BASELINE config 5's shape on one device). The PNG is written
with the standard library (zlib + struct): no plotting package is needed.
"""

import argparse
import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W) uint8 image as an 8-bit grayscale PNG, row 0 at the top."""
    h, w = img.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(row, np.uint8).tobytes() for row in img)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16384, help="channel-rate samples")
    ap.add_argument("--out", default="waterfall.png")
    ap.add_argument("--dense", action="store_true",
                    help="the dense formulation instead of the single-pass kernel (K5)")
    args = ap.parse_args(argv)

    import torch

    from radioframe_torch.api.monitor import Monitor
    from radioframe_torch.pipelines.channelizer import ChannelizerConfig

    M = args.channels
    if M < 8:
        ap.error(f"--channels {M}: need >= 8 (the demo places AM/NFM/CW "
                 "signals on three distinct channels)")
    if not args.dense and M & (M - 1):
        print(f"note: --channels {M} is not a power of two, which the fused kernels "
              "need; using the dense formulation")
        args.dense = True
    fs_ch = 48_000.0
    if args.dense:
        cfg = ChannelizerConfig(fs_in=fs_ch * M, num_channels=M,
                                emit_spectrum=True, spectrum_nfft=1024)
    else:
        cfg = ChannelizerConfig(fs_in=fs_ch * M, num_channels=M,
                                emit_spectrum=True, waterfall_from_pfb=True,
                                waterfall_frame_avg=4, fuse_pfb=True,
                                fuse_demod=True, fuse_single_pass=True,
                                enabled_modes=(0, 1, 2, 3))
    mon = Monitor(cfg, device=args.device)
    F = args.frames
    T = F * M
    if T % mon.chain.min_block:
        ap.error(f"--frames {F}: {T} samples is not a multiple of the block "
                 f"{mon.chain.min_block}")
    fs = cfg.fs_in
    t = np.arange(T) / fs
    rng = np.random.default_rng(0)

    wide = 0.02 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    # AM / FM / CW signals on three channels, scaled to the channel count
    ch_am, ch_fm, ch_cw = M // 6, M * 2 // 5, M * 5 // 8
    tt = np.arange(F) / fs_ch
    am = (1 + 0.8 * np.sin(2 * np.pi * 800.0 * tt)).astype(np.complex128)
    wide += np.repeat(am, M) * np.exp(2j * np.pi * (ch_am * fs_ch) * t) * 0.5
    fm_phase = 2 * np.pi * 2500.0 / fs_ch * np.cumsum(0.7 * np.sin(2 * np.pi * 400.0 * tt))
    wide += np.repeat(np.exp(1j * fm_phase), M) * np.exp(2j * np.pi * (ch_fm * fs_ch) * t) * 0.5
    key = (np.sin(2 * np.pi * 2.0 * tt) > 0).astype(np.float64)
    wide += np.repeat(key, M) * np.exp(2j * np.pi * (ch_cw * fs_ch) * t) * 0.4
    wide = wide.astype(np.complex64)

    mon.set_mode_all("ssb")
    for ch, mode in ((ch_am, "am"), (ch_fm, "nfm"), (ch_cw, "cw")):
        mon.set_mode(ch, mode)
    audio = mon.process(wide)
    wf = mon.waterfall()
    cp = 10 * np.log10(mon.channel_power() + 1e-12)

    lo, hi = np.percentile(wf, 1.0), float(wf.max())
    img = np.clip((wf - lo) / max(hi - lo, 1e-6) * 255.0, 0, 255).astype(np.uint8)
    write_png(args.out, img[::-1])  # latest line at the top
    name = torch.cuda.get_device_name(mon.device) if mon.device.type == "cuda" else "cpu"
    print(f"waterfall {wf.shape} -> {args.out} ({fs / 1e6:.2f} Msps, {M} channels, "
          f"{'dense' if args.dense else 'single-pass'} on {mon.device} ({name}))")
    print(f"channel powers (dB): AM ch{ch_am} {cp[ch_am]:.1f}, "
          f"NFM ch{ch_fm} {cp[ch_fm]:.1f}, "
          f"CW ch{ch_cw} {cp[ch_cw]:.1f}, noise floor {np.median(cp):.1f}")
    print(f"audio matrix: {audio.shape} (channels x samples @ {fs_ch / 1e3:.0f} kHz)")
    if not min(cp[ch_am], cp[ch_fm], cp[ch_cw]) > np.median(cp) + 10.0:
        print("the three signals' channels do not stand above the floor")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
