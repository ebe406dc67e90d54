"""Demo: the port's Monitor API — every-channel receiver with checkpoint/resume.

Usage:
  python examples/torch_monitor_demo.py [--device cuda|cpu]   # unsharded single-pass
  python examples/torch_monitor_demo.py --mesh 4              # time-sharded over 4
                                                              # ranks (gloo)

Synthesizes a wideband capture (AM tone + CW beacon over noise), drives it
through ``api.monitor.Monitor`` (BASELINE config 5's user surface) in two
halves with a checkpoint between them, restores into a FRESH Monitor, and
verifies the resumed stream is bit-exact: the channelizer's stream state
(PFB history, demod carries, AGC envelopes) plus the per-channel mode map.

With ``--mesh N`` the demo spawns N ranks (``shard.mesh.spawn``: gloo, on
the one device named) and each runs ``Monitor(mesh=make_mesh(1, N))``;
the checkpoint is gathered and written by rank 0, and every rank restores
its part. The ranks import this script again, hence the ``__main__`` guard.
"""

import argparse
import tempfile

import numpy as np


def _wideband(cfg, blocks: int, min_block: int) -> np.ndarray:
    """AM tone on channel 9, keyed CW on channel 23, noise floor."""
    M = cfg.num_channels
    fs, fs_ch = cfg.fs_in, cfg.fs_channel
    rng = np.random.default_rng(7)
    T = blocks * min_block
    t = np.arange(T) / fs
    f_audio = np.sin(2 * np.pi * 1000.0 * np.arange(T // M) / fs_ch)
    am = (1.0 + 0.8 * np.repeat(f_audio, M)) * np.exp(2j * np.pi * (9 * fs_ch) * t)
    key = (np.arange(T) // (T // 8)) % 2 == 0
    cw = 0.5 * key * np.exp(2j * np.pi * (23 * fs_ch + 600.0) * t)
    return (0.7 * am + cw + 0.02 * (rng.standard_normal(T)
            + 1j * rng.standard_normal(T))).astype(np.complex64)


def run(channels: int, device: str, ck: str, ranks: int = 0):
    """The demo on one process (``ranks`` 0) or as a rank of a spawned mesh,
    checkpointing under ``ck``: (lines to print, resume bit-exact, the
    strongest channel)."""
    from radioframe_torch.api.monitor import Monitor
    from radioframe_torch.core import presets
    from radioframe_torch.shard.mesh import make_mesh

    M = channels
    cfg = presets.channelizer_61m44(M, fs_in=15_000.0 * M, waterfall_frame_avg=4)
    mesh = make_mesh(1, ranks, device=device) if ranks else None
    mon = Monitor(cfg, device=device, mesh=mesh)
    mon.set_mode_all("ssb")
    mon.set_mode(9, "am")
    mon.set_mode(23, "cw")
    halves = np.split(_wideband(cfg, max(2, 2 * (ranks or 1)), mon.chain.min_block), 2)

    a1 = mon.process(halves[0])
    mon.save(ck, epoch=1)
    a2 = mon.process(halves[1])
    # a fresh Monitor restores mid-stream and continues bit-exactly
    mon2 = Monitor(cfg, device=device, mesh=mesh)
    assert mon2.load(ck) == 1
    assert mon2.mode(9) == "am" and mon2.mode(23) == "cw"
    b2 = mon2.process(halves[1])
    exact = bool(np.array_equal(a2, b2))
    cp = mon.channel_power()
    top = np.argsort(cp)[::-1][:3]
    form = (f"sharded single-pass, {ranks} ranks" if mesh is not None
            else "single-pass kernel")
    lines = [f"monitor [{form}] on {mon.device}: {M} channels x "
             f"{a1.shape[1] + a2.shape[1]} audio samples @ {cfg.fs_channel:.0f} Hz"]
    for c in top:
        lines.append(f"  ch {int(c):3d} ({mon.channel_frequency(int(c)):+9.0f} Hz, "
                     f"{mon.mode(int(c)):>3s}): {10 * np.log10(cp[c] + 1e-12):6.1f} dB")
    lines.append(f"  checkpoint resume bit-exact: {exact}")
    return lines, exact, int(top[0])


def _rank(rank, world, channels, device, ck):
    return run(channels, device, ck, world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--mesh", type=int, default=0, help="shard time over N spawned ranks")
    args = ap.parse_args(argv)

    from radioframe_torch.device import resolve
    from radioframe_torch.shard.mesh import spawn

    resolve(args.device)  # a missing card fails here, before any rank starts
    with tempfile.TemporaryDirectory() as ck:
        if args.mesh:
            results = spawn(_rank, args.mesh, args.channels, args.device, ck, timeout_s=600.0)
            lines, exact, top = results[0]
            exact = all(r[1] for r in results)
        else:
            lines, exact, top = run(args.channels, args.device, ck)
    print("\n".join(lines))
    if top not in (9, 23) or not exact:
        print("FAILED: the strongest channel is not a signal's, or the resume differs")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
