"""Demo: the golden (numpy) RX chain over synthetic captures, all four modes,
beside the port's RxChain on a device.

Usage: python examples/torch_golden_rx_demo.py [--device cuda|cpu] [--blocked]
                                               [--snr DB]

Acceptance config 1's shape (BASELINE.json configs[0]): 192 kHz IQ -> NCO mix
-> CIC/FIR decimate -> channel BPF -> AGC -> 48 kHz audio, run on the port's
golden model (``radioframe_torch/golden/model.py``) for every demod mode and
scored against the clean modulating audio. The same four captures then go
through the port's RxChain on ``--device`` (one channel a capture, the
default RxConfig, whose AGC and filters are not the golden chain's), scored
the same way and printed beside it.
"""

import argparse

import numpy as np

FS_IQ, FS_AUDIO = 192_000.0, 48_000.0


def rx_chain(iq, offset_hz, mode, blocked=False):
    """Golden RX: mix -> CIC(2,4) -> compFIR(/2) -> mode filter -> AGC -> demod."""
    from radioframe_torch.golden import model as G
    from radioframe_torch.ops import filter_design as FD

    comp = FD.compensated_decim_taps(129, 96_000.0, 4000.0, 21_000.0, cic_R=2, cic_N=4)
    bpf_ssb = FD.complex_bandpass_taps(257, 300.0, 2700.0, FS_AUDIO)
    bpf_am = FD.complex_bandpass_taps(257, -5000.0, 5000.0, FS_AUDIO)
    bpf_nfm = FD.complex_bandpass_taps(257, -8000.0, 8000.0, FS_AUDIO)
    bpf_cw = FD.complex_bandpass_taps(257, -250.0, 250.0, FS_AUDIO)

    blocks = np.split(iq, 16) if blocked else [iq]
    st = dict(nco=0.0, cic=None, fir=None, bpf=None, agc=0.0, dc=None, nfm=None, cw=0.0)
    outs = []
    for b in blocks:
        x, st["nco"] = G.nco_mix(b, offset_hz, FS_IQ, st["nco"])
        x, st["cic"] = G.cic_decimate(x, 2, 4, state=st["cic"])
        x, st["fir"] = G.fir_decimate(x, comp, 2, st["fir"])
        bpf = {"ssb": bpf_ssb, "am": bpf_am, "nfm": bpf_nfm, "cw": bpf_cw}[mode]
        x, st["bpf"] = G.ols_filter(x, bpf, st["bpf"])
        if mode == "ssb":
            x, st["agc"], _ = G.agc(x, 0.9995, env0=st["agc"])
            y = G.demod_ssb(x)
        elif mode == "cw":
            x, st["agc"], _ = G.agc(x, 0.9995, env0=st["agc"])
            y, st["cw"] = G.demod_cw(x, 600.0, FS_AUDIO, st["cw"])
        elif mode == "am":
            y, st["dc"] = G.demod_am(x, st["dc"])
        elif mode == "nfm":
            y, st["nfm"] = G.demod_nfm(x, FS_AUDIO, 2500.0, st["nfm"])
        outs.append(np.asarray(y))
    return np.concatenate(outs)


def device_chain(captures, device, blocked):
    """The port's RxChain (default RxConfig, one channel a capture) on
    ``device``: (C, T) audio, T the whole blocks of the captures."""
    import torch

    from radioframe_torch.core.config import RxConfig
    from radioframe_torch.ops import demod as demod_op
    from radioframe_torch.ops import nco
    from radioframe_torch.pipelines.rx_chain import RxChain

    chain = RxChain(RxConfig(channels=len(captures))).to(device)
    n = (len(captures[0][0]) // chain.min_block) * chain.min_block
    iq = torch.from_numpy(np.stack([c[0][:n] for c in captures]).astype(np.complex64)).to(device)
    words = torch.from_numpy(nco.freq_word([c[1] for c in captures], FS_IQ)).to(device)
    mode = torch.tensor([demod_op.MODE_NAMES[c[2]] for c in captures], dtype=torch.int32,
                        device=device)
    step = n // 3 // chain.min_block * chain.min_block if blocked else n
    st = chain.init_state()
    outs = []
    with torch.no_grad():
        for s in range(0, n - step + 1, step):
            st, audio, _ = chain.step(st, iq[:, s:s + step], words, mode)
            outs.append(audio.cpu().numpy())
    return np.concatenate(outs, axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--blocked", action="store_true", help="stream in blocks (state handoff path)")
    ap.add_argument("--snr", type=float, default=None, help="add channel noise at this SNR (dB)")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from radioframe_torch.device import resolve
    from radioframe_torch.diag.metrics import audio_snr_db, power_db
    from radioframe_torch.golden import model as G
    from radioframe_torch.io import fixtures as FX
    from radioframe_torch.ops import filter_design as FD

    dev = resolve(args.device)
    n = int(FS_IQ * args.seconds) // 16 * 16
    caps = [(name, *capture(FS_IQ, n, f, snr_db=args.snr), f, mode)
            for name, capture, f, mode in (("SSB @ +37 kHz", FX.ssb_capture, 37_000.0, "ssb"),
                                           ("AM  @ +20 kHz", FX.am_capture, 20_000.0, "am"),
                                           ("NFM @ -15 kHz", FX.nfm_capture, -15_000.0, "nfm"))]
    iq_cw, key = FX.cw_capture(FS_IQ, n, 7_000.0, snr_db=args.snr)
    dev_audio = device_chain([(iq, f, m) for _, iq, _, f, m in caps] + [(iq_cw, 7_000.0, "cw")],
                             dev, args.blocked)
    mode_tag = "blocked-stream" if args.blocked else "one-shot"
    print(f"golden RX chain ({mode_tag}): 192 kHz IQ -> 48 kHz audio; RxChain on {dev}")
    for row, (name, iq, ref, f, mode) in enumerate(caps):
        out = rx_chain(iq, f, mode, args.blocked)
        port = dev_audio[row]
        snr_port = audio_snr_db(ref[:len(port)], port)
        print(f"  {name}: audio SNR {audio_snr_db(ref, out):6.1f} dB   out power "
              f"{power_db(out):6.1f} dB   RxChain SNR {snr_port:6.1f} dB")
    # CW scored as envelope correlation against the keying pattern
    cw_audio = rx_chain(iq_cw, 7_000.0, "cw", args.blocked)
    lp = FD.lowpass_taps(65, 100.0, FS_AUDIO)
    corr = []
    for a in (cw_audio, dev_audio[3]):
        env_s, _ = G.fir_decimate(np.abs(a).astype(np.complex128), lp, 1)
        key48 = key[::4][: len(env_s)]
        corr.append(np.corrcoef(np.real(env_s), key48)[0, 1])
    print(f"  CW  @ +7 kHz : keying envelope correlation {corr[0]:.3f}   RxChain {corr[1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
