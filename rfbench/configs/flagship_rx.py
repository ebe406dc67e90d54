"""flagship_rx: the 128-channel receiver, built from ``flagship_rx.json``.

Every channel is its own IQ stream (a (C, T) block), tuned by a DDS word
and demodulated by its mode: K1 (the fused mix, CIC and FIR) and the dense
back end (overlap-save bank, demods, AGC). The plain reference is
``rfbench/reference/rx.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rfbench.reference.rx import RxReference

MODE_NAMES = ("ssb", "cw", "am", "nfm", "lsb")
# output key -> (check name, kind of comparison); see compare.py
CHECKS = {"audio": ("audio_err", "audio"), "power_in": ("power_err", "relative")}


def channels(sizes: dict) -> int:
    return sizes["channels"]


def freqs_hz(sizes: dict) -> np.ndarray:
    lo, hi = sizes["tune_hz"]
    return np.linspace(lo, hi, channels(sizes))


def modes(sizes: dict) -> np.ndarray:
    cyc = sizes["mode_cycle"]
    return np.asarray([cyc[c % len(cyc)] for c in range(channels(sizes))], np.int64)


def samples_per_block(sizes: dict, cell: dict) -> int:
    return channels(sizes) * cell["block"]


def fs_audio(sizes: dict) -> float:
    d = 1
    for st in sizes["stages"]:
        d *= st["R"]
    return sizes["fs_in"] / d


def nfm_period(sizes: dict) -> float:
    """fs / deviation at the audio rate: one atan2 branch flip."""
    return fs_audio(sizes) / sizes["nfm_deviation_hz"]


def reference_lead_blocks(sizes: dict, cell: dict) -> int:
    """Blocks the reference runs before a checked one (about 1 s of signal:
    twice the AGC's release)."""
    return math.ceil(2.0 * sizes["agc"]["release_s"] * sizes["fs_in"] / cell["block"])


def layout(sizes: dict, cell: dict) -> dict:
    """The generator's layout: one row a channel, its signal at its tuning."""
    C = channels(sizes)
    return {"rows": C, "fs": sizes["fs_in"], "T": cell["block"], "n_blocks": cell["pool"],
            "centers_hz": freqs_hz(sizes), "row_of": np.arange(C), "modes": modes(sizes)}


def block(pool: torch.Tensor, k: int):
    """Block k of the stream: the pool's blocks in turn, (C, T)."""
    return pool[k % pool.shape[0]]


def rx_config(sizes: dict):
    """The port's RxConfig as the preset builds it, held to the file."""
    from radioframe_torch.core import presets
    from radioframe_torch.core.config import AgcConfig, CicStage, FirStage, ModeFilters

    cfg = getattr(presets, sizes["preset"])(
        channels(sizes), fuse_frontend=sizes["fuse_frontend"],
        fuse_frontend_depth=sizes["fuse_frontend_depth"], ols_hop=sizes["ols_hop"],
        enabled_modes=tuple(sizes["enabled_modes"]))
    cic, fir = sizes["stages"]
    want = {"fs_in": sizes["fs_in"],
            "stages": (CicStage(R=cic["R"], N=cic["N"], M=cic["M"]),
                       FirStage(R=fir["R"], numtaps=fir["numtaps"],
                                passband_hz=fir["passband_hz"], stopband_hz=fir["stopband_hz"])),
            "mode_filters": ModeFilters(**sizes["mode_filters"]), "agc": AgcConfig(**sizes["agc"]),
            "agc_modes": None, "cw_tone_hz": sizes["cw_tone_hz"],
            "nfm_deviation_hz": sizes["nfm_deviation_hz"]}
    for k, v in want.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"{sizes['preset']} gives {k}={getattr(cfg, k)!r}, the "
                             f"configuration file {v!r}")
    return cfg


def build_api(sizes: dict, cell: dict, device):
    """The Radio users call, every channel tuned and set to its mode."""
    from radioframe_torch.api.radio import Radio

    radio = Radio(rx_config(sizes), device=device)
    for c, (f, m) in enumerate(zip(freqs_hz(sizes), modes(sizes))):
        radio.tune(c, float(f))
        radio.set_mode(c, MODE_NAMES[m])
    return radio


def build_stream(sizes: dict, cell: dict, device):
    """(step, state, args) of the chain that ``BlockStream`` drives, with the
    tuning words and modes ``Radio`` would give it."""
    from radioframe_torch.ops import nco
    from radioframe_torch.pipelines.rx_chain import RxChain

    cfg = rx_config(sizes)
    chain = RxChain(cfg).to(device)
    words = torch.from_numpy(nco.freq_word(freqs_hz(sizes), cfg.fs_in)).to(device)
    mode = torch.from_numpy(modes(sizes).astype(np.int32)).to(device)
    return chain.step, chain.init_state(), (words, mode)


def api_outputs(obj, audio) -> dict:
    """What a Radio caller reads of a block: the audio and the input power."""
    return {"audio": torch.as_tensor(audio), "power_in": obj.last_aux["power_in"]}


def stream_outputs(out, aux) -> dict:
    """The same outputs of a step, on the device (the caller clones)."""
    return {"audio": out, "power_in": aux["power_in"]}


def reference(sizes: dict, device) -> RxReference:
    return RxReference(sizes, freqs_hz(sizes), modes(sizes), device)
