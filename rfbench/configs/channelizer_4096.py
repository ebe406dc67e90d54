"""channelizer_4096: the 4096-channel monitor, built from
``channelizer_4096.json``.

One wideband stream (a (T,) block) into M critically sampled channels, each
demodulated by its mode, with the channel powers and the waterfall: the K5
single pass. The plain reference is ``rfbench/reference/channelizer.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rfbench.reference.channelizer import ChannelizerReference

MODE_NAMES = ("ssb", "cw", "am", "nfm", "lsb")
# output key -> (check name, kind of comparison); see compare.py
CHECKS = {"audio": ("audio_err", "audio"), "channel_power": ("power_err", "relative"),
          "waterfall": ("waterfall_err_db", "db")}


def channels(sizes: dict) -> int:
    return sizes["num_channels"]


def modes(sizes: dict) -> np.ndarray:
    cyc = sizes["mode_cycle"]
    return np.asarray([cyc[c % len(cyc)] for c in range(channels(sizes))], np.int64)


def samples_per_block(sizes: dict, cell: dict) -> int:
    return cell["block"]


def fs_channel(sizes: dict) -> float:
    return sizes["fs_in"] / channels(sizes)


def nfm_period(sizes: dict) -> float:
    """fs / deviation at the channel rate: one atan2 branch flip."""
    return fs_channel(sizes) / sizes["nfm_deviation_hz"]


def reference_lead_blocks(sizes: dict, cell: dict) -> int:
    """Blocks the reference runs before a checked one (about 1 s of signal:
    twice the AGC's release)."""
    return math.ceil(2.0 * sizes["agc"]["release_s"] * sizes["fs_in"] / cell["block"])


def layout(sizes: dict, cell: dict) -> dict:
    """The generator's layout: one wideband row, channel c's signal at its
    centre c fs/M (above M/2: c - M)."""
    M = channels(sizes)
    c = np.arange(M)
    centers = np.where(c < M // 2, c, c - M) * fs_channel(sizes)
    return {"rows": 1, "fs": sizes["fs_in"], "T": cell["block"], "n_blocks": cell["pool"],
            "centers_hz": centers, "row_of": np.zeros(M, np.int64), "modes": modes(sizes)}


def block(pool: torch.Tensor, k: int):
    """Block k of the stream: the pool's blocks in turn, (T,)."""
    return pool[k % pool.shape[0], 0]


def ch_config(sizes: dict):
    """The port's ChannelizerConfig as the preset builds it, held to the file."""
    from radioframe_torch.core import presets
    from radioframe_torch.core.config import AgcConfig

    cfg = getattr(presets, sizes["preset"])(channels(sizes), fused=sizes["fused"])
    want = {"fs_in": sizes["fs_in"], "taps_per_channel": sizes["taps_per_channel"],
            "fuse_single_pass": sizes["fuse_single_pass"],
            "enabled_modes": tuple(sizes["enabled_modes"]),
            "waterfall_frame_avg": sizes["waterfall_frame_avg"], "agc": AgcConfig(**sizes["agc"]),
            "agc_modes": None, "cw_tone_hz": sizes["cw_tone_hz"],
            "nfm_deviation_hz": sizes["nfm_deviation_hz"]}
    for k, v in want.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"{sizes['preset']} gives {k}={getattr(cfg, k)!r}, the "
                             f"configuration file {v!r}")
    return cfg


def build_api(sizes: dict, cell: dict, device):
    """The Monitor users call, every channel set to its mode."""
    from radioframe_torch.api.monitor import Monitor

    mon = Monitor(ch_config(sizes), device=device)
    for c, m in enumerate(modes(sizes)):
        mon.set_mode(c, MODE_NAMES[m])
    return mon


def build_stream(sizes: dict, cell: dict, device):
    """(step, state, args) of the chain that ``BlockStream`` drives."""
    from radioframe_torch.pipelines.channelizer import ChannelizerChain

    chain = ChannelizerChain(ch_config(sizes)).to(device)
    mode = torch.from_numpy(modes(sizes).astype(np.int32)).to(device)
    return chain.step, chain.init_state(), (mode,)


def api_outputs(obj, audio) -> dict:
    """What a Monitor caller reads of a block: the audio, the channel powers
    and the waterfall lines."""
    return {"audio": torch.as_tensor(audio), "channel_power": obj.last_aux["channel_power"],
            "waterfall": obj.last_aux["waterfall"]}


def stream_outputs(out, aux) -> dict:
    """The same outputs of a step, on the device (the caller clones)."""
    return {"audio": out, "channel_power": aux["channel_power"], "waterfall": aux["waterfall"]}


def reference(sizes: dict, device) -> ChannelizerReference:
    return ChannelizerReference(sizes, modes(sizes), device)
