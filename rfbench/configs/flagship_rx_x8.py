"""flagship_rx_x8: a receiving station of ``receivers`` flagship receivers on
one card, built from ``flagship_rx_x8.json``.

Front ends on one sample clock each hand the host ``channels`` rows of IQ;
receiver r holds the station's channels ``channels`` r to ``channels``
(r + 1) - 1, each its own IQ stream with a tuning, a mode and a signal of
its own. A block of the stream is a round: every receiver's rows of one
sample clock, (receivers x channels, T). Each receiver is one ``Radio`` of
the flagship's chain (``flagship_rx.py``), so the plain reference is
``rfbench/reference/rx.py`` over all the station's channels.
"""

from __future__ import annotations

import math

import torch

from rfbench.configs import flagship_rx as one
from rfbench.reference.rx import RxReference

MODE_NAMES = one.MODE_NAMES
CHECKS = one.CHECKS
block = one.block
fs_audio = one.fs_audio
nfm_period = one.nfm_period
api_outputs = one.api_outputs  # one receiver's


def receivers(sizes: dict) -> int:
    return sizes["receivers"]


def station(sizes: dict) -> dict:
    """``sizes`` with the station's channel count: what the generator, the
    check and the reference see."""
    return dict(sizes, channels=sizes["channels"] * receivers(sizes))


def channels(sizes: dict) -> int:
    return one.channels(station(sizes))


def freqs_hz(sizes: dict):
    return one.freqs_hz(station(sizes))


def modes(sizes: dict):
    return one.modes(station(sizes))


def samples_per_block(sizes: dict, cell: dict) -> int:
    """A round's input samples: every receiver's block."""
    return one.samples_per_block(station(sizes), cell)


def reference_lead_blocks(sizes: dict, cell: dict) -> int:
    """Blocks the reference runs before a checked one: about 2 s of signal,
    four AGC releases. A fresh start's DC block passes an AM channel's
    carrier into the AGC's envelope as a step. Where the channel's two
    sidebands lie near quadrature (the generator draws each line's phase)
    its audio peaks at down to a sixteenth of the carrier, and the step's
    trace outlasts the stream's own envelope for ln 16 = 2.8 releases: the
    flagship's lead of two releases then starts the AGC from another state
    (audio 4e-3 to 1.8e-2 off in such a channel, three runs in twelve of
    1,024 channels; from four releases, as from block 0)."""
    return math.ceil(4.0 * sizes["agc"]["release_s"] * sizes["fs_in"] / cell["block"])


def layout(sizes: dict, cell: dict) -> dict:
    return one.layout(station(sizes), cell)


def rows(sizes: dict, r: int) -> slice:
    """Receiver r's rows of a round."""
    c = sizes["channels"]
    return slice(r * c, (r + 1) * c)


def receiver_block(round_block, sizes: dict, r: int):
    """What receiver r's caller hands its ``Radio``: its rows of the round
    (a view)."""
    return round_block[rows(sizes, r)]


def build_api(sizes: dict, cell: dict, device) -> list:
    """The station's Radios, receiver r's channels tuned and set to their
    modes through the public ``tune`` and ``set_mode``."""
    from radioframe_torch.api.radio import Radio

    cfg = one.rx_config(sizes)
    f, m = freqs_hz(sizes), modes(sizes)
    radios = []
    for r in range(receivers(sizes)):
        radio = Radio(cfg, device=device)
        for c, (fc, mc) in enumerate(zip(f[rows(sizes, r)], m[rows(sizes, r)])):
            radio.tune(c, float(fc))
            radio.set_mode(c, MODE_NAMES[mc])
        radios.append(radio)
    return radios


def build_stream(sizes: dict, cell: dict, device):
    raise ValueError("flagship_rx_x8 runs a Radio a receiver (entry api_host_threads); "
                     "the station over BlockStream rings has no entry yet")


def station_outputs(parts: list) -> dict:
    """A round's outputs: the receivers' ``api_outputs``, in receiver order,
    concatenated over channels."""
    return {k: torch.cat([torch.as_tensor(p[k]).cpu() for p in parts]) for k in parts[0]}


def stream_outputs(out, aux) -> dict:
    return one.stream_outputs(out, aux)


def reference(sizes: dict, device) -> RxReference:
    return RxReference(station(sizes), freqs_hz(sizes), modes(sizes), device)
