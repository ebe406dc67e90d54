"""k5_roofline: K5 (``channelizer_one_kernel``: the polyphase filter, the
M-point DFT, the demods, the AGC, the power and the averaged waterfall in
one pass) at its roofline, in %.

Its least work for a block of T = F M samples (the counts ``chip_smoke.py``
makes from shapes): the complex64 input (8 T bytes); the taps, twiddles,
per-channel constants and the K - 1 history frames (4 (K M + M + 7 M) +
8 (K - 1) M); the audio (4 F M), the waterfall (4 F/avg M) and the carries in
and out (2 4 7 M). Operations: 4 K T polyphase multiply-adds, 5 F M log2 M of
the FFT, and per frame and channel 3 for |X|^2, the mode's demod (SSB, LSB
1; CW 10; AM 0; NFM 8), 4 of the AM DC block, 10 of the AGC and 2 of power
and waterfall.
"""

import math

from rfbench.metrics._roofline import roofline_pct

MODE_OPS = {0: 1, 1: 10, 2: 0, 3: 8, 4: 1}


def work(sizes: dict, cell: dict) -> tuple[float, float]:
    M, K = sizes["num_channels"], sizes["taps_per_channel"]
    T = cell["block"]
    F = T // M
    avg = sizes["waterfall_frame_avg"]
    cyc = sizes["mode_cycle"]
    const = 4 * (K * M + M + 7 * M) + 8 * (K - 1) * M
    back = 4 * F * M + 4 * (F // avg) * M + 2 * 4 * 7 * M
    nbytes = 8 * T + const + back
    per_frame = sum(3 + MODE_OPS[cyc[c % len(cyc)]] + 4 + 10 + 2 for c in range(M))
    ops = 4 * K * T + 5 * F * M * math.log2(M) + F * per_frame
    return nbytes, ops


def read(run):
    return roofline_pct(run, "channelizer_one_kernel", work)
