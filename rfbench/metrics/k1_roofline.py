"""k1_roofline: K1 (``fused_frontend2_kernel``: the DDS mix, the CIC and
the FIR decimator of every channel, the input power summed as it reads) at
its roofline, in %.

Its least work for a block of C channels of T samples, n = C T (the counts
``chip_smoke.py`` makes from shapes): the complex64 input (8 n bytes), the
raw history carried in and out (8 C H_carry), the polyphase taps (4 bytes
each), the decimated complex64 output (8 n / (R1 R2)) and the per-channel
power and accumulators (12 C); per input sample 6 flops of the mix, 2 of
its sine and cosine and 4 of the power, 4 a stage-1 tap and 4 a stage-2 tap
over R1.
"""

import math

from rfbench.metrics._roofline import roofline_pct


def work(sizes: dict, cell: dict) -> tuple[float, float]:
    cic, fir = sizes["stages"]
    R1, R2 = cic["R"], fir["R"]
    L1 = cic["N"] * (cic["R"] * cic["M"] - 1) + 1
    L2 = fir["numtaps"]
    J0 = max(1, math.ceil((L1 - 1) / R1))
    J2 = max(1, math.ceil((L2 - 1) / R2))
    h_carry = J2 * R2 * R1 + J0 * R1
    C, T = sizes["channels"], cell["block"]
    n = C * T
    nbytes = 8 * n + 8 * C * h_carry + 4 * ((J0 + 1) * R1 + (J2 + 1) * R2) \
        + 8 * n // (R1 * R2) + 12 * C
    ops = n * (12 + 4 * (J0 + 1) + 4 * (J2 + 1) / R1)
    return nbytes, ops


def read(run):
    return roofline_pct(run, "fused_frontend2_kernel", work)
