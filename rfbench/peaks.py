"""The card's peaks and the least time a kernel could take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores. A kernel's byte and operation counts live beside its metric under
``metrics/``; each input byte counts as read once and each output byte as
written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
