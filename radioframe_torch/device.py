"""Explicit device resolution and the float32 precision pins.

There is no automatic device choice: a caller names the device, and a CUDA
device on a machine without a card is an error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full float32 in every convolution and matrix product.

    cuDNN convolutions default to TF32 (about three decimal digits), which
    the decimating FIRs cannot afford; the reference pins
    ``Precision.HIGHEST`` on the same ops for the same reason."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve(device) -> torch.device:
    """``device`` ("cpu", "cuda", "cuda:1", torch.device) -> torch.device.

    Raises RuntimeError for a CUDA device when no card is present and
    ValueError for any device type other than cpu or cuda."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch sees no CUDA device")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (cpu or cuda)")
    pin_precision()
    return dev
