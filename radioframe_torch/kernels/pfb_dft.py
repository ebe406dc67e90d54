"""Fused polyphase filterbank + M-point DFT (counterpart of
``radioframe/kernels/pfb_dft.py``, kernel K3), with the stage variants of
``tools/probe_pfbdft_stages.py`` (kernel K9).

``FusedPfbDft.step_planes`` launches the hand-written CUDA C++ kernel
``csrc/pfb_dft.cu`` for CUDA tensors and runs the plain PyTorch version
``plain_pfb_dft`` (``plain_variant`` for K9's variants) for CPU tensors.
For a CUDA tensor it launches or raises: there is no fallback. ``launches``
counts kernel launches, ``variant_launches`` the launches of each variant.
K3 and pfb_only run the polyphase as a walk down each point's column,
planned by ``pfb_plan`` (``last_plan`` is the last launch's);
``batched_b3`` runs its Cooley-Tukey products on the tensor cores in
3xTF32, whose arithmetic ``plain_batched_tf32`` emulates.

Differences from the reference, none of them in the function computed:
outputs are in channel order (the reference's ``native=False``), the
reference's TPU gate on ``num_channels % 128`` is gone (any power of two
2 <= M <= 8192), and both ``dft_precision`` settings compute the DFT in FP32:
"b3" names the reference's bf16x3 matrix-unit split, which has no
counterpart in the register-resident FFT (``kernels/fft_plan.py``).

State: the last (K-1)*M input samples, (1, (K-1)*M) complex64.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, fft_plan, pfb_plan
from radioframe_torch.ops.filter_design import pfb_prototype_taps
from radioframe_torch.ops.pfb import polyphase_frames

DFT_PRECISIONS = ("highest", "b3")
# K9's variants, in the order of the kernel's template argument; "base_b3"
# is K3 itself (the reference's shipped b3 form, FP32 here)
VARIANTS = ("base_b3", "pfb_only", "pfb_noshift", "dft_only", "batched_b3")
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use
BATCHED_M = (2048, 4096, 8192)  # batched_b3's tensor-core tiles: M2 = 128, M1 in (16, 32, 64)
_MAX_FFT_THREADS = 512    # the kernels' launch bound: one frame's M/16 threads


def check_channels(M: int, frames_in_smem: int) -> None:
    """Power of two M >= 2 whose FFT fits one block: its M/16 threads, and
    the twiddle table, the exchange buffer and ``frames_in_smem`` - 1 more
    complex frames in shared memory. The reference asserts the power of two."""
    if M < 2 or M & (M - 1):
        raise AssertionError(f"fused channelizer kernels need a power-of-two M >= 2, got {M}")
    if fft_plan.threads(M) > _MAX_FFT_THREADS:
        raise ValueError(f"M={M}: the FFT of one frame needs {fft_plan.threads(M)} threads, "
                         f"more than a block's {_MAX_FFT_THREADS}")
    words = len(fft_plan.twiddles(M)) + fft_plan.exchange_points(M) + (frames_in_smem - 1) * M
    if 8 * words > _SMEM_LIMIT:
        raise ValueError(f"M={M}: {frames_in_smem} complex frames exceed a block's shared memory")


def next_tail(tail, xr, xi):
    """The last (K-1)*M input samples after a block of planes xr/xi (T,)."""
    tl = tail.shape[-1]
    x = torch.complex(xr[-tl:].to(torch.float32), xi[-tl:].to(torch.float32))[None]
    if xr.shape[-1] >= tl:
        return x
    return torch.cat([tail, x], dim=-1)[:, -tl:]


def plain_pfb_dft(h, tail, xr, xi):
    """The plain PyTorch version of the kernel: (h (K, M) prototype rows,
    tail (1, (K-1)M) complex, xr/xi (T,)) -> (yr, yi), each (F, M) float32
    in channel order: the polyphase accumulation of ``ops/pfb.py`` and
    ``torch.fft.fft`` over each frame."""
    K, M = h.shape
    F = xr.shape[-1] // M
    frr = torch.cat([tail[0].real, xr.to(torch.float32)]).reshape(F + K - 1, M)
    fri = torch.cat([tail[0].imag, xi.to(torch.float32)]).reshape(F + K - 1, M)
    y = torch.fft.fft(torch.complex(*polyphase_frames(h, frr, fri)), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def ct_factors(M: int) -> tuple[int, int]:
    """The reference's Cooley-Tukey split M = M1 * M2 (``_dft_consts``):
    M2 = 128 where it divides M, else about sqrt(M)."""
    M2 = 128 if M % 128 == 0 and M >= 128 else 1 << (M.bit_length() // 2)
    return M // M2, M2


def ct_tables(M: int) -> np.ndarray:
    """The explicit CT product's tables, built in float64 and stored
    complex64, flat: W1 (M1, M1) [n1, k1], TW (M2, M1) [n2, k1] =
    e^{-2 pi i n2 k1 / M}, W2 (M2, M2) [n2, k2]."""
    M1, M2 = ct_factors(M)
    w1 = np.exp(-2j * np.pi * np.outer(np.arange(M1), np.arange(M1)) / M1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(M2), np.arange(M1)) / M)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(M2), np.arange(M2)) / M2)
    return np.concatenate([w1.ravel(), tw.ravel(), w2.ravel()]).astype(np.complex64)


def _frames(tail, xr, xi, M: int, history: bool):
    """(F [+ K-1], M) re/im frame planes, the tail's frames first if ``history``."""
    fr, fi = xr.to(torch.float32), xi.to(torch.float32)
    if history:
        fr, fi = torch.cat([tail[0].real, fr]), torch.cat([tail[0].imag, fi])
    return fr.reshape(-1, M), fi.reshape(-1, M)


def plain_variant(h, ct, tail, xr, xi, variant: str):
    """The plain PyTorch version of each of K9's variants: (yr, yi) (F, M)
    float32. ``base_b3`` is ``plain_pfb_dft``; ``pfb_only`` the polyphase
    accumulation in sample order; ``pfb_noshift`` every tap on the current
    frame, summed in tap order from zero (the probe's timing-only numerics);
    ``dft_only`` the FFT of the raw frames; ``batched_b3`` the polyphase, then
    the explicit CT product (W1 stage, twiddle, W2 stage), channel order."""
    K, M = h.shape
    if variant == "base_b3":
        return plain_pfb_dft(h, tail, xr, xi)
    if variant == "dft_only":
        y = torch.fft.fft(torch.complex(*_frames(tail, xr, xi, M, False)), dim=-1)
        return y.real.contiguous(), y.imag.contiguous()
    if variant == "pfb_noshift":
        fr, fi = _frames(tail, xr, xi, M, False)
        ur, ui = torch.zeros_like(fr), torch.zeros_like(fi)
        for t in range(K):
            ur, ui = ur + h[t] * fr, ui + h[t] * fi
        return ur, ui
    ur, ui = polyphase_frames(h, *_frames(tail, xr, xi, M, True))
    if variant == "pfb_only":
        return ur, ui
    if variant != "batched_b3":
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    M1, M2 = ct_factors(M)
    w1 = ct[: M1 * M1].reshape(M1, M1)
    tw = ct[M1 * M1: M1 * M1 + M2 * M1].reshape(M2, M1)
    w2 = ct[M1 * M1 + M2 * M1:].reshape(M2, M2)
    u = torch.complex(ur, ui).reshape(-1, M1, M2)      # [f, n1, n2]
    b = torch.einsum("fnm,nk->fkm", u, w1) * tw.T       # [f, k1, n2]
    x = torch.einsum("fkm,mj->fjk", b, w2).reshape(-1, M)  # [f, k2, k1]: channel M1 k2 + k1
    return x.real.contiguous(), x.imag.contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the magnitude rounded
    off."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (complex64) as the tensor cores take it: each real operand
    split x = hi + lo (hi = tf32_round(x), lo = tf32_round(x - hi)), the
    products of TF32 values exact, summed in float64: lo hi + hi lo + hi hi
    for ``terms`` = 3, hi hi alone for 1; complex as four real products."""
    def parts(x):
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)

    def real(x, y):
        (xh, xl), (yh, yl) = parts(x), parts(y)
        mm = lambda u, v: u.double() @ v.double()  # noqa: E731
        out = mm(xh, yh)
        if terms == 3:
            out = out + mm(xl, yh) + mm(xh, yl)
        return out

    re = real(a.real, b.real) - real(a.imag, b.imag)
    im = real(a.real, b.imag) + real(a.imag, b.real)
    return torch.complex(re.float(), im.float())


def plain_batched_tf32(h, ct, tail, xr, xi, terms: int = 3):
    """``batched_b3``'s arithmetic on the tensor cores, emulated: the
    polyphase, then stage one (W1^T times each frame's (M1, M2) view) and
    stage two (times W2) through ``_tf32_matmul`` with ``terms`` products a
    real product (3: the kernel's 3xTF32 split; 1: TF32 alone), the twiddle
    between them in complex64. (yr, yi) (F, M) in channel order."""
    K, M = h.shape
    M1, M2 = ct_factors(M)
    w1 = ct[: M1 * M1].reshape(M1, M1)
    tw = ct[M1 * M1: M1 * M1 + M2 * M1].reshape(M2, M1)
    w2 = ct[M1 * M1 + M2 * M1:].reshape(M2, M2)
    ur, ui = polyphase_frames(h, *_frames(tail, xr, xi, M, True))
    u = torch.complex(ur, ui).reshape(-1, M1, M2)                   # [f, n1, n2]
    a = _tf32_matmul(w1.T.contiguous(), u.permute(1, 0, 2).reshape(M1, -1), terms)
    b = a.reshape(M1, -1, M2).permute(1, 0, 2) * tw.T                # [f, k1, n2]
    x = _tf32_matmul(b.reshape(-1, M2), w2, terms).reshape(-1, M1, M2)  # [f, k1, k2]
    x = x.permute(0, 2, 1).reshape(-1, M)                            # channel M1 k2 + k1
    return x.real.contiguous(), x.imag.contiguous()


@functools.cache
def _kernel_fn():
    fn = _build.build("pfb_dft").lib.rf_pfb_dft
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class FusedPfbDft(nn.Module):
    """Fused PFB + DFT with the streaming contract of ``ops/pfb.PfbChannelizer``
    restricted to B=1. Buffers: ``h`` (K, M) prototype tap rows, ``tw`` the
    FFT's twiddle table (``fft_plan.twiddles``), ``ct`` the explicit CT product's tables
    (``ct_tables``, read by the ``batched_b3`` variant only)."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 window: str = "hamming", dft_precision: str = "highest"):
        super().__init__()
        if dft_precision not in DFT_PRECISIONS:
            raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, got {dft_precision!r}")
        self.dft_precision = dft_precision
        self.M = int(num_channels)
        self.K = int(taps_per_channel)
        check_channels(self.M, 1)
        proto = pfb_prototype_taps(self.M, self.K, window)
        self.register_buffer("h", torch.from_numpy(
            np.ascontiguousarray(proto.reshape(self.K, self.M).astype(np.float32))))
        self.register_buffer("tw", torch.from_numpy(fft_plan.twiddles(self.M)))
        self.register_buffer("ct", torch.from_numpy(ct_tables(self.M)))
        self.launches = 0
        self.variant_launches = dict.fromkeys(VARIANTS, 0)
        self.last_plan: pfb_plan.PfbPlan | None = None

    def init_state(self, batch: int = 1) -> torch.Tensor:
        if batch != 1:
            raise ValueError("FusedPfbDft streams one wideband input (batch=1)")
        return torch.zeros((1, (self.K - 1) * self.M), dtype=torch.complex64,
                           device=self.h.device)

    def forward(self, tail, x):
        """Channel-major complex contract: (tail, x (1, T) complex) ->
        (y (1, M, F) complex64, new_tail)."""
        (yr, yi), new_tail = self.call_planes(tail, x)
        return torch.complex(yr, yi).T[None], new_tail

    def call_planes(self, tail, x):
        """(tail, x (1, T) complex) -> ((yr, yi) each (F, M), new_tail); the
        planes are strided views of ``x``."""
        planes = torch.view_as_real(x[0])
        return self.step_planes(tail, planes[:, 0], planes[:, 1])

    def step_planes(self, tail, xr, xi, variant: str = "base_b3"):
        """(tail, xr/xi (T,) float32) -> ((yr, yi) each (F, M) float32 in
        channel order, new_tail). ``variant`` selects one of K9's stage
        variants, whose values are another function except for "base_b3"
        (see ``plain_variant``)."""
        T = xr.shape[-1]
        if xr.shape != xi.shape or xr.dim() != 1 or T % self.M:
            raise ValueError(f"planes {tuple(xr.shape)}/{tuple(xi.shape)}: need (T,) with T a "
                             f"multiple of M={self.M}")
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        if xr.device.type == "cuda":
            y = self._launch(tail, xr, xi, variant)
        elif xr.device.type == "cpu":
            y = plain_variant(self.h, self.ct, tail, xr, xi, variant)
        else:
            raise ValueError(f"unsupported device {xr.device}")
        return y, next_tail(tail, xr, xi)

    def plan(self, variant: str, F: int, device: int) -> pfb_plan.PfbPlan | None:
        """The launch's polyphase plan on CUDA device ``device``: the
        cluster plan for base_b3, the column plan for pfb_only, None for the
        others. Raises ValueError where the card's kernels refuse (M, K)."""
        if variant == "base_b3":
            occ = pfb_plan.occupancy("pfb_dft", device, VARIANTS.index(variant), self.M, self.K)
            p = pfb_plan.plan(self.M, self.K, F, occ["clusters"])
        elif variant == "pfb_only":
            occ = pfb_plan.occupancy("pfb_dft", device, VARIANTS.index(variant), self.M, self.K)
            p = pfb_plan.columns_plan(self.M, self.K, F, occ["sms"])
        else:
            return None
        pfb_plan.check_occupancy(p, occ)
        return p

    def _launch(self, tail, xr, xi, variant: str = "base_b3"):
        dev = xr.device
        if variant == "batched_b3" and self.M not in BATCHED_M:
            raise ValueError(f"batched_b3 on the card takes M in {BATCHED_M} (M1 = M/128 a "
                             f"multiple of 16), got M={self.M}")
        for name, t in (("xi", xi), ("tail", tail), ("h", self.h)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if xr.dtype != torch.float32 or xi.dtype != torch.float32:
            raise ValueError("planes must be float32")
        if xr.stride() != xi.stride():
            raise ValueError("xr and xi must have the same strides")
        tail_c = tail.to(torch.complex64).contiguous()
        if tail_c.shape != (1, (self.K - 1) * self.M):
            raise ValueError(f"tail must be (1, {(self.K - 1) * self.M})")
        M = self.M
        F = xr.shape[0] // M
        plan = self.plan(variant, F, torch.cuda.current_device())
        yr = torch.empty((F, M), dtype=torch.float32, device=dev)
        yi = torch.empty_like(yr)
        rc = _kernel_fn()(xr.data_ptr(), xi.data_ptr(), xr.stride(0), tail_c.data_ptr(),
                          self.h.data_ptr(), self.tw.data_ptr(), self.ct.data_ptr(),
                          yr.data_ptr(), yi.data_ptr(), M, self.K, *ct_factors(M), F,
                          VARIANTS.index(variant), plan.runs if plan else 0,
                          plan.run_length if plan else 0,
                          torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pfb_dft kernel launch failed: CUDA error {rc}")
        _build.launched(self, variant)
        self.last_plan = plan
        return yr, yi
