"""Ring halo exchange (counterpart of ``radioframe/kernels/halo_dma.py``,
kernel K7).

Every shard of a time axis sends the last H samples of each channel to its
right neighbour, so shard d receives shard d-1's tail: the causal FIR halo.
Shard 0 receives shard D-1's tail, the block's global tail, which becomes
the next block's carry (``causal_halo_dma``), as with the ppermute transport.

``HaloDma`` is one rank's endpoint on one axis. For CUDA tensors it
launches the hand-written kernels of ``csrc/halo_dma.cu``: ``start`` puts
the tail into the right neighbour's buffer (mapped through CUDA IPC), so
that compute can be enqueued behind it; ``finish`` waits for this rank's
put, meets the axis at a barrier and launches the receive, which checks the
sequence flag and raises if it does not hold this call's number. For CPU
tensors ``start`` runs the plain version, the ppermute transport. There is
no fallback from one to the other: the caller names the transport
(``ppermute_fallback``). ``launches`` counts completed exchanges (one put and
one receive kernel each).

Complex streams travel as float32 pairs (complex64's memory layout).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from radioframe_torch.kernels import _build
from radioframe_torch.shard.halo import causal_from_recv

_VOID_P = ctypes.c_void_p
_U64 = ctypes.c_ulonglong


@functools.cache
def _lib():
    lib = _build.build("halo_dma").lib
    sigs = {
        "rf_halo_handle_bytes": [],
        "rf_halo_alloc": [ctypes.c_int, _U64, ctypes.POINTER(_VOID_P), _VOID_P],
        "rf_halo_open": [ctypes.c_int, _VOID_P, ctypes.POINTER(_VOID_P)],
        "rf_halo_close": [ctypes.c_int, _VOID_P],
        "rf_halo_free": [ctypes.c_int, _VOID_P],
        "rf_halo_put": [ctypes.c_int, _VOID_P, ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [_VOID_P, _U64, _U64, _VOID_P],
        "rf_halo_recv": [ctypes.c_int, _VOID_P, _U64, ctypes.c_int, _VOID_P, _U64, _VOID_P,
                         _VOID_P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"halo_dma {what} failed: CUDA error {rc}")


def _words(x_local: torch.Tensor) -> torch.Tensor:
    """(C, T) complex64 or float32 -> (C, W) float32 words (a view)."""
    if x_local.dim() != 2:
        raise ValueError(f"halo input must be (C, T), got {tuple(x_local.shape)}")
    if x_local.dtype == torch.complex64:
        return torch.view_as_real(x_local).reshape(x_local.shape[0], -1)
    if x_local.dtype == torch.float32:
        return x_local
    raise ValueError(f"halo input must be complex64 or float32, got {x_local.dtype}")


def _unwords(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(y.reshape(y.shape[0], -1, 2))
    return y


def plain_ring_halo(x_local, H: int, axis):
    """The plain version: the left neighbour's last H samples (C, H) through
    the ppermute transport (``axis.ppermute_right`` of the tail)."""
    return axis.ppermute_right(x_local[..., x_local.shape[-1] - H:].contiguous())


class _Endpoint:
    """One (C, Hf) receive buffer of this rank, mapped by its left
    neighbour, and the right neighbour's buffer mapped here."""

    def __init__(self, device: torch.device, slot_floats: int, axis):
        lib = _lib()
        self.dev = device.index if device.index is not None else torch.cuda.current_device()
        self.slot_floats = slot_floats
        self.seq = 0
        self.own = _VOID_P()
        self.peer = _VOID_P()
        handle = (ctypes.c_ubyte * lib.rf_halo_handle_bytes())()
        _check(lib.rf_halo_alloc(self.dev, slot_floats, ctypes.byref(self.own), handle), "alloc")
        # every rank of the axis sets up in the same order, so this
        # all_gather pairs the same endpoint on each
        mine = torch.frombuffer(bytearray(handle), dtype=torch.uint8)
        handles = axis.all_gather(mine)
        theirs = bytes(handles[(axis.index + 1) % axis.size].numpy().tobytes())
        _check(lib.rf_halo_open(self.dev, theirs, ctypes.byref(self.peer)), "IPC open")

    def close(self, axis) -> None:
        lib = _lib()
        _check(lib.rf_halo_close(self.dev, self.peer), "IPC close")
        axis.barrier()  # no neighbour maps this buffer any more
        _check(lib.rf_halo_free(self.dev, self.own), "free")


@dataclass
class _Pending:
    like: torch.Tensor                 # the local block (dtype, device)
    recv: torch.Tensor | None = None   # the plain route's result
    end: _Endpoint | None = None
    seq: int = 0
    shape: tuple = ()
    put_done: torch.cuda.Event | None = None


class HaloDma:
    """One rank's K7 endpoint on ``axis`` (a ``mesh.Axis``). Buffers are set
    up once per (C, H) shape, with one collective over the axis; every rank
    must make the same sequence of calls."""

    def __init__(self, axis):
        self.axis = axis
        self.launches = 0
        self._ends: dict[tuple, _Endpoint] = {}

    def start(self, x_local: torch.Tensor, H: int) -> _Pending:
        """Send the last H samples of every row of ``x_local`` (C, T) to the
        right neighbour. On a CUDA tensor the put is enqueued on the current
        stream; work enqueued after it runs before ``finish`` waits."""
        words = _words(x_local)
        if not 0 < H <= x_local.shape[-1]:
            raise ValueError(f"halo of {H} samples for a local block of {x_local.shape[-1]}")
        if x_local.device.type == "cpu":
            return _Pending(like=x_local, recv=plain_ring_halo(x_local, H, self.axis))
        if x_local.device.type != "cuda":
            raise ValueError(f"unsupported device {x_local.device}")
        if self.axis.size == 1:
            raise ValueError("K7 needs a time axis of at least two ranks")
        if words.stride(1) != 1:
            raise ValueError("halo input rows must be contiguous")
        C, W = words.shape
        Hf = W // x_local.shape[-1] * H
        key = (C, Hf, x_local.device)
        if key not in self._ends:
            self._ends[key] = _Endpoint(x_local.device, C * Hf, self.axis)
        end = self._ends[key]
        end.seq += 1
        stream = torch.cuda.current_stream(x_local.device)
        _check(_lib().rf_halo_put(end.dev, words.data_ptr(), words.stride(0), W, Hf, C, end.peer,
                                  end.slot_floats, end.seq, stream.cuda_stream), "put launch")
        done = torch.cuda.Event()
        done.record(stream)
        return _Pending(like=x_local, end=end, seq=end.seq, shape=(C, Hf), put_done=done)

    def finish(self, pending: _Pending) -> torch.Tensor:
        """The left neighbour's tail (C, H) for a ``start``ed exchange."""
        if pending.recv is not None:
            return pending.recv
        end = pending.end
        pending.put_done.synchronize()
        self.axis.barrier()  # after it, every put of this call has landed
        dev = pending.like.device
        out = torch.empty(pending.shape, dtype=torch.float32, device=dev)
        seen = torch.zeros(1, dtype=torch.int64, device=dev)
        _check(_lib().rf_halo_recv(end.dev, end.own, end.slot_floats, out.numel(),
                                   out.data_ptr(), pending.seq, seen.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream), "recv launch")
        self.launches += 1
        flag = int(seen.item())
        if flag != pending.seq:
            raise RuntimeError(f"halo_dma: sequence flag holds {flag}, expected {pending.seq} "
                               "(the neighbour's put did not land)")
        return _unwords(out, pending.like)

    def close(self) -> None:
        """Unmap and free every buffer; a collective over the axis."""
        for end in self._ends.values():
            end.close(self.axis)
        self._ends.clear()


def ring_halo_dma(x_local, H: int, dma: HaloDma):
    """The left neighbour's last H samples (C, H) (shard 0 gets shard D-1's;
    the caller substitutes its carried state there)."""
    return dma.finish(dma.start(x_local, H))


def causal_halo_dma(x_local, carry, H: int, dma: HaloDma, ppermute_fallback: bool = False,
                    pending: _Pending | None = None):
    """Drop-in for ``shard.halo.causal_halo`` with the K7 transport:
    (x_with_halo (C, H+T_local), new_carry (C, H)).

    ``ppermute_fallback`` routes the transfer through ``axis.ppermute_right``
    instead of K7, keeping this API. ``pending``: an exchange already
    ``start``ed on this ``x_local`` (the caller enqueued work behind the put)."""
    if H == 0:
        return x_local, carry
    axis = dma.axis
    if axis.size == 1:
        return torch.cat([carry, x_local], dim=-1), x_local[..., x_local.shape[-1] - H:]
    if ppermute_fallback:
        recv = axis.ppermute_right(x_local[..., x_local.shape[-1] - H:])
    elif pending is not None:
        recv = dma.finish(pending)
    else:
        recv = ring_halo_dma(x_local, H, dma)
    return causal_from_recv(x_local, carry, recv, axis)
