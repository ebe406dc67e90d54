"""Ring halo exchange (counterpart of ``radioframe/kernels/halo_dma.py``,
kernel K7).

Every shard of a time axis sends the last H samples of each channel to its
right neighbour, so shard d receives shard d-1's tail: the causal FIR halo.
Shard 0 receives shard D-1's tail, the block's global tail, which becomes
the next block's carry (``causal_halo_dma``), as with the ppermute transport.

``HaloDma`` is one rank's endpoint on one axis. For CUDA tensors it
launches the hand-written kernels of ``csrc/halo_dma.cu``, ordered on the
card by sequence words in device memory, as the TPU kernel's DMA
semaphores order its copy: ``start`` enqueues, on the current stream, a wait
for the right neighbour's acknowledgement of the call before last and the
put of the tail into its buffer (mapped through CUDA IPC), so that compute
can be enqueued behind it; ``finish`` enqueues a wait for this call's flag,
the receive and the acknowledgement to the left neighbour, and returns.
Neither waits on the host or calls a collective. A flag that does not hold
its call's number is counted on the card; ``check`` (once per block, where
the caller synchronizes anyway) and ``close`` raise on it. The waits need
64-bit stream memory operations (``stream_mem_ops``): an endpoint raises on
a card without them. For CPU tensors ``start`` runs the plain version, the
ppermute transport. There is no fallback from one to the other: the caller
names the transport (``ppermute_fallback``). ``launches`` counts exchanges
(one put and one receive kernel each).

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

# A rank's buffer: a header of u64 words, then two payload slots.
HEADER_BYTES = 256
FLAG_WORDS = (0, 1)  # flag of slot 0 and 1, written by the left neighbour's put
ACK_WORD = 8         # on its own 64-byte line, written by the right neighbour's recv


@dataclass(frozen=True)
class Call:
    """What call number s of an endpoint does (``schedule``)."""
    slot: int      # payload slot and flag index
    flag: int      # the value the put stores into the flag, the recv waits for and checks
    ack_wait: int  # the put first waits until the sender's own ack word is >= this
    ack: int       # the value the recv then writes into the left neighbour's ack word


def schedule(s: int) -> Call:
    """The parity schedule of call s >= 1: slot and flag s & 1; the put waits
    for the ack of call s - 1 (which follows the recv of s - 2, the last user
    of the slot); the recv waits for the flag to reach s and acknowledges s."""
    if s < 1:
        raise ValueError(f"calls are numbered from 1, got {s}")
    return Call(slot=s & 1, flag=s, ack_wait=s - 1, ack=s)


def flag_offset(slot: int) -> int:
    return 8 * FLAG_WORDS[slot]


def ack_offset() -> int:
    return 8 * ACK_WORD


def slot_offset(slot: int, slot_floats: int) -> int:
    return HEADER_BYTES + slot * slot_floats * 4


def buffer_bytes(slot_floats: int) -> int:
    return slot_offset(2, slot_floats)


@functools.cache
def _lib():
    lib = _build.build("halo_dma").lib
    sigs = {
        "rf_halo_handle_bytes": [],
        "rf_halo_stream_mem_ops": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
        "rf_halo_alloc": [ctypes.c_int, _U64, ctypes.POINTER(_VOID_P), _VOID_P],
        "rf_halo_open": [ctypes.c_int, _VOID_P, ctypes.POINTER(_VOID_P)],
        "rf_halo_close": [ctypes.c_int, _VOID_P],
        "rf_halo_free": [ctypes.c_int, _VOID_P],
        "rf_halo_put": [ctypes.c_int, _VOID_P, ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [_VOID_P] * 3 + [_U64, _U64, _VOID_P],
        "rf_halo_recv": [ctypes.c_int, _VOID_P, _VOID_P, _U64, ctypes.c_int, _VOID_P, _VOID_P,
                         _U64, _VOID_P, _VOID_P],
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


def stream_mem_ops(device: torch.device) -> bool:
    """Whether the card can wait on 64-bit values in device memory from a
    stream (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS), which K7's
    ordering needs."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    supported = ctypes.c_int(0)
    _check(_lib().rf_halo_stream_mem_ops(index, ctypes.byref(supported)), "attribute query")
    return bool(supported.value)


class _Endpoint:
    """This rank's buffer (two (C, Hf) slots, two flags and an ack word),
    mapped by both neighbours, and the neighbours' buffers mapped here: the
    right one's to put into, the left one's to acknowledge. With two ranks
    on the axis they are one buffer, mapped once."""

    def __init__(self, device: torch.device, slot_floats: int, axis):
        lib = _lib()
        if not stream_mem_ops(device):
            raise RuntimeError(f"{torch.cuda.get_device_name(device)} cannot wait on 64-bit "
                               "values from a stream; K7 needs it (the caller may name the "
                               "ppermute transport instead)")
        self.dev = device.index if device.index is not None else torch.cuda.current_device()
        self.slot_floats = slot_floats
        self.seq = 0
        self.own = _VOID_P()
        # [wrong flags seen, the first such call, the value it held]
        self.errors = torch.zeros(3, dtype=torch.int64, device=device)
        handle = (ctypes.c_ubyte * lib.rf_halo_handle_bytes())()
        _check(lib.rf_halo_alloc(self.dev, buffer_bytes(slot_floats), ctypes.byref(self.own),
                                 handle), "alloc")
        # every rank of the axis sets up in the same order, so this
        # all_gather pairs the same endpoint on each
        mine = torch.frombuffer(bytearray(handle), dtype=torch.uint8)
        handles = axis.all_gather(mine)
        self.mapped = {}  # axis index -> the neighbour's buffer mapped here
        for i in dict.fromkeys(((axis.index + 1) % axis.size, (axis.index - 1) % axis.size)):
            peer = _VOID_P()
            _check(lib.rf_halo_open(self.dev, bytes(handles[i].numpy().tobytes()),
                                    ctypes.byref(peer)), "IPC open")
            self.mapped[i] = peer.value
        self.right = self.mapped[(axis.index + 1) % axis.size]
        self.left = self.mapped[(axis.index - 1) % axis.size]

    def mismatches(self) -> tuple[int, int, int]:
        """(wrong flags seen, the first such call, its flag's value); waits
        for this rank's work so far."""
        n, first, seen = (int(v) for v in self.errors.cpu())
        return n, first, seen

    def close(self, axis) -> None:
        lib = _lib()
        torch.cuda.synchronize(self.dev)  # no wait or copy of this rank still pending
        for peer in self.mapped.values():
            _check(lib.rf_halo_close(self.dev, peer), "IPC close")
        axis.barrier()  # no neighbour maps this buffer any more
        _check(lib.rf_halo_free(self.dev, self.own), "free")


def _raise_on(mismatch: tuple[int, int, int]) -> None:
    n, first, seen = mismatch
    if n:
        raise RuntimeError(f"halo_dma: {n} exchange(s) found a wrong sequence flag, first at call "
                           f"{first} (the flag held {seen}): a neighbour's put did not land")


@dataclass
class _Pending:
    like: torch.Tensor                 # the local block (dtype, device)
    recv: torch.Tensor | None = None   # the plain route's result
    end: _Endpoint | None = None
    seq: int = 0
    shape: tuple = ()


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
        stream behind a wait for the neighbour's acknowledgement of the call
        before last; work enqueued after it runs before ``finish``'s wait."""
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
        call = schedule(end.seq)
        stream = torch.cuda.current_stream(x_local.device)
        _check(_lib().rf_halo_put(
            end.dev, words.data_ptr(), words.stride(0), W, Hf, C,
            end.right + slot_offset(call.slot, end.slot_floats), end.right + flag_offset(call.slot),
            end.own.value + ack_offset(), call.ack_wait, call.flag, stream.cuda_stream),
            "put launch")
        return _Pending(like=x_local, end=end, seq=end.seq, shape=(C, Hf))

    def finish(self, pending: _Pending) -> torch.Tensor:
        """The left neighbour's tail (C, H) for a ``start``ed exchange. On the
        card the receive is enqueued (behind a wait for its flag) and the
        result is a tensor that later work on the stream reads in order."""
        if pending.recv is not None:
            return pending.recv
        end, call = pending.end, schedule(pending.seq)
        dev = pending.like.device
        out = torch.empty(pending.shape, dtype=torch.float32, device=dev)
        own = end.own.value
        _check(_lib().rf_halo_recv(
            end.dev, own + slot_offset(call.slot, end.slot_floats), own + flag_offset(call.slot),
            call.flag, out.numel(), out.data_ptr(), end.left + ack_offset(), call.ack,
            end.errors.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "recv launch")
        self.launches += 1
        return _unwords(out, pending.like)

    def mismatches(self) -> int:
        """Exchanges so far whose flag did not hold their call's number, over
        every buffer; waits for this rank's work."""
        return sum(end.mismatches()[0] for end in self._ends.values())

    def check(self) -> None:
        """Raise if any exchange so far found a wrong flag (waits for this
        rank's work: call it where the caller synchronizes anyway)."""
        for end in self._ends.values():
            _raise_on(end.mismatches())

    def close(self) -> None:
        """Unmap and free every buffer (a collective over the axis); then
        raise if any exchange found a wrong flag."""
        found = []
        for end in self._ends.values():
            end.close(self.axis)
            found.append(end.mismatches())
        self._ends.clear()
        for m in found:
            _raise_on(m)


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
