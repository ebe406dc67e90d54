"""Block streaming (counterpart of ``radioframe/core/stream.py``): the
double-buffered block loop of an interrupt-driven receiver, as dataflow.

    copy(block k+1) -> device   ||   step(state, block k) on the device

On a CUDA device a host block is written into a pinned (page-locked) host
buffer and copied to the card with ``non_blocking=True`` on a side stream;
an event orders the step that reads it after the copy, so the copy of
block k+1 overlaps the step of block k. On the CPU the loop is a plain
loop. Sources are iterables of numpy blocks (WAV readers, the capture
ring, synthetic generators); a block is an array or a tuple of arrays (the
int16 ``(xr, xi)`` planes of ``CaptureSource(raw_i16=True)``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from radioframe_torch.core.compiled import CompiledStep, clone_tree
from radioframe_torch.device import resolve
from radioframe_torch.diag.timing import span, stream_id
from radioframe_torch.io.wav import read_wav
from radioframe_torch.native import RingBuffer, iq_i16_deinterleave, iq_i16_to_c64


class Stager:
    """Host arrays to ``device`` and back. On CUDA a block is written into a
    buffer of torch's caching page-locked allocator and copied to the card
    on a side stream; ``stage`` starts the copy, ``take`` makes the owner's
    stream wait for it. The allocator hands a buffer out again only after
    the copies that read it have finished, so a buffer's reuse needs no
    wait here. ``to_host`` copies a result into page-locked memory, waiting
    for the current stream only. On the CPU: the array itself as a tensor
    (no copy where none is needed), and back.

    The owner's stream is the caller's current stream, or with
    ``own_stream=True`` (an API object's ``Stager``) a stream of the
    owner's own, created here and current inside ``running()``: there the
    owner queues a block's wait, its copies, its replay and its copy back,
    so that objects driven from several threads run side by side on one
    card and each waits for its own work alone. Streams come from torch's
    pool, 32 a card handed out in turn: owners hold distinct ones while
    fewer than 32 streams are made between the first and the last (three
    an API object, with its step's).

    Spans (``diag.timing.span``, while a profiler runs): ``stager.pin``
    (the page-locked buffer; ``count``: the allocator's new host
    allocations), ``stager.host_copy`` (the block into it; on the CPU the
    contiguous array), ``stager.h2d`` (the copy enqueued), ``stager.take``
    and ``stager.to_host`` (with the ``stream`` they ordered or waited
    for), each with the bytes it moves."""

    def __init__(self, device, *, own_stream: bool = False):
        self.device = resolve(device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None  # the copies'
        # the owner's own stream; None: the caller's current one
        self.stream = None
        if cuda and own_stream:
            self.stream = torch.cuda.Stream(self.device)
            self._joins = (torch.cuda.Event(), torch.cuda.Event())  # into it, back out

    @contextlib.contextmanager
    def running(self):
        """The owner's own stream made current, after the work queued so far
        on the caller's stream and before the work queued there next (the
        owner's set-up, a state assigned, the tensors a caller reads and
        frees). Without one, nothing to do. Events kept for the purpose and
        ``set_stream``: the stream context and ``wait_stream`` cost twice as
        much (51 against 22 to 26 us on the H100's host)."""
        if self.stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        into, out = self._joins
        into.record(caller)
        self.stream.wait_event(into)
        torch.cuda.set_stream(self.stream)
        try:
            yield
        finally:
            torch.cuda.set_stream(caller)
            out.record(self.stream)
            caller.wait_event(out)

    def _owner(self):
        return self.stream if self.stream is not None else torch.cuda.current_stream(self.device)

    def stream_id(self) -> int | None:
        """The owner's stream (a span's ``stream``); None off a card."""
        return None if self._stream is None else self._owner().cuda_stream

    def _one(self, arr, dtype):
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device), None
        arr = np.asarray(arr)
        dtype = arr.dtype if dtype is None else np.dtype(dtype)
        if self._stream is None:
            with span("stager.host_copy") as sp:
                arr = np.ascontiguousarray(arr, dtype)
                out = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
                if sp:
                    sp.nbytes = out.nbytes
            return out, None
        if not np.can_cast(arr.dtype, dtype, "same_kind"):
            raise TypeError(f"cannot stage {arr.dtype} as {dtype}")
        with span("stager.pin") as sp:
            allocs = _host_allocs() if sp else 0
            pinned = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                 pin_memory=True)
            if sp:
                sp.count = _host_allocs() - allocs
        with span("stager.host_copy", pinned.nbytes):
            if arr.flags.writeable and all(st >= 0 for st in arr.strides):
                pinned.copy_(torch.from_numpy(arr))  # on several threads; numpy copies on one
            else:
                np.copyto(pinned.numpy(), arr, casting="same_kind")
        with span("stager.h2d", pinned.nbytes), torch.cuda.stream(self._stream):
            out = torch.empty(pinned.shape, dtype=pinned.dtype, device=self.device)
            out.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def stage(self, block, dtype=None):
        """Start moving ``block`` (an array or a tuple of arrays) to the
        device; returns a handle for ``take``."""
        if isinstance(block, tuple):
            return tuple(self._one(b, dtype) for b in block)
        return self._one(block, dtype)

    def take(self, staged):
        """The staged tensors, ordered after their copies on the owner's
        stream."""
        with span("stager.take") as sp:
            owner = None if self._stream is None else self._owner()
            if sp and owner is not None:
                sp.stream = owner.cuda_stream
            return self._take(staged, owner)

    def _take(self, staged, owner):
        if isinstance(staged, tuple) and staged and isinstance(staged[0], tuple):
            return tuple(self._take(s, owner) for s in staged)
        out, done = staged
        if done is not None:
            owner.wait_event(done)
            out.record_stream(owner)  # allocated on the side stream, read there
        return out

    def to_device(self, block, dtype=None):
        """``take(stage(block, dtype))``."""
        return self.take(self.stage(block, dtype))

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as a numpy array. From the card it is copied into a buffer of
        torch's caching page-locked allocator, which is mapped already (a
        fresh pageable array takes a page fault on every page the copy
        writes); the array holds the buffer until it is freed. The copy is
        queued on the current stream and waits for it alone: an owner with a
        stream of its own calls it inside ``running()``."""
        with span("stager.to_host", t.nbytes) as sp:
            if t.device.type != "cuda":
                return t.numpy()
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t).numpy()
        if sp:  # read once the span is closed, as compiled.replay's
            sp.stream = stream_id(self.device)
        return out


def _host_allocs() -> int:
    """Page-locked buffers torch's caching host allocator has allocated (a
    buffer it hands out again is not one). The nested form of the stats:
    the flat one costs 27 us a call on the H100's host, this one 8."""
    return torch.cuda.host_memory_stats_as_nested_dict().get("num_host_alloc", 0)


class BlockStream:
    """Runs a ``step(state, block, *args) -> (state, out, aux)`` over a
    source on ``device``, the copy of the next block overlapping the step of
    the current one. A tuple block reaches the step as one tuple of tensors.
    The step runs as a ``CompiledStep`` (one CUDA graph a block signature on
    a card), the reference's ``jax.jit(step, donate_argnums=0)``: with
    ``donate=True`` the caller's state tensors are consumed (they become the
    stream's buffers and hold its latest state); with ``donate=False`` they
    stay as they were, and ``state`` is a copy of the stream's.

    A block already on the device (a GPUDirect NIC ring) is read where it
    lies, with no copy: one capture a buffer, up to ``compiled.BIND_CAP``
    buffers, after which blocks are copied into the step's static input.
    The caller must not overwrite such a block before the stream reaches
    its step, as it must not overwrite one that a copy reads. The step's
    outputs are the graph's own tensors, overwritten by a later block;
    ``run`` clones what it collects.

    >>> bs = BlockStream(chain.step, chain.init_state(), device="cuda")
    >>> outs, auxs = bs.run(blocks, words, modes)

    Spans: ``stream.block`` (a root: one block id each) around a block's
    step and the staging of the next, ``stream.source`` around each wait
    for the source."""

    def __init__(self, step, state, *, device, donate: bool = True):
        self.stager = Stager(device)
        self.device = self.stager.device
        self.compiled = CompiledStep(step, state, device=self.device, donate=donate,
                                     name=f"BlockStream({getattr(step, '__qualname__', step)})")

    @property
    def state(self):
        return self.compiled.state

    @state.setter
    def state(self, tree) -> None:
        self.compiled.state = tree

    def run(self, source, *args, collect: bool = True):
        """Iterate ``source`` blocks through the step; returns (outs, auxs),
        the step's outputs (on the device; copies, since the next block's
        replay overwrites the graph's own)."""
        outs, auxs = [], []
        it = iter(source)
        nxt = self._stage_next(it)
        while nxt is not None:
            with span("stream.block", root=True):
                cur = self.stager.take(nxt)
                out, aux = self.compiled(cur, *args)
                nxt = self._stage_next(it)  # its copy overlaps the step above
                if collect:
                    out, aux = clone_tree((out, aux))
                    outs.append(out)
                    auxs.append(aux)
        return outs, auxs

    def _stage_next(self, it):
        """Stage the source's next block; None at its end."""
        with span("stream.source"):
            try:
                block = next(it)
            except StopIteration:
                return None
        return self.stager.stage(block)


class CaptureSource:
    """Capture thread -> lock-free ring -> block iterator.

    A producer thread plays the bus-read interrupt: it pulls interleaved
    int16 IQ chunks from ``producer``, converts them to complex64 in native
    code (``native.iq_i16_to_c64``) and pushes them into the lock-free SPSC
    ring (``native/iqtransport.c``). The consumer side (this iterator,
    normally driven by ``BlockStream.run``) pops fixed-length blocks. A full
    ring blocks the producer briefly, then drops the chunk and counts it in
    ``overruns``.

    >>> src = CaptureSource(pcm_chunks, block_len=4096)
    >>> outs, auxs = BlockStream(chain.step, state, device="cuda").run(src, words, mode)
    """

    def __init__(self, producer, block_len: int, channels: int = 1,
                 capacity_blocks: int = 8, scale: float = 1.0 / 32767.0,
                 overrun_wait_s: float = 0.005, overrun_retries: int = 20,
                 raw_i16: bool = False):
        self.block_len = int(block_len)
        self.channels = int(channels)
        self._scale = scale
        # raw_i16: the int16-ingest path (RxConfig.int16_ingest): the ring
        # carries the interleaved int16 words (half the bytes of complex64)
        # and the iterator yields (xr, xi) int16 plane blocks for step_i16
        self.raw_i16 = bool(raw_i16)
        if self.raw_i16 and abs(scale - 1.0 / 32767.0) > 1e-12:
            # the int16 route never applies ``scale``: the chain's front end
            # converts with its own input_scale (2**-15); a custom scale would
            # silently give the wrong gain
            raise ValueError("raw_i16=True ignores CaptureSource scale; "
                             "set the chain's int16 input_scale instead")
        sample_bytes = 4 if raw_i16 else 8
        self._block_bytes = self.channels * self.block_len * sample_bytes
        self.ring = RingBuffer(capacity_blocks * self._block_bytes)
        self._producer = producer
        self.overruns = 0
        self._wait = overrun_wait_s
        self._retries = overrun_retries
        self._done = False
        self._thread = None

    # -- producer side (the interrupt) ------------------------------------------

    def _capture_loop(self):
        for pcm in self._producer:
            if self.raw_i16:
                payload = np.ascontiguousarray(pcm, dtype=np.int16)
            else:
                payload = iq_i16_to_c64(pcm, self._scale)
            for _ in range(self._retries):
                if self.ring.write(payload):
                    break
                time.sleep(self._wait)  # consumer catching up
            else:
                self.overruns += 1  # the ring stayed full: drop the chunk
        self._done = True

    def start(self):
        self._thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._thread.start()
        return self

    # -- consumer side (the block loop) -------------------------------------------

    def __iter__(self):
        if self._thread is None:
            self.start()
        while True:
            if self.raw_i16:
                blk = self.ring.read(self._block_bytes, dtype=np.int16)
                if blk is not None:
                    xr, xi = iq_i16_deinterleave(blk)
                    yield (xr.reshape(self.channels, self.block_len),
                           xi.reshape(self.channels, self.block_len))
                    continue
            else:
                blk = self.ring.read(self._block_bytes)
                if blk is not None:
                    yield blk.reshape(self.channels, self.block_len)
                    continue
            if self._done and self.ring.fill < self._block_bytes:
                return  # drained (a partial tail shorter than a block is dropped)
            time.sleep(0.0005)  # underrun: wait for the capture thread


def wav_blocks(path: str, block_len: int):
    """Yield (1, block_len) complex64 IQ blocks from a stereo WAV capture,
    the last one zero-padded."""
    iq, _fs = read_wav(path)
    for i in range(0, len(iq), block_len):
        b = iq[i: i + block_len]
        if len(b) < block_len:
            b = np.pad(b, (0, block_len - len(b)))
        yield b[None, :]


def synthetic_blocks(generator, block_len: int, num_blocks: int, channels: int = 1,
                     seed: int = 0):
    """Deterministic synthetic block source: ``generator(rng, channels,
    block_len)`` for each of ``num_blocks`` blocks."""
    rng = np.random.default_rng(seed)
    for _ in range(num_blocks):
        yield generator(rng, channels, block_len)
