"""The host side of the fused front ends' load path (``csrc/frontend.cuh``,
used by K1 ``csrc/fused_frontend2.cu`` and K2 ``csrc/fused_frontend.cu``):
the plan of strips, chunks and ring stages, the shared-memory layout, the copy
path an input's alignment allows, and plain PyTorch executors of the same
schedule with the same index maps (``execute`` for K1's two stages,
``execute_single`` for K2's one stage and K8's variants), as ``fft_plan.py``
and ``walk_plan.py`` are for ``rf::fft`` and ``rf::agc_walk_all``.

The kernel's schedule. Each thread block owns one channel and a strip of
consecutive chunks of it, and walks them in time order. A chunk is ``q2``
final-rate outputs, ``q2 * R1 * R2`` raw samples. The block keeps, in shared
memory, the mixed window (phase-major: row p holds mixed samples f*R1 + p,
the first J0 frames the history that stage 1 needs) and the stage-1 outputs
(row p2 holds outputs g*R2 + p2, the first J2 frames the history that stage
2 needs). After a chunk the last J0 mixed frames and the last J2 stage-1
frames move to the front: the next chunk re-reads and re-mixes nothing. At a
strip's start a prologue reads the Hc = J2*R1*R2 + J0*R1 raw samples before
it (the carried tail below sample 0) with plain loads, mixes them and runs
stage 1 over them to fill both histories. Stage 2 runs once a ``batch`` of
chunks (THREADS / q2 of them: one thread an output), and both stages sum
their taps in order in one accumulator, as the plain version's strided
conv1d does. K2 is the single-stage shape (``stage2`` off: R2 = 1, J2 = 0,
Hc = J0*R1, no stage-2 taps, rows or batch): its stage writes the output,
one thread an output of the chunk. Both sum each sample's xr^2 + xi^2 as
they mix it, into one partial a strip.

Raw chunks reach shared memory through a ring of ``stages`` buffers, each
guarded by an mbarrier, ``stages`` chunks in flight ahead of the one being
mixed. Three copy paths, chosen per launch from the input's form and the
alignment of every copy's address and length:

    bulk    one ``cp.async.bulk`` (TMA) per plane and chunk: addresses and
            lengths 16-byte aligned
    async   per-thread ``cp.async`` of ``width`` bytes (8 or 4) over the
            chunk's byte range rounded out to ``width``; the consumer reads
            past the ``shift`` = address mod ``width`` (2 bytes at most, for
            int16 rows at odd sample offsets)
    gather  plain loads of a strided view (neither interleaved nor unit
            stride), stored in the planes layout

Input forms: ``pair`` (the interleaved ``view_as_real`` of complex samples:
xi is xr plus one element, time stride 2; one copy of both), ``planes``
(unit time stride; two copies), ``gather``. A shared (1, T) wideband input
(channel stride 0) is any of them, its re-reads served from L2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from radioframe_torch.ops.fir import conv_planes
from radioframe_torch.ops.nco import wrap_i32

SCALE = np.float32(-(2.0 * np.pi) * 2.0 ** -32)  # int32 Q0.32 turns -> -radians
THREADS = 256          # threads per block (csrc/fused_frontend2.cu kThreads)
TARGET_CHUNK = 2048    # raw samples per chunk the plan aims at
STAGES = 3             # ring stages
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use
BANKS = 32
FORMS = ("pair", "planes", "gather")
COPIES = ("bulk", "async", "gather")


def dds_oscillator(acc, words, n):
    """e^{-j theta(n)}, theta(n) = (acc + word*n) mod 2**32 as int32 Q0.32, at
    absolute sample indices n (int64): (C, len(n)) complex64."""
    theta = wrap_i32(acc.to(torch.int64)[:, None] + words.to(torch.int64)[:, None] * n)
    ang = theta.to(torch.float32) * float(SCALE)
    return torch.complex(torch.cos(ang), torch.sin(ang))


@dataclass(frozen=True)
class FrontendPlan:
    q2: int         # final-rate outputs per chunk
    chunk: int      # raw samples per chunk, q2 * R1 * R2
    chunks: int     # chunks per channel, ceil(M2 / q2)
    per_strip: int  # chunks per strip (the last strip may hold fewer)
    strips: int     # strips per channel
    stages: int     # ring buffers of raw chunks
    batch: int      # chunks whose stage-1 outputs one stage-2 pass takes
    form: str       # "pair", "planes" or "gather"
    copy: str       # "bulk", "async" or "gather"
    width: int      # bytes per copy instruction (bulk 16; gather the element size)
    smem: int       # dynamic shared memory per block, bytes
    stage2: bool = True  # K1's second stage (K2: off)


def padded_frames(n: int, R: int) -> int:
    """Row length (floats) of a phase-major buffer of R rows of n frames:
    n rounded up to 32/R mod 32 (R a power of two up to 32), so that a warp's
    32 consecutive samples (R rows by 32/R frames) fall in 32 banks; odd
    otherwise."""
    target = (BANKS // R) % BANKS if R <= BANKS and R & (R - 1) == 0 else 1
    return n + (target - n) % BANKS


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def stage_bytes(chunk: int, form: str, elt: int) -> int:
    """One ring buffer: the chunk's bytes plus 16 of slack for the async
    path's rounding, per plane (two planes unless ``pair``)."""
    if form == "pair":
        return _round16(2 * chunk * elt + 16)
    return 2 * _round16(chunk * elt + 16)


def stage2_batch(q2: int) -> int:
    """Chunks a stage-2 pass takes: enough outputs for every thread."""
    return THREADS // q2 if q2 < THREADS else 1


def smem_bytes(R1: int, J0: int, R2: int, J2: int, q2: int, stages: int, form: str,
               elt: int, stage2: bool = True) -> int:
    """Dynamic shared memory of one block (csrc/frontend.cuh Layout): the
    stages' mbarriers, the ring, the taps (each stage's rounded to 16 bytes),
    the power reduction, the mixed window and, with ``stage2``, the stage-1
    outputs (two planes each, padded rows)."""
    nf = padded_frames(J0 + q2 * R2, R1)
    taps = -(-(J0 + 1) * R1 // 4) * 4  # rows 16-byte aligned
    floats = taps + THREADS // 32 + 2 * R1 * nf
    if stage2:
        nf2 = padded_frames(J2 + stage2_batch(q2) * q2, R2)
        floats += -(-(J2 + 1) * R2 // 4) * 4 + 2 * R2 * nf2
    return _round16(8 * stages) + stages * stage_bytes(q2 * R1 * R2, form, elt) + 4 * floats


def byte_alignment(*values: int) -> int:
    """The largest power of two up to 16 that divides every value."""
    a = 16
    for v in values:
        while v % a:
            a //= 2
    return a


def input_form(xr: torch.Tensor, xi: torch.Tensor) -> tuple[str, int]:
    """(form, alignment) of (rows, T) planes xr/xi with equal strides: the
    form, and the byte alignment that every row's start shares (1 for
    ``gather``, whose copies are per element)."""
    elt = xr.element_size()
    rows_differ = xr.shape[0] > 1 and xr.stride(0) != 0
    if xr.stride(1) == 2 and xi.data_ptr() == xr.data_ptr() + elt:
        addrs = [xr.data_ptr()]
        form = "pair"
    elif xr.stride(1) == 1:
        addrs = [xr.data_ptr(), xi.data_ptr()]
        form = "planes"
    else:
        return "gather", 1
    if rows_differ:
        addrs.append(xr.stride(0) * elt)
    return form, byte_alignment(*addrs)


def least_outputs(J0: int, R2: int, J2: int) -> int:
    """The fewest final-rate outputs a chunk may hold: J2 (the prologue's
    stage-1 frames fit the window) and J0 mixed frames (each history moves
    forward without overlap)."""
    return max(1, J2, -(-J0 // R2))


def chunk_outputs(M2: int, D: int, J0: int, R2: int, J2: int, chunk: int | None = None) -> int:
    """Final-rate outputs per chunk: about ``chunk`` raw samples (default
    TARGET_CHUNK), at least ``least_outputs``, at most the block's M2."""
    q2 = max(least_outputs(J0, R2, J2), (TARGET_CHUNK if chunk is None else int(chunk)) // D)
    return min(q2, M2)


def copy_path(form: str, elt: int, align: int, chunk_bytes: int, last_bytes: int):
    """(copy, width) for chunks of ``chunk_bytes`` (the last ``last_bytes``)
    whose row starts share ``align``."""
    if form == "gather":
        return "gather", elt
    a = byte_alignment(align, chunk_bytes, last_bytes)
    if a >= 16:
        return "bulk", 16
    return "async", max(4, a)


def plan(C: int, T: int, R1: int, J0: int, R2: int, J2: int, *, elt: int, form: str,
         align: int, resident, stages: int = STAGES, strips: int | None = None,
         chunk: int | None = None, stage2: bool = True) -> FrontendPlan:
    """The launch's plan. ``resident(smem)`` gives the blocks the card keeps
    resident at that dynamic shared memory; ``strips`` per channel default to
    resident // C (at least one chunk a strip), ``chunk`` (raw samples) to
    TARGET_CHUNK, halved while the layout exceeds SMEM_LIMIT. ``stage2``
    off is K2's single-stage shape (R2 = 1, J2 = 0)."""
    if form not in FORMS:
        raise ValueError(f"input form must be one of {FORMS}, got {form!r}")
    if not stage2 and (R2, J2) != (1, 0):
        raise ValueError(f"the single-stage plan takes R2 = 1, J2 = 0, got {R2}, {J2}")
    D = R1 * R2
    if T % D or T < J2 * D + J0 * R1 or T < D:
        raise ValueError(f"block length {T} must be a multiple of {D} and hold the "
                         f"{J2 * D + J0 * R1}-sample halo")
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    M2 = T // D
    q2 = chunk_outputs(M2, D, J0, R2, J2, chunk)
    while smem_bytes(R1, J0, R2, J2, q2, stages, form, elt, stage2) > SMEM_LIMIT:
        if q2 // 2 < least_outputs(J0, R2, J2):
            raise ValueError("fused front end: filter history too long for shared memory")
        q2 //= 2
    smem = smem_bytes(R1, J0, R2, J2, q2, stages, form, elt, stage2)
    chunks = -(-M2 // q2)
    if strips is None:
        strips = max(1, min(chunks, int(resident(smem)) // C))
    if not 1 <= strips <= chunks:
        raise ValueError(f"strips must be in 1..{chunks}, got {strips}")
    per_strip = -(-chunks // strips)
    strips = -(-chunks // per_strip)
    bps = elt * (1 if form == "planes" else 2)  # copied bytes per sample and copy
    copy, width = copy_path(form, elt, align, q2 * D * bps, (T - (chunks - 1) * q2 * D) * bps)
    return FrontendPlan(q2, q2 * D, chunks, per_strip, strips, stages,
                        stage2_batch(q2) if stage2 else 1, form, copy, width, smem, stage2)


def copy_range(addr: int, nbytes: int, width: int) -> tuple[int, int, int]:
    """(first byte, byte count, shift) one async copy moves for ``nbytes`` at
    ``addr``: the range rounded out to ``width``, the data ``shift`` bytes
    into it."""
    a0 = addr - addr % width
    a1 = -(-(addr + nbytes) // width) * width
    return a0, a1 - a0, addr - a0


def _bytes(x: torch.Tensor, a0: int, nbytes: int) -> np.ndarray:
    """``nbytes`` of ``x``'s storage from address ``a0``; zeros past the
    storage's end (the 2-byte case's rounding reaches at most 2 bytes past
    it, inside the last aligned word)."""
    storage = torch.empty(0, dtype=torch.uint8).set_(x.untyped_storage()).numpy()
    lo = a0 - x.untyped_storage().data_ptr()
    buf = np.zeros(nbytes, np.uint8)
    got = storage[lo:lo + nbytes]
    buf[:got.size] = got
    return buf


def _staged(p: FrontendPlan, xr, xi, row: int, n0: int, n: int):
    """Samples [n0, n0 + n) of the planes' row as the kernel's consumer reads
    them from a ring buffer: for the async path, the bytes its copies moved
    (the range ``copy_range`` rounds out, one range for ``pair``, one a plane
    for ``planes``), then every element at the shift plus its index times the
    sample step. Returns float32 (re, im)."""
    if p.copy != "async":
        return xr[row, n0:n0 + n].to(torch.float32), xi[row, n0:n0 + n].to(torch.float32)
    elt = xr.element_size()
    dtype = np.dtype(str(xr.dtype).replace("torch.", ""))

    def addr(x):
        return x.data_ptr() + (row * x.stride(0) + n0 * x.stride(1)) * elt

    def view(buf, offset, step):
        vals = np.ndarray((n,), dtype=dtype, buffer=buf, offset=offset, strides=(step,))
        return torch.from_numpy(vals.astype(np.float32))

    if p.form == "pair":
        a0, nbytes, shift = copy_range(addr(xr), 2 * n * elt, p.width)
        buf = _bytes(xr, a0, nbytes)
        return view(buf, shift, 2 * elt), view(buf, shift + elt, 2 * elt)
    out = []
    for x in (xr, xi):
        a0, nbytes, shift = copy_range(addr(x), n * elt, p.width)
        out.append(view(_bytes(x, a0, nbytes), shift, elt))
    return tuple(out)


def _raw(p, xr, xi, tail, c_rows, a: int, b: int, staged: bool):
    """Raw samples [a, b) of every channel as (C, b - a) float32 re/im: the
    tail below 0, the planes (through the ring when ``staged``), 0 at T and
    beyond."""
    C, T = tail.shape[0], xr.shape[1]
    Hc = tail.shape[1]
    re = torch.zeros((C, b - a), dtype=torch.float32)
    im = torch.zeros((C, b - a), dtype=torch.float32)
    lo, hi = max(a, 0), min(b, T)
    if a < 0:
        t = tail[:, Hc + a:Hc + min(b, 0)]
        re[:, :t.shape[1]], im[:, :t.shape[1]] = t.real, t.imag
    if hi > lo:
        for c in range(C):
            if staged:
                re[c, lo - a:hi - a], im[c, lo - a:hi - a] = _staged(p, xr, xi, c_rows[c], lo,
                                                                      hi - lo)
            else:
                re[c, lo - a:hi - a] = xr[c_rows[c], lo:hi].to(torch.float32)
                im[c, lo - a:hi - a] = xi[c_rows[c], lo:hi].to(torch.float32)
    return re, im


def mix_exact(re, im, cos, sin) -> torch.Tensor:
    """(re + j im) (cos + j sin) as a complex64 tensor, each product and sum
    a separate elementwise op, rounded once: the same bits on the CPU and on
    the card, wherever an element sits in its tensor (PyTorch's complex
    product on the CPU fuses a multiply-add in the elements its vectorized
    loop leaves over, and so rounds by position). K2's kernel mixes so."""
    return torch.complex(re * cos - im * sin, re * sin + im * cos)


def _mix(re, im, acc, words, a: int) -> tuple[torch.Tensor, torch.Tensor]:
    osc = dds_oscillator(acc, words, torch.arange(a, a + re.shape[1], dtype=torch.int64))
    return re * osc.real - im * osc.imag, re * osc.imag + im * osc.real


def _stage(win_r, win_i, w):
    """sum_{j, p} w[j, p] win[i + j, p] over windows of the (C, frames, R)
    phase-major planes: (C, frames - J) outputs."""
    J = w.shape[0] - 1
    if win_r.shape[1] <= J:  # no whole window (single stage's empty prologue)
        empty = win_r.new_zeros((win_r.shape[0], 0))
        return empty, empty
    ur = win_r.unfold(1, J + 1, 1)  # (C, n, R, J + 1)
    ui = win_i.unfold(1, J + 1, 1)
    return torch.einsum("cnpj,jp->cn", ur, w), torch.einsum("cnpj,jp->cn", ui, w)


def execute(p: FrontendPlan, w1: torch.Tensor, w2: torch.Tensor, xr, xi, tail, acc, words):
    """The kernel's schedule in plain PyTorch on the CPU: strip by strip,
    chunk by chunk, the mixed and stage-1 histories carried from chunk to
    chunk and filled by a prologue at each strip's start, stage 2 once a
    batch of chunks. w1 (J0+1, R1) and
    w2 (J2+1, R2) are the padded polyphase taps; xr/xi (C or 1, T), tail
    (C, Hc) complex64. Returns (y (C, M2) complex64, power (C,) float32, the
    sum of the per-strip partials in strip order)."""
    J0, R1 = w1.shape[0] - 1, w1.shape[1]
    J2, R2 = w2.shape[0] - 1, w2.shape[1]
    C, T, D = words.shape[0], xr.shape[1], R1 * R2
    M2, Hc = T // D, J2 * D + J0 * R1
    if tuple(tail.shape) != (C, Hc):
        raise ValueError(f"tail must be ({C}, {Hc})")
    rows = [0 if xr.shape[0] == 1 else c for c in range(C)]
    y = torch.zeros((C, M2), dtype=torch.complex64)
    partials = []
    for s in range(p.strips):
        k0, k1 = s * p.per_strip, min(p.chunks, (s + 1) * p.per_strip)
        n0 = k0 * p.chunk
        # prologue: the history mixed, and stage 1 over its last J2*R2 frames
        re, im = _raw(p, xr, xi, tail, rows, n0 - Hc, n0, staged=False)
        mr, mi = _mix(re, im, acc, words, n0 - Hc)
        hr, hi = mr.reshape(C, -1, R1), mi.reshape(C, -1, R1)
        s1r, s1i = _stage(hr, hi, w1)
        s1r, s1i = s1r.reshape(C, J2, R2), s1i.reshape(C, J2, R2)
        hr, hi = hr[:, hr.shape[1] - J0:], hi[:, hi.shape[1] - J0:]
        pw = torch.zeros(C, dtype=torch.float32)
        filled = 0  # chunks whose stage-1 outputs wait for stage 2
        for k in range(k0, k1):
            a = k * p.chunk
            re, im = _raw(p, xr, xi, tail, rows, a, a + p.chunk, staged=True)
            pw = pw + (re * re + im * im).sum(dim=1)
            mr, mi = _mix(re, im, acc, words, a)
            wr = torch.cat([hr, mr.reshape(C, -1, R1)], dim=1)
            wi = torch.cat([hi, mi.reshape(C, -1, R1)], dim=1)
            o1r, o1i = _stage(wr, wi, w1)  # (C, q2 R2)
            hr, hi = wr[:, wr.shape[1] - J0:], wi[:, wi.shape[1] - J0:]
            s1r = torch.cat([s1r, o1r.reshape(C, -1, R2)], dim=1)
            s1i = torch.cat([s1i, o1i.reshape(C, -1, R2)], dim=1)
            filled += 1
            if filled < p.batch and k < k1 - 1:
                continue
            o2r, o2i = _stage(s1r, s1i, w2)  # (C, filled q2)
            s1r, s1i = s1r[:, s1r.shape[1] - J2:], s1i[:, s1i.shape[1] - J2:]
            q0 = (k + 1 - filled) * p.q2
            q1 = min(M2, q0 + filled * p.q2)
            y[:, q0:q1] = torch.complex(o2r[:, :q1 - q0], o2i[:, :q1 - q0])
            filled = 0
        partials.append(pw)
    power = partials[0]
    for pw in partials[1:]:
        power = power + pw
    return y, power


SINGLE_VARIANTS = ("full", "no_osc", "osc_only", "copy_only")  # execute_single's K8 variants
NO_OSC = (0.6, 0.8)  # K8 no_osc's constant oscillator (cos, sin)


def _mixed(variant: str, re, im, acc, words, a: int) -> torch.Tensor:
    """The window samples K2 (or a K8 variant) stores for raw samples [a, a +
    n): the mixed input, the input times the constant oscillator, the
    oscillator, or the input."""
    if variant == "copy_only":
        return torch.complex(re, im)
    if variant == "no_osc":
        return mix_exact(re, im, *(torch.tensor(v, dtype=torch.float32) for v in NO_OSC))
    osc = dds_oscillator(acc, words, torch.arange(a, a + re.shape[1], dtype=torch.int64))
    if variant == "osc_only":
        return osc
    return mix_exact(re, im, osc.real, osc.imag)


def execute_single(p: FrontendPlan, w: torch.Tensor, xr, xi, tail, acc, words,
                   variant: str = "full"):
    """K2's schedule (``stage2`` off) in plain PyTorch on the CPU: strip by
    strip, chunk by chunk, the last J0 mixed frames carried from chunk to
    chunk and filled by a prologue from the raw samples before each strip
    (the tail below 0). A chunk's q outputs come from its window of J0 + q
    frames: the strided conv1d of the plain version over it (``full``,
    ``no_osc``), or the sum of frame i (``osc_only``) or i + J0
    (``copy_only``). w (J0+1, R) are the padded polyphase taps; xr/xi (C or
    1, T), tail (C, J0 R) complex64. Returns (y (C, T/R) complex64, power
    (C,) float32, the sum of the per-strip partials in strip order)."""
    if p.stage2:
        raise ValueError("execute_single runs the single-stage plan (stage2 off)")
    if variant not in SINGLE_VARIANTS:
        raise ValueError(f"variant must be one of {SINGLE_VARIANTS}, got {variant!r}")
    J0, R = w.shape[0] - 1, w.shape[1]
    C, T = words.shape[0], xr.shape[1]
    M, H = T // R, J0 * R
    if tuple(tail.shape) != (C, H):
        raise ValueError(f"tail must be ({C}, {H})")
    weight = w.reshape(1, 1, -1).expand(2, 1, -1).contiguous()
    rows = [0 if xr.shape[0] == 1 else c for c in range(C)]
    y = torch.zeros((C, M), dtype=torch.complex64)
    partials = []
    for s in range(p.strips):
        k0, k1 = s * p.per_strip, min(p.chunks, (s + 1) * p.per_strip)
        n0 = k0 * p.chunk
        re, im = _raw(p, xr, xi, tail, rows, n0 - H, n0, staged=False)  # the prologue
        hist = _mixed(variant, re, im, acc, words, n0 - H)  # (C, J0 R): J0 frames
        pw = torch.zeros(C, dtype=torch.float32)
        for k in range(k0, k1):
            a = k * p.chunk
            re, im = _raw(p, xr, xi, tail, rows, a, a + p.chunk, staged=True)
            pw = pw + (re * re + im * im).sum(dim=1)
            win = torch.cat([hist, _mixed(variant, re, im, acc, words, a)], dim=1)
            if variant == "osc_only":
                out = win[:, :p.chunk].reshape(C, p.q2, R).sum(dim=-1)
            elif variant == "copy_only":
                out = win[:, H:].reshape(C, p.q2, R).sum(dim=-1)
            else:
                out = conv_planes(win, weight, R)
            hist = win[:, win.shape[1] - H:]
            q1 = min(M, (k + 1) * p.q2)
            y[:, k * p.q2:q1] = out[:, :q1 - k * p.q2]
        partials.append(pw)
    power = partials[0]
    for pw in partials[1:]:
        power = power + pw
    return y, power


def describe(p: FrontendPlan) -> str:
    """One line: strips, chunks, stages, copy path."""
    return (f"{p.strips} strips x {p.per_strip} chunks of {p.chunk} samples (q2 {p.q2}, "
            f"{p.chunks} a channel), {p.stages} stages, "
            f"{f'stage 2 every {p.batch}' if p.stage2 else 'one stage'}, "
            f"{p.form} {p.copy}"
            f"{'' if p.copy == 'bulk' else f' {p.width} B'}, {p.smem} B shared")

