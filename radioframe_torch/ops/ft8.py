"""FT8 digital mode (counterpart of ``radioframe/ops/ft8.py``): pack,
encode and modulate on the host; tone energies, sync and soft bits as torch
tensors on the caller's device; LDPC decode by the batched min-sum of
``ops/fec.py``, so thousands of FT8 channels decode in lockstep.

TABLE PROVENANCE (the reference's; no spec documents were retrievable):
- VERIFIED-STRUCTURE (standard FT8 framing, high confidence): 79 symbols of
  8-FSK at 6.25 Hz spacing / 0.16 s, 7-symbol Costas sync [3,1,4,0,6,5,2] at
  positions 0/36/72, 58 data symbols x 3 bits = 174 coded bits, 77-bit
  message + 14-bit CRC = 91 info bits, Gray tone mapping.
- PROVISIONAL (isolated as data; on-air interop NOT claimed until verified):
  * the LDPC(174,91) parity matrix: H here is a deterministic
    LDPC-staircase code of the same rate (fec.ldpc_staircase, seed pinned).
  * CRC-14 polynomial (0x2757) and its padding convention.
  * the exact 77-bit field packing offsets for message type 1.
  All round-trip/channel tests go through our own encoder, so swapping in
  verified tables (``radioframe_torch/data/``) is a data change that cannot
  break the machinery.

The host half (constants, ``H``, packing, ``crc14``, ``encode_symbols``,
``modulate``, ``tone_basis``) is the reference's, copied as it is
(``tests/test_torch_digital_modes.py`` holds it equal).
"""

from __future__ import annotations

import numpy as np

# Runtime-discoverable interop status (VERDICT r1 #8): decodes round-trip
# against our own encoder, but on-air interop is NOT claimed until the
# items below are replaced with the published tables (data-only change).
INTEROP_PROVISIONAL = True
PROVISIONAL_ITEMS = ("LDPC(174,91) parity matrix", "CRC-14 polynomial/padding", "77-bit packing offsets")

import torch

from radioframe_torch.device import resolve
from radioframe_torch.ops import fec

COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], dtype=np.int64)
GRAY = np.array([0, 1, 3, 2, 5, 6, 4, 7], dtype=np.int64)  # 3-bit value -> tone
GRAY_INV = np.argsort(GRAY)
N_SYM = 79
N_DATA_SYM = 58
N_MSG = 77
N_CRC = 14
N_INFO = N_MSG + N_CRC  # 91
N_CODED = 174
CRC_POLY = 0x2757  # PROVISIONAL (see header)
FS = 12_000.0
SPS = 1920  # 0.16 s at 12 kHz
TONE_HZ = 6.25

# Deterministic stand-in LDPC(174,91) — staircase construction (see header)
H = fec.ldpc_staircase(N_INFO, N_CODED - N_INFO, col_weight=3, seed=174091)
_HP_INV = None  # set iff a real (non-staircase) H is loaded below

# Verified-table drop-in (VERDICT r2 ask #5): when radioframe_torch/data/
# ft8_tables.npz exists (schema in radioframe_torch/data/__init__.py), the
# published tables replace the stand-ins and the provisional flag clears —
# a pure data commit, validated at import (shape + GF(2) invertibility).
from radioframe_torch import data as _data

_tables = _data.ft8_tables()
if _tables is not None:
    H = _tables["ldpc_h"]
    _HP_INV = _tables["hp_inv"]
    CRC_POLY = _tables["crc_poly"]
    # the npz supplies LDPC H + CRC only (radioframe_torch/data schema); the 77-bit
    # packing offsets stay provisional until independent KAT vectors land too
    # (ft8_kats.npz)
    import os as _os

    PROVISIONAL_ITEMS = tuple(
        () if _os.path.exists(_data.path("ft8_kats.npz"))
        else ("77-bit packing offsets",))
    INTEROP_PROVISIONAL = bool(PROVISIONAL_ITEMS)

_DATA_POS = np.asarray([i for i in range(N_SYM) if not (i < 7 or 36 <= i < 43 or i >= 72)])
_SYNC_POS = np.asarray([i for i in range(N_SYM) if (i < 7 or 36 <= i < 43 or i >= 72)])


# ---------------------------------------------------------------------------
# Message packing (type 1: two standard callsigns + grid)
# ---------------------------------------------------------------------------

_A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"   # 37
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"    # 36
_A3 = "0123456789"                              # 10
_A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"             # 27
NTOKENS = 2063592
MAX22 = 4194304


def _std_call_to_idx(call: str) -> int:
    """Standard callsign -> base index in [0, 37*36*10*27^3)."""
    call = call.upper().strip()
    if len(call) < 3 or not any(c.isdigit() for c in call):
        raise ValueError(f"not a standard callsign: {call!r}")
    if call[1].isdigit() and not call[2].isdigit():
        call = " " + call
    call = call.ljust(6)[:6]
    v = _A1.index(call[0])
    v = v * 36 + _A2.index(call[1])
    v = v * 10 + _A3.index(call[2])
    for c in call[3:]:
        v = v * 27 + _A4.index(c)
    return v


def _std_call_from_idx(v: int) -> str:
    suf = []
    for _ in range(3):
        v, u = divmod(v, 27)
        suf.append(_A4[u])
    v, d = divmod(v, 10)
    v, c2 = divmod(v, 36)
    return (_A1[v] + _A2[c2] + _A3[d] + "".join(reversed(suf))).strip()


def _c28(call: str) -> int:
    """28-bit callsign field: CQ/QRZ/DE tokens or standard callsign."""
    call = call.upper().strip()
    tokens = {"DE": 0, "QRZ": 1, "CQ": 2}
    if call in tokens:
        return tokens[call]
    return NTOKENS + MAX22 + _std_call_to_idx(call)


def _c28_inv(v: int) -> str:
    for name, tok in (("DE", 0), ("QRZ", 1), ("CQ", 2)):
        if v == tok:
            return name
    return _std_call_from_idx(v - NTOKENS - MAX22)


def _g15(grid: str) -> int:
    """15-bit grid field for a 4-char Maidenhead locator (or 'RRR' etc. unused)."""
    grid = grid.upper().strip()
    if len(grid) != 4:
        raise ValueError(f"need 4-char grid, got {grid!r}")
    j = (ord(grid[0]) - ord("A")) * 18 + (ord(grid[1]) - ord("A"))
    return j * 100 + int(grid[2]) * 10 + int(grid[3])


def _g15_inv(v: int) -> str:
    j, mn = divmod(v, 100)
    a, b = divmod(j, 18)
    return chr(ord("A") + a) + chr(ord("A") + b) + str(mn // 10) + str(mn % 10)


def pack_message(call_to: str, call_de: str, grid: str) -> np.ndarray:
    """Type-1 message -> 77 bits: c28 r1 c28 r1 R1 g15 i3 (i3=1)."""
    fields = [(_c28(call_to), 28), (0, 1), (_c28(call_de), 28), (0, 1),
              (0, 1), (_g15(grid), 15), (1, 3)]
    bits = []
    for v, w in fields:
        bits += [(v >> (w - 1 - i)) & 1 for i in range(w)]
    assert len(bits) == N_MSG
    return np.asarray(bits, dtype=np.uint8)


def unpack_message(bits: np.ndarray) -> tuple[str, str, str]:
    bits = np.asarray(bits, dtype=np.uint8)
    def take(off, w):
        return int("".join(map(str, bits[off:off + w])), 2)
    i3 = take(74, 3)
    if i3 != 1:
        raise ValueError(f"unsupported message type i3={i3}")
    return (_c28_inv(take(0, 28)), _c28_inv(take(29, 28)), _g15_inv(take(59, 15)))


# ---------------------------------------------------------------------------
# Encode: 77 bits -> CRC -> LDPC -> 79 symbols; modulate
# ---------------------------------------------------------------------------


def crc14(msg_bits: np.ndarray) -> int:
    """CRC-14 over the 77 message bits zero-padded to 82 (PROVISIONAL conv.)."""
    padded = np.concatenate([np.asarray(msg_bits, np.uint8), np.zeros(5, np.uint8)])
    return fec.crc_msb(padded, CRC_POLY, N_CRC)


def encode_symbols(call_to: str, call_de: str, grid: str) -> np.ndarray:
    msg = pack_message(call_to, call_de, grid)
    c = crc14(msg)
    crc_bits = np.asarray([(c >> (N_CRC - 1 - i)) & 1 for i in range(N_CRC)], np.uint8)
    info = np.concatenate([msg, crc_bits])  # 91
    # staircase H encodes by prefix-XOR; a loaded real H by GF(2) solve
    cw = (fec.ldpc_encode_general(H, info, _HP_INV) if _HP_INV is not None
          else fec.ldpc_encode(H, info))  # 174
    tones = np.zeros(N_SYM, dtype=np.int64)
    tones[_SYNC_POS] = np.tile(COSTAS, 3)
    vals = cw.reshape(N_DATA_SYM, 3) @ np.array([4, 2, 1])
    tones[_DATA_POS] = GRAY[vals]
    return tones


def modulate(tones: np.ndarray, fs: float = FS, f0: float = 1000.0,
             sps: int | None = None) -> np.ndarray:
    """Tones -> continuous-phase real 8-FSK audio (hard FSK; GFSK optional)."""
    sps = SPS if sps is None else sps
    freqs = f0 + np.asarray(tones, np.float64) * TONE_HZ
    inst = np.repeat(freqs, sps)
    phase = 2.0 * np.pi * np.cumsum(inst) / fs
    return np.sin(phase)


# ---------------------------------------------------------------------------
# Decode: tone energies (torch matmul) -> sync -> LLR -> LDPC (torch) -> unpack
# ---------------------------------------------------------------------------


def tone_basis(fs: float = FS, f0: float = 1000.0, sps: int = SPS) -> np.ndarray:
    """(sps, 8) conjugate oscillator bank for tone correlation."""
    t = np.arange(sps) / fs
    tones = f0 + np.arange(8) * TONE_HZ
    return np.exp(-2j * np.pi * tones[None, :] * t[:, None]).astype(np.complex64)


def _on(x, device) -> torch.Tensor:
    """``x`` (numpy or torch) as a tensor on ``device``; None keeps a tensor
    where it is (a numpy array needs a device: none is chosen for it)."""
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise TypeError("a numpy input needs device= (no device is chosen implicitly)")
        return x
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=resolve(device))


def symbol_energies(audio, basis, start: int = 0, sps: int = SPS, *, device=None):
    """(..., T) audio -> (..., 79, 8) float32 tone energies, on ``device``
    (default: ``audio``'s, when it is a tensor).

    Accepts real audio (a receiver's demodulated channel) or complex
    analytic baseband (a channelizer output, e.g. the FT8 skimmer path);
    the complex projection keeps the full +3 dB of the analytic signal. The
    projection is a float32 product (TF32 pinned off)."""
    audio = _on(audio, device)
    dev = audio.device
    seg = audio[..., start : start + N_SYM * sps]
    frames = seg.reshape(seg.shape[:-1] + (N_SYM, sps))
    b = np.asarray(basis)
    br = torch.as_tensor(np.ascontiguousarray(b.real, np.float32), device=dev)
    bi = torch.as_tensor(np.ascontiguousarray(b.imag, np.float32), device=dev)
    if frames.is_complex():
        fr = frames.real.to(torch.float32)
        fi = frames.imag.to(torch.float32)
        cr = torch.matmul(fr, br) - torch.matmul(fi, bi)
        ci = torch.matmul(fr, bi) + torch.matmul(fi, br)
    else:
        frames = frames.to(torch.float32)
        cr = torch.matmul(frames, br)
        ci = torch.matmul(frames, bi)
    return cr * cr + ci * ci


def sync_metric(energies: torch.Tensor) -> torch.Tensor:
    """(..., 79, 8) -> (...): the Costas positions' energy fraction."""
    e = energies / (energies.sum(dim=-1, keepdim=True) + 1e-12)
    dev = energies.device
    pos = torch.as_tensor(_SYNC_POS, device=dev)
    tones = torch.as_tensor(np.tile(COSTAS, 3), device=dev)
    return e[..., pos, tones].mean(dim=-1)


def soft_bits(energies: torch.Tensor) -> torch.Tensor:
    """(..., 79, 8) energies -> (..., 174) LLRs (positive = bit 0, max-log)."""
    dev = energies.device
    e = torch.log(energies[..., torch.as_tensor(_DATA_POS, device=dev), :] + 1e-12)
    # reindex tones -> 3-bit values: value v was sent on tone GRAY[v], so
    # E_val[..., v] = e[..., GRAY[v]] (gather by GRAY, not its inverse)
    e = e[..., torch.as_tensor(GRAY, device=dev)]
    vals = np.arange(8)
    llrs = []
    for bit in (2, 1, 0):  # MSB first
        zero = e[..., torch.as_tensor(np.flatnonzero((vals >> bit) & 1 == 0), device=dev)]
        one = e[..., torch.as_tensor(np.flatnonzero((vals >> bit) & 1 == 1), device=dev)]
        llrs.append(zero.amax(dim=-1) - one.amax(dim=-1))
    llr = torch.stack(llrs, dim=-1)  # (..., 58, 3)
    return llr.reshape(llr.shape[:-2] + (N_CODED,))


def decode_llrs(llr: torch.Tensor, iters: int = 40):
    """(..., 174) LLRs -> (info_bits (..., 91) int8, crc_ok (...,) bool) via
    min-sum, on ``llr``'s device."""
    hard, ok = fec.ldpc_decode_minsum(H, llr, iters=iters)
    return hard[..., :N_INFO], ok


def decode(audio, fs: float = FS, f0: float = 1000.0, start: int = 0,
           sps: int = SPS, *, device=None):
    """Single-channel convenience: audio -> (call_to, call_de, grid) or None."""
    basis = tone_basis(fs, f0, sps)
    e = symbol_energies(audio, basis, start, sps, device=device)
    info, ok = decode_llrs(soft_bits(e))
    info = info.cpu().numpy()
    if not bool(ok):
        return None
    msg, crc_bits = info[:N_MSG], info[N_MSG:]
    c = int("".join(map(str, crc_bits)), 2)
    if c != crc14(msg):
        return None
    try:
        return unpack_message(msg)
    except (ValueError, IndexError):
        return None


def sync_search(audio, fs: float = FS, f0: float = 1000.0, sps: int = SPS,
                time_steps: int = 8, freq_steps: int = 5,
                freq_step_hz: float = TONE_HZ / 2, *, device=None):
    """Coarse (start, f0, metric) search maximizing the Costas metric over
    ``time_steps`` half-symbol offsets and ``freq_steps`` tone-basis shifts."""
    audio = _on(audio, device)
    best = (0, f0, -1.0)
    for df in (np.arange(freq_steps) - freq_steps // 2) * freq_step_hz:
        basis = tone_basis(fs, f0 + df, sps)
        for k in range(time_steps):
            s = k * sps // 2
            if s + N_SYM * sps > audio.shape[-1]:
                continue
            m = float(sync_metric(symbol_energies(audio, basis, s, sps)))
            if m > best[2]:
                best = (s, f0 + df, m)
    return best
