"""WSPR beacon encoder/decoder (counterpart of ``radioframe/ops/wspr.py``;
SURVEY.md §2.1 #15, reference `[U:wspr.c]`). Host numpy, copied as it is;
only the imports name this package.

The reference firmware transmits WSPR beacons (encode-only); we implement
both directions so the codec is closed under test (ROADMAP capability #1).

TABLE PROVENANCE (zero-egress build — no spec documents retrievable):
- VERIFIED-STRUCTURE (standard, high confidence): 50-bit message packing
  (28-bit callsign / 15-bit locator / 7-bit power), K=32 r=1/2 convolutional
  code with polynomials 0xF2D05351 / 0xE4613C47, bit-reversal interleaver,
  162 symbols of 4-FSK at 12000/8192 Hz tone spacing, symbol = sync + 2*data.
- PROVISIONAL: the 162-bit pseudo-random sync vector below is a deterministic
  stand-in (LFSR-generated), NOT the published WSPR sync vector. Swapping in
  the real vector is a pure data change (this constant); every test here is a
  round trip through our own encoder so nothing else depends on it.
  On-air interop is therefore NOT claimed until the vector is verified.

Signal layer: 4-FSK tone-energy extraction is a (symbols x samples) @
(samples x tones) matmul — MXU-shaped; the codec (conv encode / stack
decode) is host control-rate work per the CW/RTTY disposition (§2.1 #14).
"""

from __future__ import annotations

import numpy as np

# Runtime-discoverable interop status (VERDICT r1 #8): decodes round-trip
# against our own encoder, but on-air interop is NOT claimed until the
# items below are replaced with the published tables (data-only change).
INTEROP_PROVISIONAL = True
PROVISIONAL_ITEMS = ("162-bit sync vector",)

from radioframe_torch.ops import fec

POLYS = (0xF2D05351, 0xE4613C47)  # WSPR convolutional polynomials (K=32)
K = 32
N_MSG = 50
N_SYM = 162
FS = 12_000.0
SPS = 8192  # samples per symbol at FS
TONE_HZ = FS / SPS  # 1.4648 Hz spacing and symbol rate


def _lfsr_bits(n: int, seed: int = 0xACE1, taps: int = 0xB400) -> np.ndarray:
    reg, out = seed, []
    for _ in range(n):
        out.append(reg & 1)
        lsb = reg & 1
        reg >>= 1
        if lsb:
            reg ^= taps
    return np.asarray(out, dtype=np.uint8)


# PROVISIONAL stand-in for the published 162-bit WSPR sync vector (see header)
SYNC = _lfsr_bits(N_SYM)

# Verified-table drop-in (VERDICT r2 ask #5): radioframe_torch/data/
# wspr_tables.npz, schema in radioframe_torch/data/__init__.py — the published
# sync vector replaces the stand-in and the provisional flag clears.
from radioframe_torch import data as _data

_tables = _data.wspr_tables()
if _tables is not None:
    SYNC = _tables["sync"]
    INTEROP_PROVISIONAL = False
    PROVISIONAL_ITEMS = ()

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "


def _callsign_to_28(call: str) -> int:
    """Standard WSPR callsign packing: 6 chars, digit forced at position 3."""
    call = call.upper().strip()
    # right-align so the last digit lands at index 2 (e.g. 'K1ABC ' vs 'GM4XYZ')
    if len(call) < 3 or not any(c.isdigit() for c in call):
        raise ValueError(f"not a packable standard callsign: {call!r}")
    if not call[1].isdigit() and not (len(call) > 2 and call[2].isdigit()):
        raise ValueError(f"callsign digit must be 2nd or 3rd char: {call!r}")
    if call[1].isdigit() and not call[2].isdigit():
        call = " " + call  # shift so digit is 3rd
    call = call.ljust(6)[:6]
    v = _ALNUM.index(call[0])
    v = v * 36 + _ALNUM.index(call[1])  # alnum, no space
    v = v * 10 + int(call[2])
    for c in call[3:]:
        u = 26 if c == " " else ord(c) - ord("A")
        if not (0 <= u <= 26):
            raise ValueError(f"callsign suffix char {c!r} must be A-Z or space")
        v = v * 27 + u
    return v


def _callsign_from_28(v: int) -> str:
    suf = []
    for _ in range(3):
        v, u = divmod(v, 27)
        suf.append(" " if u == 26 else chr(ord("A") + u))
    v, d = divmod(v, 10)
    v, c2 = divmod(v, 36)
    c1 = v
    call = _ALNUM[c1] + _ALNUM[c2] + str(d) + "".join(reversed(suf))
    return call.strip()


def _grid_power_to_22(grid: str, power_dbm: int) -> int:
    grid = grid.upper()
    n1 = (179 - 10 * (ord(grid[0]) - ord("A")) - int(grid[2])) * 180 \
        + 10 * (ord(grid[1]) - ord("A")) + int(grid[3])
    return n1 * 128 + int(power_dbm) + 64


def _grid_power_from_22(m: int) -> tuple[str, int]:
    n1, rem = divmod(m, 128)
    power = rem - 64
    lat = n1 % 180
    lon = n1 // 180
    g2 = chr(ord("A") + lat // 10)
    g4 = str(lat % 10)
    g1 = chr(ord("A") + (179 - lon) // 10)
    g3 = str((179 - lon) % 10)
    return g1 + g2 + g3 + g4, power


def pack_message(callsign: str, grid: str, power_dbm: int) -> np.ndarray:
    """(callsign, 4-char grid, power dBm) -> 50 message bits (MSB first)."""
    n = _callsign_to_28(callsign)
    m = _grid_power_to_22(grid, power_dbm)
    bits = [(n >> (27 - i)) & 1 for i in range(28)]
    bits += [(m >> (21 - i)) & 1 for i in range(22)]
    return np.asarray(bits, dtype=np.uint8)


def unpack_message(bits: np.ndarray) -> tuple[str, str, int]:
    bits = np.asarray(bits, dtype=np.uint8)
    n = int("".join(map(str, bits[:28])), 2)
    m = int("".join(map(str, bits[28:50])), 2)
    grid, power = _grid_power_from_22(m)
    return _callsign_from_28(n), grid, power


def _interleave_map() -> np.ndarray:
    """dest[i] = bit-reversed 8-bit addresses < 162, in order."""
    rev = [int(f"{i:08b}"[::-1], 2) for i in range(256)]
    dest = [r for r in rev if r < N_SYM]
    return np.asarray(dest, dtype=np.int64)


_ILEAVE = _interleave_map()


def encode_symbols(callsign: str, grid: str, power_dbm: int) -> np.ndarray:
    """Message -> 162 channel symbols in {0,1,2,3} (sync + 2*data)."""
    msg = pack_message(callsign, grid, power_dbm)
    padded = np.concatenate([msg, np.zeros(K - 1, np.uint8)])
    coded = fec.conv_encode(padded, POLYS, K)  # (162,)
    inter = np.zeros(N_SYM, np.uint8)
    inter[_ILEAVE] = coded
    return (SYNC + 2 * inter).astype(np.uint8)


def modulate(symbols: np.ndarray, fs: float = FS, f0: float = 1500.0,
             sps: int | None = None) -> np.ndarray:
    """Symbols -> continuous-phase real 4-FSK audio at fs."""
    sps = int(round(fs / TONE_HZ)) if sps is None else sps
    freqs = f0 + (np.asarray(symbols, np.float64) - 1.5) * TONE_HZ
    inst = np.repeat(freqs, sps)
    phase = 2.0 * np.pi * np.cumsum(inst) / fs
    return np.sin(phase)


def symbol_energies(audio: np.ndarray, fs: float = FS, f0: float = 1500.0,
                    start: int = 0, sps: int | None = None) -> np.ndarray:
    """(162, 4) tone energies — (symbols x samples) @ (samples x tones)."""
    sps = int(round(fs / TONE_HZ)) if sps is None else sps
    seg = audio[start:start + N_SYM * sps]
    if len(seg) < N_SYM * sps:
        seg = np.pad(seg, (0, N_SYM * sps - len(seg)))
    frames = seg.reshape(N_SYM, sps)
    t = np.arange(sps) / fs
    tones = f0 + (np.arange(4) - 1.5) * TONE_HZ
    basis = np.exp(-2j * np.pi * tones[None, :] * t[:, None])  # (sps, 4)
    corr = frames @ basis
    return np.abs(corr) ** 2


def sync_metric(energies: np.ndarray) -> float:
    """How well the (PROVISIONAL) sync vector explains the tone energies."""
    e = energies / (energies.sum(axis=-1, keepdims=True) + 1e-12)
    on = e[np.arange(N_SYM), SYNC] + e[np.arange(N_SYM), SYNC + 2]
    return float(on.mean())


def decode(audio: np.ndarray, fs: float = FS, f0: float = 1500.0,
           search_offsets: int = 8, sps: int | None = None):
    """Audio -> (callsign, grid, power) or None. Coarse timing search only
    (±search_offsets half-symbol steps); frequency assumed within a bin."""
    sps_i = int(round(fs / TONE_HZ)) if sps is None else sps
    best, best_m = 0, -1.0
    for k in range(search_offsets + 1):
        for s in {max(0, k * sps_i // 2)}:
            if s + N_SYM * sps_i > len(audio) + N_SYM * sps_i:  # allow pad
                continue
            m = sync_metric(symbol_energies(audio, fs, f0, s, sps_i))
            if m > best_m:
                best_m, best = m, s
    e = symbol_energies(audio, fs, f0, best, sps_i)
    # data bit d: tone = SYNC + 2d. positive llr = coded bit 0 likelier.
    scale = 4.0 / (np.mean(e) + 1e-12)
    llr_sym = (e[np.arange(N_SYM), SYNC] - e[np.arange(N_SYM), SYNC + 2]) * scale
    # _ILEAVE maps coded-bit index -> symbol position; deinterleave by gather
    coded_llr = llr_sym[_ILEAVE]
    msg = fec.conv_stack_decode(coded_llr, POLYS, N_MSG, K)
    if msg is None:
        return None
    try:
        return unpack_message(msg)
    except (ValueError, IndexError):
        return None
