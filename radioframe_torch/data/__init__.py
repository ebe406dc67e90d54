"""Optional verified interop tables (counterpart of ``radioframe/data/__init__.py``).

The FT8/WSPR machinery ships with deterministic PROVISIONAL stand-ins for a
few published constants (see ops/ft8.py and ops/wspr.py headers). When the
real tables are checked in HERE as npz files, everything flips
automatically: the ops load them at import and `INTEROP_PROVISIONAL` goes
False. The reference package reads its own copy of the same files from
``radioframe/data/``: a table drop-in goes into both directories.

File schemas (all little-endian npz), the reference's:

ft8_tables.npz
    ldpc_h   (83, 174) uint8 — the published FT8 LDPC(174,91) parity-check
             matrix, systematic column order [91 message | 83 parity] with
             H_p invertible over GF(2) (fec.ldpc_encode_general handles the
             non-staircase structure).
    crc_poly () uint32 — the 14-bit CRC polynomial (no implicit top bit),
             MSB-first convention as in ops/ft8.crc14.

wspr_tables.npz
    sync     (162,) uint8 — the published WSPR pseudo-random sync vector.

ft8_kats.npz (known-answer vectors from an independent reference encoder;
its presence clears FT8's last provisional item, the 77-bit packing):
    call_to, call_de, grid (N,) unicode; tones (N, 79) uint8
"""

from __future__ import annotations

import os

import numpy as np

_DIR = os.path.dirname(__file__)


def path(name: str) -> str:
    return os.path.join(_DIR, name)


def load_npz(name: str) -> dict | None:
    """Load ``radioframe_torch/data/<name>.npz`` -> dict of arrays, or None."""
    p = path(name + ".npz")
    if not os.path.exists(p):
        return None
    with np.load(p, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def ft8_tables() -> dict | None:
    """Validated FT8 tables or None (shape/invertibility checked so a
    malformed drop-in fails loudly at import, not silently mid-decode)."""
    t = load_npz("ft8_tables")
    if t is None:
        return None
    from radioframe_torch.ops.fec import gf2_inv

    H = np.asarray(t["ldpc_h"], dtype=np.uint8)
    if H.shape != (83, 174):  # raise (not assert): must survive python -O
        raise ValueError(f"ldpc_h shape {H.shape} != (83, 174)")
    t["ldpc_h"] = H
    t["hp_inv"] = gf2_inv(H[:, 91:])  # raises if parity part singular
    t["crc_poly"] = int(t["crc_poly"])
    if not 0 < t["crc_poly"] < (1 << 14):
        raise ValueError(f"crc_poly {t['crc_poly']:#x} not a 14-bit polynomial")
    return t


def wspr_tables() -> dict | None:
    t = load_npz("wspr_tables")
    if t is None:
        return None
    sync = np.asarray(t["sync"], dtype=np.uint8)
    if sync.shape != (162,) or not set(np.unique(sync)) <= {0, 1}:
        raise ValueError("wspr sync must be a (162,) binary vector")
    t["sync"] = sync
    return t
