"""Forward error correction for the digital modes (counterpart of
``radioframe/ops/fec.py``).

The LDPC min-sum decoder is a dense masked program on torch tensors, on the
caller's device: checks x variables as a (rows, cols) tensor, batched over
messages or channels. The code constructions, the encoders, the
convolutional code and the CRC are host numpy, copied from the reference as
they are (``tests/test_torch_digital_modes.py`` holds them equal).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from radioframe_torch.device import pin_precision

# ---------------------------------------------------------------------------
# LDPC: staircase (IRA-style) construction + encode (host), min-sum BP (torch)
# ---------------------------------------------------------------------------


def ldpc_staircase(n_msg: int, n_par: int, col_weight: int = 3, seed: int = 1) -> np.ndarray:
    """Deterministic LDPC-staircase parity-check matrix H = [A | T].

    A is (n_par, n_msg) sparse with ``col_weight`` ones per message column
    (rows balanced); T is the dual-diagonal accumulator, so encoding is a
    prefix-XOR (see :func:`ldpc_encode`). This is a standard IRA/"staircase"
    construction (RFC 5170 family) — used here as a well-defined, reproducible
    code for the FT8-class channel; see ft8.py header for table provenance.
    """
    rng = np.random.default_rng(seed)
    A = np.zeros((n_par, n_msg), dtype=np.uint8)
    fill = np.zeros(n_par, dtype=np.int64)
    for c in range(n_msg):
        # choose the col_weight least-filled rows (ties broken randomly)
        order = np.lexsort((rng.random(n_par), fill))
        rows = order[:col_weight]
        A[rows, c] = 1
        fill[rows] += 1
    T = np.eye(n_par, dtype=np.uint8)
    T[np.arange(1, n_par), np.arange(n_par - 1)] = 1
    return np.concatenate([A, T], axis=1)


def ldpc_encode(H: np.ndarray, msg: np.ndarray) -> np.ndarray:
    """Encode message bits (..., n_msg) -> codeword (..., n_msg+n_par).

    Requires H = [A | T] with T dual-diagonal (staircase): parity is the
    running XOR of A @ m.
    """
    msg = np.asarray(msg, dtype=np.uint8)
    n_par = H.shape[0]
    n_msg = H.shape[1] - n_par
    assert msg.shape[-1] == n_msg
    A = H[:, :n_msg]
    s = (msg @ A.T) & 1  # (..., n_par)
    parity = np.bitwise_xor.accumulate(s, axis=-1)
    return np.concatenate([msg, parity], axis=-1)


def gf2_inv(M: np.ndarray) -> np.ndarray:
    """Inverse of a square GF(2) matrix via Gauss-Jordan (raises if singular)."""
    M = np.asarray(M, dtype=np.uint8)
    n = M.shape[0]
    assert M.shape == (n, n)
    A = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(A[col:, col]))
        if A[piv, col] == 0:
            raise ValueError("matrix is singular over GF(2)")
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        rows = np.nonzero(A[:, col])[0]
        rows = rows[rows != col]
        A[rows] ^= A[col]
    return A[:, n:]


def ldpc_encode_general(H: np.ndarray, msg: np.ndarray,
                        hp_inv: np.ndarray | None = None) -> np.ndarray:
    """Encode against an ARBITRARY systematic-layout H = [H_m | H_p]
    (parity columns last, H_p invertible): solve H_p p = H_m m over GF(2).

    Used when a real (non-staircase) parity matrix is loaded from
    radioframe_torch/data/ — e.g. the published FT8 LDPC(174,91) table. Pass a
    precomputed ``hp_inv = gf2_inv(H[:, n_msg:])`` to amortize the solve.
    """
    msg = np.asarray(msg, dtype=np.uint8)
    n_par = H.shape[0]
    n_msg = H.shape[1] - n_par
    assert msg.shape[-1] == n_msg
    if hp_inv is None:
        hp_inv = gf2_inv(H[:, n_msg:])
    s = (msg @ H[:, :n_msg].T) & 1
    parity = (s @ hp_inv.T) & 1
    return np.concatenate([msg, parity], axis=-1).astype(np.uint8)


def ldpc_check(H: np.ndarray, cw: np.ndarray) -> np.ndarray:
    """Syndrome == 0 per codeword (..., n) -> bool (...)."""
    return (((np.asarray(cw, np.uint8) @ H.T) & 1) == 0).all(axis=-1)


def ldpc_decode_minsum(H: np.ndarray, llr: torch.Tensor, iters: int = 30,
                       scale: float = 0.75):
    """Batched normalized min-sum LDPC decode on ``llr``'s device.

    llr: (..., n) float32 tensor, positive = bit 0 likelier.
    Returns (hard_bits (..., n) int8, ok (...,) bool).

    Edge messages are a dense (..., rows, n) tensor masked by H; the sign
    products and each row's two smallest magnitudes are plain reductions,
    batched over the leading axes. The reference's tie rules hold: the
    first minimum of a row is the one excluded, and sign(0) counts as +1.
    """
    pin_precision()  # the syndrome's 0/1 product must not round through TF32
    llr = llr.to(torch.float32)
    dev = llr.device
    Hm = torch.as_tensor(np.asarray(H), dtype=torch.float32, device=dev)  # (R, n) 0/1
    mask = Hm > 0
    R, n = Hm.shape
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    # check->var messages; zero off the mask, so their sum over the rows
    # needs no product with H
    c2v = torch.zeros(llr.shape[:-1] + (R, n), dtype=torch.float32, device=dev)
    for _ in range(iters):
        v2c = (llr + c2v.sum(dim=-2)).unsqueeze(-2) - c2v
        v2c = torch.where(mask, v2c, zero)
        mag = torch.where(mask, v2c.abs(), big)
        m1 = mag.amin(dim=-1, keepdim=True)
        arg1 = mag.argmin(dim=-1, keepdim=True)  # the first minimum
        m2 = mag.scatter(-1, arg1, 1e9).amin(dim=-1, keepdim=True)
        mins = torch.where(mag == m1, m2, m1)  # each edge's min over the others
        sgn = torch.where(mask, torch.sign(v2c) + (v2c == 0).to(torch.float32), one)
        row_sgn = sgn.prod(dim=-1, keepdim=True)
        c2v = torch.where(mask, scale * (row_sgn * sgn) * mins, zero)
    total = llr + c2v.sum(dim=-2)
    hard = (total < 0).to(torch.int8)
    syndrome = torch.matmul(hard.to(torch.float32), Hm.T)  # exact 0/1 counts
    ok = (torch.remainder(syndrome, 2.0) < 0.5).all(dim=-1)
    return hard, ok


# ---------------------------------------------------------------------------
# Convolutional code (WSPR: K=32, r=1/2) — host-side encode + stack decode
# ---------------------------------------------------------------------------


def conv_encode(bits: np.ndarray, polys: tuple[int, int], K: int = 32) -> np.ndarray:
    """Non-recursive r=1/2 convolutional encode, MSB-first shift register.

    bits: (N,) 0/1 including any zero tail. Returns (2N,) coded bits,
    poly0 bit then poly1 bit per input bit (the WSPR ordering).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    reg = 0
    out = np.empty(2 * len(bits), dtype=np.uint8)
    maskreg = (1 << K) - 1
    for i, b in enumerate(bits):
        reg = ((reg << 1) | int(b)) & maskreg
        out[2 * i] = bin(reg & polys[0]).count("1") & 1
        out[2 * i + 1] = bin(reg & polys[1]).count("1") & 1
    return out


def conv_stack_decode(llr: np.ndarray, polys: tuple[int, int], n_msg: int,
                      K: int = 32, max_nodes: int = 200_000) -> np.ndarray | None:
    """Stack (Zigangirov–Jelinek) sequential decoder for large-K conv codes.

    llr: (2*(n_msg+K-1),) soft bits, positive = coded bit 0 likelier.
    Returns (n_msg,) decoded bits or None if the search budget is exhausted.
    K=32 makes Viterbi's 2^31 states impossible — sequential decoding is the
    standard approach for WSPR-class codes.
    """
    llr = np.asarray(llr, dtype=np.float64)
    n_tot = n_msg + K - 1  # message + zero tail
    assert llr.shape[0] == 2 * n_tot
    # Fano-like metric: log p(bit|obs) - bias per coded bit
    p1 = 1.0 / (1.0 + np.exp(np.clip(llr, -50, 50)))  # P(coded bit = 1)
    p = np.stack([1.0 - p1, p1], axis=-1)  # (2n, 2)
    logp = np.log(np.maximum(p, 1e-12)) + np.log(2.0) - 0.35  # bias keeps metric drift ~0 on correct path
    maskreg = (1 << K) - 1
    pop = [bin(x).count("1") & 1 for x in range(1 << 16)]

    def parity(x: int) -> int:
        return pop[x & 0xFFFF] ^ pop[(x >> 16) & 0xFFFF]

    # heap of (-metric, depth, reg, path_int)
    heap = [(-0.0, 0, 0, 0)]
    nodes = 0
    best_at_depth: dict[tuple[int, int], float] = {}
    while heap and nodes < max_nodes:
        negm, depth, reg, path = heapq.heappop(heap)
        metric = -negm
        nodes += 1
        if depth == n_tot:
            bits = [(path >> (n_tot - 1 - i)) & 1 for i in range(n_tot)]
            return np.asarray(bits[:n_msg], dtype=np.uint8)
        choices = (0, 1) if depth < n_msg else (0,)  # zero tail is known
        for b in choices:
            nreg = ((reg << 1) | b) & maskreg
            c0 = parity(nreg & polys[0])
            c1 = parity(nreg & polys[1])
            m = metric + logp[2 * depth, c0] + logp[2 * depth + 1, c1]
            key = (depth + 1, nreg & 0xFFFFF)
            if best_at_depth.get(key, -1e18) >= m:
                continue
            best_at_depth[key] = m
            heapq.heappush(heap, (-m, depth + 1, nreg, (path << 1) | b))
    return None


# ---------------------------------------------------------------------------
# CRC (generic MSB-first, for FT8's CRC-14)
# ---------------------------------------------------------------------------


def crc_msb(bits: np.ndarray, poly: int, width: int) -> int:
    """MSB-first CRC over a bit array (no reflection, zero init/xorout)."""
    reg = 0
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for b in np.asarray(bits, dtype=np.uint8):
        reg ^= int(b) << (width - 1)
        reg = ((reg << 1) ^ (poly if reg & top else 0)) & mask
    return reg
