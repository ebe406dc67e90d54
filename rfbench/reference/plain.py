"""The operations that both plain references share, in plain PyTorch.

Each works in the precision it is given: ``F64`` computes in float64 and
complex128, the reference proper; ``TF32`` is the control, the precision
below the configuration's float32 with TF32 off: float32 with every stage's
inputs, coefficients and outputs rounded to TF32's 10-bit mantissa (the
FFTs run in float32 between rounded inputs and outputs, integer phase words
stay integers). The recursions are written in closed
form (a running max in the log domain, a triangular Toeplitz product), not as
a loop over samples, so a block takes milliseconds on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

SSB, CW, AM, NFM, LSB, SAM = 0, 1, 2, 3, 4, 5
DC_POLE = 0.995       # the AM DC block's pole
AGC_EPS = 1e-9        # the AGC's floor under the envelope
TWO32 = 2 ** 32


class Precision:
    """How a reference computes: ``real``/``cplx`` dtypes and ``r``, the
    rounding applied at each stage boundary."""

    def __init__(self, name: str, real: torch.dtype, cplx: torch.dtype, round_fn=None):
        self.name, self.real, self.cplx, self._round = name, real, cplx, round_fn

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in this precision, rounded for the control."""
        if t.is_complex():
            t = t.to(self.cplx)
            if self._round is not None:
                t = torch.complex(self._round(t.real), self._round(t.imag))
            return t
        t = t.to(self.real)
        return t if self._round is None else self._round(t)

    def __repr__(self) -> str:
        return self.name


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties to even)
    through its bits: add half of the 13 dropped bits (less one on an even
    kept bit) and clear them."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


F64 = Precision("float64", torch.float64, torch.complex128)
TF32 = Precision("tfloat32", torch.float32, torch.complex64, tf32_round)


def f32(x: float) -> float:
    """A constant as the configuration stores it, in float32."""
    return float(np.float32(x))


def freq_word(freq_hz, fs: float) -> np.ndarray:
    """Frequency -> DDS increment in Q0.32 turns a sample, as an int64 in
    [0, 2**32) (the rounding of a hardware DDS tuning word)."""
    cycles = np.asarray(freq_hz, dtype=np.float64) / fs
    word = np.round((cycles - np.round(cycles)) * 2.0 ** 32).astype(np.int64)
    return word % TWO32


def advance(acc0, word, samples: int) -> np.ndarray:
    """A DDS accumulator after ``samples`` samples, modulo 2**32 (int64). The
    product wraps modulo 2**64 in uint64, which keeps it modulo 2**32."""
    w = np.asarray(word, np.int64).astype(np.uint64) % np.uint64(TWO32)
    prod = w * np.uint64(samples % TWO32)
    acc = np.asarray(acc0, np.int64).astype(np.uint64)
    return ((acc + prod % np.uint64(TWO32)) % np.uint64(TWO32)).astype(np.int64)


def phasor(acc: torch.Tensor, word: torch.Tensor, T: int, sign: float, p: Precision):
    """e^{sign j 2 pi (acc + word n) / 2**32} for n in [0, T), (C, T)."""
    n = torch.arange(T, dtype=torch.int64, device=acc.device)
    ph = torch.remainder(acc[:, None] + word[:, None] * n, TWO32)
    ang = ph.to(torch.float64 if p is F64 else torch.float32) * (2.0 * math.pi / TWO32)
    return p.r(torch.polar(torch.ones_like(ang), sign * ang))


def fir_decimate(tail: torch.Tensor, x: torch.Tensor, h: np.ndarray, R: int, p: Precision):
    """Causal y[n] = sum_k h[k] x[n - k] at n = 0, R, 2R, ... with the last
    L - 1 inputs of the stream in ``tail``: (y (C, T/R), new tail)."""
    L = len(h)
    T = x.shape[-1]
    xp = torch.cat([tail, x], dim=-1)
    hh = p.r(torch.as_tensor(h, device=x.device))
    y = torch.zeros((x.shape[0], T // R), dtype=p.cplx, device=x.device)
    for k in range(L):
        y = y + hh[k] * xp[:, L - 1 - k: L - 1 - k + T: R]
    return p.r(y), xp[:, xp.shape[-1] - (L - 1):]


@functools.lru_cache(maxsize=4)
def _decay_matrix(T: int, pole: float, device: str, dtype: torch.dtype) -> torch.Tensor:
    """(T, T) with [j, n] = pole^(n - j) for j <= n, else 0."""
    n = torch.arange(T, dtype=torch.float64, device=device)
    d = n[None, :] - n[:, None]
    return torch.where(d >= 0, pole ** torch.clamp_min(d, 0), 0.0).to(dtype)


def dc_block(state: torch.Tensor, x: torch.Tensor, p: Precision):
    """y[n] = x[n] - x[n-1] + pole y[n-1] over (C, T) real; state (2, C) =
    (last x, last y). Returns (y, new state)."""
    T = x.shape[-1]
    pole = f32(DC_POLE)
    b = p.r(x - torch.cat([state[0][:, None], x[:, :-1]], dim=-1))
    D = p.r(_decay_matrix(T, pole, str(x.device), p.real))
    carry = (pole ** torch.arange(1, T + 1, dtype=torch.float64, device=x.device)).to(p.real)
    y = p.r(b @ D + state[1][:, None] * carry[None, :])
    return y, torch.stack([x[:, -1], y[:, -1]])


def agc(env0: torch.Tensor, audio: torch.Tensor, release_s: float, fs: float, target: float,
        max_gain: float, p: Precision):
    """Instant attack, exponential release: env[n] = max(|a[n]|, d env[n-1])
    from env0, gain = min(max_gain, target / max(env, eps)). The per-sample
    decay d is taken at float32, as the configuration stores it: an envelope
    that decays over n samples raises its rounding n-fold. Returns (audio *
    gain, last env)."""
    T = audio.shape[-1]
    ld = math.log(f32(math.exp(-1.0 / (release_s * fs))))
    n = torch.arange(T, dtype=torch.float64, device=audio.device)
    mag = torch.abs(audio).to(torch.float64)
    lead = torch.cummax(torch.log(mag) - n * ld, dim=-1).values
    start = torch.log(env0.to(torch.float64)) + ld
    env = p.r(torch.exp(n * ld + torch.maximum(lead, start[:, None])))
    gain = p.r(torch.clamp_max(f32(target) / torch.clamp_min(env, f32(AGC_EPS)), f32(max_gain)))
    return p.r(audio * gain), env[:, -1]


def demod(state: dict, x: torch.Tensor, mode: torch.Tensor, cw_word: torch.Tensor, fs: float,
          deviation_hz: float, p: Precision):
    """The demod bank over (C, T) complex channels, each channel by its mode:
    SSB and LSB 2 Re x (after their filters), CW 2 Re(x e^{j bfo}), AM the
    DC-blocked |x|, NFM angle(x[n] conj x[n-1]) fs / (2 pi deviation).
    State: cw (C,) int64 BFO accumulator, am (2, C), nfm (C,) last sample."""
    T = x.shape[-1]
    m = mode[:, None]
    bfo = phasor(state["cw"], cw_word, T, 1.0, p)
    ssb = 2.0 * x.real
    cw = 2.0 * p.r(x * bfo).real
    am, am_state = dc_block(state["am"], p.r(torch.abs(x)), p)
    d = p.r(x * torch.conj(torch.cat([state["nfm"][:, None], x[:, :-1]], dim=-1)))
    nfm = torch.atan2(d.imag, d.real) * (fs / (2.0 * math.pi * deviation_hz))
    out = torch.where((m == SSB) | (m == LSB), ssb, torch.zeros_like(ssb))
    out = torch.where(m == CW, cw, out)
    out = torch.where(m == AM, am, out)
    out = torch.where(m == NFM, nfm, out)
    new = {"cw": torch.remainder(state["cw"] + cw_word * T, TWO32), "am": am_state,
           "nfm": x[:, -1]}
    return p.r(out), new


def agc_except_nfm(state: dict, audio: torch.Tensor, mode: torch.Tensor, agc_cfg: dict,
                   fs: float, p: Precision):
    """The AGC on every channel, its gain applied to all but NFM (FM audio is
    deviation-scaled and bypasses it). Updates state["env"]."""
    out, state["env"] = agc(state["env"], audio, agc_cfg["release_s"], fs, agc_cfg["target"],
                            agc_cfg["max_gain"], p)
    return torch.where((mode == NFM)[:, None], audio, out)


def demod_init(C: int, start_block: int, samples_per_block: int, cw_word: np.ndarray,
               device, p: Precision) -> dict:
    """The demod and AGC state at the start of block ``start_block``: the
    BFO accumulator worked out from the block count, the rest fresh."""
    return {"cw": torch.as_tensor(advance(0, cw_word, start_block * samples_per_block),
                                  device=device),
            "am": torch.zeros((2, C), dtype=p.real, device=device),
            "nfm": torch.ones((C,), dtype=p.cplx, device=device),
            "env": torch.zeros((C,), dtype=p.real, device=device)}
