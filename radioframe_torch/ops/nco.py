"""NCO / complex mixer — int32 Q0.32 DDS phase accumulator, batched over
channels (counterpart of ``radioframe/ops/nco.py``).

The accumulator wraps modulo 2**32 exactly like DDS hardware. Torch int32
overflow is not relied on (CUDA does not promise to wrap): phase products are
formed in int64 and wrapped explicitly by ``wrap_i32``.

Layout: x is (channels, time) complex64; freq words (channels,) int32.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi
_SCALE = np.float32(2.0 ** -32)
_GROUP = 128  # oscillator factorization group size


def freq_word(freq_hz, fs) -> np.ndarray:
    """Host-side: frequency (Hz) -> int32 DDS increment (Q0.32 turns/sample).

    Same function as the reference's ``freq_word``, restated here because
    the reference module imports JAX."""
    cycles = np.asarray(freq_hz, dtype=np.float64) / fs
    word = np.round((cycles - np.round(cycles)) * 2.0 ** 32)
    return word.astype(np.int64).astype(np.int32)  # wrap into int32


def word_to_freq(word, fs) -> np.ndarray:
    """Host-side: int32 DDS increment -> frequency (Hz), the inverse of
    ``freq_word`` up to its rounding."""
    return np.asarray(word, dtype=np.float64) * fs / 2.0 ** 32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor, reduced modulo 2**32 (two's complement)."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def init_state(num_channels: int, device) -> torch.Tensor:
    """Phase accumulator (turns, Q0.32), one per channel."""
    return torch.zeros((num_channels,), dtype=torch.int32, device=device)


def _cis(ang: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _osc(word, base_acc, T: int, sign: float) -> torch.Tensor:
    """e^{sign*j*2π*(base + word*n)/2^32} for n in [0, T), (C, T) complex64.

    Factorized as in the reference: osc[m*K + k] = e(base + word*K*m) *
    e(word*k), T/K + K transcendentals per channel instead of T; the direct
    form when K does not divide T."""
    C = int(torch.broadcast_shapes(word.shape, base_acc.shape)[0])
    K = _GROUP
    s = float(np.float32(sign) * _SCALE * np.float32(TWO_PI))
    w = word.to(torch.int64).expand(C)
    b = base_acc.to(torch.int64).expand(C)
    dev = word.device
    if T % K != 0 or T < 2 * K:
        n = torch.arange(T, dtype=torch.int64, device=dev)
        return _cis(wrap_i32(b[:, None] + w[:, None] * n).to(torch.float32) * s)
    M = T // K
    m = torch.arange(M, dtype=torch.int64, device=dev)
    k = torch.arange(K, dtype=torch.int64, device=dev)
    coarse = wrap_i32(b[:, None] + (w * K)[:, None] * m).to(torch.float32) * s
    fine = wrap_i32(w[:, None] * k).to(torch.float32) * s
    return (_cis(coarse)[:, :, None] * _cis(fine)[:, None, :]).reshape(C, T)


def _advance(phase_acc, word, T: int) -> torch.Tensor:
    return wrap_i32(phase_acc.to(torch.int64) + word.to(torch.int64) * T)


def mix_down(x, word, phase_acc):
    """y = x * e^{-j phase}; returns (y, new_phase_acc).

    ``word`` per channel; a signal at +f Hz (word=freq_word(f, fs)) lands at DC.
    """
    T = x.shape[-1]
    return x * _osc(word, phase_acc, T, -1.0).to(x.dtype), _advance(phase_acc, word, T)


def mix_up(x, word, phase_acc):
    """y = x * e^{+j phase} (DUC direction); returns (y, new_phase_acc)."""
    T = x.shape[-1]
    return x * _osc(word, phase_acc, T, 1.0).to(x.dtype), _advance(phase_acc, word, T)


def _base_at(word, phase_acc, sample_offset) -> torch.Tensor:
    """The accumulator at ``sample_offset`` samples into the stream (int32 wrap)."""
    return wrap_i32(phase_acc.to(torch.int64) + word.to(torch.int64) * int(sample_offset))


def mix_down_at(x, word, phase_acc, sample_offset: int):
    """mix_down evaluated at a sample offset into the stream.

    Used by time-sharded chains: shard d computes its oscillator segment
    locally from the replicated phase state, with no communication and
    exact (int32 wrap) agreement with the unsharded chain. Does NOT advance
    the accumulator; the caller advances it once by the global block length.
    """
    T = x.shape[-1]
    return x * _osc(word, _base_at(word, phase_acc, sample_offset), T, -1.0).to(x.dtype)


def mix_up_at(x, word, phase_acc, sample_offset: int):
    """mix_up at a sample offset (see mix_down_at)."""
    T = x.shape[-1]
    return x * _osc(word, _base_at(word, phase_acc, sample_offset), T, 1.0).to(x.dtype)
