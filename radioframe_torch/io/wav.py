"""WAV read/write for IQ captures and demodulated audio.

Reference analog: SD-card WAV record/play (`[U:sd.c]` + FatFS, SURVEY.md
§2.2 #23). Convention: IQ captures are stereo WAV (L=I, R=Q), int16 PCM;
audio is mono int16. Pure stdlib ``wave`` + numpy — no extra deps.
"""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, data: np.ndarray, fs: float, scale: float | None = None):
    """data: real (T,) -> mono; complex (T,) -> stereo I/Q. int16 PCM."""
    data = np.asarray(data)
    if np.iscomplexobj(data):
        frames = np.stack([np.real(data), np.imag(data)], axis=-1)
    else:
        frames = data[:, None]
    if scale is None:
        peak = np.max(np.abs(frames)) or 1.0
        scale = 0.95 / peak
    pcm = np.clip(frames * scale * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(round(fs)))
        w.writeframes(pcm.tobytes())


def read_wav(path: str):
    """Returns (data, fs): complex64 for stereo (I/Q), float32 for mono."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        assert w.getsampwidth() == 2, "only 16-bit PCM supported"
        fs = float(w.getframerate())
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    x = raw.astype(np.float32) / 32767.0
    if nch == 2:
        x = x.reshape(-1, 2)
        return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64), fs
    return x, fs
