"""ctypes bindings for the native IQ transport (counterpart of
``radioframe/native/``), with a numpy fallback.

``iqtransport.c`` (a byte-equal copy of the reference's) is compiled with
``cc -O3 -shared -fPIC`` at first use into ``build/native/`` at the
checkout root (git-ignored), keyed by a hash of the source and the flags as
``kernels/_build.py`` keys the CUDA kernels; nothing is written into the
package. Importing this module builds nothing: the first conversion, ring
buffer or read of ``HAVE_NATIVE`` does. Without a C compiler, or if the
build fails, pure-numpy equivalents keep everything working and
``HAVE_NATIVE`` is False.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "iqtransport.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CC_FLAGS = ("-O3", "-shared", "-fPIC")


def _build() -> Path | None:
    """The shared object for this source, compiled if it is not there yet."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"iqtransport-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SRC)],
                               capture_output=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
            return out
    return None


@functools.cache
def _load():
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.iq_i16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.iq_i16_to_f32.restype = None
    lib.iq_f32_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.iq_f32_to_i16.restype = None
    lib.iq_i16_deinterleave.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int64]
    lib.iq_i16_deinterleave.restype = None
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_destroy.restype = None
    lib.rb_capacity.restype = ctypes.c_uint64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_fill.restype = ctypes.c_uint64
    lib.rb_fill.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_uint64
    lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_uint64
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    return lib


def __getattr__(name: str):
    # HAVE_NATIVE is computed on first read, so that importing builds nothing
    if name == "HAVE_NATIVE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _even_i16(pcm) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    if pcm.size % 2:
        raise ValueError(f"interleaved I/Q needs an even number of int16 words, not {pcm.size}")
    return pcm


def iq_i16_to_c64(pcm: np.ndarray, scale: float = 1.0 / 32767.0) -> np.ndarray:
    """Interleaved int16 I/Q -> complex64 (the capture-ingest hot loop)."""
    pcm = _even_i16(pcm)
    out = np.empty(pcm.size, dtype=np.float32)
    lib = _load()
    if lib is not None:
        lib.iq_i16_to_f32(pcm.ctypes.data, out.ctypes.data, pcm.size, np.float32(scale))
    else:
        np.multiply(pcm, np.float32(scale), out=out, casting="unsafe")
    return out.view(np.complex64)


def c64_to_iq_i16(iq: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """complex64 -> interleaved int16 I/Q with saturation (DAC direction)."""
    flat = np.ascontiguousarray(iq, dtype=np.complex64).view(np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(flat.size, dtype=np.int16)
        lib.iq_f32_to_i16(flat.ctypes.data, out.ctypes.data, flat.size, np.float32(scale))
        return out
    return np.clip(flat * np.float32(scale), -32768, 32767).astype(np.int16)


def iq_i16_deinterleave(pcm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved int16 I/Q -> (xr, xi) int16 planes: the int16-ingest
    path (RxConfig.int16_ingest), whose front-end kernel converts to float
    itself, so the host moves half the bytes and never converts."""
    pcm = _even_i16(pcm)
    n = pcm.size // 2
    xr = np.empty(n, dtype=np.int16)
    xi = np.empty(n, dtype=np.int16)
    lib = _load()
    if lib is not None:
        lib.iq_i16_deinterleave(pcm.ctypes.data, xr.ctypes.data, xi.ctypes.data, n)
    else:
        xr[:] = pcm[0::2]
        xi[:] = pcm[1::2]
    return xr, xi


class RingBuffer:
    """Lock-free single-producer single-consumer ring buffer over the native
    implementation (a locked bytearray in the numpy fallback)."""

    def __init__(self, capacity_bytes: int):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.rb_create(capacity_bytes)
            if not self._h:
                raise MemoryError(f"rb_create({capacity_bytes}) failed")
            self.capacity = lib.rb_capacity(self._h)
        else:
            import threading

            cap = 1
            while cap < capacity_bytes:
                cap <<= 1
            self.capacity = cap
            self._buf = bytearray()
            self._lock = threading.Lock()

    def write(self, arr: np.ndarray) -> bool:
        """Append all of ``arr``'s bytes, or nothing (False) if they do not fit."""
        data = np.ascontiguousarray(arr)
        n = data.nbytes
        if self._lib is not None:
            return bool(self._lib.rb_write(self._h, data.ctypes.data, n))
        with self._lock:
            if len(self._buf) + n > self.capacity:
                return False
            self._buf.extend(data.tobytes())
            return True

    def read(self, n_bytes: int, dtype=np.complex64) -> np.ndarray | None:
        """Pop exactly ``n_bytes`` as ``dtype``, or None if fewer are there."""
        out = np.empty(n_bytes // np.dtype(dtype).itemsize, dtype=dtype)
        if self._lib is not None:
            got = self._lib.rb_read(self._h, out.ctypes.data, n_bytes)
            return out if got else None
        with self._lock:
            if len(self._buf) < n_bytes:
                return None
            out = np.frombuffer(bytes(self._buf[:n_bytes]), dtype=dtype).copy()
            del self._buf[:n_bytes]
            return out

    @property
    def fill(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_fill(self._h))
        return len(self._buf)

    def close(self) -> None:
        """Free the native ring (also done when the object is collected)."""
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
