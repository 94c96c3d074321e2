"""ctypes bindings for the native ingest runtime (native/ingest_ring.cpp).

Builds the shared library on first use (g++ -O2 -shared) and exposes a
Pythonic `IngestRing`.  The native ring is the host-side producer/
consumer seam between an I/Q source thread (USB/TCP/replay feeder) and
the device-step loop — the reference's SPSC input ring
(include/dsd-neo/runtime/input_ring.h) rebuilt for block framing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRCS = [os.path.join(_HERE, "native", "ingest_ring.cpp"),
         os.path.join(_HERE, "native", "audio_codec.cpp")]


def _so_path() -> str:
    """The library's path, named by a hash of its committed sources:
    a binary built from other sources (a stale copy) is never loaded."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_HERE, "native",
                        f"libdsdneo_ingest-{h.hexdigest()[:16]}.so")


_lib = None
_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the native library if needed; returns the .so path."""
    so = _so_path()
    if force or not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-o", tmp] + _SRCS,
            check=True)
        os.replace(tmp, so)          # concurrent builders: last one wins
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.dsd_ring_create.restype = ctypes.c_void_p
        lib.dsd_ring_create.argtypes = [ctypes.c_size_t]
        lib.dsd_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.dsd_ring_write.restype = ctypes.c_size_t
        lib.dsd_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_size_t]
        lib.dsd_ring_read.restype = ctypes.c_size_t
        lib.dsd_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_size_t, ctypes.c_int]
        lib.dsd_ring_read_widen_cu8.restype = ctypes.c_size_t
        lib.dsd_ring_read_widen_cu8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int]
        lib.dsd_ring_purge.argtypes = [ctypes.c_void_p]
        lib.dsd_ring_shutdown.argtypes = [ctypes.c_void_p]
        lib.dsd_ring_drops.restype = ctypes.c_uint64
        lib.dsd_ring_drops.argtypes = [ctypes.c_void_p]
        lib.dsd_ring_fill.restype = ctypes.c_size_t
        lib.dsd_ring_fill.argtypes = [ctypes.c_void_p]
        lib.dsd_ring_generation.restype = ctypes.c_uint32
        lib.dsd_ring_generation.argtypes = [ctypes.c_void_p]
        lib.dsd_set_ftz_daz.restype = ctypes.c_int
        lib.dsd_set_ftz_daz.argtypes = [ctypes.c_int]
        lib.dsd_adpcm_decode.restype = None
        lib.dsd_adpcm_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return lib


def set_ftz_daz(enable: bool = True) -> bool:
    """DSD_NEO_FTZ_DAZ: flush-to-zero/denormals-are-zero on the calling
    thread (x86 MXCSR; returns False where unsupported)."""
    try:
        return bool(_load().dsd_set_ftz_daz(1 if enable else 0))
    except (OSError, subprocess.CalledProcessError, AttributeError):
        return False


def adpcm_decode(blob: "np.ndarray") -> "np.ndarray | None":
    """IMA ADPCM expansion (native/audio_codec.cpp): [S, T2] uint8
    packed 4-bit codes → [S, 2·T2] float32; None if the native library
    cannot be built (caller falls back to the NumPy decoder)."""
    try:
        lib = _load()
    except (OSError, subprocess.CalledProcessError):
        return None
    S, T2 = blob.shape
    out = np.empty((S, 2 * T2), dtype=np.float32)
    lib.dsd_adpcm_decode(blob.ctypes.data_as(ctypes.c_void_p), S, T2,
                         out.ctypes.data_as(ctypes.c_void_p))
    return out


class IngestRing:
    """SPSC byte ring with CU8→float block framing."""

    def __init__(self, capacity: int = 1 << 22):
        self._lib = _load()
        self._h = self._lib.dsd_ring_create(capacity)
        self._dangle = b""      # odd trailing byte held for next write

    def write(self, data: bytes | np.ndarray) -> int:
        """Producer side.  The ring carries CU8 sample pairs, but TCP
        sources deliver arbitrary chunk sizes — an odd byte is stashed
        here and prepended to the next write so the ring only ever
        sees whole samples (and a truncated write can only drop whole
        samples, never flipping I/Q byte parity)."""
        buf = bytes(data) if not isinstance(data, bytes) else data
        if self._dangle:
            buf = self._dangle + buf
            self._dangle = b""
        if len(buf) & 1:
            self._dangle = buf[-1:]
            buf = buf[:-1]
        if not buf:
            return 0
        return self._lib.dsd_ring_write(self._h, buf, len(buf))

    def read_block_cu8(self, n_samples: int, rotate: int = 0,
                       timeout_ms: int = 1000) -> np.ndarray | None:
        """Blocking read of one framed block → float32 [n, 2] I/Q planes;
        None on timeout/purge."""
        out = np.empty((n_samples, 2), dtype=np.float32)
        got = self._lib.dsd_ring_read_widen_cu8(
            self._h, out.ctypes.data_as(ctypes.c_void_p), n_samples,
            rotate, timeout_ms)
        if got < n_samples:
            return None
        return out

    def purge(self) -> None:
        self._lib.dsd_ring_purge(self._h)

    def shutdown(self) -> None:
        self._lib.dsd_ring_shutdown(self._h)

    @property
    def drops(self) -> int:
        return self._lib.dsd_ring_drops(self._h)

    @property
    def fill(self) -> int:
        return self._lib.dsd_ring_fill(self._h)

    @property
    def generation(self) -> int:
        return self._lib.dsd_ring_generation(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.dsd_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
