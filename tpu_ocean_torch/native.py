"""The asynchronous field exporter, a ctypes binding of
``native/exporter.cpp``, and the build of the native stream client
``native/stream_client.cpp``.

JAX counterpart: the exporter half of ``tpu_ocean/native.py``. Submissions
are copied into a bounded ring and written to ``.npy`` files (float64,
``<name>_<step:08d>.npy``) by a worker thread, so file IO stays off the
step loop. The port compiles ``exporter.cpp`` alone with the host's
``g++`` (``-O3 -fPIC -std=c++17 -pthread -shared``) into
``build/tpu_ocean_torch_native/<hash>/`` (a directory ``.gitignore``
lists), keyed by a hash of the source and the flags, at the first
exporter it makes; nothing builds at import. A failed build raises with
the compiler's output. ``stream_client()`` builds the framework-free C++
consumer of the ``tpu-ocean/1`` frame stream the same way (g++
``CLIENT_FLAGS``, the same hash and directory) and returns the
executable's path; ``native/Makefile`` is not used.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ._build import cached_library

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "exporter.cpp"
BUILD_ROOT = _ROOT / "build" / "tpu_ocean_torch_native"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
LIB_NAME = "libtpu_ocean_exporter.so"
CLIENT_SOURCE = _ROOT / "native" / "stream_client.cpp"
CLIENT_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra")
CLIENT_NAME = "tpu_ocean_stream_client"


def _gxx(source: Path, flags, out: Path) -> str:
    """g++ ``source`` into ``out``; returns the compiler's output."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the port builds {source.name} "
                           f"on first use")
    cmd = [gxx, *flags, str(source), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{source.name}: build failed ({proc.returncode})"
                           f":\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


@functools.cache
def stream_client() -> Path:
    """Build (once per source hash) the native stream client; its path.
    Run it as ``<path> <host> <port> <frames> [lod] [dtype]``."""
    path, _ = cached_library(
        BUILD_ROOT, [CLIENT_SOURCE], CLIENT_FLAGS, CLIENT_NAME,
        lambda tmp: _gxx(CLIENT_SOURCE, CLIENT_FLAGS, tmp / CLIENT_NAME))
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the exporter library."""
    lib_path, _ = cached_library(
        BUILD_ROOT, [SOURCE], FLAGS, LIB_NAME,
        lambda tmp: _gxx(SOURCE, FLAGS, tmp / LIB_NAME))
    lib = ctypes.CDLL(str(lib_path))
    d = ctypes.POINTER(ctypes.c_double)
    lib.exporter_create.restype = ctypes.c_void_p
    lib.exporter_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.exporter_submit.restype = ctypes.c_int32
    lib.exporter_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64, d, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.exporter_pending.restype = ctypes.c_int64
    lib.exporter_pending.argtypes = [ctypes.c_void_p]
    lib.exporter_flush.restype = None
    lib.exporter_flush.argtypes = [ctypes.c_void_p]
    lib.exporter_destroy.restype = None
    lib.exporter_destroy.argtypes = [ctypes.c_void_p]
    lib.exporter_errors.restype = ctypes.c_int64
    lib.exporter_errors.argtypes = [ctypes.c_void_p]
    return lib


class AsyncExporter:
    """Non-blocking .npy snapshot writer backed by the native worker
    thread; arrays are written as float64."""

    def __init__(self, directory: str, capacity_bytes: int = 256 << 20):
        self._lib = load()
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.exporter_create(directory.encode(), capacity_bytes)

    def submit(self, name: str, step: int, array) -> bool:
        """Queue one array (a tensor on any device, or an array) for
        writing; returns False if the ring is full."""
        if hasattr(array, "detach"):
            array = array.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(array), dtype=np.float64)
        dims = (ctypes.c_int64 * a.ndim)(*a.shape)
        return bool(self._lib.exporter_submit(
            self._h, name.encode(), step,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.ndim, dims))

    def pending(self) -> int:
        return int(self._lib.exporter_pending(self._h))

    def flush(self) -> None:
        """Block until every accepted submission is written."""
        self._lib.exporter_flush(self._h)

    def errors(self) -> int:
        """Failed opens, short writes, renames and truncated paths since
        creation: after flush(), 0 means every accepted submission is a
        complete .npy on disk."""
        return int(self._lib.exporter_errors(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.exporter_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
