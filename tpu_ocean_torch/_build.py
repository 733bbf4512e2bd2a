"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into a shared
library with a plain C interface, loaded with ``ctypes``. The library lives
under ``build/tpu_ocean_torch/<hash>/`` beside the package (a directory
``.gitignore`` lists), keyed by a hash of every file in ``csrc/`` that the
build reads (the ``.cu`` sources and the ``.cuh`` headers they include)
and of the flags, so a changed source or header rebuilds and an unchanged
tree loads at once. Nothing builds when the module is imported: the first
kernel launch calls ``load()``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tpu_ocean_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")
LIB_NAME = "libtpu_ocean_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the row-DFT and fused entries take (tier, split3) after their other ints;
# the fused ones take (packed, nch_live) before those, the transposed row
# entry its cluster size after them
_ROWS = [_P] * 5 + [_I] * 6 + [_P]
_FUSED = [_P] * 9 + [_I] * 10 + [_F] * 3 + [_P]
# (name, argtypes) of every C entry; each returns cudaGetLastError() as int
_SIGNATURES = {
    "tpu_fft_rows_transposed": [_P] * 5 + [_I] * 7 + [_P],
    "tpu_fft_rows_natural": _ROWS,
    "tpu_fft_rows_mixed": [_P] * 5 + [_I] * 7 + [_P] * 2,
    "tpu_fused_rows_transposed": _FUSED,
    "tpu_fused_rows_natural": _FUSED,
    "tpu_fields_stencil": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "tpu_fields_stencil_v1": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "tpu_gerstner_bank": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library with what its build reported."""
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an earlier build was reused
    build_log: str           # nvcc's output, ptxas register/smem report included

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry reported a CUDA error."""
        if err != 0:
            msg = self.lib.tpu_cuda_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "port's CUDA kernels are built from source on first use")


def _sources(csrc: Path = CSRC):
    """(the .cu files nvcc compiles, every file the build key hashes: those
    and the .cuh headers they include)."""
    compiled = sorted(csrc.glob("*.cu"))
    return compiled, sorted(compiled + list(csrc.glob("*.cuh")))


def _digest(files, flags=COMPILE_FLAGS + LINK_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def cached_library(root: Path, files, flags, lib_name: str, build):
    """The shared library ``root/<hash>/lib_name``, keyed by a hash of
    ``flags`` and of ``files`` (names and bytes). When it is not there,
    ``build(tmp)`` makes ``tmp/lib_name`` in a temporary directory and
    returns the compiler's output, kept beside the library as
    ``build.log``; the library is then renamed into place, so a
    concurrent loader sees either no library or a whole one. Returns
    (library path, seconds the build took: 0.0 when an earlier build
    was reused)."""
    out_dir = root / _digest(files, flags)
    lib_path = out_dir / lib_name
    seconds = 0.0
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            t0 = time.perf_counter()
            log = build(Path(tmp))
            seconds = time.perf_counter() - t0
            (out_dir / "build.log").write_text(log)
            os.replace(Path(tmp) / lib_name, lib_path)
    return lib_path, seconds


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _wait(procs) -> str:
    """Wait for every (command, Popen) of _start and return their output;
    raise for the first that failed, after all have ended."""
    outs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    for cmd, out, code in outs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
    return "".join(out for _, out, _ in outs)


def _compile_and_link(compiled, tmp: Path) -> str:
    """One nvcc per source, all started together, then one link into
    ``tmp / LIB_NAME``; returns nvcc's output."""
    nvcc = _nvcc()
    objects = [str(tmp / f"{src.stem}.o") for src in compiled]
    log = _wait([_start([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", obj])
                 for src, obj in zip(compiled, objects)])
    return log + _wait([_start([nvcc, *LINK_FLAGS, "-o", str(tmp / LIB_NAME),
                                *objects])])


@functools.cache
def load() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    compiled, hashed = _sources()
    lib_path, seconds = cached_library(
        BUILD_ROOT, hashed, COMPILE_FLAGS + LINK_FLAGS, LIB_NAME,
        lambda tmp: _compile_and_link(compiled, tmp))
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpu_cuda_error_string.restype = ctypes.c_char_p
    log_path = lib_path.parent / "build.log"
    log = log_path.read_text() if log_path.is_file() else ""
    return Kernels(lib=lib, path=lib_path, build_seconds=seconds, build_log=log)
