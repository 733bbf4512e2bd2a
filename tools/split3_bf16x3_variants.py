#!/usr/bin/env python3
"""Time the bf16x3 three-factor row kernel (tpu_ocean_torch/csrc/
dft_split3_bf16x3.cuh) against variants of its design on one NVIDIA GPU,
in turns (kernel, variants, variants reversed, kernel), each at 1, 2, 4
and 8 rows a block, beside the f32 three-factor kernel of the same build
at the rows its wrapper picks:

- late_tables: each lane loads its F_W, TW and F_U registers from device
  memory before each stage, not at the start of the block at every N
  (the kernel does so only where stage 1 leaves the registers, n2 ≤ 8);
- threads256: blocks of 256 threads, and the largest shared-memory
  carveout, so that two blocks of R ≤ 4 fit an SM;
- bounds2: __launch_bounds__(512, 2) (at most 64 registers a thread) and
  the largest carveout, two blocks of R ≤ 4 an SM.

Then the phases of the kernel and of late_tables (a copy of the header
that records each block's SM clock, clock64, after its rows are in shared
memory, after stage 1, after stage 2a and after stage 2b's stores are
issued, each behind a barrier) at [1, 1024, 1024], over 20 launches after
a warm-up (warm L2, as chip_smoke.py times the kernels): the mean, min
and max over blocks and launches, in µs at the SM clock the same copy
reads from %globaltimer over each block.

Each variant is the header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/split3_bf16x3_variants.py

Prints, a build at a time, the registers ptxas reports for the kernel at
N = 1024 (at every N for the first build) and the device µs a launch (torch.profiler) at the shapes path
(ix) gives the kernel and [1, 512, 1024], each checked against the plain
version first.
"""

import contextlib
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tpu_ocean_torch import _build  # noqa: E402
from tpu_ocean_torch.fft import planes  # noqa: E402

HEADER = "dft_split3_bf16x3.cuh"
SHAPES = [(1, 1024, 1024), (1, 1, 1024), (1, 512, 1024)]
SWITCHES = {"THREE_FACTOR_THRESHOLD": 0, "KERNEL_B3_THRESHOLD": 0}
_CARVEOUT = ("  const cudaError_t err = allow_smem(kernel, smem);",
             "  cudaFuncSetAttribute(kernel,"
             " cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
             "  const cudaError_t err = allow_smem(kernel, smem);")
_SYNCS = ["M, R, m0);\n  __syncthreads();\n", "      });\n  __syncthreads();\n",
          "    }\n  }\n  __syncthreads();\n\n  // Stage 2b"]
_END = "      }\n    }\n  }\n}\n\ntemplate <int kLog2N>\nint launch_n("
# variant: [(text of the header, its replacement)]
VARIANTS = {
    "late_tables": [("  constexpr bool kEarlyTables = n2 <= 8;",
                     "  constexpr bool kEarlyTables = false;")],
    "threads256": [("constexpr int kThreads = 512;",
                    "constexpr int kThreads = 256;"), _CARVEOUT],
    "bounds2": [("__global__ void __launch_bounds__(kThreads)\n",
                 "__global__ void __launch_bounds__(kThreads, 2)\n"),
                _CARVEOUT],
}
PHASES = ["rows in shared memory", "stage 1", "stage 2a", "stage 2b issued"]


def _stamp(i):
    return f"  if (tid == 0) phase_clk[blk * 6 + {i}] = clock64();\n"


# the kernel with its phases recorded (PHASES; clock64 at the start and
# after each, the block's %globaltimer ns in the last word)
PHASE_COPY = [
    ("extern __shared__ uint4 split3_bf16x3_smem[];",
     "extern __shared__ uint4 split3_bf16x3_smem[];\n"
     "__device__ long long phase_clk[1 << 16];\n"
     "__device__ __forceinline__ long long global_ns() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}"),
    ("  const size_t plane = static_cast<size_t>(M) * G::N;\n",
     "  const size_t plane = static_cast<size_t>(M) * G::N;\n"
     "  const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "  const long long ns0 = global_ns();\n" + _stamp(0)),
    *((sync, sync.replace("__syncthreads();\n", "__syncthreads();\n"
                          + _stamp(i + 1))) for i, sync in enumerate(_SYNCS)),
    (_END, "      }\n    }\n  }\n  __syncthreads();\n" + _stamp(4)
     + "  if (tid == 0) phase_clk[blk * 6 + 5] = global_ns() - ns0;\n"
     "}\n\ntemplate <int kLog2N>\nint launch_n("),
    ("}  // namespace tpu_fft\n",
     "}  // namespace tpu_fft\n\n"
     "extern \"C\" int tpu_split3_phase_clk(void* dst, int count) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      dst, tpu_fft::split3_bf16x3::phase_clk, count * 8));\n}\n"),
]


def variant_sources(name, replacements):
    """A copy of csrc/ with the header's text replaced, under build/."""
    out = ROOT / "build" / "split3_bf16x3_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    text = (out / HEADER).read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def registers(log, log2n=10):
    """ptxas's report for the kernel at N = 2^log2n."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if (f"split3_bf16x3_rows_kernelILi{log2n}E" in line
                and "Compiling" in line):
            return " | ".join(x.strip() for x in lines[i + 1:i + 5]
                              if "Used" in x or "spill" in x)
    return "not reported"


@contextlib.contextmanager
def rows_per_block(rows):
    """rows a block for the duration (0: the wrapper's own choice)."""
    chosen = planes.rows_per_block
    if rows:
        planes.rows_per_block = lambda *_, **__: rows
    try:
        yield
    finally:
        planes.rows_per_block = chosen


@contextlib.contextmanager
def built(sources):
    """The package's build from ``sources`` for the duration."""
    find = _build._sources
    _build._sources = lambda: find(sources)
    _build.load.cache_clear()
    try:
        yield _build.load()
    finally:
        _build._sources = find
        _build.load.cache_clear()


def device_ms(fn, windows=3):
    """The median over ``windows`` profiler windows of chip_smoke.device_ms
    (a window now and then records fewer launches than it ran)."""
    return float(np.median([chip_smoke.device_ms(fn)[0]
                            for _ in range(windows)]))


def time_builds(sources, data):
    for turn, name in enumerate(["kernel", *VARIANTS, *reversed(VARIANTS),
                                 "kernel"]):
        with built(sources[name]) as kernels:
            for log2n in (range(7, 14) if turn == 0 else (10,)):
                print(f"[variants] {name}: ptxas at N = {1 << log2n}: "
                      f"{registers(kernels.build_log, log2n)}", flush=True)
            for shape, (re_, im_) in data.items():
                times = []
                for tier, rows_list in (("bf16x3", (1, 2, 4, 8)), ("f32", (0,))):
                    planes.KERNEL_B3_THRESHOLD = (0 if tier == "bf16x3"
                                                  else 1 << 30)
                    for rows in rows_list:
                        if rows > shape[1]:
                            continue
                        with rows_per_block(rows):
                            chip_smoke.check_kernel(
                                name, shape, planes.fft1d_transposed(re_, im_),
                                planes.fft1d_transposed_plain(re_, im_))
                            ms = device_ms(
                                lambda a=re_, b=im_: planes.fft1d_transposed(a, b))
                        times.append(f"{tier} R {rows or 'wrapper'} "
                                     f"{ms * 1e3:.2f}")
                planes.KERNEL_B3_THRESHOLD = 0
                print(f"[variants] {name} {list(shape)} µs: "
                      + ", ".join(times), flush=True)


def time_phases(name, sources, re_, im_, launches=20):
    c, m, n = re_.shape
    rows = planes.rows_per_block(
        c, m, n, planes.sm_count(re_.device),
        planes.row_pass_max_rows(n, False, "bf16x3", True),
        planes.split3_bf16x3_shared_bytes)
    blocks = c * -(-m // rows)
    runs = []
    with built(sources) as kernels:
        fn = kernels.lib.tpu_split3_phase_clk
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        planes.fft1d_transposed(re_, im_)             # warm-up
        for _ in range(launches):
            planes.fft1d_transposed(re_, im_)
            torch.cuda.synchronize()
            buf = np.zeros(blocks * 6, np.int64)
            kernels.check(fn(buf.ctypes.data, buf.size), "tpu_split3_phase_clk")
            runs.append(buf.reshape(blocks, 6))
    clk = np.concatenate(runs)
    ghz = (clk[:, 4] - clk[:, 0]).sum() / clk[:, 5].sum()
    steps = np.diff(clk[:, :5], axis=1) / ghz / 1e3          # µs
    print(f"[phases] {name} {[c, m, n]} R {rows}, {blocks} blocks x "
          f"{launches} launches, SM clock {ghz:.3f} GHz (clock64 over "
          f"%globaltimer): "
          + "; ".join(f"{what} {s.mean():.2f} µs (min {s.min():.2f}, max "
                      f"{s.max():.2f})" for what, s in zip(PHASES, steps.T))
          + f"; block total {steps.sum(1).mean():.2f} µs", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("split3_bf16x3_variants: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {s: (torch.randn(s, device=dev, generator=gen),
                torch.randn(s, device=dev, generator=gen)) for s in SHAPES}
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name, reps)
                  for name, reps in VARIANTS.items()}}
    saved = {k: getattr(planes, k) for k in SWITCHES}
    try:
        for k, v in SWITCHES.items():
            setattr(planes, k, v)
        time_builds(sources, data)
        for name, reps in (("kernel", []),
                           ("late_tables", VARIANTS["late_tables"])):
            time_phases(name, variant_sources(f"phases_{name}",
                                              PHASE_COPY + reps),
                        *data[(1, 1024, 1024)])
    finally:
        for k, v in saved.items():
            setattr(planes, k, v)


if __name__ == "__main__":
    main()
