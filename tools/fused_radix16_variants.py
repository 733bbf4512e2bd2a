#!/usr/bin/env python3
"""Time the f32 fused natural-store kernel (tpu_ocean_torch/csrc/
fused_rows_natural_f32.cuh) against variants of its design on one NVIDIA
GPU, in turns (kernel, variants, variants reversed, kernel):

- registers: h̃ of a thread's 16 points held in registers with 1/|k|
  across the channel loop instead of a second shared buffer (R rows of N
  complex after the exchange buffer, 32 KB at N = 4096, R = 1), and only
  the exchange buffer in shared memory;
- group4: the five planes read 4 points of a thread at a time (20 loads
  in flight) instead of 8;
- pipelined: groups of 4 points, the next group's 20 loads issued before
  the group before is reduced to its terms (two groups in registers).

Each variant is the header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/fused_radix16_variants.py

Prints, a build at a time, the registers, stack and spills ptxas reports
for every instantiation (N = 16 … 8192) and the device µs a launch
(torch.profiler, the median of three windows) at the shapes the paths
give the kernel, each checked against the plain version first (every
channel on its own scale, 1e-5·max).
"""

import contextlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tpu_ocean_torch import OCEAN_DEMO, _build  # noqa: E402
from tpu_ocean_torch.fft import planes  # noqa: E402
from tpu_ocean_torch.ops import fused_spectrum as fused  # noqa: E402

HEADER = "fused_rows_natural_f32.cuh"
# (M, N, ch_start, ch_count, packed, nch_live): paths (iv), (xii), (xiii)
SHAPES = [(4096, 4096, 0, 1, True, 3), (2048, 4096, 1, 1, True, 3),
          (4096, 4096, 0, 5, False, 3), (4096, 4096, 0, 3, True, 5),
          (2048, 4096, 2, 1, True, 5)]
_HELD_REGISTERS = """template <int T>
struct HeldTerms {
  PointTerms a[16];
  __device__ __forceinline__ HeldTerms(float2* /*slot*/, int /*t*/) {}
  __device__ __forceinline__ void put(int m, const PointTerms& x) { a[m] = x; }
  __device__ __forceinline__ PointTerms get(int m) const { return a[m]; }
};"""
_HELD = """template <int T>
struct HeldTerms {
  float2* ht;
  float invk[16];
  __device__ __forceinline__ HeldTerms(float2* slot, int t) : ht(slot + t) {}
  __device__ __forceinline__ void put(int m, const PointTerms& x) {
    ht[T * m] = make_float2(x.htr, x.hti);
    invk[m] = x.invk;
  }
  __device__ __forceinline__ PointTerms get(int m) const {
    const float2 h = ht[T * m];
    return PointTerms{h.x, h.y, invk[m]};
  }
};"""
_SHARED = """inline int shared_bytes(int rows, int n) {
  const int t = n / 16;
  const int stride = n + n / (t < 16 ? t : 16) + (t < 16 ? t : 0);
  return static_cast<int>(rows * (stride + n) * sizeof(float2));
}"""
_SHARED_REGISTERS = """inline int shared_bytes(int rows, int n) {
  return radix16::shared_bytes(rows, n);
}"""
_LOADS = """#pragma unroll
  for (int g = 0; g < 16; g += kGroup) {
    float x[kGroup][5];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const size_t i = at + T * (g + u);
      x[u][0] = live ? __ldg(h0r + i) : 0.f;
      x[u][1] = live ? __ldg(h0i + i) : 0.f;
      x[u][2] = live ? __ldg(h0cr + i) : 0.f;
      x[u][3] = live ? __ldg(h0ci + i) : 0.f;
      x[u][4] = live ? __ldg(phase + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      held.put(g + u, point_terms(x[u][0], x[u][1], x[u][2], x[u][3],
                                  x[u][4], kx, __ldg(kz + t + T * (g + u)),
                                  p));
  }"""
_LOADS_PIPELINED = """float x[2][4][5];
#pragma unroll
  for (int g = 0; g <= 4; ++g) {
    if (g < 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t i = at + T * (4 * g + u);
        x[g & 1][u][0] = live ? __ldg(h0r + i) : 0.f;
        x[g & 1][u][1] = live ? __ldg(h0i + i) : 0.f;
        x[g & 1][u][2] = live ? __ldg(h0cr + i) : 0.f;
        x[g & 1][u][3] = live ? __ldg(h0ci + i) : 0.f;
        x[g & 1][u][4] = live ? __ldg(phase + i) : 0.f;
      }
    }
    if (g > 0) {
      const int b = (g - 1) & 1;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        held.put(4 * (g - 1) + u,
                 point_terms(x[b][u][0], x[b][u][1], x[b][u][2], x[b][u][3],
                             x[b][u][4], kx, __ldg(kz + t + T * (4 * (g - 1) + u)),
                             p));
    }
  }"""
# variant: ([(text of the header, its replacement)], its shared bytes)
VARIANTS = {
    "registers": ([(_HELD, _HELD_REGISTERS), (_SHARED, _SHARED_REGISTERS)],
                  lambda rows, n: planes.radix16_shared_bytes(rows, n)),
    "group4": ([("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")],
               None),
    "pipelined": ([(_LOADS, _LOADS_PIPELINED)], None),
}


def variant_sources(name):
    """A copy of csrc/ with the variant's header, under build/."""
    out = ROOT / "build" / "fused_radix16_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    text = (out / HEADER).read_text()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def registers(log):
    """{log2 N: ptxas's report} for the kernel's instantiations."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "radix16_fused_rows_natural_kernel" in line and "Compiling" in line:
            log2n = int(line.split("kernelILi")[1].split("E")[0])
            found[log2n] = " | ".join(x.strip() for x in lines[i + 1:i + 5]
                                      if "Used" in x or "spill" in x)
    return found


@contextlib.contextmanager
def built(sources, shared):
    """The package's build from ``sources`` (and the variant's shared
    bytes) for the duration."""
    find, twin = _build._sources, planes.fused_natural_shared_bytes
    _build._sources = lambda: find(sources)
    if shared is not None:
        planes.fused_natural_shared_bytes = shared
    _build.load.cache_clear()
    try:
        yield _build.load()
    finally:
        _build._sources = find
        planes.fused_natural_shared_bytes = twin
        _build.load.cache_clear()


def device_ms(fn, windows=3):
    """The median over ``windows`` profiler windows of chip_smoke.device_ms."""
    return float(np.median([chip_smoke.device_ms(fn)[0]
                            for _ in range(windows)]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fused_radix16_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for m, n, ch, count, packed, nch_live in SHAPES:
        h0 = tuple(torch.randn((m, n), device=dev, generator=gen)
                   for _ in range(4))
        phase = 2 * np.pi * torch.rand((m, n), device=dev, generator=gen)
        kw = dict(epsilon=1e-4, ch_start=ch, ch_count=count, packed=packed,
                  nch_live=nch_live)
        calls.append(([m, n, f"ch {ch}+{count}",
                       fused.channel_set(packed, nch_live) or "packed3"],
                      (h0, phase, OCEAN_DEMO.length, -1.0), kw))
    sources = {"kernel": (_build.CSRC, None),
               **{name: (variant_sources(name), shared)
                  for name, (_, shared) in VARIANTS.items()}}
    for turn, name in enumerate(["kernel", *VARIANTS, *reversed(VARIANTS),
                                 "kernel"]):
        with built(*sources[name]) as kernels:
            if turn <= len(VARIANTS):
                for log2n, report in sorted(registers(kernels.build_log)
                                            .items()):
                    print(f"[variants] {name}: ptxas at N = {1 << log2n}: "
                          f"{report}", flush=True)
            times = []
            for shape, args, kw in calls:
                chip_smoke.check_kernel(
                    name, shape, fused.assemble_rowfft_natural(*args, **kw),
                    fused.assemble_rowfft_natural_plain(*args, **kw),
                    channels=kw["ch_count"])
                ms = device_ms(lambda a=args, k=kw:
                               fused.assemble_rowfft_natural(*a, **k))
                times.append(f"{shape} {ms * 1e3:.2f}")
            print(f"[variants] {name} µs: " + "; ".join(times), flush=True)


if __name__ == "__main__":
    main()
