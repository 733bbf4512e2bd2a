#!/usr/bin/env python3
"""Time the bf16 fused natural-store kernel (tpu_ocean_torch/csrc/
fused_rows_natural_bf16.cuh) against variants of its fused load on one
NVIDIA GPU, in turns (kernel, variants, variants reversed, kernel):

- loads1, loads2: 1 or 2 groups of 4 points a lane in flight (5 float4
  loads a group) instead of 4;
- f1_first: F1's 64 fragment registers issued at the kernel's start, as
  the bf16 row kernel issues them, instead of after the load;
- pipelined: one group in flight, the next group's five loads issued
  before the group before is assembled (two groups in registers).

Each variant is the header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/fused_bf16_variants.py

Prints, a build at a time, the registers, stack and spills ptxas reports
for every instantiation (N = 16 … 8192) and the device µs a launch
(torch.profiler, the median of three windows) at path (vii)'s two
launches and at C = 5 per-channel (on no path), each checked against the
plain version first (every channel on its own scale, 2e-3·max).
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
from tpu_ocean_torch.ops import fused_spectrum as fused  # noqa: E402

HEADER = "fused_rows_natural_bf16.cuh"
# (M, N, ch_start, ch_count, packed, nch_live): path (vii)'s two launches,
# then C = 5 per-channel
SHAPES = [(4096, 4096, 0, 1, True, 3), (2048, 4096, 1, 1, True, 3),
          (4096, 4096, 0, 5, False, 3)]
_F1 = """  uint4 a2[G::kt2];
  bf16_rows::load_f1<kLog2N>(a2, tables);
"""
_LOAD = "  // The fused load: lane group idx holds points"
# the pipelined load: from the loop over base to the end of the load block
_LOOP_START = "    for (int base = threadIdx.x; base < total;"
_LOOP_END = "\n  }\n" + _F1
_PIPELINED = """    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v[5], next[5];
    {
      const int idx = threadIdx.x;
      const bool ok = idx < valid;
      v[0] = ok ? __ldg(&in0[idx]) : z;
      v[1] = ok ? __ldg(&in1[idx]) : z;
      v[2] = ok ? __ldg(&in2[idx]) : z;
      v[3] = ok ? __ldg(&in3[idx]) : z;
      v[4] = ok ? __ldg(&in4[idx]) : z;
    }
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int after = idx + kThreads;
      const bool ok_after = after < valid;
      next[0] = ok_after ? __ldg(&in0[after]) : z;
      next[1] = ok_after ? __ldg(&in1[after]) : z;
      next[2] = ok_after ? __ldg(&in2[after]) : z;
      next[3] = ok_after ? __ldg(&in3[after]) : z;
      next[4] = ok_after ? __ldg(&in4[after]) : z;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (idx < valid) {
        const int j = (idx * 4) & (G::N - 1);
        const int row = p.row_offset + m0 + ((idx * 4) >> kLog2N);
        const float kx = row_kx(row, G::N, p);
        const float4 k = __ldg(&kz4[j >> 2]);
        w.x = pair(v[0].x, v[1].x, v[2].x, v[3].x, v[4].x, kx, k.x, row, j,
                   G::N, ch, p);
        w.y = pair(v[0].y, v[1].y, v[2].y, v[3].y, v[4].y, kx, k.y, row,
                   j + 1, G::N, ch, p);
        w.z = pair(v[0].z, v[1].z, v[2].z, v[3].z, v[4].z, kx, k.z, row,
                   j + 2, G::N, ch, p);
        w.w = pair(v[0].w, v[1].w, v[2].w, v[3].w, v[4].w, kx, k.w, row,
                   j + 3, G::N, ch, p);
      }
      *reinterpret_cast<uint4*>(&b.xs[bf16_rows::x_word<kLog2N>(idx * 4)]) =
          w;
#pragma unroll
      for (int i = 0; i < 5; ++i) v[i] = next[i];
    }"""


def _pipelined(text):
    start = text.index(_LOOP_START)
    end = text.index(_LOOP_END)
    return text[:start] + _PIPELINED + text[end:]


def _f1_first(text):
    text = text.replace(_F1, "")
    return text.replace(_LOAD, _F1 + _LOAD)


# variant: [(text of the header, its replacement) or a function of the
# header's text]
VARIANTS = {
    "loads1": [("constexpr int kLoadsInFlight = 4;",
                "constexpr int kLoadsInFlight = 1;")],
    "loads2": [("constexpr int kLoadsInFlight = 4;",
                "constexpr int kLoadsInFlight = 2;")],
    "f1_first": [(_F1, None), (_LOAD, None), _f1_first],
    "pipelined": [(_LOOP_START, None), (_LOOP_END, None), _pipelined],
}


def variant_sources(name):
    """A copy of csrc/ with the variant's header, under build/."""
    out = ROOT / "build" / "fused_bf16_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    text = (out / HEADER).read_text()
    for edit in VARIANTS[name]:
        if callable(edit):
            text = edit(text)
            continue
        old, new = edit
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        if new is not None:
            text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def registers(log):
    """{log2 N: ptxas's report} for the kernel's instantiations."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "bf16_fused_natural_kernel" in line and "Compiling" in line:
            log2n = int(line.split("kernelILi")[1].split("E")[0])
            found[log2n] = " | ".join(x.strip() for x in lines[i + 1:i + 5]
                                      if "Used" in x or "spill" in x)
    return found


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
    """The median over ``windows`` profiler windows of chip_smoke.device_ms."""
    return float(np.median([chip_smoke.device_ms(fn)[0]
                            for _ in range(windows)]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fused_bf16_variants: needs a CUDA GPU")
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
                  nch_live=nch_live, precision="bfloat16")
        calls.append(([m, n, f"ch {ch}+{count}",
                       fused.channel_set(packed, nch_live) or "packed3"],
                      (h0, phase, OCEAN_DEMO.length, -1.0), kw))
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name) for name in VARIANTS}}
    for turn, name in enumerate(["kernel", *VARIANTS, *reversed(VARIANTS),
                                 "kernel"]):
        with built(sources[name]) as kernels:
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
                    band=chip_smoke.TIER_BAND["bf16"],
                    channels=kw["ch_count"])
                ms = device_ms(lambda a=args, k=kw:
                               fused.assemble_rowfft_natural(*a, **k))
                times.append(f"{shape} {ms * 1e3:.2f}")
            print(f"[variants] {name} µs: " + "; ".join(times), flush=True)


if __name__ == "__main__":
    main()
