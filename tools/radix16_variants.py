#!/usr/bin/env python3
"""Time the f32 natural-store row kernel (tpu_ocean_torch/csrc/
rows_natural_f32.cuh) against two variants of its design on one NVIDIA GPU,
in turns (kernel, variants, variants reversed, kernel):

- two_buffers: two exchange buffers, an exchange writing the one the pass
  before did not read, so one barrier an exchange (twice the shared
  memory);
- shared_twiddles: each block copies the twiddle table into shared memory
  and the passes read it there instead of through the read-only cache.

Each variant is the header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/radix16_variants.py

Prints, a build at a time, the device µs a launch (torch.profiler) at the
shapes the solver's natural row pass takes, each checked against the plain
version first.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tpu_ocean_torch import _build  # noqa: E402
from tpu_ocean_torch.fft import planes  # noqa: E402

HEADER = "rows_natural_f32.cuh"
SHAPES = [(1, 4096, 4096), (1, 2048, 4096), (1, 1, 4096), (1, 1024, 1024)]
# variant: [(text of the header, its replacement)]
VARIANTS = {
    "two_buffers": [
        ("  return static_cast<int>(rows * stride * sizeof(float2));",
         "  return static_cast<int>(2 * rows * stride * sizeof(float2));"),
        ("      // every thread has read its points before any writes the next ones\n"
         "      if (p < P::kPasses - 1) __syncthreads();\n", ""),
        ("v[j] = buf[P::pad(t + T * j)];",
         "v[j] = radix16_smem[(((p - 1) & 1) * R + row) * P::S "
         "+ P::pad(t + T * j)];"),
        ("buf[P::pad(b + s * ns)] = v[s];",
         "radix16_smem[((p & 1) * R + row) * P::S + P::pad(b + s * ns)] "
         "= v[s];"),
    ],
    "shared_twiddles": [
        ("  return static_cast<int>(rows * stride * sizeof(float2));",
         "  return static_cast<int>((rows * stride + n) * sizeof(float2));"),
        ("  const float sg = __ldg(&tw[0].y);\n",
         "  const float sg = __ldg(&tw[0].y);\n"
         "  float2* const tws = radix16_smem + R * P::S;\n"
         "  for (int i = threadIdx.x; i < P::N - P::kFirst + 1; i += blockDim.x)\n"
         "    tws[i] = tw[i];\n"),
        ("const float2* w = tw + 1 + ns - P::kFirst + k;",
         "const float2* w = tws + 1 + ns - P::kFirst + k;"),
        ("cmul(v[s], __ldg(w + (s - 1) * ns))", "cmul(v[s], w[(s - 1) * ns])"),
    ],
}


def variant_sources(name):
    """A copy of csrc/ with the variant's header, under build/."""
    out = ROOT / "build" / "radix16_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    text = (out / HEADER).read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("radix16_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {s: (torch.randn(s, device=dev, generator=gen),
                torch.randn(s, device=dev, generator=gen)) for s in SHAPES}
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name) for name in VARIANTS}}
    find = _build._sources
    order = ["kernel", *VARIANTS, *reversed(VARIANTS), "kernel"]
    try:
        for name in order:
            _build._sources = lambda csrc=sources[name]: find(csrc)
            _build.load.cache_clear()
            kernels = _build.load()
            times = []
            for shape, (re, im) in data.items():
                chip_smoke.check_kernel(
                    name, shape, planes.fft1d_natural_large(re, im),
                    planes.fft1d_natural_large_plain(re, im))
                ms, _, how = chip_smoke.device_ms(
                    lambda re=re, im=im: planes.fft1d_natural_large(re, im))
                times.append(f"{list(shape)} {ms * 1e3:.2f} µs ({how})")
            print(f"[variants] {name} ({kernels.path.parent.name}): "
                  + "; ".join(times), flush=True)
    finally:
        _build._sources = find
        _build.load.cache_clear()


if __name__ == "__main__":
    main()
