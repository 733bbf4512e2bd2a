#!/usr/bin/env python3
"""Time the f32 fused transposed-store kernel (tpu_ocean_torch/csrc/
fused_rows_transposed_f32.cuh) against a variant of its design and, where
given, against the kernel it replaced, on one NVIDIA GPU, in turns
(kernel, third, vec4, parent, parent, vec4, third, kernel):

- third: the store's tile in a third region of shared memory after h̃
  instead of in the exchange buffer: a barrier less a channel (the
  passes return while other threads may still read the buffer), R·G
  complex more a block (65.7 KB at N = 1024, R = 8);
- vec4: the read-out four rows at one k a thread, stored as a float4 of
  each plane (16-byte stores) where R ≥ 4, the block's rows all lie
  below M and M is a multiple of 4; else the kernel's read-out;
- parent (with --parent DIR): the fused kernels of another checkout's
  csrc/ directory, e.g. the commit before this kernel unpacked with

      git archive <commit> tpu_ocean_torch/csrc | tar -x -C build/parent

  and passed as --parent build/parent/tpu_ocean_torch/csrc. Its f32
  transposed store is fused_rows_kernel on stockham.cuh's radix-2 stages
  (one channel a block, the Stockham twiddles, rows from
  planes.max_rows), called here with those arguments. Its f32 fused
  natural kernel takes the same arguments as this checkout's, and its
  outputs must equal this checkout's bit for bit at every shape below
  (the natural kernel's load and passes were factored out for both f32
  fused kernels).

Each build is the package's build into a library of its own under
build/ (the package's sources are not touched). Run from the root of a
checkout, on a machine with a CUDA GPU and nvcc:

    python3 tools/fused_transposed_variants.py [--parent DIR]

Prints, a build at a time, the registers, stack and spills ptxas reports
for the kernel's instantiations (N = 16 … 8192) and the device µs a
launch (torch.profiler, the median of three windows) at the shapes paths
(ii), (x) and (xi) give the kernel, each checked against the plain
version first (every channel on its own scale, 1e-5·max).
"""

import argparse
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

HEADER = "fused_rows_transposed_f32.cuh"
# (M, N, ch_start, ch_count, packed, nch_live): paths (ii), (x), (xi)
SHAPES = [(1024, 1024, 0, 1, True, 3), (512, 1024, 1, 1, True, 3),
          (1024, 1024, 0, 3, False, 3), (1024, 1024, 0, 2, True, 5),
          (512, 1024, 2, 1, True, 5)]
# the variant: (text of the header, its replacement)
THIRD = [
    ("  float2* const tile = smem;      // in the exchange buffer\n",
     "  float2* const tile = smem + R * (P::S + P::N);\n"),
    ("    // every thread's last reads of the exchange buffer are done\n"
     "    __syncthreads();\n", ""),
    ("  const int smem = fused_radix16::shared_bytes(rows, 1 << kLog2N);\n",
     "  const int smem = fused_radix16::shared_bytes(rows, 1 << kLog2N) +\n"
     "      static_cast<int>(rows * gather_stride(rows, 1 << kLog2N) *\n"
     "                       sizeof(float2));\n"),
]


# the variant: the read-out four rows a thread (a float4 of each plane)
# where the block's rows are whole and M allows 16-byte stores
VEC4 = [(
    """#pragma unroll 4
    for (int i = threadIdx.x; i < (P::N << log2r); i += blockDim.x) {""",
    """    if (R >= 4 && live_rows == R && (M & 3) == 0) {
      for (int i = threadIdx.x; i < (P::N << (log2r - 2)); i += blockDim.x) {
        const int r = (i & ((R >> 2) - 1)) << 2;
        const int k = i >> (log2r - 2);
        const float2 a = tile[r * G + k], b = tile[(r + 1) * G + k];
        const float2 d = tile[(r + 2) * G + k], e = tile[(r + 3) * G + k];
        const size_t g = static_cast<size_t>(k) * M + r;
        *reinterpret_cast<float4*>(o_re + g) = make_float4(a.x, b.x, d.x, e.x);
        *reinterpret_cast<float4*>(o_im + g) = make_float4(a.y, b.y, d.y, e.y);
      }
      continue;
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < (P::N << log2r); i += blockDim.x) {""")]
VARIANTS = {"third": THIRD, "vec4": VEC4}


def _third_shared_bytes(rows, n):
    return (planes.fused_natural_shared_bytes(rows, n)
            + rows * planes.cluster_gather_stride(rows, n) * 8)


def _third_rows(c, m, n, sms, natural, tier, split3):
    """The kernel's rows, with the third region's shared memory."""
    if natural:
        return ROWS(c, m, n, sms, natural, tier, split3)
    return planes.rows_per_block(1, m, n, sms,
                                 planes.fused_transposed_max_rows(n),
                                 _third_shared_bytes)


def variant_sources(name):
    """A copy of csrc/ with the variant's header, under build/."""
    out = ROOT / "build" / "fused_transposed_variants" / name
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


def registers(log):
    """{(kernel, log2 N): ptxas's report} for the f32 fused kernels."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        for kernel in ("radix16_fused_rows_transposed_kernel",
                       "radix16_fused_rows_natural_kernel",
                       "fused_rows_kernelILb0EN7tpu_fft14StockhamEngine"):
            if kernel in line and "Compiling" in line:
                log2n = (int(line.split("kernelILi")[1].split("E")[0])
                         if "ILi" in line else 0)
                found[kernel, log2n] = " | ".join(
                    x.strip() for x in lines[i + 1:i + 5]
                    if "Used" in x or "spill" in x)
    return found


def _parent_rows(c, m, n, sms, natural, tier, split3):
    """The rows the kernel before this one took: max_rows, one channel
    a block, two radix-2 buffers (planes.shared_bytes)."""
    if natural:
        return ROWS(c, m, n, sms, natural, tier, split3)
    return planes.rows_per_block(c, m, n, sms, planes.max_rows(n, False))


def _parent_tables(n, inverse, tier, split3, natural, device):
    if natural:
        return TABLES(n, inverse, tier, split3, natural, device)
    return planes.tables_for(n, inverse, tier, split3, device)


ROWS, TABLES = planes.fused_rows, planes.fused_tables


@contextlib.contextmanager
def built(sources, name):
    """The package's build from ``sources`` for the duration, with the
    wrapper's arguments of that build."""
    find = _build._sources
    _build._sources = lambda: find(sources)
    if name == "third":
        planes.fused_rows = _third_rows
    if name == "parent":
        planes.fused_rows, planes.fused_tables = _parent_rows, _parent_tables
    _build.load.cache_clear()
    try:
        yield _build.load()
    finally:
        _build._sources = find
        planes.fused_rows, planes.fused_tables = ROWS, TABLES
        _build.load.cache_clear()


def device_ms(fn, windows=3):
    """The median over ``windows`` profiler windows of chip_smoke.device_ms."""
    return float(np.median([chip_smoke.device_ms(fn)[0]
                            for _ in range(windows)]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path,
                        help="a csrc/ directory holding the kernel replaced")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_transposed_variants: needs a CUDA GPU")
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
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name) for name in VARIANTS}}
    middle = [*VARIANTS]
    if opts.parent is not None:
        sources["parent"] = opts.parent.resolve()
        middle.append("parent")
    order = ["kernel", *middle, *reversed(middle), "kernel"]
    natural = {}
    for turn, name in enumerate(order):
        with built(sources[name], name) as kernels:
            if name not in order[:turn]:
                for (kernel, log2n), report in sorted(
                        registers(kernels.build_log).items()):
                    at = f"N = {1 << log2n}" if log2n else "every N"
                    print(f"[variants] {name}: ptxas {kernel} at {at}: "
                          f"{report}", flush=True)
            times = []
            for shape, args, kw in calls:
                chip_smoke.check_kernel(
                    name, shape, fused.assemble_rowfft(*args, **kw),
                    fused.assemble_rowfft_plain(*args, **kw),
                    channels=kw["ch_count"])
                ms = device_ms(lambda a=args, k=kw: fused.assemble_rowfft(*a, **k))
                times.append(f"{shape} {ms * 1e3:.2f}")
                # the f32 fused natural kernel on the same inputs: one
                # build's outputs bit for bit the other's
                if name in ("kernel", "parent"):
                    out = fused.assemble_rowfft_natural(*args, **kw)
                    key = tuple(shape)
                    if key in natural:
                        same = all(torch.equal(a, b)
                                   for a, b in zip(out, natural[key]))
                        print(f"[variants] {name}: the f32 fused natural "
                              f"kernel at {shape} bit-equal to the first "
                              f"build's: {same}", flush=True)
                        if not same:
                            raise SystemExit("the f32 fused natural kernel "
                                             "changed its output")
                    else:
                        natural[key] = out
            print(f"[variants] {name} µs: " + "; ".join(times), flush=True)


if __name__ == "__main__":
    main()
