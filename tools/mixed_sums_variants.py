#!/usr/bin/env python3
"""Time the f32 mixed-radix row kernel (tpu_ocean_torch/csrc/
rows_mixed_f32.cuh) against two variants of its generic stage's sums on one
NVIDIA GPU, in turns (kernel, variants, variants reversed, kernel):

- no_fold: the 8 accumulators summed pairwise at the end only, with no
  total (each takes p/8 terms in turn);
- fold_branch: the kernel's order of sums (a fold into the total every 8
  rounds), counted by a round counter and a branch in one loop instead of
  blocks of 64 unrolled terms.

Each variant is the header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/mixed_sums_variants.py

Prints, a build at a time, the card's SM clock, power draw and temperature
as nvidia-smi reads them after its timings, the device ms a launch
(torch.profiler) and the error against float64 (torch.fft in complex128)
over the max at shapes whose odd part is a large prime (2042 = 2·1021,
8186 = 2·4093), where the sums differ, and at two the solver's paths give
it (1536², 106 at C = 3), where every prime is below 64 and the three give
the same bits.
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

HEADER = "rows_mixed_f32.cuh"
# (shape, store, calls timed)
SHAPES = [((1, 2042, 2042), "transposed", 50),
          ((1, 8186, 8186), "natural", 10),
          ((1, 1536, 1536), "transposed", 50),
          ((3, 106, 106), "transposed", 50)]
BLOCKS = """    // blocks of kRounds rounds, each folded into the total
    for (; t + kAccumulators * kRounds <= p; t += kAccumulators * kRounds) {
#pragma unroll
      for (int i = 0; i < kAccumulators * kRounds; ++i) {
        const int u = i % kAccumulators;
        acc[u] = cmac(acc[u], x[(t + i) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
      total = cadd(total, sum8(acc));
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) acc[u] = make_float2(0.f, 0.f);
    }
"""
ROUNDS = """    for (; t + kAccumulators <= p; t += kAccumulators) {
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) {
        acc[u] = cmac(acc[u], x[(t + u) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
    }
"""
BRANCH = """    int round = 0;
    for (; t + kAccumulators <= p; t += kAccumulators) {
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) {
        acc[u] = cmac(acc[u], x[(t + u) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
      if (++round == kRounds) {
        round = 0;
        total = cadd(total, sum8(acc));
#pragma unroll
        for (int u = 0; u < kAccumulators; ++u) acc[u] = make_float2(0.f, 0.f);
      }
    }
"""
# variant: [(text of the header, its replacement)]
VARIANTS = {
    "no_fold": [(BLOCKS, "")],
    "fold_branch": [(BLOCKS + ROUNDS, BRANCH)],
}


def variant_sources(name):
    """A copy of csrc/ with the variant's header, under build/."""
    out = ROOT / "build" / "mixed_sums_variants" / name
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


def card_state():
    """nvidia-smi's SM clock, its maximum, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mixed_sums_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for shape, store, _ in SHAPES:
        re = torch.randn(shape, device=dev, generator=gen)
        im = torch.randn(shape, device=dev, generator=gen)
        ref = torch.fft.ifft(torch.complex(re.double(), im.double()), dim=-1,
                             norm="forward")
        if store == "transposed":
            ref = ref.transpose(-1, -2)
        data[shape] = (re, im, (ref.real, ref.imag))
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name) for name in VARIANTS}}
    find = _build._sources
    order = ["kernel", *VARIANTS, *reversed(VARIANTS), "kernel"]
    try:
        for name in order:
            _build._sources = lambda csrc=sources[name]: find(csrc)
            _build.load.cache_clear()
            kernels = _build.load()
            readings = []
            for shape, store, iters in SHAPES:
                re, im, ref = data[shape]
                fn = (planes.fft1d_transposed if store == "transposed"
                      else planes.fft1d_natural_large)
                got = fn(re, im)
                torch.cuda.synchronize()
                rel = (max((g.double() - r).abs().max().item()
                           for g, r in zip(got, ref))
                       / max(r.abs().max().item() for r in ref))
                del got
                ms, _, how = chip_smoke.device_ms(
                    lambda fn=fn, re=re, im=im: fn(re, im), iters=iters)
                readings.append(f"{list(shape)} {store} {ms:.4f} ms ({how}), "
                                f"vs float64 {rel:.3e} x max")
            print(f"[variants] {name} ({kernels.path.parent.name}; "
                  f"{card_state()}): " + "; ".join(readings), flush=True)
    finally:
        _build._sources = find
        _build.load.cache_clear()


if __name__ == "__main__":
    main()
