#!/usr/bin/env python3
"""Hold the bf16x3 tier's sums on the tensor cores against their plain
versions, across seeds, for the kernel and four variants, on one NVIDIA
GPU:

- no_promote: the matrix engine's contract_mma (csrc/dft_matrix.cuh) with
  one mma accumulator over the whole depth, added into the f32 sum
  rounded to nearest once, at the end;
- promote_unroll4: contract_mma's loop over the depth blocks between two
  such sums unrolled 4 times;
- split3_lo_first: the bf16x3 three-factor row kernel
  (csrc/dft_split3_bf16x3.cuh) issues the hi·lo and lo·hi products of
  stages 2a and 2b before hi·hi;
- split3_lo_apart: that kernel sums hi·lo and lo·hi in an accumulator of
  their own and adds it to hi·hi's in f32 rounded to nearest.

The bf16x3 direct row pass has since left the matrix engine for
csrc/dft_bf16_rows_mixed.cuh, which promotes its sums as the engine does:
the first two variants now change the engine's fused passes only, and the
direct pass's lines read that kernel in every build.

Each variant is a header with a few lines replaced, built with the
package's build into a library of its own under build/ (the package's
sources are not touched). Run from the root of a checkout, on a machine
with a CUDA GPU and nvcc:

    python3 tools/bf16x3_sums_variants.py [--seeds 16] [--variants no_promote]
        [--turns]

(--turns: the kernel, the variants, the variants reversed, the kernel, so
each build is timed early and late in the call.)

For each build it prints:

- the bf16x3 direct row pass at lengths whose n1 = N/2 is deep (2042,
  8186, 8190) and at n1 = 128 (1024, 1536): max abs error against the
  plain version over max|plain|, and the kernel's and the plain version's
  max abs error against float64 (torch.fft in complex128) over max;
- the bf16x3 three-factor row pass at [1, 1024, 1024] on each seed's rows
  (numpy's default_rng(seed), normal): the kernel's max and RMS error
  against float64 over the plain version's (chip_smoke.py holds the max
  ratio to B3_SPLIT3_F64_SPREAD);
- the device ms a launch (torch.profiler) of the direct pass at [1, 8,
  8186] natural, [1, 2042, 2042] and [1, 1536, 1536], and of the
  three-factor pass at [1, 1024, 1024].
"""

import argparse
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

B3 = {"KERNEL_B3_THRESHOLD": 0}
B3_SPLIT3 = {"KERNEL_B3_THRESHOLD": 0, "THREE_FACTOR_THRESHOLD": 0}
# (shape, store) of the direct pass
DIRECT = [((1, 1024, 1024), "transposed"), ((1, 1536, 1536), "transposed"),
          ((1, 2042, 2042), "transposed"), ((1, 8, 8186), "transposed"),
          ((1, 8, 8186), "natural"), ((1, 8, 8190), "natural")]
# (shape, store, calls) of the direct pass timed
TIMED = [((1, 8, 8186), "natural", 5), ((1, 2042, 2042), "transposed", 20),
         ((1, 1536, 1536), "transposed", 50)]

PROMOTE = "constexpr int kPromoteBlocks = 16;"
INNER = "      for (int kb = kc; kb < kend; ++kb) {"
STAGE_2A = """      bf16_rows::mma(d, fw_hi, bh.x, bh.y);
      bf16_rows::mma(d, fw_hi, bl.x, bl.y);
      bf16_rows::mma(d, fw_lo, bh.x, bh.y);
"""
STAGE_2A_LO_FIRST = """      bf16_rows::mma(d, fw_hi, bl.x, bl.y);
      bf16_rows::mma(d, fw_lo, bh.x, bh.y);
      bf16_rows::mma(d, fw_hi, bh.x, bh.y);
"""
STAGE_2A_LO_APART = """      bf16_rows::mma(d, fw_hi, bh.x, bh.y);
      {
        float dl[4] = {0.f, 0.f, 0.f, 0.f};
        bf16_rows::mma(dl, fw_hi, bl.x, bl.y);
        bf16_rows::mma(dl, fw_lo, bh.x, bh.y);
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = __fadd_rn(d[j], dl[j]);
      }
"""
STAGE_2B = """#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bh[kb].x, bh[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bl[kb].x, bl[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_lo[tm][kb], bh[kb].x, bh[kb].y);
      }
"""
STAGE_2B_LO_FIRST = """#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bl[kb].x, bl[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_lo[tm][kb], bh[kb].x, bh[kb].y);
      }
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bh[kb].x, bh[kb].y);
"""
STAGE_2B_LO_APART = """      float dl[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bh[kb].x, bh[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(dl[tm], fu_hi[tm][kb], bl[kb].x, bl[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(dl[tm], fu_lo[tm][kb], bh[kb].x, bh[kb].y);
      }
#pragma unroll
      for (int tm = 0; tm < 2; ++tm)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[tm][j] = __fadd_rn(d[tm][j], dl[tm][j]);
"""
SPLIT3 = "dft_split3_bf16x3.cuh"
# variant: [(header, text of the header, its replacement)]
VARIANTS = {
    "no_promote": [("dft_matrix.cuh", PROMOTE,
                    "constexpr int kPromoteBlocks = 1 << 30;")],
    "promote_unroll4": [("dft_matrix.cuh", INNER,
                         "#pragma unroll 4\n" + INNER)],
    "split3_lo_first": [(SPLIT3, STAGE_2A, STAGE_2A_LO_FIRST),
                        (SPLIT3, STAGE_2B, STAGE_2B_LO_FIRST)],
    "split3_lo_apart": [(SPLIT3, STAGE_2A, STAGE_2A_LO_APART),
                        (SPLIT3, STAGE_2B, STAGE_2B_LO_APART)],
}


def variant_sources(name):
    """A copy of csrc/ with the variant's headers, under build/."""
    out = ROOT / "build" / "bf16x3_sums_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    for header, old, new in VARIANTS[name]:
        text = (out / header).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {header} no longer holds {old!r}")
        (out / header).write_text(text.replace(old, new))
    return out


def switched(switches, fn):
    def call():
        with chip_smoke.dft_switches(planes, switches):
            return fn()
    return call


def max_rel(got, ref, scale):
    return max((g.double() - r.double()).abs().max().item()
               for g, r in zip(got, ref)) / scale


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=16)
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                        default=list(VARIANTS))
    parser.add_argument("--turns", action="store_true")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bf16x3_sums_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[b3] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    def rows(shape, seed):
        rng = np.random.default_rng(seed)
        return tuple(torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev) for _ in range(2))

    def f64(re, im, store):
        ref = torch.fft.ifft(torch.complex(re.double(), im.double()), dim=-1,
                             norm="forward")
        if store == "transposed":
            ref = ref.transpose(-1, -2)
        return ref.real, ref.imag

    fns = {"transposed": (planes.fft1d_transposed,
                          planes.fft1d_transposed_plain),
           "natural": (planes.fft1d_natural_large,
                       planes.fft1d_natural_large_plain)}
    # the plain versions' readings, the same for every build
    direct = {}
    for shape, store in DIRECT:
        re, im = rows(shape, 23)
        ref = f64(re, im, store)
        scale = max(r.abs().max().item() for r in ref)
        plain = switched(B3, lambda p=fns[store][1], re=re, im=im:
                         p(re, im, True, "float32"))()
        direct[shape, store] = (re, im, ref, scale, plain,
                                max_rel(plain, ref, scale))
    split3 = []
    for seed in range(opts.seeds):
        re, im = rows((1, 1024, 1024), seed)
        ref = f64(re, im, "transposed")
        scale = max(r.abs().max().item() for r in ref)
        plain = switched(B3_SPLIT3, lambda re=re, im=im:
                         planes.fft1d_transposed_plain(re, im, True,
                                                       "float32"))()
        split3.append((re, im, ref, scale, max_rel(plain, ref, scale),
                       chip_smoke.rms_rel_err(plain, ref)))
        del plain
    sources = {"kernel": _build.CSRC,
               **{name: variant_sources(name) for name in opts.variants}}
    order = ["kernel", *opts.variants]
    if opts.turns:
        order += [*reversed(opts.variants), "kernel"]
    find = _build._sources
    try:
        for name in order:
            _build._sources = lambda csrc=sources[name]: find(csrc)
            _build.load.cache_clear()
            kernels = _build.load()
            print(f"[b3] {name} ({kernels.path.parent.name})", flush=True)
            for (shape, store), (re, im, ref, scale, plain, plain_err) in (
                    direct.items()):
                got = switched(B3, lambda f=fns[store][0], re=re, im=im:
                               f(re, im, True, "float32"))()
                vs_plain = max_rel(got, plain, max(
                    p.abs().max().item() for p in plain))
                print(f"[b3] {name} direct {list(shape)} {store}: vs plain "
                      f"{vs_plain:.3e} x max|plain|; vs float64 "
                      f"{max_rel(got, ref, scale):.3e} x max, the plain "
                      f"version {plain_err:.3e}", flush=True)
                del got
            ratios = []
            for seed, (re, im, ref, scale, p_max, p_rms) in enumerate(split3):
                got = switched(B3_SPLIT3, lambda re=re, im=im:
                               planes.fft1d_transposed(re, im, True,
                                                       "float32"))()
                k_max = max_rel(got, ref, scale)
                k_rms = chip_smoke.rms_rel_err(got, ref)
                ratios.append((k_max / p_max, k_rms / p_rms))
                print(f"[b3] {name} split3 [1,1024,1024] seed {seed}: max "
                      f"{k_max:.4e} / plain {p_max:.4e} = {k_max / p_max:.4f};"
                      f" RMS {k_rms:.4e} / plain {p_rms:.4e} = "
                      f"{k_rms / p_rms:.4f}", flush=True)
                del got
            r = np.array(ratios).reshape(-1, 2)
            if len(r):
                print(f"[b3] {name} split3 over {len(r)} seeds: max ratio "
                      f"{r[:, 0].min():.4f}..{r[:, 0].max():.4f} (mean "
                      f"{r[:, 0].mean():.4f}), RMS ratio {r[:, 1].min():.4f}.."
                      f"{r[:, 1].max():.4f} (mean {r[:, 1].mean():.4f})",
                      flush=True)
            timed = []
            for shape, store, iters in TIMED:
                re, im = direct[shape, store][:2]
                ms, _, how = chip_smoke.device_ms(switched(
                    B3, lambda f=fns[store][0], re=re, im=im:
                    f(re, im, True, "float32")), iters=iters)
                timed.append(f"direct {list(shape)} {store} {ms:.4f} ms "
                             f"({how})")
            re, im = rows((1, 1024, 1024), 0)
            ms, _, how = chip_smoke.device_ms(switched(
                B3_SPLIT3, lambda re=re, im=im: planes.fft1d_transposed(
                    re, im, True, "float32")), iters=50)
            timed.append(f"split3 [1,1024,1024] {ms:.4f} ms ({how})")
            print(f"[b3] {name} timing: " + "; ".join(timed), flush=True)
    finally:
        _build._sources = find
        _build.load.cache_clear()


if __name__ == "__main__":
    main()
