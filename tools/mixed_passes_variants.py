#!/usr/bin/env python3
"""Time the f32 row kernel at lengths that are not powers of two
(tpu_ocean_torch/csrc/rows_mixed_passes_f32.cuh, register-resident
mixed-radix passes) against the stage kernel it replaced
(csrc/rows_mixed_f32.cuh's mixed_rows_kernel on its mixed-radix stages, as
the parent commit built it) and cuFFT on one NVIDIA GPU, in turns:
parent, new, variants, variants reversed, new, parent.

- parent: the parent commit's csrc/ (fft_rows.cu, whose entry
  tpu_fft_rows_mixed then ran the stages), built into a library of its own
  under build/mixed_passes_variants/ and called with the plan, table and
  rows that commit's planes gave it (planes.mixed_plan_rows,
  mixed_twiddles, mixed_rows, all still in the package for the fused
  kernel);
- new: the package's rows_mixed.cu and rows_mixed_natural.cu, called as
  planes._launch_rows calls them;
- each variant of --variants: the new header with a few lines replaced
  (VARIANTS), built the same way;
- cuFFT: torch.fft.ifft(z, dim=-1, norm="forward"), once a set.

At each shape: device ms a launch (torch.profiler, warm L2; a launch of
over ~100 ms timed over 2 calls), the error against float64 (torch.fft in
complex128) over the max, and the bound (16 B a point at 3.35 TB/s).
nvidia-smi's name and power limit head the output, its SM clock, power
draw and temperature follow each set. With --sweep, the new kernel's
transposed store at the paths' shapes at every rows × cluster it takes.

The parent's sources: --parent-csrc DIR (default
build/mixed_passes_variants/parent/csrc); where DIR holds no fft_rows.cu
and git is there, `git archive REV tpu_ocean_torch/csrc` fills it (REV
from --rev). The copy a machine without git runs needs DIR filled first:

    python3 tools/mixed_passes_variants.py --extract     # with git
    python3 tools/mixed_passes_variants.py [--variants a,b] [--sweep]
"""

import argparse
import ctypes
import io
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tpu_ocean_torch import _build  # noqa: E402
from tpu_ocean_torch.fft import planes  # noqa: E402

OUT = ROOT / "build" / "mixed_passes_variants"
#: the last commit whose f32 row pass at such N ran the stages
PARENT_REV = "b49d9c3924e6961cbaf6a3a79861a3ba1cb5e002"
HEADER = "rows_mixed_passes_f32.cuh"
#: the files the new kernel's library is built from
NEW_SOURCES = ("rows_mixed.cu", "rows_mixed_natural.cu", HEADER,
               "rows_natural_f32.cuh", "stockham.cuh")
#: (store, shape): the paths' (xxxviii)-(xlii) and the generic passes'
SHAPES = [("transposed", (1, 1536, 1536)), ("transposed", (1, 768, 1536)),
          ("transposed", (1, 1536, 768)), ("transposed", (1, 1, 1536)),
          ("transposed", (1, 3072, 3072)), ("transposed", (1, 3072, 1536)),
          ("transposed", (3, 106, 106)), ("natural", (1, 3072, 3072)),
          ("natural", (1, 1536, 3072)), ("natural", (3, 3072, 3072)),
          ("natural", (1, 6144, 6144)), ("natural", (1, 8190, 8190)),
          ("transposed", (1, 2042, 2042)), ("natural", (1, 8186, 8186))]
#: the transposed shapes --sweep runs at every rows × cluster
SWEEP = [(1, 1536, 1536), (1, 3072, 3072), (3, 106, 106)]
#: variant: ([(text of the header, its replacement wherever it stands)],
#: {planes constant: value} while it runs)
VARIANTS = {
    # every plan on the kernel built with the generic pass's code
    "onekernel": ([("  } else if (plan.roots > 0) {\n    kernel = ",
                    "  } else if (true) {\n    kernel = ")], {}),
    # the plans of N = 2p on the kernel with every pass's code
    "no_twoprime": ([("  if (plan.passes == 2 && plan.pass[0].radix == 2 "
                        "&& plan.roots > 0 &&\n      small) {",
                        "  if (false) {")], {}),
    # the transposed store at 128 registers a thread where its block has
    # at most 512 threads (as the natural store), not 64
    "regs128": ([("  } else if constexpr (kNatural) {",
                  "  } else if constexpr (true) {")], {}),
    # the generic passes' twiddles read from device memory, not staged
    "unstaged": ([("constexpr int kStagedTwiddles = 2048;",
                   "constexpr int kStagedTwiddles = -1;")],
                 {"PASS_STAGED_TWIDDLES": -1}),
    # a generic pass at N = 2p one output at a time, not in pairs
    "nopair": ([("  if (L == 2) {\n    // N = 2p, the last pass",
                 "  if (false) {\n    // N = 2p, the last pass")], {}),
    # a generic pass two items a thread where n/2 threads fit a block
    "spread2": ([], {"PASS_GENERIC_SPREAD": 2}),
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def extract_parent(rev, dest):
    """The commit's tpu_ocean_torch/csrc/ into dest (git archive)."""
    tar = subprocess.run(["git", "-C", str(ROOT), "archive", rev,
                          "tpu_ocean_torch/csrc"], check=True,
                         capture_output=True).stdout
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    with tarfile.open(fileobj=io.BytesIO(tar)) as archive:
        for member in archive.getmembers():
            if member.isfile():
                name = Path(member.name).name
                (dest / name).write_bytes(archive.extractfile(member).read())


def build(name, sources, compiled):
    """A library of `compiled` (the .cu files of `sources`, a directory)
    under OUT/name/, keyed by a hash of every file there, loaded with
    ctypes."""
    files = sorted(sources.iterdir())
    path, seconds = _build.cached_library(
        OUT / name, files, _build.COMPILE_FLAGS + _build.LINK_FLAGS,
        _build.LIB_NAME,
        lambda tmp: _build._compile_and_link(
            [sources / c for c in compiled], tmp))
    # ptxas's registers and spills of each row kernel, by store
    log = (path.parent / "build.log").read_text().splitlines()
    usage = [f"{'natural' if 'ILb1E' in line else 'transposed'}: "
             f"{log[i + 2].strip()}; {log[i + 3].split(':', 1)[1].strip()}"
             for i, line in enumerate(log[:-3])
             if "Compiling entry" in line
             and ("rows_mixed_passes" in line
                  or "mixed_rows_kernel" in line and "Stockham" in line)]
    print(f"[variants] {name}: built in {seconds:.1f} s; "
          + "; ".join(dict.fromkeys(usage)), flush=True)
    return ctypes.CDLL(str(path))


def variant_sources(name):
    """The new kernel's files with the variant's lines, under OUT."""
    out = OUT / "sources" / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in NEW_SOURCES:
        shutil.copy(_build.CSRC / f, out / f)
    text = (out / HEADER).read_text()
    for old, new in VARIANTS[name][0] if name in VARIANTS else ():
        if old not in text:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def launch_new(lib, re, im, natural, rows=None, cluster=None):
    """The new entry as planes._launch_rows calls it (the inverse)."""
    c, m, n = re.shape
    out = [torch.empty((c, m, n) if natural else (c, n, m), device=re.device)
           for _ in range(2)]
    tables = planes.passes_twiddles(n, True, re.device)
    rows = rows or planes.passes_rows(c, m, n, planes.sm_count(re.device),
                                      natural)
    plan = planes.passes_plan_rows(n)
    if cluster is None:
        cluster = 1 if natural else planes.passes_cluster(m, n, rows)
    err = lib.tpu_fft_rows_mixed(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        tables.data_ptr(), c, m, n, rows, int(natural), len(plan) - 1,
        tables.shape[0], cluster, plan.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tpu_fft_rows_mixed: CUDA error {err}")
    return out


def launch_parent(lib, re, im, natural):
    """The parent's entry with the parent's plan, table and rows."""
    c, m, n = re.shape
    out = [torch.empty((c, m, n) if natural else (c, n, m), device=re.device)
           for _ in range(2)]
    tables = planes.mixed_twiddles(n, True, re.device)
    rows = planes.mixed_rows(c, m, n, planes.sm_count(re.device), natural,
                             "f32", False)
    plan = planes.mixed_plan_rows(n)
    err = lib.tpu_fft_rows_mixed(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        tables.data_ptr(), c, m, n, rows, int(natural), len(plan),
        tables.shape[0], plan.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent tpu_fft_rows_mixed: CUDA error {err}")
    return out


def sass_counts(root):
    """{kernel: {opcode: count}} of the row kernels in the library under
    root, for the memory opcodes (LDS, LD, LDG, LDL and the stores)."""
    lib = next(root.glob(f"*/{_build.LIB_NAME}"))
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = (fn if "rows_mixed_passes" in fn
                    or "mixed_rows_kernel" in fn and "Stockham" in fn
                    else None)
            if name:
                counts[name] = {}
        elif name and "*/" in line:
            # "/*0a30*/ @P0 LDS.64 R4, [R2] ;": the opcode after a predicate
            words = [w for w in line.split("*/", 1)[1].split()
                     if not w.startswith("@")]
            op = words[0].split(".")[0] if words else ""
            if op in ("LDS", "LD", "LDG", "LDL", "STS", "ST", "STG", "STL"):
                counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def card_state():
    """nvidia-smi's SM clock, its maximum, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip()


def rel_err(got, ref):
    return (max((g.double() - r).abs().max().item() for g, r in zip(got, ref))
            / max(r.abs().max().item() for r in ref))


def patched(constants):
    """Set planes' constants (and clear the plan caches); returns the old
    values."""
    old = {k: getattr(planes, k) for k in constants}
    for k, v in constants.items():
        setattr(planes, k, v)
    planes.passes_cache_clear()
    return old


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", type=Path,
                    default=OUT / "parent" / "csrc")
    ap.add_argument("--rev", default=PARENT_REV)
    ap.add_argument("--extract", action="store_true",
                    help="only fill --parent-csrc from git and exit")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="count each library's row kernels' memory "
                    "instructions (cuobjdump -sass)")
    args = ap.parse_args()
    if args.extract or not (args.parent_csrc / "fft_rows.cu").is_file():
        extract_parent(args.rev, args.parent_csrc)
        print(f"[variants] {args.rev} csrc in {args.parent_csrc}")
        if args.extract:
            return
    if not torch.cuda.is_available():
        raise SystemExit("mixed_passes_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    variants = [v for v in args.variants.split(",") if v]
    libs = {"parent": build("parent", args.parent_csrc, ["fft_rows.cu"])}
    libs["parent"].tpu_fft_rows_mixed.argtypes = [_P] * 5 + [_I] * 7 + [_P] * 2
    for name in ["new", *variants]:
        libs[name] = build(name, variant_sources(name),
                           ["rows_mixed.cu", "rows_mixed_natural.cu"])
        libs[name].tpu_fft_rows_mixed.argtypes = [_P] * 5 + [_I] * 8 + [_P] * 2
    if args.sass:
        for name in libs:
            print(f"[sass] {name}: {sass_counts(OUT / name)}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for store, shape in SHAPES:
        re = torch.randn(shape, device=dev, generator=gen)
        im = torch.randn(shape, device=dev, generator=gen)
        ref = torch.fft.ifft(torch.complex(re.double(), im.double()), dim=-1,
                             norm="forward")
        if store == "transposed":
            ref = ref.transpose(-1, -2)
        data[store, shape] = (re, im, (ref.real, ref.imag))
    library = {}
    for store, shape in SHAPES:
        re, im, _ = data[store, shape]
        z = torch.complex(re, im)
        library[store, shape] = chip_smoke.device_ms(
            lambda z=z: torch.fft.ifft(z, dim=-1, norm="forward"))[0]
    order = ["parent", "new", *variants, *reversed(variants), "new",
             "parent"]
    for name in order:
        old = patched(VARIANTS[name][1] if name in VARIANTS else {})
        try:
            readings = []
            for store, shape in SHAPES:
                re, im, ref = data[store, shape]
                natural = store == "natural"
                lib = libs[name]
                run = ((lambda: launch_parent(lib, re, im, natural))
                       if name == "parent" else
                       (lambda: launch_new(lib, re, im, natural)))
                try:
                    err = rel_err(run(), ref)
                except RuntimeError as exc:
                    readings.append(f"{store} {list(shape)}: {exc}")
                    continue
                torch.cuda.synchronize()
                # ~100 ms a launch at 8186 = 2·4093
                ms, _, how = chip_smoke.device_ms(
                    run, iters=2 if shape[-1] == 8186 else 20)
                bound = 16 * re.numel() / 3.35e12 * 1e3
                readings.append(
                    f"{store} {list(shape)} {ms:.4f} ms ({how}; bound "
                    f"{bound:.4f}, {bound / ms:.2f} of it; cuFFT "
                    f"{library[store, shape]:.4f}), vs float64 {err:.3e}")
            print(f"[variants] {name} ({card_state()}):\n  "
                  + "\n  ".join(readings), flush=True)
        finally:
            patched(old)
    if args.sweep:
        sms = planes.sm_count(dev)
        for shape in SWEEP:
            re = torch.randn(shape, device=dev, generator=gen)
            im = torch.randn(shape, device=dev, generator=gen)
            c, m, n = shape
            chosen = planes.passes_rows(c, m, n, sms, False)
            k_chosen = planes.passes_cluster(m, n, chosen)
            t = planes.passes_threads(n)
            cells = []
            for rows in (1, 2, 4, 8):
                if rows * t > 1024 or planes.passes_shared_bytes(
                        rows, n) > planes.SMEM_LIMIT:
                    continue
                for k in planes.CLUSTER_SIZES:
                    if n % k or planes.passes_shared_bytes(
                            rows, n, k) > planes.SMEM_LIMIT:
                        continue
                    try:
                        ms = chip_smoke.device_ms(
                            lambda: launch_new(libs["new"], re, im, False,
                                               rows, k), iters=20)[0]
                    except RuntimeError as exc:
                        cells.append(f"R {rows} K {k}: {exc}")
                        continue
                    mark = "*" if (rows, k) == (chosen, k_chosen) else ""
                    cells.append(f"R {rows} K {k}{mark} {ms:.4f}")
            print(f"[sweep] transposed {list(shape)} T {t} ({card_state()}): "
                  + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
