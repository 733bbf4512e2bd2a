#!/usr/bin/env python3
"""Time the bf16 row kernel at lengths that are not powers of two
(tpu_ocean_torch/csrc/dft_bf16_rows_mixed.cuh, entry tpu_bf16_rows_mixed)
against the kernel it replaced (the matrix engine's bf16 instantiation
behind csrc/rows_mixed_f32.cuh's loads and stores, as the parent commit
built it) and cuFFT on one NVIDIA GPU, in turns: parent, new, variants,
variants reversed, new, parent. With --tier bf16x3, the same file's bf16x3
row kernel in the direct form at every even N against the matrix engine's
bf16x3 direct instantiation (behind csrc/fft_rows.cu's fft_rows_kernel at
powers of two, behind csrc/rows_mixed_f32.cuh's loads and stores
elsewhere), at PERF.md §6's shapes of the B3 rows.

- parent: the parent commit's csrc/ (fft_rows.cu, whose entries
  tpu_matrix_rows_any (and, at bf16x3, tpu_fft_rows_transposed and
  tpu_fft_rows_natural) then ran the tier in the direct form), built into
  a library of its own under build/bf16_mixed_variants/ and called with
  the tables and rows that commit's planes gave it (planes.matrix_tables,
  mixed_rows, rows_per_block with shared_bytes, all still in the package
  for the other tiers and forms);
- new: the package's bf16_rows_mixed.cu and bf16_rows_mixed_natural.cu,
  called as planes._launch_rows calls them;
- each variant of --variants: the new header with a few lines replaced
  (VARIANTS), built the same way;
- cuFFT: torch.fft.ifft(z, dim=-1, norm="forward"), once.

At each shape: device ms a launch (torch.profiler, warm L2; both launches
of n1 = N/2 > 128 together, and the tiled product alone), the error
against float64 (torch.fft in complex128) over the max, the bound (bf16:
16 B a point at 3.35 TB/s; bf16x3: the larger of that and the matrix
form's operations, 8·n2 + 6 f32 at 67 TFLOP/s and 3·8·n1 bf16 at 989) and,
where n1 = N/2 > 128, the matrix form's tensor floor (8·n1 bf16 flops a
point, three times at bf16x3, at 989 TFLOP/s). nvidia-smi's name and power
limit head the output, its SM clock, power draw and temperature follow
each set.

The parent's sources: --parent-csrc DIR (default
build/bf16_mixed_variants/parent-TIER/csrc); where DIR holds no
fft_rows.cu and git is there, `git archive REV tpu_ocean_torch/csrc`
fills it (REV from --rev, by default the tier's PARENT_REV). The copy a
machine without git runs needs DIR filled first:

    python3 tools/bf16_mixed_variants.py [--tier bf16x3] --extract  # git
    python3 tools/bf16_mixed_variants.py [--tier bf16x3] [--variants a,b]
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

OUT = ROOT / "build" / "bf16_mixed_variants"
#: by tier, the last commit whose row pass in the direct form ran the
#: matrix engine: bf16 at lengths that are not powers of two, bf16x3 at
#: every length
PARENT_REV = {"bf16": "39cbf32cc346d3a4726e258b9e119733fc1528c6",
              "bf16x3": "10bd2d97e01e2cf8b0a0584444d5ddba741f946f"}
HEADER = "dft_bf16_rows_mixed.cuh"
#: the files the new kernel's library is built from
NEW_SOURCES = ("bf16_rows_mixed.cu", "bf16_rows_mixed_natural.cu", HEADER,
               "dft_bf16_rows.cuh", "dft_matrix.cuh", "dft_split3_f32.cuh",
               "stockham.cuh")
#: by tier, (store, shape): PERF.md §6's shapes of the bf16 rows at such
#: N, and of the B3 rows (the powers of two included)
SHAPES = {
    "bf16": [("transposed", (1, 1536, 1536)), ("transposed", (1, 768, 1536)),
             ("transposed", (1, 1, 1536)), ("transposed", (1, 1536, 768)),
             ("transposed", (1, 3072, 3072)),
             ("transposed", (1, 3072, 1536)), ("transposed", (3, 106, 106)),
             ("natural", (1, 1, 3072)), ("natural", (1, 3072, 3072)),
             ("transposed", (1, 2042, 2042)), ("natural", (1, 8186, 8186))],
    "bf16x3": [("transposed", (1, 1024, 1024)),
               ("transposed", (1, 4096, 4096)),
               ("natural", (1, 1024, 1024)), ("natural", (1, 4096, 4096)),
               ("transposed", (1, 1536, 1536)),
               ("natural", (1, 3072, 3072)),
               ("transposed", (1, 2042, 2042)),
               ("natural", (1, 8186, 8186))]}
#: by tier, (store, shape) --sweep times at every rows a block that fits
#: (n1 ≤ 128)
SWEEP = {
    "bf16": [("transposed", (1, 1536, 1536)), ("transposed", (1, 768, 1536)),
             ("transposed", (1, 1536, 768)), ("transposed", (1, 3072, 3072)),
             ("transposed", (1, 3072, 1536)), ("natural", (1, 3072, 3072)),
             ("natural", (1, 1536, 1536))],
    "bf16x3": [("transposed", (1, 1024, 1024)),
               ("transposed", (1, 1536, 1536)),
               ("transposed", (1, 4096, 4096)), ("natural", (1, 1024, 1024)),
               ("natural", (1, 3072, 3072)), ("natural", (1, 4096, 4096))]}
#: variant: [(text of the header, its replacement wherever it stands)]
VARIANTS = {
    # the raster's group of k1 tiles
    "group32": [("constexpr int kGroup = 16;", "constexpr int kGroup = 32;")],
    # half the group (at bf16x3 F1's hi and lo, 16.8 MB at 8186)
    "group8": [("constexpr int kGroup = 16;", "constexpr int kGroup = 8;")],
    # bf16x3 regime 1 without one of its phases, to read what each costs:
    # timing probes only, their output is wrong (its error is printed)
    "skip_stage1": [("    stage1_b3<kS>(g, xs, yh, yl, f2s, n2p, tw, R);\n",
                     "")],
    "skip_stage2": [("    stage2_b3(g, yh, yl, lo, xs, a2, R);\n", "")],
    # two stages of cp.async in flight instead of three
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    # the mma accumulators added into the f32 sums once, at the end
    "nopromote": [("constexpr int kPromoteChunks = kPromoteBlocks * 8 / "
                   "kChunk;", "constexpr int kPromoteChunks = 1 << 20;")],
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
    ctypes; prints ptxas's registers and spills of the bf16 kernels."""
    files = sorted(sources.iterdir())
    path, seconds = _build.cached_library(
        OUT / name, files, _build.COMPILE_FLAGS + _build.LINK_FLAGS,
        _build.LIB_NAME,
        lambda tmp: _build._compile_and_link(
            [sources / c for c in compiled], tmp))
    log = (path.parent / "build.log").read_text().splitlines()
    usage = []
    for i, line in enumerate(log):
        if "Compiling entry" in line and (
                "bf16_mixed" in line or "bf16_gemm" in line
                or "MatrixEngineILi1ELb0E" in line
                or "MatrixEngineILi2ELb0E" in line):
            near = [x.strip() for x in log[i + 1:i + 5]
                    if "Used" in x or "spill" in x]
            usage.append(f"{line.split('function')[1].split()[0]}: "
                         + "; ".join(near))
    print(f"[variants] {name}: built in {seconds:.1f} s\n  "
          + "\n  ".join(dict.fromkeys(usage)), flush=True)
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
    for old, new in VARIANTS.get(name, ()):
        if old not in text:
            raise SystemExit(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    (out / HEADER).write_text(text)
    return out


def chosen_rows(c, m, n, natural, tier):
    """The rows a block planes._launch_rows gives the pass."""
    return planes.rows_per_block(c, m, n, planes.sm_count(
        torch.device("cuda")), planes.max_rows(n, natural, tier, False),
        planes.block_shared_bytes(tier, False, natural))


def launch_new(lib, re, im, natural, tier, rows=None):
    """The new entry as planes._launch_rows calls it (the inverse), at
    `rows` rows a block where given."""
    c, m, n = re.shape
    out = [torch.empty((c, m, n) if natural else (c, n, m), device=re.device)
           for _ in range(2)]
    b3 = tier == "bf16x3"
    tables = (planes.bf16x3_rows_tables if b3 else planes.bf16_rows_tables)(
        n, True, re.device)
    rows = rows or chosen_rows(c, m, n, natural, tier)
    words = (planes.bf16x3_rows_scratch_words if b3
             else planes.bf16_rows_scratch_words)(c, m, n)
    scratch = torch.empty(words, dtype=torch.int32, device=re.device)
    err = lib.tpu_bf16_rows_mixed(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        tables.data_ptr(), scratch.data_ptr(), c, m, n, rows, int(natural),
        planes.TIERS[tier], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tpu_bf16_rows_mixed: CUDA error {err}")
    return out


def launch_parent(lib, re, im, natural, tier):
    """The parent's entry with the parent's tables and rows: at a power of
    two (bf16x3) tpu_fft_rows_transposed or tpu_fft_rows_natural on the
    engine's two f32 buffers (shared_bytes), the transposed store's 8 rows
    or the natural store's NATURAL_BLOCK_POINTS; elsewhere
    tpu_matrix_rows_any at mixed_rows."""
    c, m, n = re.shape
    out = [torch.empty((c, m, n) if natural else (c, n, m), device=re.device)
           for _ in range(2)]
    tables = planes.matrix_tables(n, True, False, re.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), tables.data_ptr(), c, m, n)
    if planes.is_power_of_two(n):
        cap = (max(1, planes.NATURAL_BLOCK_POINTS // n) if natural
               else planes.TRANSPOSED_MAX_ROWS)
        rows = planes.rows_per_block(c, m, n, planes.sm_count(re.device),
                                     cap, planes.shared_bytes)
        entry = "tpu_fft_rows_natural" if natural else "tpu_fft_rows_transposed"
        err = getattr(lib, entry)(*args, rows, planes.TIERS[tier], 0,
                                  *(() if natural else (1,)), stream)
    else:
        entry = "tpu_matrix_rows_any"
        rows = planes.mixed_rows(c, m, n, planes.sm_count(re.device), natural,
                                 tier, False)
        err = lib.tpu_matrix_rows_any(*args, rows, int(natural),
                                      planes.TIERS[tier], 0, stream)
    if err:
        raise RuntimeError(f"parent {entry}: CUDA error {err}")
    return out


def card_state():
    """nvidia-smi's SM clock, its maximum, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip()


def rel_err(got, ref):
    return (max((g.double() - r).abs().max().item() for g, r in zip(got, ref))
            / max(r.abs().max().item() for r in ref))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tier", choices=sorted(PARENT_REV), default="bf16")
    ap.add_argument("--parent-csrc", type=Path, default=None)
    ap.add_argument("--rev", default=None)
    ap.add_argument("--extract", action="store_true",
                    help="only fill --parent-csrc from git and exit")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the new kernel at every rows a block")
    args = ap.parse_args()
    tier = args.tier
    args.rev = args.rev or PARENT_REV[tier]
    args.parent_csrc = (args.parent_csrc
                        or OUT / f"parent-{tier}" / "csrc")
    if args.extract or not (args.parent_csrc / "fft_rows.cu").is_file():
        extract_parent(args.rev, args.parent_csrc)
        print(f"[variants] {args.rev} csrc in {args.parent_csrc}")
        if args.extract:
            return
    if not torch.cuda.is_available():
        raise SystemExit("bf16_mixed_variants: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}; tier {tier}", flush=True)
    variants = [v for v in args.variants.split(",") if v]
    libs = {"parent": build(f"parent-{tier}", args.parent_csrc,
                            ["fft_rows.cu"])}
    libs["parent"].tpu_matrix_rows_any.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    libs["parent"].tpu_fft_rows_transposed.argtypes = ([_P] * 5 + [_I] * 7
                                                       + [_P])
    libs["parent"].tpu_fft_rows_natural.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    for name in ["new", *variants]:
        libs[name] = build(name, variant_sources(name),
                           ["bf16_rows_mixed.cu", "bf16_rows_mixed_natural.cu"])
        libs[name].tpu_bf16_rows_mixed.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data, library = {}, {}
    for store, shape in SHAPES[tier]:
        re = torch.randn(shape, device=dev, generator=gen)
        im = torch.randn(shape, device=dev, generator=gen)
        z = torch.complex(re, im)
        ref = torch.fft.ifft(z.to(torch.complex128), dim=-1, norm="forward")
        if store == "transposed":
            ref = ref.transpose(-1, -2)
        data[store, shape] = (re, im, (ref.real, ref.imag))
        library[store, shape] = chip_smoke.device_ms(
            lambda z=z: torch.fft.ifft(z, dim=-1, norm="forward"))[0]
    order = ["parent", "new", *variants, *reversed(variants), "new",
             "parent"]
    for name in order:
        readings = []
        for store, shape in SHAPES[tier]:
            re, im, ref = data[store, shape]
            natural = store == "natural"
            lib = libs[name]
            run = ((lambda: launch_parent(lib, re, im, natural, tier))
                   if name == "parent" else
                   (lambda: launch_new(lib, re, im, natural, tier)))
            try:
                err = rel_err(run(), ref)
            except RuntimeError as exc:
                readings.append(f"{store} {list(shape)}: {exc}")
                continue
            torch.cuda.synchronize()
            # ~0.8 s a launch of the parent at 8186 = 2·4093
            slow = name == "parent" and shape[-1] == 8186
            ms, by_key, how = chip_smoke.device_ms(
                run, iters=1 if slow else 20, whole=True)
            points = re.numel()
            n1, n2 = planes._split_lanes(shape[-1])
            products = 3 if tier == "bf16x3" else 1
            bound = 16 * points / 3.35e12 * 1e3
            if tier == "bf16x3":
                bound = max(bound, ((8 * n2 + 6) / 67e12
                                    + 3 * 8 * n1 / 989e12) * points * 1e3)
            line = (f"{store} {list(shape)} {ms:.4f} ms ({how}; bound "
                    f"{bound:.4f}, {bound / ms:.2f} of it; cuFFT "
                    f"{library[store, shape]:.4f})")
            if name != "parent" and planes.bf16_wide(shape[-1]):
                product = sum(v for k, v in by_key.items()
                              if "gemm_rows_kernel" in k)
                floor = products * 8 * n1 * points / 989e12 * 1e3
                line += (f"; the tiled product {product:.4f}, tensor floor "
                         f"{floor:.4f} ({product / floor:.2f}x it)")
            readings.append(f"{line}, vs float64 {err:.3e}")
        print(f"[variants] {name} ({card_state()}):\n  "
              + "\n  ".join(readings), flush=True)
    for store, shape in SWEEP[tier] if args.sweep else ():
        natural = store == "natural"
        re = torch.randn(shape, device=dev, generator=gen)
        im = torch.randn(shape, device=dev, generator=gen)
        chosen = chosen_rows(*shape, natural, tier)
        cells = []
        for rows in (1, 2, 4, 8, 16):
            if planes.block_shared_bytes(tier, False, natural)(
                    rows, shape[2]) > planes.SMEM_LIMIT:
                continue
            ms = chip_smoke.device_ms(lambda: launch_new(
                libs["new"], re, im, natural, tier, rows), iters=20)[0]
            cells.append(f"R {rows}{'*' if rows == chosen else ''} "
                         f"{ms:.4f}")
        print(f"[sweep] {store} {list(shape)} ({card_state()}): "
              + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
