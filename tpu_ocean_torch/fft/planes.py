"""Inverse 2-D DFTs on (re, im) f32 planes: the full transform and the
half-spectrum (C2R) route, in two storage regimes.

JAX counterpart: ``tpu_ocean/fft/pallas_fft.py`` (``_fft1d_transposed``,
``fft1d_natural_large``, ``ifft2_planes_auto``, ``ifft2_planes_half``,
``_c2r_combine``, ``half_column_pass``, and ``ifft2_pallas``, the
``pallas`` backend on a complex tensor) and ``tpu_ocean/fft/matmul.py``
(``ifft1d_planes_axis2``). Two row-DFT kernels carry every pass:

- ``fft1d_transposed``: a row DFT whose output is stored transposed, so a
  second call transforms the columns and restores the orientation;
- ``fft1d_natural_large``: the same row DFT stored in natural order, the
  row pass of the large-N regime (N > ``MAX_TRANSPOSED_N``), which is
  followed by a column pass along axis −2 (``ifft1d_planes_axis2``).

On a CUDA tensor each launches its hand-written kernel
(``csrc/fft_rows.cu``) and nothing else; on a CPU tensor it runs its plain
version, at every length. The TPU package's size gates (Mosaic lane
rules, VMEM caps) have no counterpart here: on the card the kernels cover
every even N in [MIN_N, MAX_N] at every tier and form, fused or not
(``require_card_kernel``): powers of two on the kernels below; every other
even N at f32 in the direct form on the register-resident mixed-radix
passes of ``csrc/rows_mixed_passes_f32.cuh`` (plan ``passes_plan``, table
``passes_table``) and, fused, on ``csrc/fused_rows_mixed_f32.cuh``'s
mixed-radix stages (plan ``mixed_plan``, table ``mixed_table``), at bf16
and bf16x3 in the direct form on ``csrc/dft_bf16_rows_mixed.cuh`` (not
fused), at every other tier and form on the matrix-form engine behind
``csrc/rows_mixed_f32.cuh``'s and that fused kernel's loads and stores
(``matrix_tables``); a wrapper refuses odd N and N outside that range with
ValueError. Only the
regime switch is kept, as ``MAX_TRANSPOSED_N``, so that the port pairs
like with like against the JAX package.

Every transform takes a ``precision``, ``"float32"`` or ``"bfloat16"``
(``OceanConfig.precision``), which ``kernel_tier`` maps to the kernel's
tier as ``pallas_fft.kernel_precision`` does: ``bf16`` (one bf16 pass),
``f32``, or ``bf16x3`` for N above ``KERNEL_B3_THRESHOLD``. A transposed-
store pass takes the three-factor form (#1b, ``_fft_block_kernel_split3``)
where ``use_split3`` says so (N above ``THREE_FACTOR_THRESHOLD``). f32 in
the direct form (the "Stockham" tier and form below) runs the radix-2
Stockham stages with the transposed store, through a thread-block cluster
of ``transposed_cluster`` blocks (``csrc/stockham_rows_cluster.cuh``), and
register-resident radix-16 passes with the natural store
(``csrc/rows_natural_f32.cuh``, plan ``radix16_plan``, twiddles from
``radix16_twiddles``); the plain version of both is ``torch.fft``.
bf16 in the direct form runs a kernel of its own with
either store (``csrc/dft_bf16_rows.cuh``, tables from
``bf16_rows_tables``), and so does the three-factor form at f32
(``csrc/dft_split3_f32.cuh``, tables from ``matrix_tables``) and at
bf16x3 (``csrc/dft_split3_bf16x3.cuh``, tables from
``split3_bf16x3_tables``); bf16 three-factor runs the matrix-form engine
(``csrc/dft_matrix.cuh``). Those are the kernels at powers of two; at
every other even N, f32 in the direct form runs the mixed-radix passes
(``passes_rows``, ``passes_cluster``, ``passes_twiddles``), bf16 in the
direct form the bf16 row kernel's generalization
(``csrc/dft_bf16_rows_mixed.cuh``: where n1 ≤ 128 one launch, where
n1 = N/2 > 128 a stage-1 launch and a tiled tensor-core product,
``bf16_rows_launches``; the same ``bf16_rows_tables``,
``bf16_rows_shared_bytes`` and ``max_rows`` at every even N) and the
three-factor form the matrix-form engine (``mixed_rows``,
``matrix_tables``). bf16x3 in the direct form runs the same file's bf16x3
kernels at every even N, powers of two included, either store
(``bf16x3_rows_launches``, ``bf16x3_rows_tables``,
``bf16x3_rows_shared_bytes``). The bf16x3 tier keeps stage 1 at f32, as
the TPU kernels do. All but Stockham take their plain version from
``fft/matrix.py``.
Each launch counts once: a Stockham kernel's on its wrapper's
``launches``; any other row launch, and a fused launch outside the packed
set with 3 live fields, in ``named_launches`` under ``kernel_name`` (a
launch at a length that is not a power of two under ``mixed_kernel_name``:
the f32 mixed-radix row kernel's under ``MIXED_NAMES``, the fused one's under
``MIXED_FUSED_NAME``, the bf16 row kernel's under ``bf16_rows_launches``,
the matrix engine's there as e.g.
``matrix_rows_mixed_transposed[f32,split3]``; a bf16x3 direct launch at
any length under ``bf16x3_rows_launches``).

Both row DFTs are differentiable by the JAX package's linear-adjoint rule
(``pallas_fft._fft1d_transposed_diff``, ``_fft1d_natural_large_diff``):
the DFT matrix is symmetric, so the VJP is the same dispatch in the
opposite direction at the same precision, on the cotangents (swapped
around the transposed store). A wrapper enters its autograd.Function only
where ``needs_grad``; the backward's launches count like the forward's.
Everything else here is torch ops, which autograd differentiates itself.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from tpu_ocean_torch import _build
from tpu_ocean_torch.fft import matrix

#: transform lengths the row kernels take: even lengths in this range
#: (require_card_kernel). The upper end is where two shared-memory buffers
#: of one row plus the twiddle table still fit one block (the card's 227 KB).
MIN_N = 16
MAX_N = 8192
#: named_launches' names of the f32 mixed-radix row kernel, by store
MIXED_NAMES = {"rows_transposed": "fft_rows_mixed_transposed",
               "rows_natural": "fft_rows_mixed_natural"}
#: named_launches' names of the bf16 row kernel at lengths that are not
#: powers of two (csrc/dft_bf16_rows_mixed.cuh), by store: where n1 ≤ 128
#: one launch (BF16_MIXED_NAMES); where n1 = N/2 > 128 two, stage 1
#: (BF16_GEMM_PREP) and the tiled stage 2 with the store (BF16_GEMM_NAMES)
BF16_MIXED_NAMES = {"rows_transposed": "bf16_rows_mixed_transposed",
                    "rows_natural": "bf16_rows_mixed_natural"}
BF16_GEMM_PREP = "bf16_gemm_prep"
BF16_GEMM_NAMES = {"rows_transposed": "bf16_gemm_rows_transposed",
                   "rows_natural": "bf16_gemm_rows_natural"}
#: the same for the bf16x3 row kernel in the direct form at every even N
#: (csrc/dft_bf16_rows_mixed.cuh at tier bf16x3): where n1 ≤ 128 one launch
#: (BF16X3_NAMES); where n1 = N/2 > 128 stage 1 (BF16X3_GEMM_PREP) and the
#: tiled stage 2 with the store (BF16X3_GEMM_NAMES)
BF16X3_NAMES = {"rows_transposed": "bf16x3_rows_transposed",
                "rows_natural": "bf16x3_rows_natural"}
BF16X3_GEMM_PREP = "bf16x3_gemm_prep"
BF16X3_GEMM_NAMES = {"rows_transposed": "bf16x3_gemm_rows_transposed",
                     "rows_natural": "bf16x3_gemm_rows_natural"}
#: named_launches' name of the f32 fused mixed-radix kernel
#: (csrc/fused_rows_mixed_f32.cuh) by store ("transposed" or "natural")
#: and channel set ("packed3", "packed5" or "per_channel"), e.g.
#: "fused_mixed_transposed[packed3]"
MIXED_FUSED_NAME = "fused_mixed_{store}[{channel_set}]"
#: shared memory one block may use on the H100 (bytes)
SMEM_LIMIT = 232448
#: above this N both 2-D routes take the natural regime (natural-store row
#: pass, then a column pass along axis −2), the crossover of the JAX
#: package (``MAX_PALLAS_N``/``MAX_FUSED_N``, pallas_fft.py:308-309). Kept
#: as the JAX crossover until a measurement on the card moves it.
MAX_TRANSPOSED_N = 2048
#: the most rows a transposed-store block takes: R = 8 rows give 32-byte
#: runs in the transposed store
TRANSPOSED_MAX_ROWS = 8
#: the rows one thread-block cluster of the f32 transposed kernel
#: (csrc/stockham_rows_cluster.cuh) stores together, at least: K·R = 8 rows
#: give 32-byte runs where a block holds fewer. Swept on an H100 80GB HBM3
#: at 700 W (python3 chip_smoke.py --sweep-rows), [1, 4096, 4096]: at R = 1
#: K = 8 took 278.9 µs, K = 4 336.1; at R = 2 K = 4 366.2, K = 8 367.4;
#: [1, 4096, 2048] at R = 4: K = 2 154.8, K = 4 171.6
TRANSPOSED_CLUSTER_ROWS = 8
#: the most points (rows × N) a block of that kernel takes where 8 rows do
#: not fit one block (N ≥ 2048): in the same sweep, blocks of 4096 points,
#: two to an SM, in clusters of 8 / R were fastest at every such shape:
#: [1, 4096, 4096] 278.9 µs at R = 1 against 366.2 at R = 2 (one block an
#: SM), [1, 4096, 2048] 127.0 at R = 2 against 154.8 at R = 4
CLUSTER_BLOCK_POINTS = 4096
#: the cluster sizes that kernel takes (8: the card's portable limit)
CLUSTER_SIZES = (1, 2, 4, 8)
#: the most points (rows × N) a natural-store block of the fused kernels
#: and the matrix engine takes (max_rows). Its store is coalesced at any
#: R; swept on the H100 (python3 chip_smoke.py --sweep-rows) on the radix-2
#: row kernel that ran the f32 natural pass before the radix-16 one, the
#: fastest blocks held about 4096 points:
#: R = 4 at N = 1024, R = 2 at N = 2048, R = 1 at N = 4096
NATURAL_BLOCK_POINTS = 4096
#: the most points (rows × N) a block of the f32 natural-store row kernel
#: (csrc/rows_natural_f32.cuh, 16 points a thread) takes; the fused kernels
#: keep NATURAL_BLOCK_POINTS (max_rows). Swept on an H100 80GB HBM3 at
#: 700 W (python3 chip_smoke.py --sweep-rows): [1, 4096, 4096] 94.91 µs at
#: R = 1, 97.94 at R = 2; [1, 2048, 4096] 49.83 and 50.77; [1, 1024, 1024]
#: 5.79, 5.75, 5.83 and 6.30 µs at R = 1, 2, 4 and 8
RADIX16_BLOCK_POINTS = 4096
#: the most threads a block of that kernel has (radix16::kThreads)
RADIX16_MAX_THREADS = 512
#: the most points (rows × N) a block of the f32 fused natural-store
#: kernel (csrc/fused_rows_natural_f32.cuh, 16 points a thread, at most
#: RADIX16_MAX_THREADS threads) takes; the matrix engine's fused kernels
#: keep NATURAL_BLOCK_POINTS. Swept on an H100 80GB HBM3 at 700 W (python3
#: chip_smoke.py --sweep-rows), µs at R = 1 and 2: [4096, 4096] ch 0
#: 213.77, 231.51; C = 5 478.21, 566.84; C = 3 350.74, 406.00;
#: [2048, 4096] ch 1 113.25, 125.28
FUSED_NATURAL_BLOCK_POINTS = 4096
#: the most rows a block of the f32 fused transposed-store kernel
#: (csrc/fused_rows_transposed_f32.cuh, 16 points a thread, at most
#: RADIX16_MAX_THREADS threads) takes: R = 8 rows give 32-byte runs in
#: its transposed store, as TRANSPOSED_MAX_ROWS. Swept on an H100 80GB
#: HBM3 at 700 W (python3 chip_smoke.py --sweep-rows), µs at R = 1, 2, 4
#: and 8: [1024, 1024] ch 0 45.55, 27.90, 19.34, 14.88; C = 3 116.49,
#: 71.13, 48.24, 33.05; [512, 1024] ch 1 25.00, 17.11, 13.00, 12.65
FUSED_TRANSPOSED_MAX_ROWS = 8
#: the same for the bf16 row kernel's natural store: swept on the H100,
#: [1, 4096, 4096] took 200.6, 173.1 and 209.1 µs at R = 1, 2 and 4 (two
#: blocks of 8192 points fit an SM's shared memory, 100 KB each, though at
#: 114 registers a thread of 512 one block runs on an SM at a time). The
#: bf16 fused natural kernel, which runs the same stages, takes it too: on
#: an H100 80GB HBM3 at 700 W (python3 chip_smoke.py --sweep-rows),
#: [4096, 4096] ch 0 292.67, 288.19 and 317.97 µs at R = 1, 2 and 4;
#: [2048, 4096] ch 1 153.91, 156.41 and 164.43; C = 5 1368.92, 1285.14
#: and 1469.07
BF16_NATURAL_BLOCK_POINTS = 8192


#: grid sides STRICTLY ABOVE this run the f32 tier as bf16x3 (hi + lo
#: bf16 parts, three products): pallas_fft.KERNEL_B3_THRESHOLD, off by
#: default as in the JAX package
KERNEL_B3_THRESHOLD = 1 << 30
#: grid sides STRICTLY ABOVE this (with n1 = 128) run stage 2 of a
#: transposed-store pass as 128 = 8·16: pallas_fft.THREE_FACTOR_THRESHOLD,
#: off by default as in the JAX package
THREE_FACTOR_THRESHOLD = 1 << 30
_SPLIT_W, _SPLIT_U = matrix._SPLIT_W, matrix._SPLIT_U
#: the kernels' tier codes (csrc/dft_matrix.cuh Tier)
TIERS = {"f32": 0, "bf16": 1, "bf16x3": 2}
PRECISIONS = ("float32", "bfloat16")


def kernel_tier(n: int, precision: str = "float32") -> str:
    """The kernel tier of a length-``n`` pass at ``precision`` (the
    counterpart of pallas_fft.kernel_precision): "bf16" for "bfloat16";
    for "float32", "bf16x3" above KERNEL_B3_THRESHOLD, else "f32"."""
    if precision == "bfloat16":
        return "bf16"
    if precision != "float32":
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return "bf16x3" if n > KERNEL_B3_THRESHOLD else "f32"


def use_split3(n: int, n1: int) -> bool:
    """The three-factor form of a transposed-store pass (pallas_fft.
    _use_split3)."""
    return n > THREE_FACTOR_THRESHOLD and n1 == _SPLIT_W * _SPLIT_U


def _split_lanes(n: int):
    """(n1, n2) with n = n2·n1; n1 = 128 when 128 divides n, else the
    largest divisor ≤ n/2 (pallas_fft._split_lanes)."""
    if n % 128 == 0:
        return 128, n // 128
    n1 = n // 2
    while n1 > 1 and n % n1 != 0:
        n1 -= 1
    return n1, n // n1


#: above this n1 (n = 2·n1 where 128 does not divide n) F1 is large: n1²
#: complex f32, 134 MB at n1 = 4095, built from twice that in float64
LARGE_N1 = 1024


def _cached_by_n1(fn):
    """``fn(n, ...)`` cached by its arguments: 32 entries, and apart from
    them 2 whose n has n1 above LARGE_N1, so that the cache never holds
    more than two of the large tables (a direction's pair at one n)."""
    small = functools.lru_cache(maxsize=32)(fn)
    large = functools.lru_cache(maxsize=2)(fn)

    @functools.wraps(fn)
    def cached(n, *args):
        return (large if _split_lanes(n)[0] > LARGE_N1 else small)(n, *args)

    def cache_clear():
        small.cache_clear()
        large.cache_clear()
    cached.cache_clear = cache_clear
    return cached


@_cached_by_n1
def _tables_np(n: int, inverse: bool):
    """(n1, n2, F2 re/im [n2, n2], T re/im [n2, n1], F1 re/im [n1, n1]),
    f32 from float64 (pallas_fft._tables_np)."""
    n1, n2 = _split_lanes(n)
    sign = +1.0 if inverse else -1.0
    w1 = np.exp(sign * 2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(sign * 2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    f32 = np.float32
    return (n1, n2,
            w2.real.astype(f32), w2.imag.astype(f32),
            tw.real.astype(f32), tw.imag.astype(f32),
            w1.real.astype(f32), w1.imag.astype(f32))


@functools.lru_cache(maxsize=8)
def _split3_tables_np(n1: int, inverse: bool):
    """(F_W, TW, F_U) re/im, f32 from float64, for stage 2 of the
    three-factor form: F1[a·W + b, w·U + u] = F_U[a, u]·TW[b, u]·F_W[b, w]
    with TW[b, u] = e^{±2πi·u·b/n1} (pallas_fft._split3_tables_np)."""
    assert n1 == _SPLIT_W * _SPLIT_U
    sign = +1.0 if inverse else -1.0
    w, u = _SPLIT_W, _SPLIT_U
    fw = np.exp(sign * 2j * np.pi * np.outer(np.arange(w), np.arange(w)) / w)
    fu = np.exp(sign * 2j * np.pi * np.outer(np.arange(u), np.arange(u)) / u)
    tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(w), np.arange(u)) / n1)
    f32 = np.float32
    return (fw.real.astype(f32), fw.imag.astype(f32),
            tw.real.astype(f32), tw.imag.astype(f32),
            fu.real.astype(f32), fu.imag.astype(f32))


def engine(n: int, precision: str, transposed: bool):
    """(tier, split3) of a length-``n`` row pass with the transposed store
    or, with ``transposed=False``, the natural store (no three-factor
    form there, as in the JAX package)."""
    return (kernel_tier(n, precision),
            transposed and use_split3(n, _split_lanes(n)[0]))


def kernel_name(kind: str, tier: str, split3: bool,
                channel_set: str = "") -> str:
    """A launch's name in named_launches: entry × tier × form (× the fused
    kernels' channel set), e.g. "matrix_rows_transposed[bf16]",
    "matrix_fused_transposed[f32,split3,packed5]", or for the f32 Stockham
    kernel "fused_transposed[per_channel]"."""
    stockham = _stockham(tier, split3)
    tags = ([] if stockham else [tier] + ["split3"] * split3) + (
        [channel_set] if channel_set else [])
    return f"{'' if stockham else 'matrix_'}{kind}[{','.join(tags)}]"


#: launches since the last clear() that do not count on a wrapper's own
#: ``launches``, by kernel_name (CPU calls do not count)
named_launches = collections.Counter()


def _stockham(tier: str, split3: bool) -> bool:
    """f32 direct: the passes that run the port's own f32 kernels, which
    count under the plain launch names (kernel_name). As fused passes
    they run the radix-16 passes behind one read of the five planes for
    every channel: the natural store csrc/fused_rows_natural_f32.cuh, the
    transposed store csrc/fused_rows_transposed_f32.cuh. Every fused pass
    but those and _fused_bf16's runs fused_rows_kernel (csrc/fused_rows.cu)
    on the matrix engine."""
    return tier == "f32" and not split3


def _bf16_rows(tier: str, split3: bool) -> bool:
    """The passes, either store, that run the bf16 row kernel instead of
    the matrix engine: csrc/dft_bf16_rows.cuh at powers of two,
    csrc/dft_bf16_rows_mixed.cuh at every other even N."""
    return tier == "bf16" and not split3


def _bf16x3_rows(tier: str, split3: bool) -> bool:
    """The passes, either store, that run the bf16x3 row kernel in the
    direct form (csrc/dft_bf16_rows_mixed.cuh at tier bf16x3) at every
    even N."""
    return tier == "bf16x3" and not split3


def bf16_wide(n: int) -> bool:
    """Regime 2 of the bf16 row kernel: n1 = N/2 > 128 (every even N above
    256 that 128 does not divide), where csrc/dft_bf16_rows_mixed.cuh runs
    stage 1 in a launch of its own and stage 2 as a tiled product over the
    whole batch; elsewhere (n1 ≤ 128) one launch of R rows a block."""
    return _split_lanes(n)[0] > 128


def bf16_rows_launches(n: int, natural: bool):
    """The named_launches names of one bf16 row pass at length n, in launch
    order: the power-of-two kernel's kernel_name, BF16_MIXED_NAMES' where
    n1 ≤ 128, BF16_GEMM_PREP then BF16_GEMM_NAMES' where n1 = N/2 > 128."""
    kind = "rows_natural" if natural else "rows_transposed"
    if is_power_of_two(n):
        return [kernel_name(kind, "bf16", False)]
    if bf16_wide(n):
        return [BF16_GEMM_PREP, BF16_GEMM_NAMES[kind]]
    return [BF16_MIXED_NAMES[kind]]


def bf16x3_rows_launches(n: int, natural: bool):
    """The named_launches names of one bf16x3 row pass in the direct form
    at length n, in launch order: BF16X3_NAMES' where n1 ≤ 128,
    BF16X3_GEMM_PREP then BF16X3_GEMM_NAMES' where n1 = N/2 > 128."""
    kind = "rows_natural" if natural else "rows_transposed"
    if bf16_wide(n):
        return [BF16X3_GEMM_PREP, BF16X3_GEMM_NAMES[kind]]
    return [BF16X3_NAMES[kind]]


def direct_rows_launches(n: int, natural: bool, tier: str):
    """The named_launches names of one row pass at (n, tier) in the direct
    form on the bf16 or bf16x3 row kernel (bf16_rows_launches,
    bf16x3_rows_launches)."""
    return (bf16x3_rows_launches(n, natural) if tier == "bf16x3"
            else bf16_rows_launches(n, natural))


def _split3_rows(tier: str, split3: bool) -> bool:
    """The pass that runs the f32 three-factor row kernel
    (csrc/dft_split3_f32.cuh) instead of the matrix engine (the
    three-factor form has the transposed store only)."""
    return tier == "f32" and split3


def _fused_bf16(tier: str, split3: bool, natural: bool) -> bool:
    """The fused pass that runs the bf16 fused natural-store kernel
    (csrc/fused_rows_natural_bf16.cuh, the bf16 row kernel's stages behind
    the assembly): bf16 direct, natural store."""
    return natural and _bf16_rows(tier, split3)


def _split3_bf16x3_rows(tier: str, split3: bool) -> bool:
    """The pass that runs the bf16x3 three-factor row kernel
    (csrc/dft_split3_bf16x3.cuh) instead of the matrix engine (the
    transposed store only, as _split3_rows)."""
    return tier == "bf16x3" and split3


@_cached_by_n1
def matrix_tables(n: int, inverse: bool, split3: bool,
                  device: torch.device) -> torch.Tensor:
    """The matrix engine's tables as one [L, 2] f32 (re, im) tensor, in the
    order csrc/dft_matrix.cuh reads them: F2, T, then F1 or F_W, TW, F_U."""
    n1, _, *mats = _tables_np(n, inverse)
    if split3:
        mats = mats[:4] + list(_split3_tables_np(n1, inverse))
    pairs = [np.stack([r.ravel(), i.ravel()], axis=-1)
             for r, i in zip(mats[::2], mats[1::2])]
    return torch.from_numpy(np.concatenate(pairs)).to(device)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → the bits of the nearest bfloat16 (ties to even), uint16: the
    rounding of matrix.round_bf16 and of the kernels' __float2bfloat16_rn."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def mma_a_fragments(fr: np.ndarray, fi: np.ndarray) -> np.ndarray:
    """The complex table F = fr + i·fi [m, k] in its real form [[Fr, −Fi],
    [Fi, Fr]], rounded to bf16 and laid out as mma.sync.m16n8k16's A
    fragments, zero-padded to whole tiles: uint32 [mt, kt, 32, 4], tile
    (tm, kb), lane (g, q) = (lane // 4, lane % 4), each register two bf16,
    the first in the low half. A tile's 16 rows are re and im of outputs
    i = 8·tm + g; its 16 depth columns are re and im of k_h = 8·kb + 2q + h
    (h = 0 in registers 0-1, h = 1 in 2-3), so a lane's two depths are
    adjacent and its B fragment is one 64-bit load:
      reg 0 (row g,     cols 2q, 2q+1)   = (Fr[i, k_0], −Fi[i, k_0])
      reg 1 (row g + 8, cols 2q, 2q+1)   = (Fi[i, k_0],  Fr[i, k_0])
      reg 2 (row g,     cols 2q+8, 2q+9) = (Fr[i, k_1], −Fi[i, k_1])
      reg 3 (row g + 8, cols 2q+8, 2q+9) = (Fi[i, k_1],  Fr[i, k_1])"""
    m, k = fr.shape
    mt, kt = -(-m // 8), -(-k // 8)
    shape = ((0, 8 * mt - m), (0, 8 * kt - k))
    fr, fi = np.pad(fr, shape), np.pad(fi, shape)
    br, bi, nbi = (_bf16_bits(a).astype(np.uint32) for a in (fr, fi, -fi))
    lane = np.arange(32)
    i = 8 * np.arange(mt)[:, None, None] + lane // 4          # [mt, 1, 32]
    k0 = 8 * np.arange(kt)[None, :, None] + 2 * (lane % 4)    # [1, kt, 32]
    regs = [low[i, kk] | (high[i, kk] << 16)
            for kk in (k0, k0 + 1) for low, high in ((br, nbi), (bi, br))]
    return np.stack(regs, axis=-1)


def mma_a_fragments_split(fr: np.ndarray, fi: np.ndarray):
    """The hi/lo twin of mma_a_fragments: (hi, lo) uint32 [mt, kt, 32, 4],
    hi the fragments of bf16(F) and lo those of bf16(F − hi), each part
    rounded to nearest even (matrix.split_bf16): the bf16x3 split of the
    real form, since the split of −Fi is −(the split of Fi)."""
    hr, hi_ = (_bf16_value(a) for a in (fr, fi))
    return (mma_a_fragments(hr, hi_),
            mma_a_fragments(fr - hr, fi - hi_))


def _bf16_value(x: np.ndarray) -> np.ndarray:
    """f32 → the nearest bfloat16 (ties to even), as f32 values."""
    return (_bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


@functools.lru_cache(maxsize=32)
def split3_bf16x3_tables_np(n: int, inverse: bool) -> np.ndarray:
    """The bf16x3 three-factor row kernel's tables as one int32 array, in
    the order csrc/dft_split3_bf16x3.cuh reads them: matrix_tables(n,
    inverse, True) (F2, T, F_W, TW, F_U as f32 (re, im) pairs), zero-padded
    to a 16-byte boundary, then the A fragments (mma_a_fragments_split) of
    F_W hi, F_W lo, F_U hi, F_U lo."""
    f32 = matrix_tables(n, inverse, True, torch.device("cpu")).numpy()
    f32 = np.pad(f32.view(np.uint32).ravel(), (0, -f32.size % 4))
    fwr, fwi, _, _, fur, fui = _split3_tables_np(_split_lanes(n)[0], inverse)
    frags = [f.ravel() for tab in (mma_a_fragments_split(fwr, fwi),
                                   mma_a_fragments_split(fur, fui))
             for f in tab]
    return np.concatenate([f32, *frags]).view(np.int32)


@functools.lru_cache(maxsize=32)
def split3_bf16x3_tables(n: int, inverse: bool,
                         device: torch.device) -> torch.Tensor:
    return torch.from_numpy(split3_bf16x3_tables_np(n, inverse)).to(device)


#: the tiled stage 2 of the bf16 row kernel where n1 = N/2 > 128
#: (csrc/dft_bf16_rows_mixed.cuh bf16_gemm): k1 a block tile, complex depth
#: a chunk, and a block's shared memory (3 stages of 64 + 64 rows of 40
#: words; the 64 × 66 float2 result tile fits in them)
BF16_GEMM_TILE, BF16_GEMM_CHUNK = 64, 32
BF16_GEMM_SHARED = 3 * (64 + 64) * 40 * 4


def bf16_gemm_depth(n1: int) -> int:
    """Words a row of F1's table and of the stage-1 buffer X′: n1 complex
    bf16 pairs in whole chunks, zero past n1 (bf16_gemm::depth_words)."""
    return -(-n1 // BF16_GEMM_CHUNK) * BF16_GEMM_CHUNK


def bf16_gemm_rows(n1: int) -> int:
    """Rows of F1's table: n1 in whole k1 tiles, zero past n1
    (bf16_gemm::table_rows)."""
    return -(-n1 // BF16_GEMM_TILE) * BF16_GEMM_TILE


def bf16_rows_scratch_words(c: int, m: int, n: int) -> int:
    """32-bit words of the device buffer a bf16 row pass of [c, m, n]
    needs: X′, a row of bf16_gemm_depth(n1) pairs for each (row, k2), where
    n1 = N/2 > 128 (bf16_wide); none elsewhere."""
    if not bf16_wide(n):
        return 0
    return c * m * 2 * bf16_gemm_depth(_split_lanes(n)[0])


@_cached_by_n1
def bf16_rows_tables_np(n: int, inverse: bool) -> np.ndarray:
    """The bf16 row kernel's tables as one int32 array, from the f32 tables
    of _tables_np, in the order the kernel reads them. Where n1 ≤ 128
    (csrc/dft_bf16_rows.cuh, csrc/dft_bf16_rows_mixed.cuh's regime 1): F2's
    A fragments, T as f32 (re, im) pairs [n2, n1], F1's A fragments
    (mma_a_fragments; depths and outputs padded with zeros to whole tiles
    of 8). Where n1 = N/2 > 128 (regime 2): F1 as complex bf16 pairs, the
    bits of bf16(re) in the low half and of bf16(im) in the high half,
    [bf16_gemm_rows(n1), bf16_gemm_depth(n1)], zero-padded; then T[1, ·]
    as n1 f32 pairs (T[0, ·] is 1)."""
    _, _, f2r, f2i, tr, ti, f1r, f1i = _tables_np(n, inverse)
    if bf16_wide(n):
        n1 = f1r.shape[0]
        f1 = np.zeros((bf16_gemm_rows(n1), bf16_gemm_depth(n1)), np.uint32)
        f1[:n1, :n1] = (_bf16_bits(f1r).astype(np.uint32)
                        | _bf16_bits(f1i).astype(np.uint32) << 16)
        t1 = np.stack([tr[1], ti[1]], axis=-1).view(np.uint32)
        return np.concatenate([f1.ravel(), t1.ravel()]).view(np.int32)
    t = np.stack([tr.ravel(), ti.ravel()], axis=-1).view(np.uint32)
    return np.concatenate([mma_a_fragments(f2r, f2i).ravel(), t.ravel(),
                           mma_a_fragments(f1r, f1i).ravel()]).view(np.int32)


@_cached_by_n1
def bf16_rows_tables(n: int, inverse: bool,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bf16_rows_tables_np(n, inverse)).to(device)


#: the tiled stage 2 of the bf16x3 row kernel: each operand's hi and lo
#: rows a stage, twice the bf16 block (bf16_gemm::kSmemBytesBf16x3)
BF16X3_GEMM_SHARED = 2 * BF16_GEMM_SHARED


def bf16x3_f2_rows(n2: int) -> int:
    """Rows of F2 in the bf16x3 table where n1 ≤ 128: whole shares of 16,
    zero past n2 (bf16_mixed::b3_f2_rows)."""
    return -(-n2 // 16) * 16


def bf16x3_rows_scratch_words(c: int, m: int, n: int) -> int:
    """32-bit words of the device buffer a bf16x3 row pass of [c, m, n]
    needs: X′'s hi and lo planes, twice bf16_rows_scratch_words, where
    n1 = N/2 > 128; none elsewhere."""
    return 2 * bf16_rows_scratch_words(c, m, n)


def _bf16_pairs(re_: np.ndarray, im_: np.ndarray, rows: int,
                cols: int) -> np.ndarray:
    """Complex bf16 pairs (the bits of bf16(re) low, of bf16(im) high),
    uint32 [rows, cols], zero past the table."""
    out = np.zeros((rows, cols), np.uint32)
    out[:re_.shape[0], :re_.shape[1]] = (
        _bf16_bits(re_).astype(np.uint32)
        | _bf16_bits(im_).astype(np.uint32) << 16)
    return out


@_cached_by_n1
def bf16x3_rows_tables_np(n: int, inverse: bool) -> np.ndarray:
    """The bf16x3 row kernel's tables (the direct form) as one int32
    array, from the f32 tables of _tables_np, in the order the kernel
    reads them. Where n1 ≤ 128: F2 as f32 (re, im) pairs [bf16x3_f2_rows
    (n2), n2] (zero rows past n2), T as f32 pairs [n2, n1], then F1's hi
    A fragments and its lo part as the complex bf16 pairs of its lo
    fragments (mma_a_fragments_split) in the same order, a lane's two
    depths (registers 1 and 3, (Fi, Fr), their halves swapped to (Fr, Fi))
    a uint32 pair: [mt, kt, 32, 2]. Where n1 = N/2 > 128: F1's
    hi and lo parts (matrix.split_bf16) each as complex bf16 pairs
    [bf16_gemm_rows(n1), bf16_gemm_depth(n1)], zero-padded, then T[1, ·] as
    n1 f32 pairs, then F2 [2, 2] as f32 pairs."""
    _, _, f2r, f2i, tr, ti, f1r, f1i = _tables_np(n, inverse)
    f2 = np.stack([f2r, f2i], axis=-1)
    if bf16_wide(n):
        n1 = f1r.shape[0]
        rows, ldk = bf16_gemm_rows(n1), bf16_gemm_depth(n1)
        hr, hi_ = _bf16_value(f1r), _bf16_value(f1i)
        t1 = np.stack([tr[1], ti[1]], axis=-1)
        return np.concatenate([
            _bf16_pairs(hr, hi_, rows, ldk).ravel(),
            _bf16_pairs(f1r - hr, f1i - hi_, rows, ldk).ravel(),
            t1.view(np.uint32).ravel(), f2.view(np.uint32).ravel()
        ]).view(np.int32)
    n2 = f2r.shape[0]
    f2 = np.pad(f2, ((0, bf16x3_f2_rows(n2) - n2), (0, 0), (0, 0)))
    t = np.stack([tr, ti], axis=-1)
    hi, lo = mma_a_fragments_split(f1r, f1i)
    pairs = lo[..., 1::2]
    pairs = (pairs >> 16) | (pairs << 16)
    return np.concatenate([f2.view(np.uint32).ravel(),
                           t.view(np.uint32).ravel(), hi.ravel(),
                           pairs.ravel()]).view(np.int32)


@_cached_by_n1
def bf16x3_rows_tables(n: int, inverse: bool,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bf16x3_rows_tables_np(n, inverse)).to(device)


def rows_plain(re, im, inverse: bool, tier: str, split3: bool):
    """Row DFT along the last axis of (re, im) [C, M, N], natural order, as
    the kernel at (tier, split3) computes it: torch.fft for the Stockham
    kernel (f32 direct), else the matrix engine's plain version."""
    if _stockham(tier, split3):
        f = _fft_plain(re, im, inverse)
        return f.real, f.imag
    n = re.shape[-1]
    split3_tables = (_split3_tables_np(_split_lanes(n)[0], bool(inverse))
                     if split3 else None)
    return matrix.rows_dft(re, im, _tables_np(n, bool(inverse)),
                           split3_tables, tier)


def is_power_of_two(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def require_card_kernel(n: int, tier: str = "f32", split3: bool = False,
                        fused: bool = False) -> None:
    """Raise ValueError unless the card has a kernel for a length-``n``
    row pass at (tier, split3), fused (#5, #5b, #6) or not: every even
    length in [MIN_N, MAX_N] at every tier and form. Powers of two run the
    kernels of csrc/fft_rows.cu and csrc/fused_rows.cu; every other even
    length at f32 in the direct form the mixed-radix passes
    (csrc/rows_mixed_passes_f32.cuh) and the fused mixed-radix kernel
    (csrc/fused_rows_mixed_f32.cuh), at the other tiers and forms the
    matrix engine behind csrc/rows_mixed_f32.cuh's and that fused kernel's
    loads and stores. The three-factor form needs n1 = 128 (use_split3 gives it no
    other)."""
    what = (f"{'fused ' if fused else ''}row DFT of length {n} at tier "
            f"{tier}{', three-factor form' if split3 else ''}")
    if not (MIN_N <= n <= MAX_N and n % 2 == 0):
        raise ValueError(f"no kernel on the card for a {what}: the row-DFT "
                         f"kernels take even lengths in [{MIN_N}, {MAX_N}]")
    if split3 and _split_lanes(n)[0] != _SPLIT_W * _SPLIT_U:
        raise ValueError(f"no kernel on the card for a {what}: the "
                         f"three-factor form needs 128 | n (n1 = 128)")


def check_card_sizes(n: int, precision: str = "float32", fused: bool = False,
                     half: bool = False) -> None:
    """Raise ValueError (require_card_kernel) unless the card has a kernel
    for every row pass of an N² transform at ``precision``: the length-n
    passes (fused or not; each 2-D transform has a transposed-store pass,
    the only store with a three-factor form) and, with ``half``, the half
    channel's length-n/2 column pass."""
    lengths = [(n, fused)] + ([(n // 2, False)] if half else [])
    for length, f in lengths:
        tier, split3 = engine(length, precision, transposed=True)
        require_card_kernel(length, tier, split3, f)


def matrix_mixed_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the matrix engine behind the
    mixed-radix kernels' loads and stores (csrc/dft_matrix.cuh
    matrix_smem_bytes), row or fused: two buffers of ``rows`` rows of
    n + 1 complex values and no table, which the engine reads from device
    memory. At n = 8190, one row: 131 KB."""
    return 2 * rows * (n + 1) * 8


def shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one row-DFT block (csrc/stockham.cuh):
    two buffers of ``rows`` rows of n + 1 complex values, and n − 1
    twiddles. The fused kernels use the same."""
    return (2 * rows * (n + 1) + n - 1) * 8


def bf16_rows_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the bf16 row kernel at any
    even n, either store. Where n1 ≤ 128 (csrc/dft_bf16_rows.cuh at powers
    of two, csrc/dft_bf16_rows_mixed.cuh's regime 1 elsewhere): the rows as
    bf16 pairs at n1p + 4 words an s-row (n1p: n1 in whole tiles of 8),
    aliased by the f32 result (n + 1 complex a row), then the bf16
    intermediate at n1p + 8 words a (row, k2), + 8 more where n1p is an
    odd multiple of 8 at a length that is not a power of two. Where
    n1 = N/2 > 128 the tiled stage 2's block, whatever ``rows``
    (BF16_GEMM_SHARED)."""
    if bf16_wide(n):
        return BF16_GEMM_SHARED
    n1, n2 = _split_lanes(n)
    n1p = -(-n1 // 8) * 8
    ys = n1p + 8 + (0 if is_power_of_two(n) else n1p & 8)
    rows_in = rows * n2 * (n1p + 4) * 4
    rows_out = -(-rows * (n + 1) * 8 // 16) * 16
    return max(rows_in, rows_out) + rows * n2 * ys * 4


def bf16x3_rows_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the bf16x3 row kernel in the
    direct form, either store. Where n1 ≤ 128 (bf16_mixed::
    b3_shared_bytes): the rows as complex f32, aliased by the f32 result
    (n + 1 complex a row, whole 16 bytes), C ⊙ T's hi and lo planes at
    n1p + 8 + (n1p & 8) words a (row, k2) (n1p: n1 in whole tiles of 8),
    F1's lo part as n1p² complex bf16 pairs (F2 there during stage 1).
    Where n1 = N/2 > 128 the tiled stage 2's block, whatever ``rows``
    (BF16X3_GEMM_SHARED)."""
    if bf16_wide(n):
        return BF16X3_GEMM_SHARED
    n1, n2 = _split_lanes(n)
    n1p = -(-n1 // 8) * 8
    ys = n1p + 8 + (n1p & 8)
    return (-(-rows * (n + 1) * 8 // 16) * 16 + 2 * rows * n2 * ys * 4
            + n1p * n1p * 4)


def split3_rows_geometry(n: int) -> dict:
    """The padded layout of the f32 three-factor row kernel
    (csrc/dft_split3_f32.cuh Geometry), in complex (8-byte) units: n2, the
    odd step P of u and the step Sb of b in the stage-2 buffer, the row
    strides SA (rows, then B ⊙ TW) and SY (C ⊙ T, then the result), and
    K1, the stage-1 outputs one thread computes at a time."""
    n2 = n // 128
    p = n2 | 1
    sb = 16 * p + (n2 if n2 < 16 else 0)
    return dict(n2=n2, P=p, Sb=sb, SA=max(n, 8 * sb), SY=n + 1,
                K1=min(n2, 16))


def split3_rows_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the f32 three-factor row
    kernel: the two row buffers and F2, F_W, TW, F_U (n2² + 448 complex)."""
    g = split3_rows_geometry(n)
    return 8 * (rows * (g["SA"] + g["SY"]) + g["n2"] ** 2
                + _SPLIT_W * _SPLIT_W + _SPLIT_W * _SPLIT_U
                + _SPLIT_U * _SPLIT_U)


def split3_bf16x3_geometry(n: int, rows: int) -> dict:
    """The layout of the bf16x3 three-factor row kernel
    (csrc/dft_split3_bf16x3.cuh Geometry) for ``rows`` rows a block: n2;
    pad, the pad columns a b in H2 (1 where n2·rows ≥ 4); the 32-bit
    words of one plane (hi or lo) of H1 (C ⊙ T, rows·n) and of H2
    (B ⊙ TW, (8·n2·rows + 8·pad)·16); and f32_words, the table's complex
    f32 part in words before its fragments (matrix_tables, padded to 16
    bytes)."""
    n2 = n // 128
    pad = 1 if n2 * rows >= 4 else 0
    return dict(n2=n2, pad=pad, h1_words=rows * n,
                h2_words=(8 * n2 * rows + 8 * pad) * 16,
                f32_words=-(-2 * (n2 * n2 + n + 448) // 4) * 4)


def split3_bf16x3_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the bf16x3 three-factor row
    kernel: the rows (f32, later H2's two planes), H1's two planes and F2
    (n2² complex): 8·(2·rows·n + 128·pad + n2²)."""
    g = split3_bf16x3_geometry(n, rows)
    return 8 * (g["h2_words"] + g["h1_words"] + g["n2"] ** 2)


def cluster_gather_stride(kr: int, w: int) -> int:
    """Row stride, in complex units, of the tile of ``kr`` rows of ``w``
    columns that a block of the f32 transposed kernel gathers
    (csrc/stockham_rows_cluster.cuh gather_stride): the least S ≥ w with
    S ≡ 16/kr (mod 16), odd from kr = 16 on, so that its half-warp reads of
    kr rows at 16/kr consecutive columns meet no bank conflict."""
    want = 1 if kr >= 16 else (16 // kr) & 15
    return w + ((want - w) & 15)


def cluster_rows_shared_bytes(rows: int, n: int, k: int) -> int:
    """Dynamic shared memory of one block of the f32 transposed kernel
    with ``k`` blocks a cluster (cluster_smem_bytes): the stages' two
    buffers and twiddles (shared_bytes), or the result buffer and the
    gathered tile of k·rows rows of n/k columns (none at k = 1, which
    stores from its result), whichever is more."""
    if k == 1:
        return shared_bytes(rows, n)
    gathered = rows * (n + 1) + k * rows * cluster_gather_stride(k * rows,
                                                                  n // k)
    return max(shared_bytes(rows, n), 8 * gathered)


def cluster_rows_block_bytes(rows: int, n: int) -> int:
    """The most shared memory a block of ``rows`` rows of the f32
    transposed kernel takes at any cluster size."""
    return max(cluster_rows_shared_bytes(rows, n, k) for k in CLUSTER_SIZES)


def cluster_max_rows(n: int) -> int:
    """The most rows per block of the f32 transposed kernel:
    TRANSPOSED_MAX_ROWS where that many rows fit one block (N ≤ 1024: the
    block stores whole sectors alone, K = 1), else CLUSTER_BLOCK_POINTS // n
    (R = 2 at N = 2048, 1 from N = 4096), which a cluster makes up to
    TRANSPOSED_CLUSTER_ROWS rows. (The fused kernels keep max_rows.)"""
    if shared_bytes(TRANSPOSED_MAX_ROWS, n) <= SMEM_LIMIT:
        return TRANSPOSED_MAX_ROWS
    return max(1, CLUSTER_BLOCK_POINTS // n)


def transposed_cluster(m: int, n: int, rows: int) -> int:
    """Blocks a cluster of the f32 transposed kernel for M rows of length
    ``n`` at ``rows`` rows a block: the smallest power of two K with K·rows
    ≥ TRANSPOSED_CLUSTER_ROWS, at most 8, at most n/16 (each block's
    column range n/K keeps 16 columns, which the tile's bank arithmetic
    assumes) and at most ⌈M/rows⌉, rounded down to a power of two. K = 8
    at [*, 4096, 4096] (rows 1), 4 at [1, 4096, 2048] (rows 2), 2 at
    [1, 512, 1024] (rows 4), 1 at rows 8 and for the one-row Nyquist
    pass."""
    cap = min(CLUSTER_SIZES[-1], n // 16, -(-m // rows))
    k = 1
    while k * rows < TRANSPOSED_CLUSTER_ROWS and 2 * k <= cap:
        k *= 2
    return k


def radix16_plan(n: int):
    """The passes of the f32 natural-store row kernel
    (csrc/rows_natural_f32.cuh Plan) for a length ``n`` = 16^a · r, r in
    1, 2, 4, 8: [(radix, span)], one radix-r pass (radix 16 where r = 1)
    at span 1, then radix-16 passes at spans r, 16·r, …, n/16."""
    if not (MIN_N <= n <= MAX_N and is_power_of_two(n)):
        raise ValueError(f"radix16_plan: a power of two in [{MIN_N}, "
                         f"{MAX_N}], got {n}")
    log2n = n.bit_length() - 1
    first = 1 << (log2n % 4 or 4)
    passes, span = [(first, 1)], first
    while span < n:
        passes.append((16, span))
        span *= 16
    return passes


def radix16_pad(n: int) -> int:
    """That kernel's exchange buffer holds point a of a row at
    a + a // P, one pad every P = min(n/16, 16) points (Plan::pad)."""
    return min(n // 16, 16)


def radix16_stride(n: int) -> int:
    """Row stride, in complex units, of that kernel's exchange buffer
    (Plan::S): n + n/P, plus the n/16 threads of a row where they are
    fewer than 16 (rows then share a half warp)."""
    t = n // 16
    return n + n // radix16_pad(n) + (t if t < 16 else 0)


def radix16_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the f32 natural-store row
    kernel (radix16::shared_bytes): one exchange buffer of ``rows`` rows
    of radix16_stride(n) complex values; none at n = 16 (one pass)."""
    return 0 if n == 16 else rows * radix16_stride(n) * 8


def radix16_max_rows(n: int) -> int:
    """The most rows per block of the f32 natural-store row kernel:
    RADIX16_BLOCK_POINTS // n, at most RADIX16_MAX_THREADS threads of 16
    points (the fused kernels keep max_rows)."""
    points = min(RADIX16_BLOCK_POINTS, 16 * RADIX16_MAX_THREADS)
    return max(1, points // n)


@functools.lru_cache(maxsize=32)
def radix16_twiddles_np(n: int, inverse: bool) -> np.ndarray:
    """That kernel's table, [n − r + 1, 2] f32 (re, im), r the first
    pass's radix: entry 0 is (0, ±1), the direction; then each pass after
    the first (radix 16, span ns) has e^{±2πi s·k/(16·ns)} for s = 1..15,
    k < ns at 1 + (ns − r) + (s − 1)·ns + k; built in float64."""
    sign = 1.0 if inverse else -1.0
    parts = [np.array([sign * 1j])]
    for _, span in radix16_plan(n)[1:]:
        sk = np.outer(np.arange(1, 16), np.arange(span))
        parts.append(np.exp(sign * 2j * np.pi * sk / (16 * span)).ravel())
    w = np.concatenate(parts)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def radix16_twiddles(n: int, inverse: bool,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(radix16_twiddles_np(n, inverse)).to(device)


@functools.lru_cache(maxsize=64)
def mixed_plan(n: int):
    """The stages of the f32 fused mixed-radix kernel
    (csrc/fused_rows_mixed_f32.cuh on csrc/rows_mixed_f32.cuh's stages,
    which take them from mixed_plan_rows) for an even length ``n``:
    ((radix, span), ...), span the product of the radices before. A radix-2
    stage where n's power-of-two part is 2^a with a odd, then a // 2
    radix-4 stages, then one stage for each odd prime factor (with its
    multiplicity), smallest first."""
    if not (MIN_N <= n <= MAX_N and n % 2 == 0):
        raise ValueError(f"mixed_plan: an even length in [{MIN_N}, {MAX_N}], "
                         f"got {n}")
    pow2 = n & -n
    a = pow2.bit_length() - 1
    radices = [2] * (a % 2) + [4] * (a // 2)
    odd, f = n // pow2, 3
    while odd > 1:
        while odd % f == 0:
            radices.append(f)
            odd //= f
        f += 2
    spans = np.cumprod([1] + radices[:-1]).tolist()
    return tuple(zip(radices, spans))


def mixed_roots(n: int):
    """The table offset of each stage's p-th roots (odd stages), else
    None: the odd stages' roots follow the twiddles (n entries) in stage
    order, p each."""
    offsets, at = [], n
    for radix, _ in mixed_plan(n):
        offsets.append(at if radix % 2 else None)
        at += radix if radix % 2 else 0
    return offsets


@functools.lru_cache(maxsize=32)
def mixed_plan_rows(n: int) -> np.ndarray:
    """The plan as the kernel's entry reads it, on the host: int32
    [stages, 3], (radix, span, table offset of an odd stage's roots, else
    0)."""
    return np.array([(radix, span, off or 0) for (radix, span), off
                     in zip(mixed_plan(n), mixed_roots(n))], np.int32)


@functools.lru_cache(maxsize=32)
def mixed_table(n: int, inverse: bool) -> np.ndarray:
    """That kernel's table in float64, complex128 [n + Σ odd p]: entry 0 is
    ±i, the direction (radix-4's ±i); the stage (radix R, span ns) has
    e^{±2πi r·k/(ns·R)} for r = 1..R−1, k < ns at ns + (r − 1)·ns + k
    (the entries end at n, since Σ (R − 1)·ns = n − 1); then each odd
    stage's p roots e^{±2πi m/p}, m < p, at mixed_roots. A p-point DFT
    reads root (j·k) mod p, never a growing angle."""
    sign = 1.0 if inverse else -1.0
    parts = [np.array([sign * 1j])]
    plan = mixed_plan(n)
    for radix, span in plan:
        rk = np.outer(np.arange(1, radix), np.arange(span))
        parts.append(np.exp(sign * 2j * np.pi * rk / (span * radix)).ravel())
    for radix, _ in plan:
        if radix % 2:
            parts.append(np.exp(sign * 2j * np.pi * np.arange(radix) / radix))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=32)
def mixed_twiddles_np(n: int, inverse: bool) -> np.ndarray:
    """mixed_table rounded to f32, [L, 2] (re, im): what the kernel reads."""
    w = mixed_table(n, inverse)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def mixed_twiddles(n: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mixed_twiddles_np(n, inverse)).to(device)


def mixed_max_rows(n: int, natural: bool) -> int:
    """The most rows per block of the fused mixed-radix kernel on either
    stage engine and of the matrix engine's row kernel at such N: max_rows
    at f32, rounded down to a power of two (N/4096 is not one at every
    N)."""
    cap = max_rows(n, natural)
    return 1 << (cap.bit_length() - 1)


def mixed_rows(c: int, m: int, n: int, sms: int, natural: bool, tier: str,
               split3: bool) -> int:
    """Rows per block of a fused pass of ``c`` channels of [m, n] at an n
    that is not a power of two, and of a three-factor row pass there on
    the matrix engine (rows_per_block, a grid of ``c`` times ⌈m / rows⌉;
    the direct row passes take passes_rows and max_rows): mixed_max_rows with the mixed-radix stages'
    shared memory (mixed_shared_bytes) at f32 in the direct form, else the
    matrix engine's two buffers (matrix_mixed_shared_bytes)."""
    shared = (mixed_shared_bytes if _stockham(tier, split3)
              else matrix_mixed_shared_bytes)
    return rows_per_block(c, m, n, sms, mixed_max_rows(n, natural), shared)


def mixed_tables(n: int, inverse: bool, tier: str, split3: bool,
                 device: torch.device) -> torch.Tensor:
    """The `tables` argument of a fused pass at an n that is not a power of
    two: the mixed-radix stages' table (mixed_twiddles) at f32 in the
    direct form, else the matrix engine's (matrix_tables)."""
    if _stockham(tier, split3):
        return mixed_twiddles(n, bool(inverse), device)
    return matrix_tables(n, bool(inverse), bool(split3), device)


def mixed_kernel_name(kind: str, tier: str, split3: bool,
                      channel_set: str = "") -> str:
    """named_launches' name of a launch at a length that is not a power of
    two; ``kind`` is "rows_transposed", "rows_natural", "fused_transposed"
    or "fused_natural", a fused launch names its channel set. At f32 in
    the direct form the mixed-radix kernels' names (MIXED_NAMES,
    MIXED_FUSED_NAME); at the other tiers and forms kernel_name's, "mixed"
    after the kind's first word: "matrix_rows_mixed_transposed[f32,split3]",
    "matrix_fused_mixed_natural[bf16,packed3]". A bf16 or bf16x3 row pass
    in the direct form counts under direct_rows_launches' names instead."""
    first, store = kind.split("_")
    if not _stockham(tier, split3):
        return kernel_name(f"{first}_mixed_{store}", tier, split3,
                           channel_set)
    if first == "rows":
        return MIXED_NAMES[kind]
    return MIXED_FUSED_NAME.format(store=store, channel_set=channel_set)


def mixed_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the fused mixed-radix kernel
    at f32 (mixed::smem_bytes): two buffers of ``rows`` rows of n + 1 complex
    values, then its table (n + Σ odd p complex). At n = 8190, one row:
    196 KB."""
    odd = sum(p for p, _ in mixed_plan(n) if p % 2)
    return (2 * rows * (n + 1) + n + odd) * 8


#: the radices the f32 row kernel at lengths that are not powers of two
#: (csrc/rows_mixed_passes_f32.cuh) runs in registers, largest first: 2, 4,
#: 8, 16 on radix16's butterflies, 3, 5, 7 as direct sums over conjugate
#: pairs, the rest as two of those with compile-time twiddles
PASS_RADICES = (16, 15, 14, 12, 10, 9, 8, 7, 6, 5, 4, 3, 2)
#: the points a thread holds in registers in a register pass
#: (mixed_passes::kPoints): 16 // radix butterflies
PASS_POINTS = 16
#: the most outputs a thread holds in a generic pass
#: (mixed_passes::kGenericPoints); it takes one item where that many
#: threads fit PASS_BLOCK_THREADS, for the parallelism of its N·p sums (at
#: L = 2 an item is the pair of outputs (q, 0), (q, 1)): on an H100 80GB
#: HBM3 at 700 W [3, 106, 106] read 0.0072 ms at one item a thread, 0.0097
#: at two (tools/mixed_passes_variants.py)
PASS_GENERIC_POINTS = 16
PASS_GENERIC_SPREAD = 1
#: the most twiddles of generic passes that kernel stages in shared memory
#: with their roots (mixed_passes::kStagedTwiddles): one wait on device
#: memory less before the pass, which brought [3, 106, 106] below the
#: stages' time on an H100 80GB HBM3 at 700 W (tools/mixed_passes_variants.py)
PASS_STAGED_TWIDDLES = 2048
#: below this N the transposed store takes no cluster: on an H100 80GB
#: HBM3 at 700 W [3, 106, 106] read 0.0082 ms at 4 rows in one block, 0.0101
#: in clusters of 2 (tools/mixed_passes_variants.py --sweep)
PASS_CLUSTER_MIN_N = 512
#: that kernel's largest block (mixed_passes::kMaxThreads); a row takes
#: passes_threads(n) threads
PASS_MAX_THREADS = 1024
#: the most threads a block of it takes where rows share one (rows ×
#: threads a row; mixed_passes::kBlockThreads): two such blocks fit an SM at
#: 64 registers a thread, the natural store's kernel for them runs at 128
PASS_BLOCK_THREADS = 512
#: the most points (rows × N) a natural-store block of it takes
PASS_BLOCK_POINTS = 4096
#: the pad shift that means no pad (a >> 31 is 0 for every index)
PASS_NO_PAD = 31


def _small_and_large(n: int):
    """n = s · Π large, s the part with primes 2, 3, 5, 7, large the other
    prime factors (with multiplicity), in increasing order."""
    small, rest, large = 1, n, []
    for p in (2, 3, 5, 7):
        while rest % p == 0:
            small, rest = small * p, rest // p
    f = 11
    while rest > 1:
        while rest % f == 0:
            large.append(f)
            rest //= f
        f += 2
    return small, large


@functools.lru_cache(maxsize=None)
def _register_factorings(s: int, largest: int = 16):
    """Every way to write s as a product of PASS_RADICES, non-increasing."""
    if s == 1:
        return [()]
    return [(r,) + rest for r in PASS_RADICES if r <= largest and s % r == 0
            for rest in _register_factorings(s // r, r)]


def _generic(radix: int) -> bool:
    """A pass of this radix runs the generic p-point sum (a prime above 7)."""
    return radix not in PASS_RADICES


def _pass_threads(n: int, radices, large) -> int:
    """The threads a row needs: a register pass of radix r holds
    PASS_POINTS // r of its n / r butterflies a thread, a generic pass
    PASS_GENERIC_SPREAD of its items (outputs, or at n = 2p pairs of them)
    where that takes at most PASS_BLOCK_THREADS threads, else as few as
    PASS_GENERIC_POINTS outputs a thread allow;
    rounded up to a power of two below 16, else to a multiple of 16 (a half
    warp's 16 lanes in one row)."""
    generic = []
    for p in large:
        pairs = n // p == 2
        items = p if pairs else n
        generic.append(max(
            -(-items // (PASS_GENERIC_POINTS // (2 if pairs else 1))),
            min(-(-items // PASS_GENERIC_SPREAD), PASS_BLOCK_THREADS)))
    need = max([-(-(n // r) // (PASS_POINTS // r)) for r in radices]
               + generic)
    if need <= 16:
        return 1 << (need - 1).bit_length()
    return -(-need // 16) * 16


def passes_cache_clear() -> None:
    """Forget every planned length (after a PASS_* constant changes)."""
    for fn in (passes_plan, passes_plan_rows, passes_table, passes_threads,
               passes_pad, passes_stride, passes_roots, passes_staged,
               passes_twiddle_offsets, passes_shared_bytes,
               passes_block_bytes, passes_max_rows, passes_rows,
               passes_cluster):
        fn.cache_clear()
    passes_twiddles.cache_clear()


@functools.lru_cache(maxsize=None)
def passes_plan(n: int):
    """The passes of the f32 row kernel at an even ``n`` in [MIN_N, MAX_N]
    that is not a power of two (csrc/rows_mixed_passes_f32.cuh, which
    takes them from passes_plan_rows): ((radix, span), ...), span the
    product of the radices before. n's part in primes 2, 3, 5, 7 runs as
    register passes of PASS_RADICES, the fewest passes, then the fewest
    threads a row (passes_threads), then the largest radices first, in
    non-increasing order (1536 = 16·16·6, 3072 = 16·16·12, 768 = 16·16·3,
    8190 = 15·14·3 · 13); each larger prime p then runs one generic p-point
    pass (106 = 2 · 53), in increasing order."""
    if not (MIN_N <= n <= MAX_N and n % 2 == 0) or is_power_of_two(n):
        raise ValueError(f"passes_plan: an even length in [{MIN_N}, {MAX_N}] "
                         f"that is not a power of two, got {n}")
    small, large = _small_and_large(n)
    radices = min(_register_factorings(small),
                  key=lambda f: (len(f), _pass_threads(n, f, large),
                                 [-r for r in f]))
    radices = list(radices) + large
    spans = np.cumprod([1] + radices[:-1]).tolist()
    return tuple(zip(radices, spans))


@functools.lru_cache(maxsize=None)
def passes_threads(n: int) -> int:
    """The threads one row of length ``n`` takes in that kernel
    (_pass_threads of its plan)."""
    radices = [r for r, _ in passes_plan(n)]
    return _pass_threads(n, [r for r in radices if not _generic(r)],
                         [r for r in radices if _generic(r)])


@functools.lru_cache(maxsize=None)
def passes_pad(n: int) -> int:
    """The exchange buffer's pad shift e: point a of a row lies at
    a + (a >> e). e = 4 (a pad every 16 points) where the first radix is
    even, PASS_NO_PAD (none) where it is odd or the plan has a generic pass
    (whose p reads an output index, each a shift and an add more, would
    otherwise pay for it). The first pass writes output
    s of butterfly j at r·j + s: with an even radix r, 16 lanes' writes
    fall on the bank pairs (r + r/16)·j mod 16 apart only with the pad
    (radix 16 without it: all 16 on one pair); with an odd r they are
    distinct mod 16 as they stand, and a pad would break that (15 of 16 on
    one pair at 8190 = 15·14·3·13). Later passes write runs of span
    consecutive points, and every pass reads runs of consecutive points,
    which either rule keeps on distinct pairs but where a run crosses a
    pad (tests/test_torch_mixed_passes.py counts the conflicts)."""
    plan = passes_plan(n)
    if plan[0][0] % 2 or any(_generic(r) for r, _ in plan):
        return PASS_NO_PAD
    return 4


@functools.lru_cache(maxsize=None)
def passes_stride(n: int) -> int:
    """The row stride of that kernel's exchange buffer, in complex units:
    the padded row, where a row has fewer than 16 threads raised to the
    least value ≡ the threads (mod 16), so that the rows sharing a half
    warp read their runs on distinct bank pairs."""
    e, t = passes_pad(n), passes_threads(n)
    stride = n + ((n - 1) >> e)
    return stride + (t - stride) % 16 if t < 16 else stride


@functools.lru_cache(maxsize=None)
def passes_roots(n: int) -> int:
    """The generic passes' roots, p for each."""
    return sum(r for r, _ in passes_plan(n) if _generic(r))


@functools.lru_cache(maxsize=None)
def passes_staged(n: int) -> int:
    """The table entries that kernel stages in shared memory: the generic
    passes' roots and, where they number at most PASS_STAGED_TWIDDLES, the
    generic passes' twiddles, which lie just before the roots."""
    roots = passes_roots(n)
    if not roots:
        return 0
    twiddles = sum((r - 1) * s for r, s in passes_plan(n) if _generic(r))
    return roots + (twiddles if twiddles <= PASS_STAGED_TWIDDLES else 0)


@functools.lru_cache(maxsize=None)
def passes_twiddle_offsets(n: int):
    """Each pass's table offsets (twiddles, roots), 0 where it has none:
    entry 0 is the direction, then each pass of span ns > 1 has its
    (radix − 1)·ns twiddles in pass order, then each generic pass its
    radix roots."""
    plan = passes_plan(n)
    at, offsets = 1, []
    for radix, span in plan:
        offsets.append(at if span > 1 else 0)
        at += (radix - 1) * span if span > 1 else 0
    roots = []
    for radix, _ in plan:
        roots.append(at if _generic(radix) else 0)
        at += radix if _generic(radix) else 0
    return tuple(zip(offsets, roots))


@functools.lru_cache(maxsize=32)
def passes_plan_rows(n: int) -> np.ndarray:
    """The plan as the kernel's entry reads it, on the host: int32
    [1 + passes, 4], a head (threads a row, pad shift, row stride, 0),
    then (radix, span, twiddle offset, roots offset) a pass."""
    head = (passes_threads(n), passes_pad(n), passes_stride(n), 0)
    rows = [(radix, span, tw, roots) for (radix, span), (tw, roots)
            in zip(passes_plan(n), passes_twiddle_offsets(n))]
    return np.array([head] + rows, np.int32)


@functools.lru_cache(maxsize=32)
def passes_table(n: int, inverse: bool) -> np.ndarray:
    """That kernel's table in float64, complex128 [n − r + 1 + Σ generic
    p], r the first radix: entry 0 is ±i (the direction), each pass (radix
    R, span ns > 1) has e^{±2πi s·k/(R·ns)}, s = 1..R−1, k < ns at its
    offset + (s − 1)·ns + k (passes_twiddle_offsets), each generic pass its
    p roots e^{±2πi m/p}, m < p."""
    sign = 1.0 if inverse else -1.0
    parts = [np.array([sign * 1j])]
    plan = passes_plan(n)
    for radix, span in plan:
        if span > 1:
            sk = np.outer(np.arange(1, radix), np.arange(span))
            parts.append(np.exp(sign * 2j * np.pi * sk / (radix * span)).ravel())
    for radix, _ in plan:
        if _generic(radix):
            parts.append(np.exp(sign * 2j * np.pi * np.arange(radix) / radix))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=32)
def passes_twiddles(n: int, inverse: bool,
                    device: torch.device) -> torch.Tensor:
    """passes_table rounded to f32, [L, 2] (re, im): what the kernel reads."""
    w = passes_table(n, bool(inverse))
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=None)
def passes_shared_bytes(rows: int, n: int, cluster: int = 1,
                        natural: bool = False) -> int:
    """Dynamic shared memory of one block of that kernel
    (mixed_passes::shared_bytes): the exchange buffer, ``rows`` rows of
    passes_stride(n) complex, and for the transposed store its tile,
    ``rows`` rows of cluster_gather_stride(rows, n), in the buffer (the
    larger of the two) or, where the plan has a generic pass, beside it;
    with a cluster of K > 1 blocks the gathered tile, K·rows rows of
    cluster_gather_stride(K·rows, n/K); then the staged table entries
    (passes_staged) and the plan's passes (mixed_passes::Pass, 32 bytes
    each)."""
    stride, tile = passes_stride(n), cluster_gather_stride(rows, n)
    if natural:
        area = rows * stride
    elif passes_roots(n):
        area = rows * (stride + tile)
    else:
        area = rows * max(stride, tile)
    if cluster > 1:
        area += cluster * rows * cluster_gather_stride(cluster * rows,
                                                       n // cluster)
    return (area + passes_staged(n)) * 8 + 32 * len(passes_plan(n))


@functools.lru_cache(maxsize=None)
def passes_block_bytes(rows: int, n: int) -> int:
    """The most shared memory a block of ``rows`` rows takes at any cluster
    passes_cluster may give it (rows_per_block's fit)."""
    return max(passes_shared_bytes(rows, n, k) for k in CLUSTER_SIZES
               if k == 1 or (n % k == 0 and k * rows <= TRANSPOSED_CLUSTER_ROWS))


@functools.lru_cache(maxsize=None)
def passes_max_rows(n: int, natural: bool) -> int:
    """The most rows a block of that kernel takes: PASS_BLOCK_POINTS // n
    for the natural store, TRANSPOSED_MAX_ROWS for the transposed one, at
    most PASS_BLOCK_THREADS threads (one row where it alone takes more),
    rounded down to a power of two; and one transposed row where a row
    takes PASS_BLOCK_THREADS // 2 threads or more (on an H100 80GB HBM3 at
    700 W [1, 3072, 3072] read 0.1441 ms at 1 row in clusters of 8, 0.1619
    at 2 rows in clusters of 4, tools/mixed_passes_variants.py --sweep)."""
    threads = passes_threads(n)
    if natural:
        cap = max(1, PASS_BLOCK_POINTS // n)
    elif 2 * threads >= PASS_BLOCK_THREADS:
        cap = 1
    else:
        cap = TRANSPOSED_MAX_ROWS
    cap = max(1, min(cap, PASS_BLOCK_THREADS // threads))
    return 1 << (cap.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def passes_rows(c: int, m: int, n: int, sms: int, natural: bool) -> int:
    """Rows per block of a pass of ``c`` channels of [m, n] on that kernel
    (rows_per_block with passes_max_rows and passes_block_bytes)."""
    shared = (functools.partial(passes_shared_bytes, natural=True)
              if natural else passes_block_bytes)
    return rows_per_block(c, m, n, sms, passes_max_rows(n, natural), shared)


@functools.lru_cache(maxsize=None)
def passes_cluster(m: int, n: int, rows: int) -> int:
    """The blocks of one thread-block cluster of that kernel's transposed
    store (transposed_cluster's rule): from n = PASS_CLUSTER_MIN_N on the
    least K in CLUSTER_SIZES with K·rows ≥ TRANSPOSED_CLUSTER_ROWS, at most
    the blocks of the grid and dividing n (each block stores n/K columns
    of the cluster's rows); 1 below."""
    k = 1
    while (n >= PASS_CLUSTER_MIN_N and k * rows < TRANSPOSED_CLUSTER_ROWS
           and 2 * k <= CLUSTER_SIZES[-1] and 2 * k <= -(-m // rows)
           and n % (2 * k) == 0):
        k *= 2
    return k


def fused_natural_shared_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the f32 fused natural-store
    kernel (fused_radix16::shared_bytes): the radix-16 row kernel's
    exchange buffer, ``rows`` rows of radix16_stride(n) complex (also at
    n = 16), then h̃ of the block's points, ``rows`` rows of n complex."""
    return rows * (radix16_stride(n) + n) * 8


def fused_natural_max_rows(n: int) -> int:
    """The most rows per block of the f32 fused natural-store kernel:
    FUSED_NATURAL_BLOCK_POINTS // n, at most RADIX16_MAX_THREADS threads
    of 16 points."""
    points = min(FUSED_NATURAL_BLOCK_POINTS, 16 * RADIX16_MAX_THREADS)
    return max(1, points // n)


def fused_transposed_max_rows(n: int) -> int:
    """The most rows per block of the f32 fused transposed-store kernel:
    FUSED_TRANSPOSED_MAX_ROWS, at most RADIX16_MAX_THREADS threads of 16
    points, and where a row has fewer than 16 threads (n < 256) at most
    256 // n rows, so that a half warp's tile writes (16/T rows of T
    threads) meet no bank conflict beside its read-out (R rows at 16/R
    columns)."""
    rows = min(FUSED_TRANSPOSED_MAX_ROWS, 16 * RADIX16_MAX_THREADS // n)
    if n < 256:
        rows = min(rows, 256 // n)
    return max(1, rows)


def fused_block_shared_bytes(tier: str, split3: bool, natural: bool):
    """The shared-memory function (rows, n) → bytes of the fused kernel
    at (tier, split3, store): fused_natural_shared_bytes for both f32
    direct stores (the transposed store's tile, ``rows`` rows of
    cluster_gather_stride(rows, n) ≤ n + 15 complex, lies in the exchange
    buffer, whose rows of radix16_stride(n) > n + 15 hold it at every n),
    the bf16 row kernel's (bf16_rows_shared_bytes) for the bf16 natural
    store, else fused_rows_kernel's two buffers (shared_bytes)."""
    if _stockham(tier, split3):
        return fused_natural_shared_bytes
    if _fused_bf16(tier, split3, natural):
        return bf16_rows_shared_bytes
    return shared_bytes


def fused_rows(c: int, m: int, n: int, sms: int, natural: bool, tier: str,
               split3: bool) -> int:
    """Rows per block of a fused pass of ``c`` channels of [m, n]
    (rows_per_block): the f32 direct kernels' own caps and shared memory
    (fused_natural_max_rows or fused_transposed_max_rows, and
    fused_natural_shared_bytes for both stores); the bf16
    natural kernel's, which are the bf16 row kernel's (max_rows at bf16,
    bf16_rows_shared_bytes); else max_rows and fused_rows_kernel's two
    buffers. The f32 direct kernels make every channel in one block, so
    their grid is ⌈m / rows⌉ blocks whatever ``c``; the others' is ``c``
    times that. At an n that is not a power of two the fused mixed-radix
    kernel takes the row kernel's geometry (mixed_rows)."""
    if not is_power_of_two(n):
        return mixed_rows(c, m, n, sms, natural, tier, split3)
    if _stockham(tier, split3):
        if natural:
            return rows_per_block(1, m, n, sms, fused_natural_max_rows(n),
                                  fused_natural_shared_bytes)
        return rows_per_block(1, m, n, sms, fused_transposed_max_rows(n),
                              fused_natural_shared_bytes)
    if _fused_bf16(tier, split3, natural):
        return rows_per_block(c, m, n, sms, max_rows(n, True, tier, split3),
                              bf16_rows_shared_bytes)
    return rows_per_block(c, m, n, sms, max_rows(n, natural))


def fused_tables(n: int, inverse: bool, tier: str, split3: bool,
                 natural: bool, device: torch.device) -> torch.Tensor:
    """The `tables` argument of a fused entry: at an n that is not a power
    of two the row kernel's (mixed_tables); else the radix-16 twiddles for
    the f32 direct stores, the bf16 row kernel's tables for the bf16
    natural store, else tables_for's."""
    if not is_power_of_two(n):
        return mixed_tables(n, inverse, tier, split3, device)
    if _stockham(tier, split3):
        return radix16_twiddles(n, bool(inverse), device)
    if _fused_bf16(tier, split3, natural):
        return bf16_rows_tables(n, bool(inverse), device)
    return tables_for(n, inverse, tier, split3, device)


def block_shared_bytes(tier: str, split3: bool, natural: bool):
    """The shared-memory function (rows, n) → bytes of the row kernel at
    (tier, split3, store): the bf16 and bf16x3 direct and the f32 and
    bf16x3 three-factor kernels' own,
    the f32 transposed kernel's at its largest cluster
    (cluster_rows_block_bytes), the f32 natural kernel's
    (radix16_shared_bytes), else the matrix engine's two buffers
    (shared_bytes)."""
    if _bf16_rows(tier, split3):
        return bf16_rows_shared_bytes
    if _bf16x3_rows(tier, split3):
        return bf16x3_rows_shared_bytes
    if _split3_rows(tier, split3) and not natural:
        return split3_rows_shared_bytes
    if _split3_bf16x3_rows(tier, split3) and not natural:
        return split3_bf16x3_shared_bytes
    if _stockham(tier, split3):
        return radix16_shared_bytes if natural else cluster_rows_block_bytes
    return shared_bytes


def max_rows(n: int, natural: bool, tier: str = "f32",
             split3: bool = False) -> int:
    """The most rows per block of the transposed store
    (TRANSPOSED_MAX_ROWS) or of the natural store at (tier, split3):
    BF16_NATURAL_BLOCK_POINTS // n on the bf16 and bf16x3 direct row
    kernels (and the bf16 fused natural kernel, which runs the bf16 one's
    stages), else NATURAL_BLOCK_POINTS // n, rounded down to a power of
    two. Those row kernels where n1 = N/2 > 128 take 1 at either store:
    their tiled stage 2 covers the whole batch. The fused kernels but the
    f32 direct ones take it (fused_rows); the f32 direct row passes take
    their own (row_pass_max_rows)."""
    direct = _bf16_rows(tier, split3) or _bf16x3_rows(tier, split3)
    if direct and bf16_wide(n):
        return 1
    if not natural:
        return TRANSPOSED_MAX_ROWS
    points = (BF16_NATURAL_BLOCK_POINTS if direct
              else NATURAL_BLOCK_POINTS)
    # rounded down to a power of two (points // n is one where n is)
    return 1 << (max(1, points // n).bit_length() - 1)


def row_pass_max_rows(n: int, natural: bool, tier: str,
                      split3: bool) -> int:
    """The most rows per block of a row pass (not fused) at (tier, split3,
    store): the f32 direct kernels' own caps (cluster_max_rows,
    radix16_max_rows), else max_rows (the three-factor kernels' R = 8 at
    N = 1024 was the fastest in their H100 sweeps, chip_smoke.py
    --sweep-rows)."""
    if _stockham(tier, split3):
        return radix16_max_rows(n) if natural else cluster_max_rows(n)
    return max_rows(n, natural, tier, split3)


def rows_per_block(c: int, m: int, n: int, sms: int,
                   cap: int = TRANSPOSED_MAX_ROWS, shared=shared_bytes) -> int:
    """Rows one kernel block transforms: the power of two that gives about
    one block per SM for a [c, m, n] batch, at most ``cap`` (max_rows) and
    at most what fits shared memory by ``shared`` (rows, n) → bytes
    (block_shared_bytes). A block takes about as
    long whatever its row count, so a batch that fills fewer SMs takes
    fewer rows per block (measured on the H100: the [1, 512, 1024] half-row
    pass runs faster at 4, the one-row Nyquist pass at 1)."""
    target = -(-c * m // sms)
    rows = 1
    while (rows < target and rows < cap
           and shared(2 * rows, n) <= SMEM_LIMIT):
        rows *= 2
    return rows


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=32)
def twiddles(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """[N − 1, 2] f32 (cos, sin): the Stockham stage with span ns uses
    e^{±2πi k/(2ns)}, k < ns, stored at rows ns − 1 + k; built in float64."""
    sign = 1.0 if inverse else -1.0
    spans = 1 << np.arange(int(np.log2(n)))
    w = np.concatenate([np.exp(sign * 1j * np.pi * np.arange(ns) / ns)
                        for ns in spans])
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _check_planes(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"planes must be float32, got {re.dtype}, {im.dtype}")
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"planes must be two [C, M, N] tensors of one shape, "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    if re.device != im.device:
        raise ValueError(f"planes on two devices: {re.device}, {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    if re.numel() == 0:
        raise ValueError("planes are empty")


def _fft_plain(re, im, inverse: bool):
    z = torch.complex(re, im)
    if inverse:
        return torch.fft.ifft(z, dim=-1, norm="forward")   # no 1/N on the inverse
    return torch.fft.fft(z, dim=-1)


def fft1d_transposed_plain(re: torch.Tensor, im: torch.Tensor,
                           inverse: bool = True, precision: str = "float32"):
    """Plain version of fft1d_transposed at the same tier and form: the row
    DFT (rows_plain), transposed and split into planes."""
    tier, split3 = engine(re.shape[-1], precision, transposed=True)
    fr, fi = rows_plain(re, im, inverse, tier, split3)
    return (fr.transpose(-1, -2).contiguous(),
            fi.transpose(-1, -2).contiguous())


def fft1d_natural_large_plain(re: torch.Tensor, im: torch.Tensor,
                              inverse: bool = True,
                              precision: str = "float32"):
    """Plain version of fft1d_natural_large at the same tier: the row DFT
    (rows_plain), split into planes."""
    tier, _ = engine(re.shape[-1], precision, transposed=False)
    fr, fi = rows_plain(re, im, inverse, tier, False)
    return fr.contiguous(), fi.contiguous()


def tables_for(n: int, inverse: bool, tier: str, split3: bool,
               device: torch.device) -> torch.Tensor:
    """The `tables` argument of a row or fused entry: the Stockham twiddles
    for f32 direct, else the matrix engine's tables."""
    if _stockham(tier, split3):
        return twiddles(n, bool(inverse), device)
    return matrix_tables(n, bool(inverse), bool(split3), device)


def count_launch(wrapper, kind: str, tier: str, split3: bool,
                 channel_set: str = "") -> None:
    """One kernel launch, counted once: on the wrapper's own count for the
    Stockham kernel in its default channel set, else in named_launches."""
    if _stockham(tier, split3) and not channel_set:
        wrapper.launches += 1
    else:
        named_launches[kernel_name(kind, tier, split3, channel_set)] += 1


def _launch_rows(entry: str, re, im, inverse: bool, out_shape, tier: str,
                 split3: bool):
    kernels = _build.load()
    c, m, n = re.shape
    natural = entry == "tpu_fft_rows_natural"
    out_re = torch.empty(out_shape, dtype=torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    mixed = not is_power_of_two(n)
    # the bf16 and bf16x3 row kernels in the direct form: their own tables,
    # rows and shared memory; bf16x3 at every even N and bf16 at a length
    # that is not a power of two through an entry of their own, with X′'s
    # buffer where n1 = N/2 > 128
    bf16x3 = _bf16x3_rows(tier, split3)
    direct = bf16x3 or _bf16_rows(tier, split3)
    if direct:
        tables = (bf16x3_rows_tables if bf16x3 else bf16_rows_tables)(
            n, bool(inverse), re.device)
        rows = rows_per_block(c, m, n, sm_count(re.device),
                              max_rows(n, natural, tier, split3),
                              block_shared_bytes(tier, split3, natural))
        if bf16x3 or mixed:
            entry = "tpu_bf16_rows_mixed"
            words = (bf16x3_rows_scratch_words if bf16x3
                     else bf16_rows_scratch_words)(c, m, n)
            scratch = torch.empty(words, dtype=torch.int32, device=re.device)
            pointers = (tables.data_ptr(), scratch.data_ptr())
            tail = (int(natural), TIERS[tier])
        else:
            pointers = (tables.data_ptr(),)
            tail = (TIERS[tier], 0) + (() if natural else (1,))
    elif mixed:
        # either store, through entries of its own: at f32 direct the
        # mixed-radix passes, in the three-factor form the matrix engine
        if _stockham(tier, split3):
            # f32 direct: the register-resident passes, the plan read from
            # the host, the transposed store in clusters of passes_cluster
            entry = "tpu_fft_rows_mixed"
            tables = passes_twiddles(n, bool(inverse), re.device)
            rows = passes_rows(c, m, n, sm_count(re.device), natural)
            plan = passes_plan_rows(n)
            cluster = 1 if natural else passes_cluster(m, n, rows)
            tail = (int(natural), len(plan) - 1, tables.shape[0], cluster,
                    plan.ctypes.data)
        else:
            entry = "tpu_matrix_rows_any"
            tables = matrix_tables(n, bool(inverse), bool(split3), re.device)
            rows = mixed_rows(c, m, n, sm_count(re.device), natural, tier,
                              split3)
            tail = (int(natural), TIERS[tier], int(split3))
        pointers = (tables.data_ptr(),)
    else:
        clustered = not natural and _stockham(tier, split3)
        if _split3_bf16x3_rows(tier, split3):
            tables = split3_bf16x3_tables(n, bool(inverse), re.device)
        elif natural and _stockham(tier, split3):
            tables = radix16_twiddles(n, bool(inverse), re.device)
        else:
            tables = tables_for(n, inverse, tier, split3, re.device)
        rows = rows_per_block(c, m, n, sm_count(re.device),
                              row_pass_max_rows(n, natural, tier, split3),
                              block_shared_bytes(tier, split3, natural))
        # the transposed entry also takes the f32 direct pass's cluster size
        cluster = (() if natural else
                   (transposed_cluster(m, n, rows) if clustered else 1,))
        tail = (TIERS[tier], int(split3), *cluster)
        pointers = (tables.data_ptr(),)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(kernels.lib, entry)(
            re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            *pointers, c, m, n, rows, *tail, stream)
    kernels.check(err, entry)
    # each launch once: at a length that is not a power of two under a name
    # of its own, so the power-of-two kernels' counts stay exact
    kind = "rows_natural" if natural else "rows_transposed"
    if direct:
        named_launches.update(direct_rows_launches(n, natural, tier))
    elif mixed:
        named_launches[mixed_kernel_name(kind, tier, split3)] += 1
    else:
        count_launch(fft1d_natural_large if natural else fft1d_transposed,
                     kind, tier, split3)
    return out_re, out_im


def on_cpu(fn_name: str, re: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs); False for a CUDA
    tensor (the kernel launches); raises for any other device."""
    if re.device.type == "cpu":
        return True
    if re.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cpu or cuda, not {re.device}")
    return False


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd records: grad mode on and an input that requires
    grad. Only then does a wrapper enter its autograd.Function; otherwise
    it runs the dispatch alone, with no Function on the host's path."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(what: str, tensors, backend: str) -> None:
    """Raise NotImplementedError where autograd would record a kernel that
    the JAX package gives no VJP (the fused and wave-bank kernels), rather
    than return outputs cut from the graph."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{what} has no gradient: the JAX package has no VJP for the "
            f"{backend} kernels either. Take gradients through "
            f"fft_backend=\"pallas\" (the row-DFT and fields kernels), or "
            f"run this under torch.no_grad()")


def _fft1d_transposed_impl(re, im, inverse, precision):
    _check_planes(re, im)
    c, m, n = re.shape
    tier, split3 = engine(n, precision, transposed=True)
    # the CPU's plain version takes every length, as the JAX package's
    if on_cpu("fft1d_transposed", re):
        return fft1d_transposed_plain(re, im, inverse, precision)
    require_card_kernel(n, tier, split3)
    return _launch_rows("tpu_fft_rows_transposed", re, im, inverse, (c, n, m),
                        tier, split3)


def _fft1d_natural_large_impl(re, im, inverse, precision):
    _check_planes(re, im)
    n = re.shape[-1]
    tier, split3 = engine(n, precision, transposed=False)
    if on_cpu("fft1d_natural_large", re):
        return fft1d_natural_large_plain(re, im, inverse, precision)
    require_card_kernel(n, tier, split3)
    return _launch_rows("tpu_fft_rows_natural", re, im, inverse, re.shape,
                        tier, split3)


class _Fft1dTransposedDiff(torch.autograd.Function):
    """fft1d_transposed with the linear-adjoint rule of
    pallas_fft._fft1d_transposed_diff: Y = T(W·X) with a symmetric DFT
    matrix W, so X̄ = T(G(T(Ȳ))), G the same dispatch in the opposite
    direction at the same precision (conj W is the other direction's
    table). The backward launches the same kernel on a CUDA tensor and runs
    the plain version on a CPU one, so at bf16 it is the adjoint rule, not
    the derivative of the plain version's rounding."""

    @staticmethod
    def forward(ctx, re, im, inverse, precision):
        ctx.inverse, ctx.precision = inverse, precision
        return _fft1d_transposed_impl(re, im, inverse, precision)

    @staticmethod
    def backward(ctx, gr, gi):
        # a cotangent may be a stride-0 expansion (from sum()) or a view
        gr, gi = _fft1d_transposed_impl(
            gr.transpose(-1, -2).contiguous(), gi.transpose(-1, -2).contiguous(),
            not ctx.inverse, ctx.precision)
        return gr.transpose(-1, -2), gi.transpose(-1, -2), None, None


class _Fft1dNaturalLargeDiff(torch.autograd.Function):
    """fft1d_natural_large with the rule of
    pallas_fft._fft1d_natural_large_diff: the VJP is the same dispatch in
    the opposite direction on the cotangents (no swap)."""

    @staticmethod
    def forward(ctx, re, im, inverse, precision):
        ctx.inverse, ctx.precision = inverse, precision
        return _fft1d_natural_large_impl(re, im, inverse, precision)

    @staticmethod
    def backward(ctx, gr, gi):
        gr, gi = _fft1d_natural_large_impl(gr.contiguous(), gi.contiguous(),
                                           not ctx.inverse, ctx.precision)
        return gr, gi, None, None


def fft1d_transposed(re: torch.Tensor, im: torch.Tensor, inverse: bool = True,
                     precision: str = "float32"):
    """Batched 1-D unnormalized DFT along the last axis of (re, im) f32
    [C, M, N], sign + for the inverse; returns (re, im) [C, N, M]:
    out[c, k, m] = Σ_n x[c, m, n]·e^{±2πi·nk/N}, at the tier and form of
    engine(N, precision, transposed=True). Differentiable
    (_Fft1dTransposedDiff) where needs_grad; the backward's launches count
    like the forward's."""
    if needs_grad(re, im):
        return _Fft1dTransposedDiff.apply(re, im, bool(inverse), precision)
    return _fft1d_transposed_impl(re, im, inverse, precision)


def fft1d_natural_large(re: torch.Tensor, im: torch.Tensor,
                        inverse: bool = True, precision: str = "float32"):
    """The same row DFT as fft1d_transposed, stored in natural order:
    (re, im) f32 [C, M, N] → [C, M, N], out[c, m, k] = Σ_n x[c, m, n]·
    e^{±2πi·nk/N}. The row pass of the natural regime (no three-factor
    form). Differentiable (_Fft1dNaturalLargeDiff) where needs_grad."""
    if needs_grad(re, im):
        return _Fft1dNaturalLargeDiff.apply(re, im, bool(inverse), precision)
    return _fft1d_natural_large_impl(re, im, inverse, precision)


#: Stockham-kernel launches since the last reset (CPU calls do not count)
fft1d_transposed.launches = 0
fft1d_natural_large.launches = 0


def ifft1d_planes_axis2(re: torch.Tensor, im: torch.Tensor,
                        inverse: bool = True, precision: str = "float32"):
    """Unnormalized DFT along axis −2 of (re, im) f32 [C, M, N] → [C, M, N]:
    the natural regime's column pass. The JAX package runs it as an
    einsum four-step outside Pallas, at the solver's precision; here it is
    the transposed row kernel on the swapped axes, at the same tier, whose
    transposed store restores the orientation (one transposing copy of
    each plane before it)."""
    return fft1d_transposed(re.transpose(-1, -2).contiguous(),
                            im.transpose(-1, -2).contiguous(), inverse,
                            precision)


def half_column_pass(vr: torch.Tensor, vi: torch.Tensor, m: int,
                     inverse: bool = True, precision: str = "float32"):
    """The half channel's column transform, length ``m`` = N/2 along axis
    −2 of [C, m, N]. The JAX package dispatches between engines here by
    the TPU's VMEM envelope; the row kernel takes every length the solver
    needs, so this is always the kernel column."""
    if vr.shape[-2] != m:
        raise ValueError(f"half_column_pass: axis −2 has {vr.shape[-2]} "
                         f"rows, not m={m}")
    return ifft1d_planes_axis2(vr, vi, inverse, precision)


def ifft2_planes_auto(re: torch.Tensor, im: torch.Tensor, inverse: bool = True,
                      precision: str = "float32"):
    """Full 2-D unnormalized transform of (re, im) [C, N, N] → [C, N, N]:
    two transposed row passes up to MAX_TRANSPOSED_N; beyond, a natural-
    store row pass and the column pass along axis −2."""
    if re.shape[-1] <= MAX_TRANSPOSED_N:
        re, im = fft1d_transposed(re, im, inverse, precision)
        return fft1d_transposed(re, im, inverse, precision)
    re, im = fft1d_natural_large(re, im, inverse, precision)
    return ifft1d_planes_axis2(re, im, inverse, precision)


def ifft2_pallas(x: torch.Tensor, inverse: bool = True,
                 precision: str = "float32") -> torch.Tensor:
    """The ``pallas`` backend on a complex tensor: the unnormalized 2-D
    transform of x [..., N, N], split into (re, im) planes, through
    ifft2_planes_auto (one launch a pass for the whole batch), then joined
    (pallas_fft.ifft2_pallas)."""
    shape = x.shape
    n0, n = shape[-2], shape[-1]
    re = x.real.float().reshape(-1, n0, n).contiguous()
    im = x.imag.float().reshape(-1, n0, n).contiguous()
    re, im = ifft2_planes_auto(re, im, inverse, precision)
    return torch.complex(re, im).reshape(shape)


@functools.lru_cache(maxsize=32)
def _c2r_twiddles(m: int, inverse: bool, device: torch.device):
    """w[k] = e^{±2πi k/(2m)} for the C2R even/odd fold, f32 from float64."""
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.arange(m) / (2 * m))
    return (torch.from_numpy(w.real.astype(np.float32)).to(device),
            torch.from_numpy(w.imag.astype(np.float32)).to(device))


def _c2r_combine(yr, yi, nyqr, nyqi, inverse: bool, axis: int = -1):
    """V[k] = (Y + conj(G)) + i·w·(Y − conj(G)) along ``axis`` (the k1 axis
    of the half row pass's output), with G[0] = the Nyquist planes (size 1
    at ``axis``) and G[k] = Y[M − k]."""
    ax = axis % yr.dim()
    m = yr.shape[ax]
    shape = [1] * yr.dim()
    shape[ax] = m
    wc, ws = (w.reshape(shape)
              for w in _c2r_twiddles(m, bool(inverse), yr.device))
    gr = torch.cat([nyqr, torch.flip(yr.narrow(ax, 1, m - 1), (ax,))], dim=ax)
    gi = torch.cat([nyqi, torch.flip(yi.narrow(ax, 1, m - 1), (ax,))], dim=ax)
    pr, pi = yr + gr, yi - gi
    qr, qi = yr - gr, yi + gi
    return (pr - wc * qi - ws * qr,
            pi + wc * qr - ws * qi)


def c2r_fold_columns(yr, yi, nyq_re, nyq_im, natural: bool,
                     inverse: bool = True, precision: str = "float32"):
    """The half route after its row pass over spectral rows 0..M−1: the
    Nyquist spectral row's own row pass, the C2R fold, the length-M column
    pass and the even/odd interleave → the real field [C, 2M, N].

    ``yr, yi`` are the row-transformed half rows, [C, N, M] (transposed
    regime: k1 is the last axis and the fold runs on it) or [C, M, N]
    (natural regime: the fold runs on axis −2); ``nyq_re, nyq_im`` are the
    untransformed Nyquist row [C, 1, N]. In the transposed regime that
    row's pass yields [C, N, 1], its transposed form with no copy."""
    if natural:
        nyr, nyi = fft1d_natural_large(nyq_re, nyq_im, inverse,
                                       precision)                  # [C, 1, N]
        vr, vi = _c2r_combine(yr, yi, nyr, nyi, inverse, axis=-2)
        xr, xi = half_column_pass(vr, vi, yr.shape[-2], inverse, precision)
    else:
        nyr, nyi = fft1d_transposed(nyq_re, nyq_im, inverse,
                                    precision)                     # [C, N, 1]
        vr, vi = _c2r_combine(yr, yi, nyr, nyi, inverse, axis=-1)
        xr, xi = fft1d_transposed(vr, vi, inverse, precision)      # [C, M, N]
    c, m, n = xr.shape
    # x[2m] = Re v[m], x[2m+1] = Im v[m]
    return torch.stack([xr, xi], dim=2).reshape(c, 2 * m, n)


def ifft2_planes_half(re: torch.Tensor, im: torch.Tensor, inverse: bool = True,
                      precision: str = "float32"):
    """Half-spectrum 2-D inverse transform: (re, im) [C, N/2+1, N], rows
    k1 = 0..N/2 of a Hermitian spectrum → the real field [C, N, N].

    With M = N/2 and Y[k] the row-transformed spectral row k:
        v[m] = x[2m] + i·x[2m+1] = Σ_{k<M} V[k]·e^{+2πi mk/M},
        V[k] = P[k] + i·w[k]·Q[k], w[k] = e^{+2πi k/N},
        P = Y + conj(G), Q = Y − conj(G), G[k] = Y[M−k], G[0] = Y[M].
    The column pass has length M, and the even and odd output rows
    interleave (c2r_fold_columns). Both regimes, as ifft2_planes_auto."""
    if not inverse:
        raise NotImplementedError("the C2R fold is derived for the inverse "
                                  "transform (the solver's only direction)")
    c, mp1, n = re.shape
    m = mp1 - 1
    if 2 * m != n:
        raise ValueError(f"half-spectrum input must carry N/2+1 rows; "
                         f"got {mp1} for N={n}")
    natural = n > MAX_TRANSPOSED_N
    rows = fft1d_natural_large if natural else fft1d_transposed
    yr, yi = rows(re[:, :m].contiguous(), im[:, :m].contiguous(), inverse,
                  precision)
    return c2r_fold_columns(yr, yi, re[:, m:].contiguous(),
                            im[:, m:].contiguous(), natural, inverse,
                            precision)
