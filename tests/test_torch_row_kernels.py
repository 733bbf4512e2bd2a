"""The row-DFT kernels' routing, blocks and layouts, on the CPU: which
kernel each (tier, form, store) runs, that every block rows_per_block can
pick fits shared memory, a numpy model of the f32 natural-store kernel
(csrc/rows_natural_f32.cuh: its radix plan, twiddle table and padded
exchange layout, run in float64 against a float64 DFT (1e-12·max) and in
float32 against JAX's fft1d_natural_large and the plain version (1e-5·max),
each output written once, every exchange access free of bank conflicts,
device-memory accesses coalesced), a numpy model of the f32 transposed kernel's
cluster store (csrc/stockham_rows_cluster.cuh: its cluster sizes, shared
memory, gather and store, their coverage, store runs and bank
arithmetic), the f32 three-factor kernel's tables
(csrc/dft_split3_f32.cuh reads planes.matrix_tables) and a numpy model of
that kernel: its stage order, its items (which thread owns which columns
and outputs), its padded layouts and their bank arithmetic, run in float64
against a float64 DFT (1e-12·max) and in float32, each product and sum of a
twiddle rounded alone, against rows_plain (1e-5·max, the kernel-vs-plain
band of the f32 tier); and the same for the bf16x3 three-factor kernel
(csrc/dft_split3_bf16x3.cuh): its tables (the f32 tables and the hi/lo
split of F_W and F_U in mma.sync fragment order), its rows per block, and
a model of its stages (stage 1 the f32 kernel's, stages 2a and 2b warp
tile by warp tile from the lanes' fragment addresses, the store straight
from stage 2b), its swizzled layouts and their bank arithmetic, in float64
with no split against a float64 DFT (1e-12·max) and in float32 with the
kernel's splits against rows_plain at bf16x3 (1e-5·max)."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean_torch.fft import planes

SMS = 132          # the H100's SMs, as sm_count reads them on the card
THREADS = 512      # a block of dft_split3_f32.cuh
SM_SHARED = 233472  # shared memory of one H100 SM (228 KB)


# ---- routing

# (tier, split3, natural) → the code that runs the pass (csrc/fft_rows.cu)
ROUTES = [("f32", False, False, "stockham"), ("f32", False, True, "stockham"),
          ("bf16", False, False, "bf16_rows"), ("bf16", False, True, "bf16_rows"),
          ("f32", True, False, "split3_f32"), ("bf16", True, False, "engine"),
          ("bf16x3", False, False, "engine"), ("bf16x3", False, True, "engine"),
          ("bf16x3", True, False, "split3_bf16x3")]


@pytest.mark.parametrize("tier,split3,natural,route", ROUTES)
def test_routing_predicates_name_one_kernel_a_pass(tier, split3, natural,
                                                   route):
    got = {"stockham": planes._stockham(tier, split3),
           "bf16_rows": planes._bf16_rows(tier, split3),
           "split3_f32": planes._split3_rows(tier, split3) and not natural,
           "split3_bf16x3": (planes._split3_bf16x3_rows(tier, split3)
                             and not natural)}
    assert [k for k, v in got.items() if v] == ([] if route == "engine"
                                               else [route])
    shared = planes.block_shared_bytes(tier, split3, natural)
    assert shared is {"bf16_rows": planes.bf16_rows_shared_bytes,
                      "split3_f32": planes.split3_rows_shared_bytes,
                      "split3_bf16x3": planes.split3_bf16x3_shared_bytes,
                      "stockham": (planes.radix16_shared_bytes if natural
                                   else planes.cluster_rows_block_bytes)}.get(
                          route, planes.shared_bytes)
    # the launch name stays the one chip_smoke and the tests count
    kind = "rows_natural" if natural else "rows_transposed"
    name = planes.kernel_name(kind, tier, split3)
    assert name == (f"{kind}[]" if route == "stockham" else
                    f"matrix_{kind}[{tier}{',split3' * split3}]")


@pytest.mark.parametrize("key,group", [
    ("void tpu_fft::bf16_rows::bf16_rows_kernel<12, true>(float const*, "
     "float const*, float*, float*, unsigned int const*, int, int)",
     "matrix_rows_natural[bf16]"),
    ("void tpu_fft::bf16_rows::bf16_rows_kernel<10, false>(float const*, "
     "float const*, float*, float*, unsigned int const*, int, int)",
     "matrix_rows_transposed[bf16]"),
    ("_ZN7tpu_fft9bf16_rows16bf16_rows_kernelILi12ELb1EEEvPKfS3_PfS4_PKjii",
     "matrix_rows_natural[bf16]"),
    ("_ZN7tpu_fft9bf16_rows16bf16_rows_kernelILi10ELb0EEEvPKfS3_PfS4_PKjii",
     "matrix_rows_transposed[bf16]"),
    ("void tpu_fft::split3_f32::split3_f32_rows_kernel<10>(float const*, "
     "float const*, float*, float*, float2 const*, int, int)",
     "matrix_rows_transposed[f32,split3]"),
    ("void (anonymous namespace)::fft_rows_kernel<false, "
     "tpu_fft::MatrixEngine<2, true> >(float const*, float const*, float*, "
     "float*, float2 const*, int, int, int, int)",
     "matrix_rows_transposed[bf16x3,split3]"),
    ("void tpu_fft::split3_bf16x3::split3_bf16x3_rows_kernel<10>(float "
     "const*, float const*, float*, float*, unsigned int const*, int, int)",
     "matrix_rows_transposed[bf16x3,split3]"),
    ("_ZN7tpu_fft13split3_bf16x325split3_bf16x3_rows_kernelILi10EEEvPKfS3_"
     "PfS4_PKjii", "matrix_rows_transposed[bf16x3,split3]"),
    ("void (anonymous namespace)::fft_rows_kernel<true, "
     "tpu_fft::StockhamEngine>(float const*, float const*, float*, float*, "
     "float2 const*, int, int, int, int)", "fft_rows_natural"),
    ("tpu_fft::stockham_rows_cluster_kernel(float const*, float const*, "
     "float*, float*, float2 const*, int, int, int, int, int)",
     "fft_rows_transposed"),
    ("_ZN7tpu_fft28stockham_rows_cluster_kernelEPKfS1_PfS2_PK6float2iiiii",
     "fft_rows_transposed"),
    ("void tpu_fft::radix16::radix16_rows_natural_kernel<12>(float const*, "
     "float const*, float*, float*, float2 const*, int, int)",
     "fft_rows_natural"),
    ("_ZN7tpu_fft7radix1627radix16_rows_natural_kernelILi12EEEvPKfS3_PfS4_"
     "PK6float2ii", "fft_rows_natural"),
    ("void tpu_fft::fused_radix16::radix16_fused_rows_natural_kernel<12>("
     "float const*, float const*, float const*, float const*, float const*, "
     "float const*, float*, float*, float2 const*, int, int, int, int, "
     "tpu_fft::Assembly)", "fused_rows_natural"),
    ("_ZN7tpu_fft13fused_radix1633radix16_fused_rows_natural_kernelILi12EEEvP"
     "KfS3_S3_S3_S3_S3_PfS4_PK6float2iiiiNS_8AssemblyE", "fused_rows_natural"),
    ("void tpu_fft::fused_transposed::radix16_fused_rows_transposed_kernel"
     "<10>(float const*, float const*, float const*, float const*, float "
     "const*, float const*, float*, float*, float2 const*, int, int, int, "
     "int, tpu_fft::Assembly)", "fused_rows_transposed"),
    ("_ZN7tpu_fft16fused_transposed36radix16_fused_rows_transposed_kernelILi"
     "10EEEvPKfS3_S3_S3_S3_S3_PfS4_PK6float2iiiiNS_8AssemblyE",
     "fused_rows_transposed"),
    ("void (anonymous namespace)::fused_rows_kernel<false, "
     "tpu_fft::StockhamEngine>(float const*, float const*, float const*, "
     "float const*, float const*, float const*, float*, float*, float2 "
     "const*, int, int, int, int, int, tpu_fft::Assembly)",
     "fused_rows_transposed"),
    ("void (anonymous namespace)::fused_rows_kernel<true, "
     "tpu_fft::MatrixEngine<1, false> >(float const*, float const*, float "
     "const*, float const*, float const*, float const*, float*, float*, "
     "float2 const*, int, int, int, int, int, tpu_fft::Assembly)",
     "matrix_fused_natural[bf16]"),
    ("void tpu_fft::bf16_fused::bf16_fused_natural_kernel<12>(float const*, "
     "float const*, float const*, float const*, float const*, float const*, "
     "float*, float*, unsigned int const*, int, int, int, tpu_fft::Assembly)",
     "matrix_fused_natural[bf16]"),
    ("_ZN7tpu_fft10bf16_fused25bf16_fused_natural_kernelILi12EEEvPKfS3_S3_S3_"
     "S3_S3_PfS4_PKjiiiNS_8AssemblyE", "matrix_fused_natural[bf16]")])
def test_profiler_keys_group_under_the_launch_names(key, group):
    assert chip_smoke.kernel_group(key) == group


# ---- rows per block

@pytest.mark.parametrize("shape,rows", [
    ((1, 4096, 4096), 2), ((1, 2048, 4096), 2), ((1, 1, 4096), 1),
    ((1, 1024, 1024), 8), ((1, 2048, 2048), 4), ((1, 1, 8192), 1),
    ((1, 3000, 8192), 1)])
def test_bf16_natural_pass_takes_the_bf16_kernels_rows(shape, rows):
    """The natural bf16 pass takes the bf16 kernel's cap,
    BF16_NATURAL_BLOCK_POINTS // N (the fastest in the H100 sweep), not
    NATURAL_BLOCK_POINTS // N: 2048 blocks at [1,4096,4096], two to an
    SM."""
    c, m, n = shape
    cap = planes.max_rows(n, True, "bf16", False)
    assert cap == max(1, planes.BF16_NATURAL_BLOCK_POINTS // n)
    assert 2 * planes.bf16_rows_shared_bytes(cap, n) <= SM_SHARED
    shared = planes.block_shared_bytes("bf16", False, True)
    assert planes.rows_per_block(c, m, n, SMS, cap, shared) == rows
    # the f32 and bf16x3 natural passes keep theirs
    for tier in ("f32", "bf16x3"):
        assert planes.max_rows(n, True, tier, False) == max(
            1, planes.NATURAL_BLOCK_POINTS // n)


@pytest.mark.parametrize("shape,rows", [
    ((1, 1024, 1024), 8), ((1, 512, 1024), 4), ((1, 1, 1024), 1),
    ((3, 1024, 1024), 8), ((1, 4096, 4096), 2), ((1, 64, 8192), 1),
    ((1, 8192, 8192), 1), ((1, 2048, 2048), 4), ((1, 512, 256), 4)])
def test_split3_f32_rows_per_block(shape, rows):
    c, m, n = shape
    shared = planes.block_shared_bytes("f32", True, False)
    got = planes.rows_per_block(c, m, n, SMS,
                                planes.max_rows(n, False, "f32", True), shared)
    assert got == rows
    assert shared(got, n) <= planes.SMEM_LIMIT


@pytest.mark.parametrize("tier,split3,natural,min_n", [
    ("bf16", False, False, 16), ("bf16", False, True, 16),
    ("f32", True, False, 128), ("f32", False, False, 16),
    ("bf16x3", True, False, 128)])
def test_every_block_rows_per_block_picks_fits_shared_memory(tier, split3,
                                                             natural, min_n):
    shared = planes.block_shared_bytes(tier, split3, natural)
    for log2n in range(int(np.log2(min_n)), 14):
        n = 1 << log2n
        cap = planes.max_rows(n, natural, tier, split3)
        for batch in sorted({1, 2, 3, 7, 64, 131, 132, 133, 264, 512, 1000,
                             1024, 2048, 4096, 5 * 4096, 8192}):
            rows = planes.rows_per_block(1, batch, n, SMS, cap, shared)
            assert rows & (rows - 1) == 0 and 1 <= rows <= cap
            assert shared(rows, n) <= planes.SMEM_LIMIT, (n, batch, rows)


def test_split3_shared_bytes_of_the_header():
    """The sizes dft_split3_f32.cuh states: 147 KB at N = 1024, R = 8;
    145 KB at N = 4096, R = 2; 168 KB at N = 8192, R = 1."""
    kb = {(1024, 8): 147520, (4096, 2): 144912, (8192, 1): 168456}
    for (n, rows), want in kb.items():
        assert planes.split3_rows_shared_bytes(rows, n) == want


# ---- the f32 transposed kernel's cluster store
# (csrc/stockham_rows_cluster.cuh)

# ([C, M, N], rows, cluster, shared bytes): every shape a path gives the f32
# transposed pass, and ragged M
CLUSTER_SHAPES = [
    ((1, 1024, 1024), 8, 1, 139384), ((1, 512, 1024), 4, 2, 73784),
    ((1, 1024, 512), 8, 1, 69752), ((1, 1, 1024), 1, 1, 24584),
    ((1, 4096, 4096), 1, 8, 98312), ((1, 4096, 2048), 2, 4, 81944),
    ((3, 1024, 1024), 8, 1, 139384), ((2, 1024, 1024), 8, 1, 139384),
    ((3, 4096, 4096), 1, 8, 98312), ((5, 4096, 4096), 1, 8, 98312),
    ((3, 5, 16), 1, 1, 392), ((2, 13, 64), 1, 4, 1544),
    ((1, 9, 2048), 1, 8, 49160), ((1, 3, 8192), 1, 2, 196616)]


@pytest.mark.parametrize("shape,rows,cluster,nbytes", CLUSTER_SHAPES)
def test_transposed_cluster_at_the_paths_shapes(shape, rows, cluster, nbytes):
    """K·R ≥ 8 rows a cluster (32-byte store runs) where M and N allow it:
    K = 8 at N = 4096 (R = 1), 4 at N = 2048 (R = 2), 2 at R = 4, 1 at
    R = 8 and for one row. Up to N = 1024 the rows per block are those of
    the block-per-R-rows store (8 rows fit a block); beyond, blocks of
    CLUSTER_BLOCK_POINTS, two of them to an SM (at most 113 KB each)."""
    c, m, n = shape
    shared = planes.block_shared_bytes("f32", False, False)
    cap = planes.cluster_max_rows(n)
    assert cap == (8 if n <= 1024 else max(1, 4096 // n))
    got = planes.rows_per_block(c, m, n, SMS, cap, shared)
    assert got == rows
    if n <= 1024:
        assert rows == planes.rows_per_block(
            c, m, n, SMS, planes.max_rows(n, False), planes.shared_bytes)
    elif rows * n == planes.CLUSTER_BLOCK_POINTS:
        assert 2 * (nbytes + 1024) <= SM_SHARED
    assert planes.transposed_cluster(m, n, rows) == cluster
    assert planes.cluster_rows_shared_bytes(rows, n, cluster) == nbytes
    assert nbytes <= planes.SMEM_LIMIT


def test_cluster_shared_bytes_of_the_header():
    """cluster_smem_bytes's sizes, in complex units: the stages' 2R(N + 1)
    + N − 1, or R(N + 1) + K·R·S with S = gather_stride(K·R, N/K). At
    N = 16, R = K = 8: S = 2 + 15 = 17 (odd, ≥ 2), 8·17 + 64·17 = 1224,
    above the stages' 287."""
    assert planes.cluster_gather_stride(64, 2) == 17
    assert planes.cluster_gather_stride(8, 1024) == 1026
    assert planes.cluster_gather_stride(4, 1024) == 1028
    assert planes.cluster_gather_stride(2, 2048) == 2056
    assert planes.cluster_gather_stride(1, 1024) == 1024
    assert planes.cluster_gather_stride(16, 256) == 257
    sizes = {(16, 8, 8): 1224, (4096, 2, 4): 20483, (8192, 1, 8): 24577,
             (64, 1, 8): 209, (1024, 4, 2): 9223, (1024, 8, 1): 17423}
    for (n, rows, k), want in sizes.items():
        assert planes.cluster_rows_shared_bytes(rows, n, k) == 8 * want


@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_every_cluster_block_the_wrapper_picks_fits_shared_memory(n):
    """At every batch the wrapper's (R, K), and every K the sweep takes at
    that R, fit the card's 227 KB; K is a cluster size the kernel takes."""
    shared = planes.block_shared_bytes("f32", False, False)
    for c in (1, 2, 3, 5):
        for m in (1, 2, 3, 7, 9, 13, 64, 131, 132, 133, 512, 1000, 1024,
                  2048, 4096, 8192):
            rows = planes.rows_per_block(c, m, n, SMS,
                                         planes.cluster_max_rows(n), shared)
            k = planes.transposed_cluster(m, n, rows)
            assert k in planes.CLUSTER_SIZES and k <= max(1, n // 16)
            for kk in planes.CLUSTER_SIZES:
                assert planes.cluster_rows_shared_bytes(rows, n, kk) <= \
                    planes.SMEM_LIMIT, (c, m, n, rows, kk)


def _round_degree(addr, threads, lanes=None):
    """The worst bank-pair conflict of 64-bit shared accesses of a loop
    over items (thread = item mod ``threads``, one item a thread a round):
    ``addr`` [items] in complex units, ``lanes`` the items that access (all
    by default); a half warp is 16 consecutive items of one round; the
    degree is the most distinct addresses of a half warp that agree mod 16
    (1: conflict-free)."""
    addr = np.asarray(addr)
    lanes = np.ones(addr.size, bool) if lanes is None else lanes
    half = min(16, threads)
    worst = 1
    for start in range(0, addr.size, half):
        a = addr[start:start + half][lanes[start:start + half]]
        if a.size:
            worst = max(worst, np.bincount(np.unique(a) % 16).max())
    return worst


def _cluster_indices(n, rows, k, j):
    """Block j's item maps in the kernel: the gather's (source block q,
    its result-buffer address, the tile address), None at k = 1, and the
    store's (address it reads: in the tile, or at k = 1 in the result
    buffer; row rr of the cluster; column k of the output), item by
    item."""
    log2w = (n // k).bit_length() - 1
    w, kr, stride = n // k, k * rows, n + 1
    s = planes.cluster_gather_stride(kr, w)
    idx = np.arange(rows * n)
    row, col = idx >> log2w, idx & (w - 1)
    rr, kk = idx & (kr - 1), idx // kr
    if k == 1:
        return None, (rr * stride + kk, rr, kk)
    gather = (row // rows, (row % rows) * stride + j * w + col,
              rows * stride + row * s + col)
    return gather, (rows * stride + rr * s + kk, rr, j * w + kk)


@pytest.mark.parametrize("n,k", [(1 << i, k) for i in range(6, 14)
                                 for k in (2, 4, 8) if (1 << i) // k >= 16])
def test_cluster_tile_passes_are_conflict_free(n, k):
    """Every R that fits at every cluster size above 1 (where there is a
    tile) with 16 columns or more a block (transposed_cluster keeps that):
    the gather's remote reads (one source block a half warp) and tile
    writes, and the store's tile reads, all conflict-free."""
    rows = 1
    while planes.shared_bytes(rows, n) <= planes.SMEM_LIMIT and rows <= 16:
        threads = min(rows * n // 2, THREADS)
        for j in range(k):
            (q, src, dst), (tile, _, _) = _cluster_indices(n, rows, k, j)
            assert (q.reshape(-1, 16) == q.reshape(-1, 16)[:, :1]).all()
            for addr in (src, dst, tile):
                assert _round_degree(addr, threads) == 1, (n, rows, k, j)
        rows *= 2


# (C, M, N, R, K): the paths' cluster geometries at a few rows, ragged
# clusters (rows past M, whole blocks past M), and the sweep's extremes
STORE_MODEL_CASES = [(1, 8, 4096, 2, 4), (2, 13, 4096, 2, 4),
                     (1, 16, 2048, 4, 2), (1, 12, 1024, 4, 2),
                     (1, 8, 1024, 8, 1), (3, 5, 16, 1, 1), (2, 13, 64, 1, 4),
                     (1, 9, 2048, 1, 8), (1, 3, 8192, 1, 2),
                     (1, 24, 1024, 8, 8), (1, 16, 512, 4, 4)]


@pytest.mark.parametrize("c,m,n,rows,k", STORE_MODEL_CASES)
def test_cluster_store_model_writes_every_output_once(c, m, n, rows, k):
    """The kernel's data movement after the stages, cluster by cluster:
    each block's result buffer (at 0, rows of n + 1) holds the float64 DFT
    of its rows (zeros past M); block j gathers its column range into its
    tile, which lies past every result buffer and inside the block's
    shared memory, and stores it (at K = 1 a block stores from its result
    buffer). Every (c, k, m < M) is written exactly
    once with its DFT value, and every warp of a full cluster writes runs
    of whole multiples of min(K·R, 32) consecutive floats a plane (runs
    join where M = K·R), each starting on a multiple of that where K·R
    divides M (whole 32-byte sectors from K·R = 8 on)."""
    rng = np.random.default_rng(m * n + k)
    x = rng.normal(size=(c, m, n)) + 1j * rng.normal(size=(c, m, n))
    want = np.fft.ifft(x, axis=-1).transpose(0, 2, 1) * n
    stride, kr = n + 1, k * rows
    size = planes.cluster_rows_shared_bytes(rows, n, k) // 8
    threads = min(rows * n // 2, THREADS)
    grid = -(-(-(-m // rows)) // k) * k
    out = np.zeros((c, n, m), complex)
    writes = np.zeros((c, n, m), int)
    run = min(kr, 32, rows * n)
    for ch in range(c):
        for first in range(0, grid, k):
            smem = np.full((k, size), np.nan, complex)
            for q in range(k):
                m0 = (first + q) * rows
                block = np.zeros((rows, n), complex)
                live = max(0, min(rows, m - m0))
                block[:live] = np.fft.ifft(x[ch, m0:m0 + live], axis=-1) * n
                pos = np.arange(rows)[:, None] * stride + np.arange(n)
                smem[q, pos] = block
            mc = first * rows
            for j in range(k):
                gather, (tile, rr, col) = _cluster_indices(n, rows, k, j)
                local = smem[j].copy()
                if gather is not None:
                    q, src, dst = gather
                    assert dst.min() >= rows * stride and dst.max() < size
                    local[dst] = smem[q, src]
                keep = mc + rr < m
                vals = local[tile[keep]]
                assert not np.isnan(vals).any()
                out[ch, col[keep], mc + rr[keep]] = vals
                np.add.at(writes[ch], (col[keep], mc + rr[keep]), 1)
                if mc + kr <= m:
                    g = col * m + mc + rr
                    for warp in g.reshape(-1, 32) if g.size >= 32 else [g]:
                        warp = np.sort(warp)
                        cuts = np.flatnonzero(np.diff(warp) != 1) + 1
                        for piece in np.split(warp, cuts):
                            assert piece.size % run == 0
                            if m % kr == 0:
                                assert piece[0] % run == 0
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, want)


# ---- the f32 three-factor kernel's tables

def _split3_tables(n, inverse):
    """planes.matrix_tables(n, inverse, True) as the header cuts it:
    F2 [n2, n2], T [n2, 128], F_W [8, 8], TW [8, 16], F_U [16, 16],
    each complex."""
    t = planes.matrix_tables(n, inverse, True, torch.device("cpu")).numpy()
    flat = t[:, 0].astype(np.complex128) + 1j * t[:, 1]
    n2 = n // 128
    cuts = np.cumsum([0, n2 * n2, n, 64, 128, 256])
    assert cuts[-1] == flat.size
    shapes = [(n2, n2), (n2, 128), (8, 8), (8, 16), (16, 16)]
    return t, [flat[a:b].reshape(s) for a, b, s in
               zip(cuts[:-1], cuts[1:], shapes)]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", [128, 256, 1024, 4096, 8192])
def test_split3_tables_are_laid_out_as_the_kernel_reads_them(n, inverse):
    """Bit-equal to _tables_np and _split3_tables_np, and to the JAX
    package's, at the offsets the kernel reads: F2 at 0, T at n2², F_W,
    TW, F_U at n2² + N."""
    t, _ = _split3_tables(n, inverse)
    n1, n2, *mats = planes._tables_np(n, inverse)
    assert n1 == 128
    mats = mats[:4] + list(planes._split3_tables_np(n1, inverse))
    jmats = list(pf._tables_np(n, inverse)[2:6]) + list(
        pf._split3_tables_np(n1, inverse))
    at = 0
    for re, im, jre, jim in zip(mats[::2], mats[1::2], jmats[::2], jmats[1::2]):
        size = re.size
        for col, want, jwant in ((0, re, jre), (1, im, jim)):
            got = t[at:at + size, col]
            np.testing.assert_array_equal(got, want.ravel())
            np.testing.assert_array_equal(got, np.asarray(jwant).ravel())
        at += size
    assert at == t.shape[0] == n2 * n2 + n + 448


def _exact_split3_tables(n, inverse):
    """The same five tables in float64, unrounded."""
    sign = 1 if inverse else -1
    n2 = n // 128

    def e(a, b, d):
        return np.exp(sign * 2j * np.pi * np.outer(np.arange(a), np.arange(b)) / d)
    return [e(n2, n2, n2), e(n2, 128, n), e(8, 8, 8), e(8, 16, 128),
            e(16, 16, 16)]


# ---- a numpy model of csrc/dft_split3_f32.cuh

class _Buffer:
    """A shared buffer of complex values as two real arrays of ``dtype``.
    A stage writing it first poisons it with NaN (what it held is spent),
    so a read of a position the stage before did not write shows in the
    output; writes of one stage must not meet."""

    def __init__(self, size, dtype):
        self.re = np.full(size, np.nan, dtype)
        self.im = np.full(size, np.nan, dtype)
        self.written = []

    def begin(self):
        self.re[:] = np.nan
        self.im[:] = np.nan
        self.written = []

    def read(self, pos):
        return self.re[pos], self.im[pos]

    def write(self, pos, vr, vi):
        self.re[pos], self.im[pos] = vr, vi
        self.written.append(np.ravel(pos))

    def check_writes(self, count):
        pos = np.concatenate(self.written)
        assert pos.size == count and np.unique(pos).size == count


def _half_warp_degree(addr):
    """The worst bank-pair conflict of 64-bit shared accesses: ``addr``
    [items] in complex units, one per item; the items of one loop round
    (thread = item) taken 16 at a time, a half warp; the degree is the most
    distinct addresses that share an address mod 16 (1: conflict-free)."""
    addr = np.asarray(addr)[:THREADS]
    worst = 1
    for h in range(0, addr.size - addr.size % 16, 16):
        distinct = np.unique(addr[h:h + 16])
        worst = max(worst, np.bincount(distinct % 16).max())
    return worst


def _cmac(ar, ai, fr, fi, xr, xi):
    return ar + fr * xr - fi * xi, ai + fr * xi + fi * xr


def _twiddle(cr, ci, wr, wi):
    """Each product and sum rounded alone in the arrays' dtype."""
    return cr * wr - ci * wi, cr * wi + ci * wr


def _stage1_model(xa, sa, n, rows, f2, tw1, dtype, degrees, write):
    """Stage 1 of csrc/dft_split3_f32.cuh (stage1, shared by both
    three-factor kernels) on the rows in ``xa`` (row r at r·sa): item →
    columns t and t + 64 of row r, outputs k0 .. k0 + K1; calls
    write(r, k, col, vr, vi) with the twiddled values [items, K1] of the
    items' column col (k [items, K1]) after recording its reads."""
    g = planes.split3_rows_geometry(n)
    n2, k1 = g["n2"], g["K1"]
    log2g = rows.bit_length() - 1 + 6
    item = np.arange((rows << 6) * (n2 // k1))
    k0 = (item >> log2g) * k1
    i = item & ((1 << log2g) - 1)
    r, t = i >> 6, i & 63
    k = k0[:, None] + np.arange(k1)                       # [items, K1]
    for col in (t, t + 64):
        base = r * sa + col
        ar = np.zeros(k.shape, dtype)
        ai = np.zeros(k.shape, dtype)
        for s in range(n2):
            vr, vi = xa.read(base + s * 128)
            degrees.append(("stage 1 read", _half_warp_degree(base + s * 128)))
            ar, ai = _cmac(ar, ai, f2[0][k, s], f2[1][k, s],
                           vr[:, None], vi[:, None])
        w = k * 128 + col[:, None]
        write(r, k, col, *_twiddle(ar, ai, tw1[0].ravel()[w],
                                   tw1[1].ravel()[w]))


def _load_model(xa, x, m0, rows, sa):
    """The block's rows m0 .. m0 + rows − 1 of x [M, N] into xa at r·sa
    (rows past M are zero)."""
    m, n = x.shape
    xa.begin()
    block = np.zeros((rows, n), np.complex128)
    block[:min(rows, m - m0)] = x[m0:m0 + rows]
    pos = np.arange(rows)[:, None] * sa + np.arange(n)
    xa.write(pos, block.real.astype(xa.re.dtype), block.imag.astype(xa.re.dtype))


def _split3_model(x, n, rows, tabs, dtype, degrees):
    """The kernel on one channel x [M, N] (complex) with R = ``rows``: its
    loads, three stages and transposed store, block by block, at
    ``dtype``; returns out [N, M] complex. Records the half-warp conflict
    degree of every stage access in ``degrees``."""
    f2, tw1, fw, tw2, fu = ((t.real.astype(dtype), t.imag.astype(dtype))
                            for t in tabs)
    g = planes.split3_rows_geometry(n)
    n2, p, sb, sa, sy = (g[k] for k in ("n2", "P", "Sb", "SA", "SY"))
    m = x.shape[0]
    r_ = rows
    log2n2 = n2.bit_length() - 1
    out = np.zeros((n, m), np.complex128)
    xa, ys = _Buffer(r_ * sa, dtype), _Buffer(r_ * sy, dtype)

    def write_y(r, k, col, vr, vi):
        dst = (r * sy)[:, None] + k * 128 + col[:, None]
        degrees.append(("stage 1 write", _half_warp_degree(dst[:, 0])))
        ys.write(dst, vr, vi)

    for m0 in range(0, m, r_):
        _load_model(xa, x, m0, r_, sa)
        ys.begin()
        _stage1_model(xa, sa, n, r_, f2, tw1, dtype, degrees, write_y)
        ys.check_writes(r_ * n)
        # stage 2a: columns c = (r·n2 + k2)·16 + u, c and c + half an item
        xa.begin()
        half = r_ * n2 * 8
        i = np.arange(half)
        for c in (i, i + half):
            u = c & 15
            rk = c >> 4
            r, k2 = rk >> log2n2, rk & (n2 - 1)
            src = r * sy + k2 * 128 + u
            dst = r * sa + u * p + k2
            ar = np.zeros((c.size, 8), dtype)
            ai = np.zeros((c.size, 8), dtype)
            for w in range(8):
                vr, vi = ys.read(src + w * 16)
                degrees.append(("stage 2a read", _half_warp_degree(src + w * 16)))
                ar, ai = _cmac(ar, ai, fw[0][:, w], fw[1][:, w],
                               vr[:, None], vi[:, None])
            degrees.append(("stage 2a write", _half_warp_degree(dst)))
            xa.write(dst[:, None] + np.arange(8) * sb,
                     *_twiddle(ar, ai, tw2[0][:, u].T, tw2[1][:, u].T))
        xa.check_writes(r_ * n)
        # stage 2b: columns c = (r·8 + b)·n2 + k2, c and c + half, outputs
        # a = 8·share .. + 7 an item
        ys.begin()
        half = r_ * 4 * n2
        item = np.arange(2 * half)
        share = (item >= half).astype(int)
        i = item - share * half
        a = share[:, None] * 8 + np.arange(8)                 # [items, 8]
        for c in (i, i + half):
            k2 = c & (n2 - 1)
            rb = c >> log2n2
            b, r = rb & 7, rb >> 3
            src = r * sa + b * sb + k2
            dst = r * sy + b * n2 + k2
            ar = np.zeros(a.shape, dtype)
            ai = np.zeros(a.shape, dtype)
            for u in range(16):
                vr, vi = xa.read(src + u * p)
                degrees.append(("stage 2b read", _half_warp_degree(src + u * p)))
                ar, ai = _cmac(ar, ai, fu[0][a, u], fu[1][a, u],
                               vr[:, None], vi[:, None])
            degrees.append(("stage 2b write", _half_warp_degree(dst)))
            ys.write(dst[:, None] + a * 8 * n2, ar, ai)
        ys.check_writes(r_ * n)
        # the transposed store (stockham.cuh store_rows<false>)
        valid = min(r_, m - m0)
        res = ys.re.astype(np.float64) + 1j * ys.im.astype(np.float64)
        out[:, m0:m0 + valid] = res.reshape(r_, sy)[:valid, :n].T
    return out


# (M, N, R): R ≤ the largest that fits, M ragged against R where it can be
MODEL_CASES = [(1, 128, 1), (3, 128, 2), (5, 256, 4), (13, 1024, 8),
               (1, 1024, 1), (7, 2048, 4), (7, 4096, 2), (2, 8192, 1)]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("m,n,rows", MODEL_CASES)
def test_split3_model_matches_float64_and_rows_plain(m, n, rows, inverse):
    assert planes.split3_rows_shared_bytes(rows, n) <= planes.SMEM_LIMIT
    rng = np.random.default_rng(n + m)
    xr, xi = (rng.normal(size=(m, n)).astype(np.float32) for _ in range(2))
    x = xr.astype(np.float64) + 1j * xi
    _, tabs = _split3_tables(n, inverse)
    # float64 with unrounded tables: the index maps and stage order give
    # the DFT, a float64 DFT within 1e-12
    degrees = []
    got64 = _split3_model(x, n, rows, _exact_split3_tables(n, inverse),
                          np.float64, degrees)
    want64 = (np.fft.ifft(x, axis=-1) * n if inverse
              else np.fft.fft(x, axis=-1)).T
    assert np.abs(got64 - want64).max() <= 1e-12 * np.abs(want64).max()
    # float32 with the kernel's roundings, against the plain version
    got32 = _split3_model(x, n, rows, tabs, np.float32, [])
    pr, pi = planes.rows_plain(torch.from_numpy(xr)[None],
                               torch.from_numpy(xi)[None], inverse, "f32",
                               True)
    want32 = (pr[0].numpy() + 1j * pi[0].numpy()).T
    scale = max(np.abs(want32.real).max(), np.abs(want32.imag).max())
    assert np.abs(got32 - want32).max() <= 1e-5 * scale
    # the header's bank arithmetic: every stage access conflict-free but
    # at N = 128 (n2 = 1), where two rows meet in a half warp
    worst = {}
    for what, degree in degrees:
        worst[what] = max(worst.get(what, 1), degree)
    if n > 128:
        assert worst == {k: 1 for k in worst}, worst


# ---- the bf16x3 three-factor kernel (csrc/dft_split3_bf16x3.cuh): its
# tables, and a numpy model of its stages, layouts and store

def _bf16_split(z):
    """complex z → (hi, lo), each part rounded to bfloat16 (nearest even)
    as f32 values: hi = bf16(z), lo = bf16(z − hi), per real component."""
    def parts(a):
        a = np.ascontiguousarray(a, np.float32)
        hi = planes._bf16_value(a)
        return hi, planes._bf16_value(a - hi)
    (hr, lr), (hi_, li) = parts(z.real), parts(z.imag)
    return hr + 1j * hi_, lr + 1j * li


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_split3_bf16x3_tables_are_the_f32_tables_and_their_split(n, inverse):
    """The kernel's tables: matrix_tables(n, inverse, True) word for word
    (F2, T, F_W, TW, F_U), zero-padded to 16 bytes where the header puts
    the fragments (Geometry::frag_words); then the A fragments of F_W and
    F_U, hi and lo, which read back by the PTX fragment layout are the
    real forms of bf16(F) and bf16(F − bf16(F)) (the plain version's
    split_bf16), hi + lo within 2⁻¹⁶ of F."""
    from tests.test_torch_precision import _real_form_bits, _torch_bf16, \
        _unpermute_fragments
    words = planes.split3_bf16x3_tables_np(n, inverse).view(np.uint32)
    f32 = planes.matrix_tables(n, inverse, True, torch.device("cpu")).numpy()
    geo = planes.split3_bf16x3_geometry(n, 1)
    at = geo["f32_words"]
    assert at % 4 == 0 and at - f32.size in (0, 2)
    np.testing.assert_array_equal(words[:f32.size], f32.view(np.uint32).ravel())
    assert not words[f32.size:at].any()
    fwr, fwi, _, _, fur, fui = planes._split3_tables_np(128, inverse)
    for fr, fi, tiles in ((fwr, fwi, 1), (fur, fui, 2)):
        size = tiles * tiles * 128
        hi = words[at:at + size].reshape(tiles, tiles, 32, 4)
        lo = words[at + size:at + 2 * size].reshape(tiles, tiles, 32, 4)
        at += 2 * size
        z = fr.astype(np.float64) + 1j * fi
        zh, zl = _bf16_split(z)
        for frags, part in ((hi, zh), (lo, zl)):
            np.testing.assert_array_equal(
                _unpermute_fragments(frags),
                _real_form_bits(part.real.astype(np.float32),
                                part.imag.astype(np.float32), _torch_bf16))
        assert np.abs(zh + zl - z).max() <= 2.0 ** -16
    assert at == words.size


def _warp_degree32(addr):
    """The worst bank conflict of 32-bit shared accesses: ``addr`` [items]
    in 4-byte words, the items of one loop round (thread = item) taken 32
    at a time, a warp; the degree is the most distinct addresses on one
    bank (1: conflict-free)."""
    addr = np.asarray(addr)[:THREADS]
    worst = 1
    for h in range(0, addr.size - addr.size % 32, 32):
        distinct = np.unique(addr[h:h + 32])
        worst = max(worst, np.bincount(distinct % 32).max())
    return worst


class _Words:
    """A shared plane of 32-bit words, each one complex value as a bf16
    pair (held here as a complex number), poisoned with NaN when a stage
    starts writing it."""

    def __init__(self, size):
        self.v = np.full(size, np.nan, np.complex128)
        self.written = []

    def begin(self):
        self.v[:] = np.nan
        self.written = []

    def write(self, pos, v):
        self.v[pos] = v
        self.written.append(np.ravel(pos))

    def check_writes(self, count):
        pos = np.concatenate(self.written)
        assert pos.size == count and np.unique(pos).size == count


def _mma3(f, b, exact):
    """A tile's three products: hi·hi + hi·lo + lo·hi of F [m, k] and the
    B operand (hi, lo) [k, cols] (the products of bf16 parts are exact;
    the f32 sum is taken here in float64, then rounded once)."""
    bh, bl = b
    if exact:
        return f @ bh
    fh, fl = _bf16_split(f)
    return (fh @ bh + fh @ bl + fl @ bh).astype(np.complex64)


def _split3_bf16x3_model(x, n, rows, tabs, exact, degrees):
    """csrc/dft_split3_bf16x3.cuh on one channel x [M, N] (complex) with
    R = ``rows``, block by block: the load and stage 1 as the f32 kernel's
    (at float64 with no split where ``exact``, else at float32), stage 1's
    epilogue into H1's hi and lo planes, stage 2a a warp tile at a time
    from its lanes' B-fragment addresses, its epilogue into H2, stage 2b
    likewise, and its store straight to out [N, M]. Records the conflict
    degree of every shared access in ``degrees``; checks that each stage
    writes each word once and each output is stored once."""
    dtype = np.float64 if exact else np.float32
    cdt = np.complex128 if exact else np.complex64
    f2, tw1 = ((t.real.astype(dtype), t.imag.astype(dtype)) for t in tabs[:2])
    fw, tw2, fu = (t.astype(cdt) for t in tabs[2:])
    geo = planes.split3_bf16x3_geometry(n, rows)
    n2, e, h2w = geo["n2"], geo["pad"], geo["h2_words"]
    log2n2, log2r = n2.bit_length() - 1, rows.bit_length() - 1
    m = x.shape[0]
    out = np.full((n, m), np.nan, np.complex128)
    xa = _Buffer(rows * n, dtype)
    h1 = (_Words(rows * n), _Words(rows * n))
    h2 = (_Words(h2w), _Words(h2w))
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3

    def split(v):
        return (v, np.zeros_like(v)) if exact else _bf16_split(v)

    def write_h1(r, k, col, vr, vi):
        u, w = col & 15, col >> 4
        pos = (((r * n2)[:, None] + k) * 16 + u[:, None]) * 8 + (
            w ^ ((u >> 1) & 6))[:, None]
        for kk in range(k.shape[1]):
            degrees.append(("stage 1 write", _warp_degree32(pos[:, kk])))
        for plane, part in zip(h1, split(vr.astype(np.float64) + 1j * vi)):
            plane.write(pos, part)

    for m0 in range(0, m, rows):
        _load_model(xa, x, m0, rows, n)
        for plane in h1:
            plane.begin()
        _stage1_model(xa, n, n, rows, f2, tw1, dtype, degrees, write_h1)
        for plane in h1:
            plane.check_writes(rows * n)
        # stage 2a: tile tn holds columns (r·n2 + k2)·16 + u, u = u0 + g
        for plane in h2:
            plane.begin()
        for tn in range(rows * n // 64):
            u0, rk = 8 * (tn & 1), tn >> 1
            u = u0 + g
            pos = (rk * 16 + u) * 8 + ((2 * q) ^ ((u >> 1) & 6))
            degrees.append(("stage 2a B load", _half_warp_degree(pos >> 1)))
            b = [np.zeros((8, 8), np.complex128) for _ in h1]
            for part, plane in zip(b, h1):
                part[2 * q, g] = plane.v[pos]
                part[2 * q + 1, g] = plane.v[pos + 1]
            d = _mma3(fw, b, exact)                       # [b, 8 columns]
            r, k2 = rk >> log2n2, rk & (n2 - 1)
            p = ((g * n2 + k2) << log2r) + r + e * g
            at = p * 16 + ((u0 + 2 * q) ^ (((p >> 1) & 1) << 3))
            degrees.append(("stage 2a write", _half_warp_degree(at >> 1)))
            for j in (0, 1):
                v = d[g, 2 * q + j]
                w = tw2[g, u0 + 2 * q + j]
                vr, vi = _twiddle(v.real, v.imag, w.real, w.imag)
                for plane, part in zip(h2, split(vr.astype(np.float64) + 1j * vi)):
                    plane.write(at + j, part)
        for plane in h2:
            plane.check_writes(rows * n)
        # stage 2b: tile tn holds columns c2 = j·R + r, j = b·n2 + k2
        log2b = log2n2 + log2r
        for tn in range(rows * n // 128):
            c2 = tn * 8 + g
            p = c2 + e * (c2 >> log2b)
            b = [np.zeros((16, 8), np.complex128) for _ in h2]
            for kb in (0, 1):
                at = p * 16 + ((kb * 8 + 2 * q) ^ (((p >> 1) & 1) << 3))
                degrees.append(("stage 2b B load", _half_warp_degree(at >> 1)))
                for part, plane in zip(b, h2):
                    part[kb * 8 + 2 * q, g] = plane.v[at]
                    part[kb * 8 + 2 * q + 1, g] = plane.v[at + 1]
            d = _mma3(fu, b, exact)                       # [a, 8 columns]
            col = tn * 8 + np.arange(8)
            j, r = col >> log2r, col & (rows - 1)
            k = np.arange(16)[:, None] * 8 * n2 + j       # [a, columns]
            keep = m0 + r < m
            assert np.isnan(out[k[:, keep], m0 + r[keep]]).all()
            out[k[:, keep], m0 + r[keep]] = d[:, keep]
    assert not np.isnan(out).any()
    return out


# (M, N, R): R ≤ the largest that fits, M ragged against R where it can be
# (N = 256 at R = 1 and N = 128 at R = 2 are the header's n2·R = 2 cases)
BF16X3_MODEL_CASES = [(1, 128, 1), (3, 128, 2), (1, 256, 1), (5, 256, 4),
                      (13, 1024, 8), (6, 1024, 4), (1, 1024, 1),
                      (7, 2048, 4), (7, 4096, 2), (2, 8192, 1)]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("m,n,rows", BF16X3_MODEL_CASES)
def test_split3_bf16x3_model_matches_float64_and_rows_plain(m, n, rows,
                                                            inverse):
    """The model in float64 with unrounded tables and no split gives the
    DFT (1e-12·max): the index maps, layouts and store are right. At
    float32 with the kernel's roundings and splits it is the plain
    version (rows_plain at bf16x3, three-factor) within the tier's
    kernel-vs-plain band, 1e-5·max. Every shared access the header names
    is conflict-free, but the stage-2a epilogue's writes where n2·R = 2
    (2-way, as the header says)."""
    assert planes.split3_bf16x3_shared_bytes(rows, n) <= planes.SMEM_LIMIT
    rng = np.random.default_rng(n + m)
    xr, xi = (rng.normal(size=(m, n)).astype(np.float32) for _ in range(2))
    x = xr.astype(np.float64) + 1j * xi
    degrees = []
    got64 = _split3_bf16x3_model(x, n, rows, _exact_split3_tables(n, inverse),
                                 True, degrees)
    want64 = (np.fft.ifft(x, axis=-1) * n if inverse
              else np.fft.fft(x, axis=-1)).T
    assert np.abs(got64 - want64).max() <= 1e-12 * np.abs(want64).max()
    _, tabs = _split3_tables(n, inverse)
    got32 = _split3_bf16x3_model(x, n, rows, tabs, False, [])
    pr, pi = planes.rows_plain(torch.from_numpy(xr)[None],
                               torch.from_numpy(xi)[None], inverse, "bf16x3",
                               True)
    want32 = (pr[0].numpy() + 1j * pi[0].numpy()).T
    scale = max(np.abs(want32.real).max(), np.abs(want32.imag).max())
    assert np.abs(got32 - want32).max() <= 1e-5 * scale
    worst = {}
    for what, degree in degrees:
        worst[what] = max(worst.get(what, 1), degree)
    want = {k: 1 for k in worst}
    if n // 128 * rows == 2:
        want["stage 2a write"] = 2
    assert worst == want, worst


# the bf16x3 three-factor pass at the shapes path (ix) gives it and two
# more: R = 8 rows a block (32-byte runs of the transposed store; fastest
# at [1,1024,1024] in the H100 sweep, chip_smoke.py --sweep-rows), one
# block an SM by shared memory there
@pytest.mark.parametrize("shape,rows", [
    ((1, 1024, 1024), 8), ((1, 1, 1024), 1), ((1, 512, 1024), 4),
    ((3, 1024, 1024), 8), ((1, 4096, 4096), 2), ((1, 64, 8192), 1)])
def test_split3_bf16x3_rows_per_block(shape, rows):
    c, m, n = shape
    shared = planes.block_shared_bytes("bf16x3", True, False)
    cap = planes.row_pass_max_rows(n, False, "bf16x3", True)
    got = planes.rows_per_block(c, m, n, SMS, cap, shared)
    assert got == rows
    assert shared(got, n) <= planes.SMEM_LIMIT


def test_split3_bf16x3_shared_bytes_of_the_header():
    """The sizes dft_split3_bf16x3.cuh states: 8·(2·R·N + 128·e + n2²)
    bytes, 130 KB at N = 1024, R = 8; 66 KB at R = 4; 137 KB at N = 4096,
    R = 2; 161 KB at N = 8192, R = 1."""
    kb = {(1024, 8): 132608, (1024, 4): 67072, (4096, 2): 140288,
          (8192, 1): 164864}
    for (n, rows), want in kb.items():
        assert planes.split3_bf16x3_shared_bytes(rows, n) == want


# ---- a numpy model of csrc/rows_natural_f32.cuh (the f32 natural store)

def _radix16_constants(dtype):
    """cos and sin of π/8 and √½, as the header's f32 literals (or in
    float64)."""
    return tuple(dtype(v) for v in (np.cos(np.pi / 8), np.sin(np.pi / 8),
                                    np.sqrt(0.5)))


class _Radix16Ops:
    """The header's in-register arithmetic on (re, im) pairs of ``dtype``
    arrays, operation for operation (the card may contract a product and
    a sum into one FMA, which the f32 band covers)."""

    def __init__(self, dtype, sg):
        self.dtype, self.sg = dtype, dtype(sg)
        self.c, self.s, self.h = _radix16_constants(dtype)

    @staticmethod
    def add(a, b):
        return a[0] + b[0], a[1] + b[1]

    @staticmethod
    def sub(a, b):
        return a[0] - b[0], a[1] - b[1]

    def rot_i(self, a):
        return -self.sg * a[1], self.sg * a[0]

    def rot16(self, a, e):
        sg, c, s, h = self.sg, self.c, self.s, self.h
        if e == 0:
            return a
        if e == 4:
            return self.rot_i(a)
        if e == 2:
            return (a[0] - sg * a[1]) * h, (a[1] + sg * a[0]) * h
        if e == 6:
            return (-a[0] - sg * a[1]) * h, (sg * a[0] - a[1]) * h
        cc, ss = {1: (c, s), 3: (s, c), 9: (-c, -s)}[e]
        ss = sg * ss
        return a[0] * cc - a[1] * ss, a[0] * ss + a[1] * cc

    @staticmethod
    def cmul(a, w):
        return a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0]

    def dft4(self, a):
        s02, d02 = self.add(a[0], a[2]), self.sub(a[0], a[2])
        s13, j13 = self.add(a[1], a[3]), self.rot_i(self.sub(a[1], a[3]))
        return [self.add(s02, s13), self.add(d02, j13), self.sub(s02, s13),
                self.sub(d02, j13)]

    def dft8(self, u):
        u = list(u)
        u[0::2] = self.dft4(u[0::2])
        u[1::2] = self.dft4(u[1::2])
        for i, e in ((3, 2), (5, 4), (7, 6)):
            u[i] = self.rot16(u[i], e)
        return ([self.add(u[2 * k], u[2 * k + 1]) for k in range(4)]
                + [self.sub(u[2 * k], u[2 * k + 1]) for k in range(4)])

    def dft16(self, v):
        v = list(v)
        for s1 in range(4):
            v[s1::4] = self.dft4(v[s1::4])
        for s1 in range(1, 4):
            for k1 in range(1, 4):
                v[s1 + 4 * k1] = self.rot16(v[s1 + 4 * k1], s1 * k1)
        for k1 in range(4):
            v[4 * k1:4 * k1 + 4] = self.dft4(v[4 * k1:4 * k1 + 4])
        return [v[4 * (k & 3) + (k >> 2)] for k in range(16)]

    def first_pass(self, v, r):
        if r == 16:
            return self.dft16(v)
        b = 16 // r
        dft = {2: lambda u: [self.add(*u), self.sub(*u)], 4: self.dft4,
               8: self.dft8}[r]
        out = list(v)
        for q in range(b):
            out[q::b] = dft(v[q::b])
        return out


def _radix16_exact_twiddles(n, inverse):
    """radix16_twiddles_np's entries in float64, unrounded."""
    sign = 1.0 if inverse else -1.0
    parts = [np.array([sign * 1j])]
    for _, span in planes.radix16_plan(n)[1:]:
        sk = np.outer(np.arange(1, 16), np.arange(span))
        parts.append(np.exp(sign * 2j * np.pi * sk / (16 * span)).ravel())
    w = np.concatenate(parts)
    return np.stack([w.real, w.imag], axis=-1)


def _radix16_passes(v, n, row, t, ops, tw, buf, log):
    """radix16::passes on the 16 points ``v`` of every thread (row, t)
    of a block, v[m] a (re, im) pair of arrays over the threads holding
    point t + T·m: the first pass in registers, then each later pass's
    exchange through ``buf`` (a _Buffer of R rows of the padded stride) and
    its radix-16 pass, with the twiddles ``tw`` ([L, 2], read at the
    header's offsets). Returns the last pass's outputs, output s at
    t + T·s. Appends (what, shared addresses of one access a thread, in
    complex units, None) to ``log`` for every exchange write and read."""
    t_row = n // 16
    plan = planes.radix16_plan(n)
    first = plan[0][0]
    stride = planes.radix16_stride(n)
    period = planes.radix16_pad(n)
    rows = int(row.max()) + 1

    def pos(a):
        return row * stride + a + a // period

    v = ops.first_pass(v, first)
    for p, (radix, span) in enumerate(plan):
        if p > 0:
            v = []
            for j in range(16):
                a = pos(t + t_row * j)
                log.append(("read", a, None))
                v.append(buf.read(a))
            k = t & (span - 1)
            at = 1 + span - first + k
            v = [v[0]] + [ops.cmul(v[s], (tw[at + (s - 1) * span, 0],
                                          tw[at + (s - 1) * span, 1]))
                          for s in range(1, 16)]
            v = ops.dft16(v)
        if p == len(plan) - 1:
            break
        # every read of the pass is done (the barrier): the buffer's
        # points are spent
        buf.begin()
        if p == 0:
            b = 16 // radix
            for q in range(b):
                for s in range(radix):
                    a = pos((t + t_row * q) * radix + s)
                    log.append(("write", a, None))
                    buf.write(a, *v[q + s * b])
        else:
            base = (t - k) * 16 + k
            for s in range(16):
                a = pos(base + s * span)
                log.append(("write", a, None))
                buf.write(a, *v[s])
        buf.check_writes(rows * n)
        assert max(np.concatenate(buf.written)) < rows * stride
    # the last pass has span n/16
    assert plan[-1][1] == n // 16
    return v


def _radix16_model(x, rows, table, dtype, log):
    """The kernel on one channel x [M, N] (complex) with R = ``rows``: its
    loads, passes, exchanges through the padded shared buffer and its
    store, block by block, at ``dtype``, with the twiddles of ``table``
    ([L, 2], read at the header's offsets); returns out [M, N] complex.
    Appends (what, shared addresses of one access a thread, in complex
    units) to ``log`` for every exchange write and read, and (what, global
    float offsets) for every device-memory load and store."""
    m, n = x.shape
    t_row = n // 16
    stride = planes.radix16_stride(n)
    threads = rows * t_row
    assert threads <= planes.RADIX16_MAX_THREADS
    tid = np.arange(threads)
    row, t = tid // t_row, tid % t_row
    ops = _Radix16Ops(dtype, table[0, 1])
    assert table[0, 0] == 0 and abs(table[0, 1]) == 1
    tw = table.astype(dtype)
    buf = _Buffer(rows * stride, dtype)
    out = np.zeros((m, n), np.complex128)
    writes = np.zeros((m, n), int)

    for m0 in range(0, m, rows):
        live = m0 + row < m
        rr = np.minimum(m0 + row, m - 1)
        v = []
        for j in range(16):
            a = t + t_row * j
            vals = np.where(live, x[rr, a], 0)
            v.append((vals.real.astype(dtype), vals.imag.astype(dtype)))
            log.append(("load", rr * n + a, live))
        v = _radix16_passes(v, n, row, t, ops, tw, buf, log)
        # the last pass (span n/16) stores output s at t + T·s
        for s in range(16):
            a = t + t_row * s
            log.append(("store", rr * n + a, live))
            vr, vi = v[s]
            assert not (np.isnan(vr[live]).any() or np.isnan(vi[live]).any())
            out[rr[live], a[live]] = (vr[live].astype(np.float64)
                                      + 1j * vi[live].astype(np.float64))
            np.add.at(writes, (rr[live], a[live]), 1)
    assert (writes == 1).all()
    return out


RADIX16_NS = [1 << i for i in range(4, 14)]


def test_radix16_plan_and_twiddle_table():
    """The passes multiply to N, each span the product of the radices
    before it, the last span N/16; the table holds the direction and the
    N − r0 twiddles at the header's offsets, the f32 rounding of its
    float64 entries."""
    for n in RADIX16_NS:
        plan = planes.radix16_plan(n)
        radices = [r for r, _ in plan]
        assert radices[1:] == [16] * (len(plan) - 1)
        assert radices[0] in (2, 4, 8, 16) and np.prod(radices) == n
        spans = np.cumprod([1] + radices[:-1])
        assert [s for _, s in plan] == list(spans)
        assert plan[-1][1] == max(1, n // 16)
        for inverse in (True, False):
            table = planes.radix16_twiddles_np(n, inverse)
            exact = _radix16_exact_twiddles(n, inverse)
            assert table.dtype == np.float32
            assert table.shape == (n - radices[0] + 1, 2)
            np.testing.assert_array_equal(table, exact.astype(np.float32))
            assert tuple(table[0]) == (0.0, 1.0 if inverse else -1.0)
            sign = 1 if inverse else -1
            for _, span in plan[1:]:
                at = 1 + span - radices[0]
                for s in (1, 7, 15):
                    k = np.arange(span)
                    want = np.exp(sign * 2j * np.pi * s * k / (16 * span))
                    got = exact[at + (s - 1) * span + k]
                    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1],
                                               want, atol=1e-15)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", RADIX16_NS)
def test_radix16_model_matches_float64_and_is_conflict_free(n, inverse):
    """The model at the wrapper's largest R and a ragged M (a full block
    and part of one): every output written once, float64 within
    1e-12·max of a float64 DFT; every exchange write and read free of
    half-warp bank conflicts (rows share a half warp below N = 256); every
    warp's device-memory loads and stores runs of consecutive floats, a
    whole warp's 32 from N = 512 on."""
    rows = planes.radix16_max_rows(n)
    m = rows + max(1, rows // 2) + 1
    rng = np.random.default_rng(n)
    x = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    log = []
    got = _radix16_model(x, rows, _radix16_exact_twiddles(n, inverse),
                         np.float64, log)
    want = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    threads = rows * n // 16
    for what, addr, live in log:
        if what in ("read", "write"):
            assert _round_degree(addr, threads) == 1, (what, n)
        else:
            run = min(32, n // 16)
            for w in range(0, threads, 32):
                a, ok = addr[w:w + 32], live[w:w + 32]
                if ok.all():
                    pieces = np.split(a, np.flatnonzero(np.diff(a) != 1) + 1)
                    assert all(p.size % run == 0 for p in pieces), (what, n)
    assert sum(what == "write" for what, _, _ in log) == (
        (len(planes.radix16_plan(n)) - 1) * 16 * -(-m // rows))


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 256), (2, 16, 512), (1, 8, 1024),
                                   (1, 3, 4096)])
def test_radix16_model_f32_matches_jax_and_plain(shape, inverse):
    """The model in float32 with the f32 table against JAX's
    fft1d_natural_large (the Pallas kernel in interpret mode; at
    [1, 3, 4096], no row block of 8 divides M, its einsum route) and
    against the plain version, each within 1e-5·max (the kernel-vs-plain
    band of the f32 tier)."""
    c, m, n = shape
    rng = np.random.default_rng(m * n)
    xr, xi = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jr, ji = pf.fft1d_natural_large(xr, xi, inverse)
    pr, pi = planes.fft1d_natural_large_plain(torch.from_numpy(xr),
                                              torch.from_numpy(xi), inverse)
    table = planes.radix16_twiddles_np(n, inverse)
    rows = planes.radix16_max_rows(n)
    for ch in range(c):
        x = xr[ch].astype(np.float64) + 1j * xi[ch]
        got = _radix16_model(x, rows, table, np.float32, [])
        for wr, wi in ((np.asarray(jr)[ch], np.asarray(ji)[ch]),
                       (pr[ch].numpy(), pi[ch].numpy())):
            want = wr.astype(np.float64) + 1j * wi
            scale = max(np.abs(wr).max(), np.abs(wi).max())
            assert np.abs(got - want).max() <= 1e-5 * scale


def test_radix16_shared_bytes_of_the_header():
    """radix16::shared_bytes: R·S complex, S = N + N/16 from N = 256 on
    (34,816 bytes at N = 4096, R = 1: the four blocks that the registers
    allow fit an SM's 228 KB; 69,632 at N = 8192, R = 1), N + 16 + N/16
    below (one pad every N/16 points, S = 50 at N = 32), none at
    N = 16."""
    assert [planes.radix16_pad(1 << i) for i in range(4, 14)] == [
        1, 2, 4, 8, 16, 16, 16, 16, 16, 16]
    assert [planes.radix16_stride(n) for n in (32, 64, 128, 256, 4096)] == [
        50, 84, 152, 272, 4352]
    sizes = {(4096, 1): 34816, (4096, 2): 69632, (8192, 1): 69632,
             (1024, 4): 34816, (2048, 2): 34816, (32, 128): 51200,
             (128, 32): 38912, (16, 256): 0}
    for (n, rows), want in sizes.items():
        assert planes.radix16_shared_bytes(rows, n) == want


# the f32 natural pass at the paths' shapes ((iii), (iv), (xiii)'s
# velocity: [1, 4096, 4096], [1, 2048, 4096], [1, 1, 4096], [3, 4096,
# 4096]) and the checked [1, 1024, 1024]: (rows, blocks an SM by shared
# memory)
@pytest.mark.parametrize("shape,rows", [
    ((1, 4096, 4096), 1), ((1, 2048, 4096), 1), ((1, 1, 4096), 1),
    ((3, 4096, 4096), 1), ((1, 1024, 1024), 4), ((1, 3, 8192), 1),
    ((1, 5, 16), 1), ((1, 1000, 64), 8)])
def test_radix16_rows_per_block_at_the_paths_shapes(shape, rows):
    c, m, n = shape
    shared = planes.block_shared_bytes("f32", False, True)
    assert shared is planes.radix16_shared_bytes
    cap = planes.row_pass_max_rows(n, True, "f32", False)
    assert cap == planes.radix16_max_rows(n)
    got = planes.rows_per_block(c, m, n, SMS, cap, shared)
    assert got == rows
    if n == 4096:
        # four blocks an SM, as many as 64 registers a thread allow (1 KB
        # of each SM's shared memory is the system's a block)
        assert 4 * (shared(got, n) + 1024) <= SM_SHARED
    # the fused kernels keep their rows (NATURAL_BLOCK_POINTS)
    assert planes.max_rows(n, True) == max(1, planes.NATURAL_BLOCK_POINTS // n)


@pytest.mark.parametrize("n", RADIX16_NS)
def test_every_radix16_block_the_wrapper_picks_fits(n):
    """At every batch and every rows the sweep may take, a block of the
    f32 natural kernel fits the card's shared memory and 512 threads; the
    wrapper's cap keeps RADIX16_BLOCK_POINTS."""
    shared = planes.block_shared_bytes("f32", False, True)
    cap = planes.radix16_max_rows(n)
    assert cap * n <= max(n, planes.RADIX16_BLOCK_POINTS)
    for c in (1, 3, 5):
        for m in (1, 2, 3, 7, 64, 131, 133, 512, 1000, 2048, 4096, 8192):
            rows = planes.rows_per_block(c, m, n, SMS, cap, shared)
            assert rows & (rows - 1) == 0 and 1 <= rows <= cap
            assert shared(rows, n) <= planes.SMEM_LIMIT
            assert rows * n // 16 <= planes.RADIX16_MAX_THREADS
    for rows in (1, 2, 4, 8, 16):
        if rows * n <= 16 * planes.RADIX16_MAX_THREADS:
            assert shared(rows, n) <= planes.SMEM_LIMIT
