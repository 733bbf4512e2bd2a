// The bf16 and bf16x3 row DFTs in the direct form, either store:
// bf16_rows_mixed.cu's entry tpu_bf16_rows_mixed, which takes the tier.
// bf16 (tier 1) at even lengths that are not powers of two (the powers of
// two run dft_bf16_rows.cuh); bf16x3 (tier 2) at every even length in
// [16, 8192].
//
// Replaces tpu_ocean/fft/pallas_fft.py _fft_block_kernel (launched by
// _fft1d_transposed_impl) and _rowfft_block_kernel_natural (launched by
// _fft1d_natural_large_impl) at lax.Precision.DEFAULT at those lengths and
// at the bf16x3 tier B3 (kernel_precision, KERNEL_B3_THRESHOLD) at every
// length, and in this port the matrix engine's bf16 and bf16x3 direct
// instantiations (MatrixEngine<kTierBf16, false>, MatrixEngine<
// kTierBf16x3, false>) behind fft_rows.cu's fft_rows_kernel and
// rows_mixed_f32.cuh's mixed_rows_kernel, which fft_rows.cu's
// tpu_fft_rows_* and tpu_matrix_rows_any now refuse. Contract: (re, im)
// f32 [C, M, N] → the transposed (re, im) f32 [C, N, M] or the
// natural-order [C, M, N], unnormalized, + sign for the inverse.
//
// Numerics are those of the plain version (fft/matrix.py rows_dft) operand
// for operand. bf16, as dft_bf16_rows.cuh states them: x and the f32
// tables rounded to bf16, stage 1 accumulated in f32, C ⊙ T in f32 with
// each product and sum rounded alone, rounded to bf16 for stage 2,
// accumulated in f32. bf16x3: stage 1 in f32 on the unrounded rows and
// tables (the TPU kernel's p1 = HIGHEST at B3), C ⊙ T in f32 with each
// product and sum rounded alone, then stage 2's operands, F1 and C ⊙ T,
// split into hi = bf16(x) and lo = bf16(x − hi) (round to nearest even),
// keeping hi·hi + hi·lo + lo·hi in the real form (four real products a
// complex product), accumulated in f32 and added into an f32 sum every
// 128 complex of depth (dft_matrix.cuh kPromoteBlocks). Only the order of
// the f32 sums differs.
//
// The four-step N = n2 · n1 of pallas_fft._split_lanes (lanes_n1), in two
// regimes:
//
// 1. n1 ≤ 128: N = 128 · n2 with n2 in 1 … 64 (every power of two from
//    128, and 384, 640, 768, 1536, 3072, 6144 …), and every N below 256
//    with n1 = N / 2, n2 = 2 (16, 32, 64; 96, 106 with n1 = 53, 160, 224).
//    The power-of-two kernel's design, generalized:
//    R rows a block of 512 threads, staged as bf16 pairs at padded
//    strides; stage 1 on mma.sync.m16n8k16 with F2's pre-rounded A
//    fragments (in registers where n2 ≤ 32), its epilogue forming C ⊙ T
//    once as bf16 pairs; stage 2 with F1's tile in 64 registers a warp;
//    the f32 result over the consumed rows, then a coalesced store. What
//    changes against the power-of-two kernel:
//    - depths that are not a multiple of 8 (n2 = 3, 12, 24, 48; n1 = 53)
//      are zero table columns (planes.mma_a_fragments pads them) against
//      zero inputs: stage 1 reads no s ≥ n2, and its epilogue writes zeros
//      at t in [n1, 8·⌈n1/8⌉) for stage 2's padded depth;
//    - outputs past n1 or n2 are never stored;
//    - a tile count that does not divide the 16 warps (⌈n2/8⌉ = 3, 5, 6,
//      7; ⌈n1/8⌉ = 7 at n1 = 53) leaves the last warps idle in that stage;
//    - the row index of a point and the stores divide by N with a
//      multiply (div_magic), not a shift, as mixed::store does by
//      division;
//    - the padded strides, rechecked for bank conflicts (32 banks of 4
//      bytes; lane = 4g + q) at n1p = 8·⌈n1/8⌉: rows at n1p + 4 words an
//      s-row, as the power-of-two kernel's n1 + 4 (stage 1's B load reads
//      bank 8q + g at n1p = 128, n2 > 2; at n2 = 2 only the q = 0 lanes
//      load, 8 distinct banks); C ⊙ T at n1p + 8 + (n1p & 8) words, ≡ 8 or
//      24 mod 32 (136 at n1 = 128; 72 at 53, where n1p + 8 = 64 would put
//      the four g of a half warp's 64-bit B load on one bank), so the half
//      warp's 16 lanes read 32 distinct banks.
//    One instantiation per ⌈n2/8⌉ at n1 = 128 (1 … 8) and one for n2 = 2
//    at n1 < 128, not one per N. What bounds it on the H100: device
//    memory, 16 B a point (37.7 MB, 0.0113 ms at 3.35 TB/s for
//    [1, 1536, 1536]); the products are 8·(n1 + n2) bf16 flops a point.
//
//    At bf16x3 the same block, rows, stage-2 tiles, result and stores, with
//    what the tier changes (design 1 of the three the hi/lo split allows;
//    F1's hi and lo fragments together are 256 KB at n1 = 128, the SM's
//    whole register file, so they cannot both sit in registers at 512
//    threads, and two launches at every N would move 32 B a point instead
//    of 16):
//    - the rows staged as complex f32 at r·N + n, the input's own order
//      (float4 loads where 4 | N, else float2; no division), aliased by the
//      f32 result after stage 1;
//    - stage 1 in f32 FFMA, as dft_split3_f32.cuh's stage1 runs it: an
//      item is 2 columns c and c + R·n1p/2 (c = r·n1p + t) and kK outputs
//      k2 (kK = 8 from n2 = 5, else the next power of two ≥ n2; F2
//      zero-padded to whole rows of 16), the share the slowest index so
//      that a warp reads F2 at one address: F2 sits s-major in shared
//      memory (f2s[s·n2p + k]) over F1's lo pairs' region until stage 1
//      is done (beside the rest it would not fit at N = 8192), one 16-byte
//      broadcast feeding 16 FFMAs; 512 items at [*, 1024] R = 8,
//      [*, 4096] R = 2 and [*, 8192] R = 1, every thread busy;
//    - its epilogue forms C ⊙ T once and splits it once (split_pair) into a
//      hi and a lo plane of bf16 pairs at C ⊙ T's padded stride, zeros at t
//      in [n1, n1p);
//    - stage 2 three products a k-step: F1's hi tile in the warp's 64
//      registers, issued at the block's start beside at most 32 stage-1
//      accumulators; F1's lo part as complex bf16 pairs in shared memory
//      in A-fragment order (n1p² × 4 B, 64 KB at n1 = 128: a warp's 64-bit
//      load is 256 contiguous bytes), copied there by cp.async after stage
//      1 (planes keeps the table in that form: the pairs of the lo
//      fragments' registers 1 and 3, 64 KB a block from L2 where the
//      fragments would be 128 KB), expanded to A registers with a sign
//      flip and a half swap as regime 2 builds its A registers; hi·hi into one
//      accumulator, hi·lo and lo·hi into another (two dependency chains),
//      added once. The depth is at most 128: one accumulator each covers it
//      (kPromoteBlocks).
//    Shared memory a block (planes.bf16x3_rows_shared_bytes): R·(N + 1)·8
//    (the rows, then the result) + 2·R·n2·ys·4 (C ⊙ T hi and lo) + n1p²·4
//    (F2 during stage 1, at most n2·16·⌈n2/16⌉·8 B, then F1's lo pairs):
//    196 KB at N = 1024, R = 8 and at N = 8192, R = 1; 163 KB at N = 1536,
//    R = 4. One instantiation per kK at n1 = 128 (1, 2, 4, 8) and one for
//    n2 = 2 at n1 < 128. What bounds it on the H100: device memory at
//    small n2 (16 B a point), the f32 stage 1 (8·n2 + 6 operations a
//    point at 67 TFLOP/s) and the products (3 · 8·n1 bf16 flops a point)
//    at large N: operations at [1, 4096, 4096] (4.4 Gflop f32 and 51.5
//    Gflop bf16, 0.1177 ms).
//
// 2. n1 = N / 2 > 128 (every even N above 256 that 128 does not divide:
//    1000, 2042, 8186, 8190 …). Stage 2 is a dense n1 × n1 complex product
//    over every row, 8·n1 bf16 flops a point: 2.19 Tflop, 2.2 ms of the
//    tensor cores' 989 TFLOP/s at [1, 8186, 8186], far above the byte
//    bound (0.32 ms) and above cuFFT's cheaper algorithm (2.75 ms). The
//    matrix engine read all of F1 from L2 once for every block of R rows
//    (134 MB a row at N = 8186). Here it is a tiled matrix product over
//    the whole batch, two launches:
//    - gemm_prep_kernel: stage 1 is a length-2 DFT (F2 = [[1, 1], [1, −1]]
//      in bf16) of the bf16-rounded inputs, C[1] twiddled by T[1, t] in
//      f32 (T[0, t] = 1), each rounded to a bf16 pair: X′[(c·M + m)·2 +
//      k2, t] in device memory, ldk = 32·⌈n1/32⌉ words a row, zero past n1
//      (12 B a point moved);
//    - gemm_rows_kernel: Y[(m, k2), k1] = Σ_t F1[k1, t] · X′[(m, k2), t]
//      as a tiled product: a block of 4 warps owns 64 k1 × 64 columns and
//      walks t in chunks of 32 complex, F1's and X′'s chunks copied into
//      shared memory with cp.async, three stages in flight; a warp owns
//      32 k1 × 32 columns, 16 mma.sync.m16n8k16 a k-step from 64-bit
//      fragment loads (rows at 40 words, ≡ 8 mod 32: conflict-free). F1
//      is planes' pre-rounded table of complex bf16 pairs (re low), 64·⌈n1
//      / 64⌉ rows of ldk words, zero-padded; a lane builds its A
//      registers (Fr, −Fi) and (Fi, Fr) from a pair with a sign flip and a
//      half swap. The grid walks groups of kGroup k1 tiles, k1 fastest, so
//      the blocks resident together share a group of F1 tiles (16.8 MB at
//      N = 8186) that stays in L2 while the columns pass, and X′ is read
//      from device memory once a group. Tiles built in shared memory from
//      the n1 roots, F1[k1, t] = w[(k1·t) mod n1], are not bit-equal to the
//      rounded table at composite n1 (tests/test_torch_bf16_mixed.py: at
//      n1 = 135 the exact zeros of sin(2π·m) are residues ≤ 1e-13 in the
//      table) and cost a multiply, a reduction and a gather an entry where
//      the table costs a quarter of a 16-byte copy: the table is kept.
//      Each 32 × 32 tile's mma accumulator is added into an f32 sum
//      rounded to nearest every 128 complex of depth (dft_matrix.cuh
//      kPromoteBlocks) and zeroed. The 64 × 64 result goes through shared
//      memory to the natural or transposed store, 128 consecutive floats
//      or 32 consecutive m a run.
//    At bf16x3 the same two launches with a tier parameter:
//    - gemm_prep_kernel<bf16x3>: stage 1 in f32 on the unrounded inputs
//      from F2's f32 table (its sin(π) residue included, as the plain
//      version's product has it), C[1] ⊙ T[1, t], each split once: X′ as a
//      hi plane and a lo plane of complex bf16 pairs (planes.
//      bf16x3_rows_scratch_words: twice the bf16 scratch; 16 B a point
//      moved);
//    - gemm_rows_kernel<bf16x3>: F1's hi and lo tables (pre-split complex
//      bf16 pairs, zero-padded as the bf16 table) and X′'s two planes
//      staged together, 2 × (64 + 64) rows of 40 words a stage (120 KB for
//      three), 48 mma.sync a warp a k-step (hi·hi, hi·lo, lo·hi into one
//      accumulator); the group of F1 tiles that stays in L2 doubles
//      (33.6 MB at N = 8186 at kGroup = 16, of the 50 MB L2).
//
// Rows past M (the ragged last block of regime 1, the last column tile of
// regime 2) are zero and never stored. Anything the entry does not take
// is refused with cudaErrorInvalidValue, never run on another kernel.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "dft_bf16_rows.cuh"
#include "dft_matrix.cuh"
#include "dft_split3_f32.cuh"

namespace tpu_fft {

// ⌈2^32 / d⌉ for 2 ≤ d: for 0 ≤ p < 2^16 and d < 2^15, p / d =
// __umulhi(p, div_magic(d)) exactly (the rounding error p·(magic·d −
// 2^32) / 2^32 stays below 1 / d)
__host__ __device__ constexpr uint32_t div_magic(uint32_t d) {
  return 0xFFFFFFFFu / d + 1;
}

__device__ __forceinline__ int fast_div(int p, uint32_t magic) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(p), magic));
}

// (Fr, −Fi) and (Fi, Fr) of a complex bf16 pair (Fr low): rows g and
// g + 8 of the real form's A fragment at one depth
__device__ __forceinline__ uint32_t neg_im(uint32_t w) {
  return w ^ 0x80000000u;
}
__device__ __forceinline__ uint32_t swap_halves(uint32_t w) {
  return __byte_perm(w, 0u, 0x1032);
}

// 16 bytes from device memory into shared memory without registers (the
// rest zero-filled where src_bytes < 16)
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}


namespace bf16_mixed {

using bf16_rows::kLoadsInFlight;
using bf16_rows::kThreads;
using bf16_rows::kWarps;
using bf16_rows::mma;
using bf16_rows::pack_rn;

constexpr int kMaxKt2 = 16;   // n1 ≤ 128: at most 16 tiles of 8

// The padded depth of stage 2 and the strides of regime 1, host and device
__host__ __device__ constexpr int padded_n1(int n1) { return (n1 + 7) / 8 * 8; }
__host__ __device__ constexpr int x_stride(int n1p) { return n1p + 4; }
__host__ __device__ constexpr int y_stride(int n1p) {
  return n1p + 8 + (n1p & 8);
}

// The geometry of one length: kWide for n1 = 128 (n2 = N / 128, ⌈n2/8⌉ =
// kKt1), else n1 = N / 2 < 128 and n2 = 2 (kKt1 = 1). Constructed inside
// the kernel, so that at n1 = 128 the strides fold to constants.
template <int kKt1, bool kWide>
struct Geometry {
  static_assert(kWide || kKt1 == 1, "n1 = N / 2 below 128 has n2 = 2");
  static constexpr int kt1 = kKt1;
  int N, n1, n2, kt2, xs, ys;
  uint32_t n_magic, n2_magic;
  __device__ __forceinline__ explicit Geometry(int n)
      : N(n),
        n1(kWide ? 128 : n / 2),
        n2(kWide ? n / 128 : 2),
        kt2(kWide ? kMaxKt2 : (n / 2 + 7) / 8),
        xs(x_stride(8 * kt2)),
        ys(y_stride(8 * kt2)),
        n_magic(div_magic(n)),
        n2_magic(div_magic(n2)) {}
  // the tables, in 32-bit words: F2's fragments, T, F1's fragments
  __device__ __forceinline__ int f2_words() const { return kt1 * kt1 * 128; }
  __device__ __forceinline__ int f1_offset() const {
    return f2_words() + 2 * N;
  }
};

// Dynamic shared memory of a block of `rows` rows (planes.
// bf16_rows_shared_bytes): the rows as bf16 pairs, aliased by the f32
// result, then C ⊙ T
inline int shared_bytes(int rows, int n) {
  const int n1 = lanes_n1(n);
  const int n2 = n / n1;
  const int n1p = padded_n1(n1);
  const int rows_in = rows * n2 * x_stride(n1p) * 4;
  const int rows_out = (rows * (n + 1) * 8 + 15) / 16 * 16;
  return (rows_in > rows_out ? rows_in : rows_out) +
         rows * n2 * y_stride(n1p) * 4;
}

// Stage 2's tile of this warp (k1 = 8·(w mod kt2) + g): its F1 fragments
// (f1, the table's) from L2, the first kt2 of 16
template <class G>
__device__ __forceinline__ void load_f1(const G& g, uint4 (&a2)[kMaxKt2],
                                        const uint4* __restrict__ f1) {
  const int lane = threadIdx.x & 31;
  const int tm2 = (threadIdx.x >> 5) % g.kt2;
#pragma unroll
  for (int kb = 0; kb < kMaxKt2; ++kb)
    if (kb < g.kt2) a2[kb] = __ldg(&f1[(tm2 * g.kt2 + kb) * 32 + lane]);
}

// The block's rows, rounded to bf16 pairs, at x[r, s·n1 + t] → word
// (r·n2 + s)·xs + t. At n1 = 128 (N = 128·n2, a multiple of 4) 4 points a
// lane as two float4 loads, kLoadsInFlight of them started before any is
// waited on, one 16-byte shared store; at n1 < 128 (N may be 2 mod 4, an
// s-row may end inside a group of 4) one point a lane. Rows past M are
// zero.
template <class G, bool kWide>
__device__ __forceinline__ void load_rows(const G& g, uint32_t* xs,
                                          const float* __restrict__ re,
                                          const float* __restrict__ im,
                                          int R, int live) {
  if constexpr (kWide) {
    const int total = R * g.N / 4;
    const int valid = live * g.N / 4;
    const float4* bre = reinterpret_cast<const float4*>(re);
    const float4* bim = reinterpret_cast<const float4*>(im);
    for (int base = threadIdx.x; base < total;
         base += kLoadsInFlight * kThreads) {
      float4 vr[kLoadsInFlight], vi[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        const bool ok = idx < valid;
        vr[u] = ok ? bre[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
        vi[u] = ok ? bim[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= total) continue;
        const int p = idx * 4;
        const int r = fast_div(p, g.n_magic);
        const int n = p - r * g.N;
        *reinterpret_cast<uint4*>(
            &xs[(r * g.n2 + (n >> 7)) * g.xs + (n & 127)]) =
            make_uint4(pack_rn(vr[u].x, vi[u].x), pack_rn(vr[u].y, vi[u].y),
                       pack_rn(vr[u].z, vi[u].z), pack_rn(vr[u].w, vi[u].w));
      }
    }
  } else {
    const int total = R * g.N;
    const int valid = live * g.N;
    for (int p = threadIdx.x; p < total; p += kThreads) {
      const bool ok = p < valid;
      const float xr = ok ? re[p] : 0.f;
      const float xi = ok ? im[p] : 0.f;
      const int r = fast_div(p, g.n_magic);
      const int n = p - r * g.N;
      const int s = n >= g.n1;
      xs[(r * 2 + s) * g.xs + n - s * g.n1] = pack_rn(xr, xi);
    }
  }
}

// Stage 1: warp w < ⌊16 / kt1⌋·kt1 computes output tile tm = w mod kt1
// (k2 = 8·tm + g) over the column tiles (r, t0 … t0 + 7) of the padded
// depth, and writes bf16(C ⊙ T) to ys, zeros at t ≥ n1.
template <class G>
__device__ __forceinline__ void stage1(const G& g, const uint32_t* xs,
                                       uint32_t* ys,
                                       const uint32_t* __restrict__ tables,
                                       int R) {
  constexpr int kt1 = G::kt1;
  constexpr int groups = kWarps / kt1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp >= groups * kt1) return;
  const int gg = lane >> 2;
  const int q = lane & 3;
  const uint4* f2 = reinterpret_cast<const uint4*>(tables);
  const float2* tw = reinterpret_cast<const float2*>(tables + g.f2_words());
  const int tm = warp % kt1;
  const uint4* f2_tile = f2 + tm * kt1 * 32 + lane;
  // F2's fragments in registers up to n2 = 32, as in the power-of-two
  // kernel; beyond, from L1 at each k-step
  constexpr bool kHold = kt1 <= 4;
  uint4 a[kHold ? kt1 : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int kb = 0; kb < kt1; ++kb) a[kb] = __ldg(&f2_tile[kb * 32]);
  }
  const int k2 = tm * 8 + gg;
  const int tiles = R * g.kt2;
  for (int tn = warp / kt1; tn < tiles; tn += groups) {
    const int r = tn / g.kt2;
    const int t0 = (tn - r * g.kt2) * 8;
    const uint32_t* xb = xs + r * g.n2 * g.xs + t0 + gg;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < kt1; ++kb) {
      const int s = kb * 8 + 2 * q;
      const uint32_t b0 = s < g.n2 ? xb[s * g.xs] : 0u;
      const uint32_t b1 = s + 1 < g.n2 ? xb[(s + 1) * g.xs] : 0u;
      if constexpr (kHold) {
        mma(d, a[kb], b0, b1);
      } else {
        mma(d, __ldg(&f2_tile[kb * 32]), b0, b1);
      }
    }
    if (k2 < g.n2) {
      uint32_t* yb = ys + (r * g.n2 + k2) * g.ys;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + 2 * q + j;
        uint32_t v = 0u;
        if (t < g.n1) {
          const float2 w = __ldg(&tw[k2 * g.n1 + t]);
          const float cr = d[j];
          const float ci = d[j + 2];
          v = pack_rn(__fsub_rn(__fmul_rn(cr, w.x), __fmul_rn(ci, w.y)),
                      __fadd_rn(__fmul_rn(cr, w.y), __fmul_rn(ci, w.x)));
        }
        yb[t] = v;
      }
    }
  }
}

// Stage 2: warp w < ⌊16 / kt2⌋·kt2 computes its tile k1 over the columns
// col = r·n2 + k2, and writes X[k1·n2 + k2] of row r to res in f32.
template <class G>
__device__ __forceinline__ void stage2(const G& g, const uint32_t* ys,
                                       float2* res,
                                       const uint4 (&a2)[kMaxKt2], int R) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = kWarps / g.kt2;
  if (warp >= groups * g.kt2) return;
  const int gg = lane >> 2;
  const int q = lane & 3;
  const int k1 = (warp % g.kt2) * 8 + gg;
  const int cols = R * g.n2;
  const int tiles = (cols + 7) >> 3;
  for (int tn = warp / g.kt2; tn < tiles; tn += groups) {
    const int col = (tn << 3) + gg;
    const bool ok = col < cols;
    const uint32_t* yb = ys + col * g.ys + 2 * q;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < kMaxKt2; ++kb) {
      if (kb < g.kt2) {
        const uint2 b = ok ? *reinterpret_cast<const uint2*>(yb + kb * 8)
                           : make_uint2(0u, 0u);
        mma(d, a2[kb], b.x, b.y);
      }
    }
    if (k1 < g.n1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int oc = (tn << 3) + 2 * q + j;
        if (oc < cols) {
          const int r = fast_div(oc, g.n2_magic);
          const int k2 = oc - r * g.n2;
          res[r * (g.N + 1) + k1 * g.n2 + k2] = make_float2(d[j], d[j + 2]);
        }
      }
    }
  }
}

// The block's `live` rows (of R, rows m0 … of the batch) into one
// channel's planes: natural [M, N], the live rows one contiguous run; or
// transposed [N, M], r the fastest thread index, runs of R floats.
template <bool kNatural, class G>
__device__ __forceinline__ void store(const G& g, const float2* res,
                                      float* __restrict__ o_re,
                                      float* __restrict__ o_im, int M, int R,
                                      int log2r, int m0, int live) {
  if constexpr (kNatural) {
    const size_t first = static_cast<size_t>(m0) * g.N;
    for (int idx = threadIdx.x; idx < live * g.N; idx += kThreads) {
      // row r's point k at r·(N + 1) + k = idx + r
      const float2 v = res[idx + fast_div(idx, g.n_magic)];
      o_re[first + idx] = v.x;
      o_im[first + idx] = v.y;
    }
  } else {
    for (int idx = threadIdx.x; idx < R * g.N; idx += kThreads) {
      const int r = idx & (R - 1);
      const int k = idx >> log2r;
      if (r < live) {
        const float2 v = res[r * (g.N + 1) + k];
        const size_t o = static_cast<size_t>(k) * M + m0 + r;
        o_re[o] = v.x;
        o_im[o] = v.y;
      }
    }
  }
}

// ---- bf16x3, regime 1

// F2's rows in the bf16x3 table: whole shares of 16 (a stage-1 share kK
// divides 16), zero past n2 (planes.bf16x3_rows_tables)
__host__ __device__ constexpr int b3_f2_rows(int n2) {
  return (n2 + 15) / 16 * 16;
}

// Stage 1's outputs a thread at n1 = 128: 8 from n2 = 5, else the next
// power of two ≥ n2 (1, 2, 4); at n1 < 128 n2 = 2
inline int b3_share(int n) {
  const int n2 = n / lanes_n1(n);
  return n2 > 4 ? 8 : n2 > 2 ? 4 : n2;
}

// Stage 1's columns a thread
constexpr int kB3Columns = 2;

// Dynamic shared memory of a bf16x3 block of `rows` rows
// (planes.bf16x3_rows_shared_bytes): the rows as complex f32, aliased by
// the f32 result (n + 1 complex a row), then C ⊙ T's hi and lo planes,
// then F1's lo part as complex bf16 pairs
inline int b3_shared_bytes(int rows, int n) {
  const int n1 = lanes_n1(n);
  const int n2 = n / n1;
  const int n1p = padded_n1(n1);
  return (rows * (n + 1) * 8 + 15) / 16 * 16 + 2 * rows * n2 * y_stride(n1p) * 4
         + n1p * n1p * 4;
}

// The block's `live` rows of R as complex f32 at r·N + n, the input's own
// order (rows past M zero): 4 points a lane as two float4 loads where
// 4 | N, else 2 points as two float2 loads, kLoadsInFlight started before
// any is waited on, one or two 16-byte shared stores.
template <class G, bool kWide>
__device__ __forceinline__ void load_rows_f32(const G& g, float2* xs,
                                              const float* __restrict__ re,
                                              const float* __restrict__ im,
                                              int R, int live) {
  if (kWide || (g.N & 3) == 0) {
    const int total = R * g.N / 4;
    const int valid = live * g.N / 4;
    const float4* bre = reinterpret_cast<const float4*>(re);
    const float4* bim = reinterpret_cast<const float4*>(im);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int base = threadIdx.x; base < total;
         base += kLoadsInFlight * kThreads) {
      float4 vr[kLoadsInFlight], vi[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        const bool ok = idx < valid;
        vr[u] = ok ? bre[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
        vi[u] = ok ? bim[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= total) continue;
        dst[2 * idx] = make_float4(vr[u].x, vi[u].x, vr[u].y, vi[u].y);
        dst[2 * idx + 1] = make_float4(vr[u].z, vi[u].z, vr[u].w, vi[u].w);
      }
    }
  } else {
    const int total = R * g.N / 2;
    const int valid = live * g.N / 2;
    const float2* bre = reinterpret_cast<const float2*>(re);
    const float2* bim = reinterpret_cast<const float2*>(im);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int base = threadIdx.x; base < total;
         base += kLoadsInFlight * kThreads) {
      float2 vr[kLoadsInFlight], vi[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        const bool ok = idx < valid;
        vr[u] = ok ? bre[idx] : make_float2(0.f, 0.f);
        vi[u] = ok ? bim[idx] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total)
          dst[idx] = make_float4(vr[u].x, vi[u].x, vr[u].y, vi[u].y);
      }
    }
  }
}

// Stage 1 at bf16x3: C[k2, t] = Σ_s F2[k2, s] · x[s·n1 + t] in f32 FFMA on
// the unrounded rows (F2 from shared memory s-major, f2s[s·n2p + k], one
// address a warp), then C ⊙ T with
// each product and sum rounded alone, split once into the hi and lo planes
// at (r·n2 + k2)·ys + t; zeros at t in [n1, n1p). An item: the columns
// c + j·R·n1p/kB3Columns, j < kB3Columns (c = r·n1p + t), and the outputs
// k2 = kK·share … + kK − 1, the share the slowest index; each F2 value read
// feeds 4·kB3Columns FFMAs.
template <int kK, class G>
__device__ __forceinline__ void stage1_b3(const G& g, const float2* xs,
                                          uint32_t* yh, uint32_t* yl,
                                          const float2* f2s, int n2p,
                                          const float2* __restrict__ tw,
                                          int R) {
  constexpr int kC = kB3Columns;
  const int n1p = 8 * g.kt2;
  const int part = R * n1p / kC;
  const int items = (g.n2 + kK - 1) / kK * part;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int share = item / part;
    const int i = item - share * part;
    const int k0 = share * kK;
    int xo[kC], yo[kC], t[kC];
    bool live[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int c = i + j * part;
      const int r = c / n1p;
      t[j] = c - r * n1p;
      live[j] = t[j] < g.n1;
      xo[j] = r * g.N + t[j];
      yo[j] = r * g.n2 * g.ys + t[j];
    }
    float2 acc[kC][kK];
#pragma unroll
    for (int j = 0; j < kC; ++j)
#pragma unroll
      for (int k = 0; k < kK; ++k) acc[j][k] = make_float2(0.f, 0.f);
#pragma unroll 2
    for (int s = 0; s < g.n2; ++s) {
      float2 x[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j)
        x[j] = live[j] ? xs[xo[j] + s * g.n1] : make_float2(0.f, 0.f);
      const float2* fk = f2s + s * n2p + k0;
      if constexpr (kK == 1) {
#pragma unroll
        for (int j = 0; j < kC; ++j) split3_f32::cfma(acc[j][0], fk[0], x[j]);
      } else {
#pragma unroll
        for (int k = 0; k < kK; k += 2) {
          const float4 f = *reinterpret_cast<const float4*>(fk + k);
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            split3_f32::cfma(acc[j][k], make_float2(f.x, f.y), x[j]);
            split3_f32::cfma(acc[j][k + 1], make_float2(f.z, f.w), x[j]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int k2 = k0 + k;
      if (k2 < g.n2) {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          uint32_t hi = 0u, lo = 0u;
          if (live[j]) {
            const float2 v = split3_f32::twiddle(
                acc[j][k], __ldg(&tw[k2 * g.n1 + t[j]]));
            split_pair(v.x, v.y, hi, lo);
          }
          yh[yo[j] + k2 * g.ys] = hi;
          yl[yo[j] + k2 * g.ys] = lo;
        }
      }
    }
  }
}

// F1's lo part (the table's complex bf16 pairs in A-fragment order, a
// lane's two depths a uint2) into shared memory with cp.async
template <class G>
__device__ __forceinline__ void load_f1_lo(const G& g, uint2* lo,
                                           const uint2* __restrict__ f1lo) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(lo);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(f1lo);
  for (int i = threadIdx.x; i < g.kt2 * g.kt2 * 16; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i, 16);
  cp_async_commit();
}

// Stage 2 at bf16x3: stage2's tiles, three products a k-step: hi·hi into
// d, hi·lo and lo·hi into e, written as d + e. F1's hi fragments are the
// warp's registers, its lo part the pairs in shared memory.
template <class G>
__device__ __forceinline__ void stage2_b3(const G& g, const uint32_t* yh,
                                          const uint32_t* yl, const uint2* lo,
                                          float2* res,
                                          const uint4 (&a2)[kMaxKt2], int R) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = kWarps / g.kt2;
  if (warp >= groups * g.kt2) return;
  const int gg = lane >> 2;
  const int q = lane & 3;
  const int tm = warp % g.kt2;
  const int k1 = tm * 8 + gg;
  const uint2* al = lo + tm * g.kt2 * 32 + lane;
  const int cols = R * g.n2;
  const int tiles = (cols + 7) >> 3;
  for (int tn = warp / g.kt2; tn < tiles; tn += groups) {
    const int col = (tn << 3) + gg;
    const bool ok = col < cols;
    const int at = col * g.ys + 2 * q;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < kMaxKt2; ++kb) {
      if (kb < g.kt2) {
        const uint2 bh = ok ? *reinterpret_cast<const uint2*>(yh + at + kb * 8)
                            : make_uint2(0u, 0u);
        const uint2 bl = ok ? *reinterpret_cast<const uint2*>(yl + at + kb * 8)
                            : make_uint2(0u, 0u);
        const uint2 p = al[kb * 32];
        const uint4 a_lo = make_uint4(neg_im(p.x), swap_halves(p.x),
                                      neg_im(p.y), swap_halves(p.y));
        mma(d, a2[kb], bh.x, bh.y);
        mma(e, a2[kb], bl.x, bl.y);
        mma(e, a_lo, bh.x, bh.y);
      }
    }
    if (k1 < g.n1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int oc = (tn << 3) + 2 * q + j;
        if (oc < cols) {
          const int r = fast_div(oc, g.n2_magic);
          const int k2 = oc - r * g.n2;
          res[r * (g.N + 1) + k1 * g.n2 + k2] = make_float2(
              __fadd_rn(d[j], e[j]), __fadd_rn(d[j + 2], e[j + 2]));
        }
      }
    }
  }
}

// One block: R rows m0 … m0 + R − 1 of channel blockIdx.y, at tier kTier
// (kTierBf16: kS = ⌈n2/8⌉, stage 1's tiles; kTierBf16x3: kS = kK, stage
// 1's outputs a thread).
template <int kTier, int kS, bool kWide, bool kNatural>
__global__ void __launch_bounds__(kThreads)
bf16_rows_mixed_kernel(const float* __restrict__ re,
                       const float* __restrict__ im,
                       float* __restrict__ out_re, float* __restrict__ out_im,
                       const uint32_t* __restrict__ tables, int M, int N,
                       int R, int log2r) {
  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const int live = M - m0 < R ? M - m0 : R;
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t first = c * plane + static_cast<size_t>(m0) * N;
  if constexpr (kTier == kTierBf16) {
    const Geometry<kS, kWide> g(N);
    uint32_t* xs = reinterpret_cast<uint32_t*>(bf16_rows::bf16_rows_smem);
    float2* res = reinterpret_cast<float2*>(bf16_rows::bf16_rows_smem);
    const int rows_in = R * g.n2 * g.xs;
    const int rows_out = (R * (N + 1) * 2 + 3) / 4 * 4;
    uint32_t* ys = xs + (rows_in > rows_out ? rows_in : rows_out);

    // F1's fragments are issued first, so that they arrive while the rows
    // load and stage 1 runs
    uint4 a2[kMaxKt2];
    load_f1(g, a2, reinterpret_cast<const uint4*>(tables + g.f1_offset()));
    load_rows<Geometry<kS, kWide>, kWide>(g, xs, re + first, im + first, R,
                                          live);
    __syncthreads();
    stage1(g, xs, ys, tables, R);
    __syncthreads();
    stage2(g, ys, res, a2, R);
    __syncthreads();
    store<kNatural>(g, res, out_re + c * plane, out_im + c * plane, M, R,
                    log2r, m0, live);
  } else {
    static_assert(kTier == kTierBf16x3, "tier bf16 or bf16x3");
    const Geometry<1, kWide> g(N);
    // the tables (planes.bf16x3_rows_tables): F2 [b3_f2_rows(n2), n2] and
    // T [n2, n1] as complex f32, then F1's hi A fragments and its lo part
    // as complex bf16 pairs in fragment order
    const float2* f2 = reinterpret_cast<const float2*>(tables);
    const float2* tw = f2 + b3_f2_rows(g.n2) * g.n2;
    const uint4* f1hi = reinterpret_cast<const uint4*>(tw + N);
    const uint2* f1lo =
        reinterpret_cast<const uint2*>(f1hi + g.kt2 * g.kt2 * 32);
    // shared memory: the rows, then the result; C ⊙ T hi, lo; F1's lo pairs
    float2* xs = reinterpret_cast<float2*>(bf16_rows::bf16_rows_smem);
    uint32_t* yh = reinterpret_cast<uint32_t*>(bf16_rows::bf16_rows_smem) +
                   (R * (N + 1) * 2 + 3) / 4 * 4;
    uint32_t* yl = yh + R * g.n2 * g.ys;
    uint2* lo = reinterpret_cast<uint2*>(yl + R * g.n2 * g.ys);

    // F2 s-major in shared memory (f2s[s·n2p + k], a broadcast a k pair),
    // over F1's lo pairs' region until stage 1 is done; F1's hi fragments
    // are issued first, so that they arrive while the rows load and stage
    // 1 runs; the lo pairs follow stage 1 by cp.async
    uint4 a2[kMaxKt2];
    const int n2p = b3_f2_rows(g.n2);
    float2* f2s = reinterpret_cast<float2*>(lo);
    for (int i = threadIdx.x; i < n2p * g.n2; i += kThreads) {
      const int k = i / g.n2;
      f2s[(i - k * g.n2) * n2p + k] = __ldg(&f2[i]);
    }
    load_f1(g, a2, f1hi);
    load_rows_f32<Geometry<1, kWide>, kWide>(g, xs, re + first, im + first,
                                             R, live);
    __syncthreads();
    stage1_b3<kS>(g, xs, yh, yl, f2s, n2p, tw, R);
    __syncthreads();
    load_f1_lo(g, lo, f1lo);
    cp_async_wait<0>();
    __syncthreads();
    stage2_b3(g, yh, yl, lo, xs, a2, R);
    __syncthreads();
    store<kNatural>(g, xs, out_re + c * plane, out_im + c * plane, M, R,
                    log2r, m0, live);
  }
}

template <int kTier, int kS, bool kWide, bool kNatural>
int launch_geometry(const void* re, const void* im, void* out_re,
                    void* out_im, const void* tables, int channels, int m,
                    int n, int rows, cudaStream_t stream) {
  const auto kernel = bf16_rows_mixed_kernel<kTier, kS, kWide, kNatural>;
  const int smem = kTier == kTierBf16 ? shared_bytes(rows, n)
                                      : b3_shared_bytes(rows, n);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const uint32_t*>(tables), m, n, rows, log2_of(rows));
  return static_cast<int>(cudaGetLastError());
}

// Regime 1 at length n (n1 = lanes_n1(n) ≤ 128): at bf16 (not a power of
// two) the instantiation of ⌈n2/8⌉ at n1 = 128, or of n2 = 2; at bf16x3
// (any even n) that of b3_share(n) at n1 = 128, or of n2 = 2. The natural
// store's builds are in bf16_rows_mixed_natural.cu, so that nvcc builds
// them beside the transposed store's (bf16_rows_mixed.cu).
template <int kTier, bool kNatural>
int launch(const void* re, const void* im, void* out_re, void* out_im,
           const void* tables, int channels, int m, int n, int rows,
           cudaStream_t stream) {
  if (lanes_n1(n) < 128)
    return launch_geometry<kTier, kTier == kTierBf16 ? 1 : 2, false,
                           kNatural>(re, im, out_re, out_im, tables,
                                     channels, m, n, rows, stream);
#define TPU_BF16_MIXED_CASE(K)                                               \
  case K:                                                                    \
    return launch_geometry<kTier, K, true, kNatural>(                        \
        re, im, out_re, out_im, tables, channels, m, n, rows, stream);
  if constexpr (kTier == kTierBf16) {
    switch ((n / 128 + 7) / 8) {
      TPU_BF16_MIXED_CASE(1)
      TPU_BF16_MIXED_CASE(2)
      TPU_BF16_MIXED_CASE(3)
      TPU_BF16_MIXED_CASE(4)
      TPU_BF16_MIXED_CASE(5)
      TPU_BF16_MIXED_CASE(6)
      TPU_BF16_MIXED_CASE(7)
      TPU_BF16_MIXED_CASE(8)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (b3_share(n)) {
      TPU_BF16_MIXED_CASE(1)
      TPU_BF16_MIXED_CASE(2)
      TPU_BF16_MIXED_CASE(4)
      TPU_BF16_MIXED_CASE(8)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef TPU_BF16_MIXED_CASE
}

extern template int launch<kTierBf16, true>(const void*, const void*,
                                            void*, void*, const void*, int,
                                            int, int, int, cudaStream_t);
extern template int launch<kTierBf16x3, true>(const void*, const void*,
                                              void*, void*, const void*, int,
                                              int, int, int, cudaStream_t);

}  // namespace bf16_mixed

namespace bf16_gemm {

using bf16_rows::mma;
using bf16_rows::pack_rn;

constexpr int kBM = 64;          // k1 a block
constexpr int kBN = 64;          // columns (m, k2) a block
constexpr int kChunk = 32;       // complex depth a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;    // 4 warps of 32 k1 × 32 columns
constexpr int kStride = kChunk + 8;              // words a staged row
constexpr int kStageWords = (kBM + kBN) * kStride;
// chunks between two promotions: 128 complex of depth (kPromoteBlocks)
constexpr int kPromoteChunks = kPromoteBlocks * 8 / kChunk;
// k1 tiles of a raster group: F1's tiles of a group stay in L2 while the
// columns pass (16.8 MB at N = 8186; at bf16x3 F1's hi and lo, 33.6 MB)
constexpr int kGroup = 16;
// the epilogue's tile: 64 k1 rows of 64 columns, float2, at 66 (≡ 2 mod
// 16): the natural store's half warp reads 32 distinct banks
constexpr int kOutStride = kBN + 2;
constexpr int kSmemBytes =
    (kStages * kStageWords * 4 > kBM * kOutStride * 8)
        ? kStages * kStageWords * 4
        : kBM * kOutStride * 8;
// bf16x3: each operand's hi and lo rows a stage (the result tile fits)
constexpr int kSmemBytesBf16x3 = 2 * kStages * kStageWords * 4;
static_assert(kSmemBytesBf16x3 >= kBM * kOutStride * 8, "the result tile");
constexpr int kPrepThreads = 256;

// a tier's operand parts (hi, and lo at bf16x3) and shared memory
template <int kTier>
constexpr int kParts = kTier == kTierBf16x3 ? 2 : 1;
template <int kTier>
constexpr int kTierSmemBytes =
    kTier == kTierBf16x3 ? kSmemBytesBf16x3 : kSmemBytes;

// ldk: words a row of X′ and of F1, the depth in whole chunks
__host__ __device__ constexpr int depth_words(int n1) {
  return (n1 + kChunk - 1) / kChunk * kChunk;
}
// F1's rows in the table, whole k1 tiles
__host__ __device__ constexpr int table_rows(int n1) {
  return (n1 + kBM - 1) / kBM * kBM;
}

// Stage 1 of every row (c·M + m = blockIdx.x) and the twiddle. bf16:
// X′[2·row + k2, t] = bf16(C[k2, t] ⊙ T[k2, t]) with C[0] = x0 + x1,
// C[1] = x0 − x1 of the bf16-rounded x0 = x[t], x1 = x[n1 + t]. bf16x3:
// C[k2] = Σ_s F2[k2, s]·x_s in f32 FFMA on the unrounded x (F2 the f32
// table, f2), C[1] ⊙ T[1, t], each split once: the hi pair at X′'s word,
// the lo pair `lo_plane` words on. Zero for t in [n1, ldk).
template <int kTier>
static __global__ void __launch_bounds__(kPrepThreads)
gemm_prep_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 uint32_t* __restrict__ xp, const float2* __restrict__ t1,
                 const float2* __restrict__ f2, int n1, int ldk,
                 size_t lo_plane) {
  const size_t row = blockIdx.x;
  const float* r0 = re + row * 2 * n1;
  const float* i0 = im + row * 2 * n1;
  uint32_t* y0 = xp + row * 2 * ldk;
  uint32_t* y1 = y0 + ldk;
  for (int t = threadIdx.x; t < ldk; t += kPrepThreads) {
    uint32_t v0 = 0u, v1 = 0u;
    if constexpr (kTier == kTierBf16) {
      if (t < n1) {
        const float ar = __bfloat162float(__float2bfloat16_rn(r0[t]));
        const float ai = __bfloat162float(__float2bfloat16_rn(i0[t]));
        const float br = __bfloat162float(__float2bfloat16_rn(r0[n1 + t]));
        const float bi = __bfloat162float(__float2bfloat16_rn(i0[n1 + t]));
        const float cr = __fsub_rn(ar, br);
        const float ci = __fsub_rn(ai, bi);
        const float2 w = __ldg(&t1[t]);
        v0 = pack_rn(__fadd_rn(ar, br), __fadd_rn(ai, bi));
        v1 = pack_rn(__fsub_rn(__fmul_rn(cr, w.x), __fmul_rn(ci, w.y)),
                     __fadd_rn(__fmul_rn(cr, w.y), __fmul_rn(ci, w.x)));
      }
    } else {
      uint32_t w0 = 0u, w1 = 0u;
      if (t < n1) {
        const float2 x0 = make_float2(r0[t], i0[t]);
        const float2 x1 = make_float2(r0[n1 + t], i0[n1 + t]);
        float2 c0 = make_float2(0.f, 0.f), c1 = make_float2(0.f, 0.f);
        split3_f32::cfma(c0, __ldg(&f2[0]), x0);
        split3_f32::cfma(c0, __ldg(&f2[1]), x1);
        split3_f32::cfma(c1, __ldg(&f2[2]), x0);
        split3_f32::cfma(c1, __ldg(&f2[3]), x1);
        const float2 d1 = split3_f32::twiddle(c1, __ldg(&t1[t]));
        split_pair(c0.x, c0.y, v0, w0);
        split_pair(d1.x, d1.y, v1, w1);
      }
      y0[lo_plane + t] = w0;
      y1[lo_plane + t] = w1;
    }
    y0[t] = v0;
    y1[t] = v1;
  }
}

// Stage 2 and the store: block b's tile of 64 k1 × 64 columns (col =
// (c·M + m)·2 + k2) of Y = F1 · X′ᵀ. At bf16x3 F1's lo table follows its
// hi table (k1_tiles·kBM rows of ldk words) and X′'s lo plane its hi
// plane (cols rows); a stage holds A hi, B hi, A lo, B lo.
template <int kTier, bool kNatural>
__global__ void __launch_bounds__(kThreads)
gemm_rows_kernel(const uint32_t* __restrict__ f1,
                 const uint32_t* __restrict__ xp, float* __restrict__ out_re,
                 float* __restrict__ out_im, int M, int cols, int n1,
                 int ldk, int k1_tiles, int col_tiles) {
  extern __shared__ uint4 gemm_smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(gemm_smem);
  constexpr bool kB3 = kTier == kTierBf16x3;
  constexpr int kWords = kParts<kTier> * kStageWords;   // a stage
  // the raster: groups of kGroup k1 tiles, k1 the fastest within a group
  const int per_group = kGroup * col_tiles;
  const int group = blockIdx.x / per_group;
  const int first = group * kGroup;
  const int in_group =
      k1_tiles - first < kGroup ? k1_tiles - first : kGroup;
  const int rest = blockIdx.x - group * per_group;
  const int tk = first + rest % in_group;
  const int tc = rest / in_group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wm = (warp & 1) * 32;     // the warp's k1 rows in the tile
  const int wn = (warp >> 1) * 32;    // its columns
  const uint32_t* a_src = f1 + static_cast<size_t>(tk) * kBM * ldk;
  const uint32_t* b_src = xp + static_cast<size_t>(tc) * kBN * ldk;
  const size_t a_lo = static_cast<size_t>(k1_tiles) * kBM * ldk;
  const size_t b_lo = static_cast<size_t>(cols) * ldk;
  const int b_rows = cols - tc * kBN;   // live columns of the tile
  const int chunks = ldk / kChunk;

  // chunk k into stage s: 64 rows × 8 pieces of 16 bytes of each operand
  // (and part), 4 a thread each; columns past `cols` zero-filled
  auto load = [&](int k, int s) {
    uint32_t* sa = sm + s * kWords;
    uint32_t* sb = sa + kBM * kStride;
#pragma unroll
    for (int u = 0; u < kBM * 8 / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i >> 3;
      const int w = (i & 7) * 4;
      const size_t at = static_cast<size_t>(r) * ldk + k * kChunk + w;
      cp_async16(sa + r * kStride + w, a_src + at, 16);
      const bool live = r < b_rows;
      cp_async16(sb + r * kStride + w, live ? b_src + at : xp,
                 live ? 16 : 0);
      if constexpr (kB3) {
        cp_async16(sa + kStageWords + r * kStride + w, a_src + a_lo + at, 16);
        cp_async16(sb + kStageWords + r * kStride + w,
                   live ? b_src + b_lo + at : xp, live ? 16 : 0);
      }
    }
  };

  float d[2][4][4][4];   // [0]: the mma accumulators, [1]: their f32 sums
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[h][i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k + kStages - 1 < chunks)
      load(k + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t* sa = sm + (k % kStages) * kWords;
    const uint32_t* sb = sa + kBM * kStride;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      uint2 bw[4], bl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (wn + j * 8 + g) * kStride + ks * 8 + 2 * q;
        bw[j] = *reinterpret_cast<const uint2*>(sb + at);
        if constexpr (kB3)
          bl[j] = *reinterpret_cast<const uint2*>(sb + kStageWords + at);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = (wm + i * 8 + g) * kStride + ks * 8 + 2 * q;
        const uint2 aw = *reinterpret_cast<const uint2*>(sa + at);
        const uint4 a = make_uint4(neg_im(aw.x), swap_halves(aw.x),
                                   neg_im(aw.y), swap_halves(aw.y));
        if constexpr (kB3) {
          const uint2 lw = *reinterpret_cast<const uint2*>(sa + kStageWords +
                                                           at);
          const uint4 al = make_uint4(neg_im(lw.x), swap_halves(lw.x),
                                      neg_im(lw.y), swap_halves(lw.y));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma(d[0][i][j], a, bw[j].x, bw[j].y);
            mma(d[0][i][j], a, bl[j].x, bl[j].y);
            mma(d[0][i][j], al, bw[j].x, bw[j].y);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(d[0][i][j], a, bw[j].x, bw[j].y);
        }
      }
    }
    if ((k + 1) % kPromoteChunks == 0 || k + 1 == chunks) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) promote(d[1][i][j], d[0][i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile through shared memory: e[k1][col], then the store
  float2* e = reinterpret_cast<float2*>(sm);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        e[(wm + i * 8 + g) * kOutStride + wn + j * 8 + 2 * q + h] =
            make_float2(d[1][i][j][h], d[1][i][j][h + 2]);
  __syncthreads();
  const int n = 2 * n1;
  const int k0 = 2 * tk * kBM;             // the tile's first output k
  const int cm0 = tc * (kBN / 2);          // its first row c·M + m
  const int rows = cols / 2;
  if constexpr (kNatural) {
    // out[cm, k0 + p], p = 2·k1 + k2 < 128 consecutive for each row cm
    for (int idx = tid; idx < (kBN / 2) * 2 * kBM; idx += kThreads) {
      const int mm = idx >> 7;
      const int p = idx & 127;
      const int cm = cm0 + mm;
      if (cm < rows && k0 + p < n) {
        const float2 v = e[(p >> 1) * kOutStride + 2 * mm + (p & 1)];
        const size_t o = static_cast<size_t>(cm) * n + k0 + p;
        out_re[o] = v.x;
        out_im[o] = v.y;
      }
    }
  } else {
    // out[c, k0 + p, m]: 32 consecutive m (lane) for each p
    const int cm = cm0 + lane;
    const int c = cm / M;
    const int m = cm - c * M;
    for (int p = warp; p < 2 * kBM; p += kThreads / 32) {
      if (cm < rows && k0 + p < n) {
        const float2 v = e[(p >> 1) * kOutStride + 2 * lane + (p & 1)];
        const size_t o = (static_cast<size_t>(c) * n + k0 + p) * M + m;
        out_re[o] = v.x;
        out_im[o] = v.y;
      }
    }
  }
}

// Both launches at n1 = n / 2 > 128. bf16: `tables` planes.
// bf16_rows_tables (F1 [table_rows(n1), ldk] pairs, then T[1, ·] as n1 f32
// pairs), `scratch` X′ of channels·m·2·ldk words. bf16x3: `tables`
// planes.bf16x3_rows_tables (F1's hi pairs, its lo pairs, T[1, ·], then F2
// as 2 × 2 complex f32), `scratch` X′'s hi and lo planes, twice the words.
template <int kTier, bool kNatural>
int launch(const void* re, const void* im, void* out_re, void* out_im,
           const void* tables, void* scratch, int channels, int m, int n,
           cudaStream_t stream) {
  const int n1 = n / 2;
  const int ldk = depth_words(n1);
  const long long rows = static_cast<long long>(channels) * m;
  const long long cols = 2 * rows;
  const int k1_tiles = table_rows(n1) / kBM;
  const long long col_tiles = (cols + kBN - 1) / kBN;
  if (scratch == nullptr || rows > (1 << 30) ||
      k1_tiles * col_tiles > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f1 = static_cast<const uint32_t*>(tables);
  const auto* t1 = reinterpret_cast<const float2*>(
      f1 + static_cast<size_t>(kParts<kTier>) * table_rows(n1) * ldk);
  auto* xp = static_cast<uint32_t*>(scratch);
  gemm_prep_kernel<kTier>
      <<<static_cast<unsigned>(rows), kPrepThreads, 0, stream>>>(
          static_cast<const float*>(re), static_cast<const float*>(im), xp,
          t1, t1 + n1, n1, ldk, static_cast<size_t>(cols) * ldk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = gemm_rows_kernel<kTier, kNatural>;
  err = allow_smem(kernel, kTierSmemBytes<kTier>);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(k1_tiles * col_tiles), kThreads,
           kTierSmemBytes<kTier>, stream>>>(
      f1, xp, static_cast<float*>(out_re), static_cast<float*>(out_im), m,
      static_cast<int>(cols), n1, ldk, k1_tiles,
      static_cast<int>(col_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16_gemm

// Launches the row DFT at tier `tier` in the direct form at an even length
// n in [16, 8192], natural or transposed store: bf16 (tier 1) where n is
// not a power of two, bf16x3 (tier 2) at every such n. Regime 1
// (lanes_n1(n) ≤ 128) on R = rows rows a block, a power of two whose block
// (bf16_mixed::shared_bytes, b3_shared_bytes) fits the card; regime 2 in
// two launches, rows 1 and `scratch` the X′ buffer
// (planes.bf16_rows_scratch_words, bf16x3_rows_scratch_words). Anything
// else is refused with cudaErrorInvalidValue.
template <bool kNatural>
int launch_bf16_rows_mixed(const void* re, const void* im, void* out_re,
                           void* out_im, const void* tables, void* scratch,
                           int channels, int m, int n, int rows, int tier,
                           void* stream) {
  if (n < 16 || n > 8192 || (n & 1) || m < 1 || channels < 1 || rows < 1 ||
      (rows & (rows - 1)) || (tier != kTierBf16 && tier != kTierBf16x3) ||
      (tier == kTierBf16 && !(n & (n - 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (lanes_n1(n) > 128) {
    if (rows != 1) return static_cast<int>(cudaErrorInvalidValue);
    return tier == kTierBf16
               ? bf16_gemm::launch<kTierBf16, kNatural>(
                     re, im, out_re, out_im, tables, scratch, channels, m, n,
                     s)
               : bf16_gemm::launch<kTierBf16x3, kNatural>(
                     re, im, out_re, out_im, tables, scratch, channels, m, n,
                     s);
  }
  return tier == kTierBf16
             ? bf16_mixed::launch<kTierBf16, kNatural>(
                   re, im, out_re, out_im, tables, channels, m, n, rows, s)
             : bf16_mixed::launch<kTierBf16x3, kNatural>(
                   re, im, out_re, out_im, tables, channels, m, n, rows, s);
}

}  // namespace tpu_fft
