// The bf16 row DFT: fft_rows.cu's entries tpu_fft_rows_transposed and
// tpu_fft_rows_natural at tier bf16 in the direct form.
//
// Replaces tpu_ocean/fft/pallas_fft.py _fft_block_kernel (launched by
// _fft1d_transposed_impl) and _rowfft_block_kernel_natural (launched by
// _fft1d_natural_large_impl), both at lax.Precision.DEFAULT, and in this
// port the matrix engine (dft_matrix.cuh, matrix_dft_stages<kTierBf16,
// false>) for those two passes; the engine keeps the other tiers and forms
// and every fused pass but the bf16 natural store, whose kernel
// (fused_rows_natural_bf16.cuh) runs the stages below. Contract: (re, im)
// f32 [C, M, N] → the transposed (re, im) f32 [C, N, M] (kNatural = false)
// or the natural-order [C, M, N] (kNatural = true), unnormalized, + sign
// for the inverse, N a power of two in [16, 8192], any M and C. The two
// stores share everything up to the f32 result in shared memory.
//
// Numerics are those of the plain version (fft/matrix.py rows_dft at tier
// bf16) operand for operand: x and the f32 tables rounded to bf16 (round
// to nearest even), stage 1 accumulated in f32, C ⊙ T in f32 with each
// product and sum rounded alone, rounded to bf16 for stage 2, accumulated
// in f32. Only the order of the f32 accumulation differs.
//
// The four-step N = n2 · n1 (n1 = 128, or N / 2 below 128):
//   stage 1  C[k2, t] = Σ_s F2[k2, s] · x[s·n1 + t]   (depth n2, ≤ 64)
//   stage 2  X[k1·n2 + k2] = Σ_t F1[k1, t] · (C ⊙ T)[k2, t]   (depth n1)
// each a complex product on warp-level mma.sync.m16n8k16 (bf16 operands,
// f32 accumulation) in the real form [re; im] = [[Fr, −Fi], [Fi, Fr]] ·
// [xr; xi], a warp computing 8 complex outputs × 8 columns a tile.
//
// What bounds it on the H100: device memory, 16 B a point for a pass
// (8 in, 8 out): 16.8 MB, 5.0 µs at 3.35 TB/s for [1, 1024, 1024]. The
// products are 8·(n1 + n2) bf16 flops a point, 1.1 Gflop there, 1.2 µs of
// the tensor cores' dense rate, so mma.sync fed from registers and shared
// memory is enough; wgmma is not needed.
//
// The design, step by step (the engine it replaces read each table entry
// from L2 and converted it at every k-step of every tile, twiddled each
// stage-2 input in f32 once for each of the 16 row tiles that read it,
// and read stage 2's inputs with 8-way bank conflicts):
//
// 1. Pre-rounded tables, read once. fft/planes.py (bf16_rows_tables)
//    rounds F1 and F2 to bf16 on the host and lays their real forms out as
//    A fragments, in the order a lane loads them: tile (tm, kb), lane,
//    4 registers (planes.mma_a_fragments); then T stays f32. A lane's
//    depths in a k-step are k = 8·kb + 2q and 8·kb + 2q + 1, adjacent, so
//    its B fragment is one 64-bit load. Each warp owns one 8-output tile
//    of each stage and keeps that tile's A fragments in registers for all
//    the column tiles it computes: stage 2's F1 tile is 16 k-steps × 4 =
//    64 registers, loaded once a block with 16-byte loads (128 KB of F1 a
//    block, from L2) issued first, so that they arrive while the rows load
//    and stage 1 runs; stage 1's F2 tile is at most 4 k-steps × 4 = 16
//    (at N = 8192, 8 k-steps, it comes from L1 at each k-step: held, it
//    spilled). A thread of 512 may hold 128 registers; these take 114.
// 2. Twiddle once, into bf16. Stage 1's epilogue forms C ⊙ T from its
//    accumulators (each T entry read once a row, from L1) and stores it as
//    one 32-bit bf16 pair a complex value, so stage 2's B fragment is a
//    load with no conversion and no twiddle. The rows are rounded to bf16
//    pairs as they are loaded, halving their shared memory. Stage 2's f32
//    result goes to shared memory, over the consumed rows, for the
//    coalesced store (stockham.cuh store_rows: transposed, R consecutive
//    m of one k per run, 32-byte runs at R = 8; natural, the R rows as
//    one contiguous run, coalesced at any R).
// 3. Conflict-free layouts (32 banks of 4 bytes; lane = 4g + q):
//    - rows: x[r, s·n1 + t] at word (r·n2 + s)·(n1 + 4) + t. Stage 1's B
//      load of lane (g, q) reads s = 8·kb + 2q + h, t = t0 + g: bank
//      (2q·(n1 + 4) + g) mod 32 = 8q + g for n1 = 128, 32 and 16 (and
//      24q + g, q < 2 live, at n1 = 8): 32 distinct banks for each h.
//      The load stores 16 bytes a lane along t: conflict-free.
//    - intermediate: (C ⊙ T)[r, k2, t] at word (r·n2 + k2)·(n1 + 8) + t.
//      Stage 2's 64-bit B load of lane (g, q) reads words col·(n1 + 8) +
//      8·kb + 2q and + 1, col = 8·tn + g; a 64-bit load is served a half
//      warp (g < 4) at a time, at banks 8g + 2q, + 1 (n1 + 8 ≡ 8 mod 32
//      for n1 ≥ 32; 24g at n1 = 16): 32 distinct banks (2-way only at
//      N = 16, n1 = 8, where g and g + 2 meet).
//      Stage 1's epilogue writes word (r·n2 + k2)·(n1 + 8) + t0 + 2q + j,
//      k2 = 8·tm + g: banks 8g + 2q + j, 2-way where g and g + 4 meet;
//      it writes each value once, stage 2 reads it 16 times.
//    - result: store_rows<false>'s layout, (N + 1) complex a row.
//    Shared memory a block, R rows (planes.bf16_rows_shared_bytes):
//    max(R·n2·(n1 + 4)·4, R·(N + 1)·8) + R·n2·(n1 + 8)·4: 100 KB at
//    N = 1024, R = 8; 196 KB at N = 4096, R = 4 and at N = 8192, R = 2,
//    twice the rows the two f32 buffers of the engine allowed there.
// Tried and not kept: a persistent grid (one block an SM walking the row
// blocks, F1 loaded once a block, the next rows copied in with cp.async
// during stage 2, stage 2 storing straight from its accumulators so that
// the staged f32 rows and the intermediate fit beside each other). It was
// right, and slower at [1, 1024, 1024] and [1, 4096, 4096] (PERF.md §6).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "dft_matrix.cuh"
#include "stockham.cuh"

namespace tpu_fft {

namespace bf16_rows {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadsInFlight = 4;

template <int kLog2N>
struct Geometry {
  static constexpr int N = 1 << kLog2N;
  static constexpr int log2n1 = kLog2N >= 7 ? 7 : kLog2N - 1;
  static constexpr int n1 = 1 << log2n1;
  static constexpr int n2 = N / n1;
  static constexpr int kt1 = (n2 + 7) / 8;   // stage 1: tiles of depth and outputs
  static constexpr int kt2 = n1 / 8;         // stage 2: the same
  static constexpr int x_stride = n1 + 4;    // words an s-row of the rows
  static constexpr int y_stride = n1 + 8;    // words a (row, k2) of C ⊙ T
  // the tables, in 32-bit words: F2's fragments, T, F1's fragments
  static constexpr int f2_words = kt1 * kt1 * 32 * 4;
  static constexpr int t_words = 2 * N;
};

// Dynamic shared memory of a block of `rows` rows (planes.bf16_rows_shared_bytes)
inline int shared_bytes(int rows, int n) {
  const int n1 = lanes_n1(n);
  const int n2 = n / n1;
  const int rows_in = rows * n2 * (n1 + 4) * 4;
  const int rows_out = (rows * (n + 1) * 8 + 15) / 16 * 16;
  return (rows_in > rows_out ? rows_in : rows_out) + rows * n2 * (n1 + 8) * 4;
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

extern __shared__ uint4 bf16_rows_smem[];

// The stages below are shared with the bf16 fused natural-store kernel
// (fused_rows_natural_bf16.cuh), which stages its rows from the assembly
// instead of from planes: a kernel fills Buffers::xs, then runs
// stage1, stage2 and store_rows behind barriers.

// A block's dynamic shared memory: the rows (bf16 pairs), aliased by the
// f32 result after stage 1; then C ⊙ T
template <int kLog2N>
struct Buffers {
  uint32_t* xs;
  float2* res;
  uint32_t* ys;
  __device__ __forceinline__ explicit Buffers(int R)
      : xs(reinterpret_cast<uint32_t*>(bf16_rows_smem)),
        res(reinterpret_cast<float2*>(bf16_rows_smem)) {
    using G = Geometry<kLog2N>;
    const int rows_in = R * G::n2 * G::x_stride;
    const int rows_out = (R * (G::N + 1) * 2 + 3) / 4 * 4;
    ys = xs + (rows_in > rows_out ? rows_in : rows_out);
  }
};

// The word of Buffers::xs that holds point p = r·N + n of the block, n a
// multiple of 4: x[r, s·n1 + t] at (r·n2 + s)·(n1 + 4) + t, the next
// three points of the row at the three words after it
template <int kLog2N>
__device__ __forceinline__ int x_word(int p) {
  using G = Geometry<kLog2N>;
  const int r = p >> kLog2N;
  const int n = p & (G::N - 1);
  return (r * G::n2 + (n >> G::log2n1)) * G::x_stride + (n & (G::n1 - 1));
}

// Stage 2's tile of this warp (k1 = 8·(w mod kt2) + g): its F1 fragments,
// from L2 (64 registers at n1 = 128)
template <int kLog2N>
__device__ __forceinline__ void load_f1(uint4 (&a2)[Geometry<kLog2N>::kt2],
                                        const uint32_t* __restrict__ tables) {
  using G = Geometry<kLog2N>;
  const int lane = threadIdx.x & 31;
  const int tm2 = (threadIdx.x >> 5) % G::kt2;
  const uint4* f1 =
      reinterpret_cast<const uint4*>(tables + G::f2_words + G::t_words);
#pragma unroll
  for (int kb = 0; kb < G::kt2; ++kb) a2[kb] = __ldg(&f1[(tm2 * G::kt2 + kb) * 32 + lane]);
}

// Stage 1: warp w computes output tile tm = w mod kt1 (k2 = 8·tm + g)
// over the columns (r, t), 8 consecutive t of one row a tile, and
// writes bf16(C ⊙ T) to ys.
template <int kLog2N>
__device__ __forceinline__ void stage1(const uint32_t* xs, uint32_t* ys,
                                       const uint32_t* __restrict__ tables,
                                       int R) {
  using G = Geometry<kLog2N>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const uint4* f2 = reinterpret_cast<const uint4*>(tables);
  const float2* tw = reinterpret_cast<const float2*>(tables + G::f2_words);
  const int tm = warp % G::kt1;
  const uint4* f2_tile = f2 + tm * G::kt1 * 32 + lane;
  // F2's fragments in registers, but at n2 = 64 (N = 8192), where their
  // 32 registers beside F1's 64 spill: there from L1 at each k-step
  constexpr bool kHold = G::kt1 <= 4;
  uint4 a[kHold ? G::kt1 : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int kb = 0; kb < G::kt1; ++kb) a[kb] = __ldg(&f2_tile[kb * 32]);
  }
  const int k2 = tm * 8 + g;
  const int tiles = (R * G::n1) >> 3;
  for (int tn = warp / G::kt1; tn < tiles; tn += kWarps / G::kt1) {
    const int col0 = tn << 3;
    const int r = col0 >> G::log2n1;
    const int t0 = col0 & (G::n1 - 1);
    const uint32_t* xb = xs + r * G::n2 * G::x_stride + t0 + g;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < G::kt1; ++kb) {
      const int s = kb * 8 + 2 * q;
      const uint32_t b0 = s < G::n2 ? xb[s * G::x_stride] : 0u;
      const uint32_t b1 = s + 1 < G::n2 ? xb[(s + 1) * G::x_stride] : 0u;
      if constexpr (kHold) {
        mma(d, a[kb], b0, b1);
      } else {
        mma(d, __ldg(&f2_tile[kb * 32]), b0, b1);
      }
    }
    if (k2 < G::n2) {
      uint32_t* yb = ys + (r * G::n2 + k2) * G::y_stride;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + 2 * q + j;
        const float2 w = __ldg(&tw[k2 * G::n1 + t]);
        const float cr = d[j];
        const float ci = d[j + 2];
        yb[t] = pack_rn(__fsub_rn(__fmul_rn(cr, w.x), __fmul_rn(ci, w.y)),
                        __fadd_rn(__fmul_rn(cr, w.y), __fmul_rn(ci, w.x)));
      }
    }
  }
}

// Stage 2: warp w computes its tile k1 over the columns
// col = r·n2 + k2, and writes X[k1·n2 + k2] of row r to res in f32,
// over the consumed rows.
template <int kLog2N>
__device__ __forceinline__ void stage2(
    const uint32_t* ys, float2* res,
    const uint4 (&a2)[Geometry<kLog2N>::kt2], int R) {
  using G = Geometry<kLog2N>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int k1 = (warp % G::kt2) * 8 + g;
  const int cols = R * G::n2;
  const int tiles = (cols + 7) >> 3;
  for (int tn = warp / G::kt2; tn < tiles; tn += kWarps / G::kt2) {
    const int col = (tn << 3) + g;
    const bool ok = col < cols;
    const uint32_t* yb = ys + col * G::y_stride + 2 * q;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < G::kt2; ++kb) {
      const uint2 b = ok ? *reinterpret_cast<const uint2*>(yb + kb * 8)
                         : make_uint2(0u, 0u);
      mma(d, a2[kb], b.x, b.y);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int oc = (tn << 3) + 2 * q + j;
      if (oc < cols) {
        const int r = oc / G::n2;
        const int k2 = oc - r * G::n2;
        res[r * (G::N + 1) + k1 * G::n2 + k2] = make_float2(d[j], d[j + 2]);
      }
    }
  }
}

// One block: R rows m0 .. m0 + R − 1 of channel blockIdx.y.
template <int kLog2N, bool kNatural>
__global__ void __launch_bounds__(kThreads)
bf16_rows_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 const uint32_t* __restrict__ tables, int M, int R) {
  using G = Geometry<kLog2N>;
  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * G::N;
  const Buffers<kLog2N> b(R);

  // F1's fragments are issued first, so that they arrive while the rows
  // load and stage 1 runs
  uint4 a2[G::kt2];
  load_f1<kLog2N>(a2, tables);

  // Load: 4 points a lane as two float4 loads, kLoadsInFlight of them
  // started before any is waited on; rounded to bf16 pairs. Rows past M
  // (the ragged last block) are zero and never stored.
  {
    const int total = R * G::N / 4;
    const int valid = (M - m0 < R ? M - m0 : R) * G::N / 4;
    const size_t first = c * plane + static_cast<size_t>(m0) * G::N;
    const float4* bre = reinterpret_cast<const float4*>(re + first);
    const float4* bim = reinterpret_cast<const float4*>(im + first);
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
        *reinterpret_cast<uint4*>(&b.xs[x_word<kLog2N>(idx * 4)]) =
            make_uint4(pack_rn(vr[u].x, vi[u].x), pack_rn(vr[u].y, vi[u].y),
                       pack_rn(vr[u].z, vi[u].z), pack_rn(vr[u].w, vi[u].w));
      }
    }
  }
  __syncthreads();
  stage1<kLog2N>(b.xs, b.ys, tables, R);
  __syncthreads();
  stage2<kLog2N>(b.ys, b.res, a2, R);
  __syncthreads();
  store_rows<kNatural>(b.res, out_re + c * plane, out_im + c * plane, M,
                       G::N, kLog2N, R, m0);
}

template <int kLog2N, bool kNatural>
int launch_n(const void* re, const void* im, void* out_re, void* out_im,
             const void* tables, int channels, int m, int rows,
             cudaStream_t stream) {
  const auto kernel = bf16_rows_kernel<kLog2N, kNatural>;
  const int smem = shared_bytes(rows, 1 << kLog2N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const uint32_t*>(tables), m, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16_rows

// Launches the bf16 row kernel with the natural or the transposed store at
// length n (a power of two in [16, 8192]; anything else is refused with
// cudaErrorInvalidValue). `tables` are planes.bf16_rows_tables(n, inverse).
template <bool kNatural>
int launch_bf16_rows(const void* re, const void* im, void* out_re,
                     void* out_im, const void* tables, int channels, int m,
                     int n, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_BF16_ROWS_CASE(L)                                                 \
  case 1 << L:                                                                \
    return bf16_rows::launch_n<L, kNatural>(re, im, out_re, out_im, tables,   \
                                            channels, m, rows, s);
  switch (n) {
    TPU_BF16_ROWS_CASE(4)
    TPU_BF16_ROWS_CASE(5)
    TPU_BF16_ROWS_CASE(6)
    TPU_BF16_ROWS_CASE(7)
    TPU_BF16_ROWS_CASE(8)
    TPU_BF16_ROWS_CASE(9)
    TPU_BF16_ROWS_CASE(10)
    TPU_BF16_ROWS_CASE(11)
    TPU_BF16_ROWS_CASE(12)
    TPU_BF16_ROWS_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_BF16_ROWS_CASE
}

}  // namespace tpu_fft
