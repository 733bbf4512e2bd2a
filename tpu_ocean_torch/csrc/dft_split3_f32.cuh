// The f32 three-factor row DFT: fft_rows.cu's entry tpu_fft_rows_transposed
// at tier f32 in the three-factor form.
//
// Replaces tpu_ocean/fft/pallas_fft.py _fft_block_kernel_split3 at
// lax.Precision.HIGHEST (launched by _fft1d_transposed_impl where
// _use_split3 holds), and in this port the matrix engine (dft_matrix.cuh,
// matrix_dft_stages<kTierF32, true>) for that one pass; the engine keeps
// the fused kernels' three-factor form. Contract: (re, im) f32 [C, M, N] →
// the transposed (re, im) f32 [C, N, M], unnormalized, + sign for the
// inverse, N = n2 · 128 a power of two in [128, 8192], any M and C.
//
// N = n2 · n1 with n1 = 128 = W · U = 8 · 16, t = w·U + u, k1 = a·W + b:
//   stage 1   C[k2, t]    = Σ_s F2[k2, s] · x[s·128 + t]  (depth n2), ⊙ T[k2, t]
//   stage 2a  B[k2, b, u] = Σ_w F_W[b, w] · C[k2, w·16 + u]  (depth 8), ⊙ TW[b, u]
//   stage 2b  X[(a·8 + b)·n2 + k2] = Σ_u F_U[a, u] · B[k2, b, u]  (depth 16)
// the plain version's order (fft/matrix.py rows_dft with split3 tables).
// Numerics: each twiddle product and sum rounded alone (__fmul_rn,
// __fadd_rn, __fsub_rn), as the plain version's torch ops round them; the
// contractions accumulate in f32 FMA, in another order than torch's
// matmul; no tensor cores, no TF32 (the f32 tier).
//
// What bounds it on the H100: device memory, 16 B a point (5.0 µs for
// [1, 1024, 1024] at 3.35 TB/s); the work is 8·(n2 + 24) + 12 f32
// operations a point, 281 Mflop there, 4.2 µs at 67 TFLOP/s. The engine it
// replaces was bound by the issue of its loads: each lane held 2 output
// columns of one output, so a depth step cost an 8-byte table load and two
// shared reads twiddled in f32 for 8 FFMAs; it re-read and re-twiddled each
// input for every 8-output tile, and computed two integer divisions a
// column a stage.
//
// The design:
// 1. A thread owns whole columns of a stage: 2 columns, and all outputs of
//    their small DFT (stage 1 at n2 ≤ 16, stage 2a) or a fixed share
//    (stage 1: 16 of n2 > 16; stage 2b: 8 of 16), at most 64 accumulator
//    registers. It streams its columns' depth inputs from shared memory
//    once a share, each table entry it reads feeding 8 FFMAs, and writes
//    each output once. The twiddles are applied once, in the epilogue of
//    the stage that produced the values (T after stage 1, TW after 2a).
// 2. Warp-uniform tables. A warp's lanes share their output share, so
//    every read of F2, F_W or F_U is one address across the warp, a
//    broadcast. The tables are planes.matrix_tables(n, inverse, True)
//    (float64 rounded to f32 on the host): F2 [n2, n2], T [n2, 128],
//    F_W [8, 8], TW [8, 16], F_U [16, 16]. F2, F_W, TW and F_U are copied to
//    shared memory once a block: at most 36 KB, read at shared memory's
//    rate, where __constant__ space would hold one N and one direction and
//    serialise TW's reads, whose address follows the lane. T, read once a
//    row and coalesced along t, comes from L1/L2 with __ldg.
// 3. Shifts and masks: every size is a power of two, the lengths are
//    template constants and R's log2 is taken once. The load and stage 1
//    (load_rows_f32, stage1, whose epilogue is the caller's) are also the
//    first steps of the bf16x3 three-factor kernel (dft_split3_bf16x3.cuh),
//    which keeps stage 1 at f32 as the TPU kernel does.
// 4. Padded layouts (complex f32 = 8 bytes; a 64-bit shared access is
//    served a half warp at a time, conflict-free when its 16 lanes fall on
//    16 distinct 8-byte bank pairs, i.e. distinct addresses mod 16 in
//    float2 units). P = n2 | 1 (odd), Sb = 16·P + (n2 < 16 ? n2 : 0):
//    - A: the rows x[r, n] at r·SA + n, SA = max(N, 8·Sb); later B ⊙ TW
//      at r·SA + b·Sb + u·P + k2.
//    - Y: C ⊙ T at r·SY + k2·128 + t; later X at r·SY + k, SY = N + 1
//      (store_rows<false>'s layout).
//    Stage 1 lanes run along t (columns t and t + 64 a thread): reads of A
//    and writes of Y are 16 consecutive addresses a half warp. Stage 2a
//    lanes run along u, then k2 (columns c and c + cols/2): reads of Y are
//    consecutive; writes of A step u·P, P odd, so 16 distinct addresses
//    mod 16. Stage 2b lanes run along k2, then b: reads of A at
//    b·Sb + u·P + k2 with Sb ≡ n2 (mod 16) for n2 < 16 give b·n2 + k2,
//    16 consecutive values mod 16; writes of Y at (a·8 + b)·n2 + k2 are
//    consecutive. (At N = 128, n2 = 1, two rows meet in a half warp of
//    stage 2b's writes: 2-way.) tests/test_torch_row_kernels.py models
//    every access and counts its conflicts.
//    Shared memory a block, R rows (planes.split3_rows_shared_bytes):
//    8·(R·(SA + SY) + n2² + 448) bytes: 147 KB at N = 1024, R = 8; 145 KB
//    at N = 4096, R = 2; 168 KB at N = 8192, R = 1.

#pragma once

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace tpu_fft {

namespace split3_f32 {

constexpr int kThreads = 512;
constexpr int kLoadsInFlight = 4;
constexpr int kW = 8;                  // stage 2a depth (F_W)
constexpr int kU = 16;                 // stage 2b depth (F_U)
constexpr int kStage2Words = 448;      // F_W, TW, F_U: 64 + 128 + 256

template <int kLog2N>
struct Geometry {
  static constexpr int N = 1 << kLog2N;
  static constexpr int log2n2 = kLog2N - 7;
  static constexpr int n2 = 1 << log2n2;
  static constexpr int P = n2 | 1;
  static constexpr int Sb = 16 * P + (n2 < 16 ? n2 : 0);
  static constexpr int SA = N > 8 * Sb ? N : 8 * Sb;
  static constexpr int SY = N + 1;
  static constexpr int K1 = n2 < 16 ? n2 : 16;   // stage 1 outputs a share
  // dynamic shared memory of a block of `rows` rows
  // (planes.split3_rows_shared_bytes)
  static int shared_bytes(int rows) {
    return 8 * (rows * (SA + SY) + n2 * n2 + kStage2Words);
  }
};

// a · w with each product and sum rounded alone
__device__ __forceinline__ float2 twiddle(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// acc += f · x (complex, f32 FMA)
__device__ __forceinline__ void cfma(float2& acc, float2 f, float2 x) {
  acc.x = fmaf(f.x, x.x, fmaf(-f.y, x.y, acc.x));
  acc.y = fmaf(f.x, x.y, fmaf(f.y, x.x, acc.y));
}

// Loads rows m0 .. m0 + R − 1 of one channel's [M, N] planes (re, im at
// the channel's first row) into x as complex f32, row r at r·sa + n: 4
// points a lane as two float4 loads, kLoadsInFlight of them started before
// any is waited on. Rows past M (the ragged last block) are zero. Also the
// first step of the bf16x3 three-factor kernel (dft_split3_bf16x3.cuh).
template <int kLog2N, int kBlock>
__device__ __forceinline__ void load_rows_f32(float2* xa, int sa,
                                              const float* __restrict__ re,
                                              const float* __restrict__ im,
                                              int M, int R, int m0) {
  constexpr int N = 1 << kLog2N;
  const int total = R * N / 4;
  const int valid = (M - m0 < R ? M - m0 : R) * N / 4;
  const size_t first = static_cast<size_t>(m0) * N;
  const float4* bre = reinterpret_cast<const float4*>(re + first);
  const float4* bim = reinterpret_cast<const float4*>(im + first);
  for (int base = threadIdx.x; base < total;
       base += kLoadsInFlight * kBlock) {
    float4 vr[kLoadsInFlight], vi[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * kBlock;
      const bool ok = idx < valid;
      vr[u] = ok ? bre[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      vi[u] = ok ? bim[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * kBlock;
      if (idx >= total) continue;
      const int p = idx * 4;
      float4* dst =
          reinterpret_cast<float4*>(&xa[(p >> kLog2N) * sa + (p & (N - 1))]);
      dst[0] = make_float4(vr[u].x, vi[u].x, vr[u].y, vi[u].y);
      dst[1] = make_float4(vr[u].z, vi[u].z, vr[u].w, vi[u].w);
    }
  }
}

// Stage 1 on the rows x (at r·sa + n): C[k2, t] = Σ_s F2[k2, s] ·
// x[s·128 + t] (depth n2, FFMA, F2 broadcast from shared memory), then
// C ⊙ T[k2, t] with each product and sum rounded alone; out(r, k2, t, v)
// takes each value. An item is the columns t and t + 64 of row r and the
// outputs k2 = K1·share .. + K1 − 1; the share is the slowest index, so a
// warp shares it, and a warp's lanes run along t. Also stage 1 of the
// bf16x3 three-factor kernel, whose out splits and stores the value.
template <int kLog2N, int kBlock, class Out>
__device__ __forceinline__ void stage1(const float2* xa, int sa,
                                       const float2* f2s,
                                       const float2* __restrict__ tw1,
                                       int R, Out&& out) {
  using G = Geometry<kLog2N>;
  constexpr int n2 = G::n2;
  constexpr int K = G::K1;
  const int log2g = (31 - __clz(R)) + 6;           // R·64 column pairs
  const int items = (R << 6) * (n2 / K);
  for (int item = threadIdx.x; item < items; item += kBlock) {
    const int k0 = (item >> log2g) * K;
    const int i = item & ((1 << log2g) - 1);
    const int r = i >> 6;
    const int t = i & 63;
    const float2* x = xa + r * sa + t;
    float2 acc0[K], acc1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc0[k] = acc1[k] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n2; ++s) {
      const float2 x0 = x[s * 128];
      const float2 x1 = x[s * 128 + 64];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 f = f2s[(k0 + k) * n2 + s];
        cfma(acc0[k], f, x0);
        cfma(acc1[k], f, x1);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = (k0 + k) * 128;
      out(r, k0 + k, t, twiddle(acc0[k], __ldg(&tw1[o + t])));
      out(r, k0 + k, t + 64, twiddle(acc1[k], __ldg(&tw1[o + t + 64])));
    }
  }
}

extern __shared__ float4 split3_f32_smem[];

// One block: R rows m0 .. m0 + R − 1 of channel blockIdx.y.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
split3_f32_rows_kernel(const float* __restrict__ re,
                       const float* __restrict__ im,
                       float* __restrict__ out_re, float* __restrict__ out_im,
                       const float2* __restrict__ tables, int M, int R) {
  using G = Geometry<kLog2N>;
  constexpr int n2 = G::n2;
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * G::N;

  float2* xa = reinterpret_cast<float2*>(split3_f32_smem);
  float2* ys = xa + R * G::SA;
  float2* f2s = ys + R * G::SY;
  float2* fws = f2s + n2 * n2;        // then TW, then F_U
  float2* tws = fws + kW * kW;
  float2* fus = tws + kW * kU;
  const float2* tw1 = tables + n2 * n2;           // T [n2, 128], global

  for (int i = tid; i < n2 * n2; i += kThreads) f2s[i] = tables[i];
  for (int i = tid; i < kStage2Words; i += kThreads)
    fws[i] = tables[n2 * n2 + G::N + i];

  load_rows_f32<kLog2N, kThreads>(xa, G::SA, re + c * plane, im + c * plane,
                                  M, R, m0);
  __syncthreads();

  // Stage 1, writing C ⊙ T to Y
  stage1<kLog2N, kThreads>(xa, G::SA, f2s, tw1, R,
                           [&](int r, int k2, int t, float2 v) {
                             ys[r * G::SY + k2 * 128 + t] = v;
                           });
  __syncthreads();

  // Stage 2a: columns c = (r·n2 + k2)·16 + u; an item is the columns i and
  // i + cols/2, all 8 outputs b. Writes B ⊙ TW to A (the rows are spent).
  {
    const int half = R * n2 * 8;
    for (int i = tid; i < half; i += kThreads) {
      int in[2], out[2], u[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = i + j * half;
        u[j] = col & 15;
        const int rk = col >> 4;
        const int r = rk >> G::log2n2;
        const int k2 = rk & (n2 - 1);
        in[j] = r * G::SY + k2 * 128 + u[j];
        out[j] = r * G::SA + u[j] * G::P + k2;
      }
      float2 acc[2][kW];
#pragma unroll
      for (int b = 0; b < kW; ++b) acc[0][b] = acc[1][b] = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float2 x0 = ys[in[0] + w * kU];
        const float2 x1 = ys[in[1] + w * kU];
#pragma unroll
        for (int b = 0; b < kW; ++b) {
          const float2 f = fws[b * kW + w];
          cfma(acc[0][b], f, x0);
          cfma(acc[1][b], f, x1);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int b = 0; b < kW; ++b)
          xa[out[j] + b * G::Sb] = twiddle(acc[j][b], tws[b * kU + u[j]]);
      }
    }
  }
  __syncthreads();

  // Stage 2b: columns c = (r·8 + b)·n2 + k2; an item is the columns i and
  // i + cols/2 and the outputs a = 8·share .. + 7 (the share slowest).
  // Writes X[(a·8 + b)·n2 + k2] to Y in natural order.
  {
    const int half = R * 4 * n2;
    for (int item = tid; item < 2 * half; item += kThreads) {
      const int share = item >= half;
      const int i = item - share * half;
      int in[2], out[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = i + j * half;
        const int k2 = col & (n2 - 1);
        const int rb = col >> G::log2n2;
        const int b = rb & 7;
        const int r = rb >> 3;
        in[j] = r * G::SA + b * G::Sb + k2;
        out[j] = r * G::SY + b * n2 + k2;
      }
      const float2* fu = fus + share * 8 * kU;
      float2 acc[2][8];
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[0][a] = acc[1][a] = make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float2 x0 = xa[in[0] + u * G::P];
        const float2 x1 = xa[in[1] + u * G::P];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float2 f = fu[a * kU + u];
          cfma(acc[0][a], f, x0);
          cfma(acc[1][a], f, x1);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
          ys[out[j] + (share * 8 + a) * kW * n2] = acc[j][a];
      }
    }
  }
  __syncthreads();

  store_rows<false>(ys, out_re + c * plane, out_im + c * plane, M, G::N,
                    kLog2N, R, m0);
}

template <int kLog2N>
int launch_n(const void* re, const void* im, void* out_re, void* out_im,
             const void* tables, int channels, int m, int rows,
             cudaStream_t stream) {
  const auto kernel = split3_f32_rows_kernel<kLog2N>;
  const int smem = Geometry<kLog2N>::shared_bytes(rows);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split3_f32

// Launches the f32 three-factor transposed row kernel at length n (a power
// of two in [128, 8192]; anything else is refused with
// cudaErrorInvalidValue). `tables` are planes.matrix_tables(n, inverse,
// True).
inline int launch_split3_f32_rows(const void* re, const void* im,
                                  void* out_re, void* out_im,
                                  const void* tables, int channels, int m,
                                  int n, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_SPLIT3_CASE(L)                                                    \
  case 1 << L:                                                                \
    return split3_f32::launch_n<L>(re, im, out_re, out_im, tables, channels,  \
                                   m, rows, s);
  switch (n) {
    TPU_SPLIT3_CASE(7)
    TPU_SPLIT3_CASE(8)
    TPU_SPLIT3_CASE(9)
    TPU_SPLIT3_CASE(10)
    TPU_SPLIT3_CASE(11)
    TPU_SPLIT3_CASE(12)
    TPU_SPLIT3_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_SPLIT3_CASE
}

}  // namespace tpu_fft
