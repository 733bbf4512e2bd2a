// The f32 natural-store row DFT with register-resident radix-16 passes:
// fft_rows.cu's entry tpu_fft_rows_natural at tier f32, direct form.
//
// Replaces: tpu_ocean/fft/pallas_fft.py:677 _rowfft_block_kernel_natural
// (launched by _fft1d_natural_large_impl) at HIGHEST, with fft_rows.cu's
// contract:
//   in  (re, im) f32 [C, M, N], contiguous, N a power of two in [16, 8192]
//   out (re, im) f32 [C, M, N], out[c, m, k] = Σ_n x[c, m, n] e^{±2πi nk/N}
//       (+ for the inverse), unnormalized.
//
// What bounds it on the H100: device memory, 16 B a point (8 read, 8
// written): 268 MB, 0.080 ms at 3.35 TB/s for [1, 4096, 4096].
//
// What the kernel it replaces lost (fft_rows_kernel on stockham.cuh's
// stages, 0.1958 ms there, 0.41 of the bound): all log2 N radix-2 stages
// ran through shared memory, each behind a barrier. A butterfly reads 2
// points and a twiddle and writes 2 points, 20 B a point a stage; over 12
// stages, with the load and the store through shared memory, about 256 B a
// point: 4.3 GB for [1, 4096, 4096], about 0.145 ms at the SMs' ~30 TB/s
// before the first stages' 2-way bank conflicts; and 12 barriers a row.
//
// What this design does about it: a thread holds 16 points of a row in
// registers, T = N/16 threads a row. N = 16^a · r (r = 1, 2, 4 or 8) runs
// as a Stockham autosort plan (planes.radix16_plan): one radix-r pass where
// r > 1, then a radix-16 passes. Pass p of radix ρ and span ns (1, then
// the product of the radices before it) takes butterfly j's inputs at
// j + s·N/ρ, twiddles input s by e^{±2πi s·(j mod ns)/(ρ·ns)} and writes
// output s at (j / ns)·ρ·ns + (j mod ns) + s·ns. Whatever its radix, a
// pass reads a thread's 16 points at t + T·m, m < 16 (a radix-r pass runs
// the 16/r butterflies j = t + T·q), so
// - the first pass reads x[t + T·m] from device memory, all 32 loads of a
//   thread issued before any is used, and the last pass (span N/16) writes
//   out[t + T·m]: consecutive threads at consecutive addresses, coalesced,
//   neither through shared memory;
// - between two passes there is one exchange: the row written to shared
//   memory, a barrier, the row read back. At N = 4096, 2 exchanges, 3
//   barriers (12 before) and 32 B a point of shared-memory traffic (0.54 GB
//   for [1, 4096, 4096]).
// A radix-16 DFT runs in registers as 4 × 4 (radix 8 as 4 × 2): its
// internal twiddles are compile-time f32 constants, ±i and (±1 ± i)/√2 by
// adds and one product, cos and sin of π/8 rounded from float64.
//
// Shared memory: one exchange buffer of R rows of S complex. A pass that
// reads it waits at a barrier before it writes it again, so an exchange
// after the first takes two barriers. Against two buffers (one barrier an
// exchange) it read faster at [1, 4096, 4096] in turns on the H100, within
// the kernel's own spread, level at [1, 2048, 4096] and [1, 1024, 1024],
// slower for the one-row pass (tools/radix16_variants.py; PERF.md §6),
// and it takes half the shared memory: four blocks of 256 threads fit an
// SM, as many as 64 registers a thread allow.
// Point a of row r lies at r·S + a + ⌊a/P⌋, one pad every P = min(T, 16)
// points, S = N + N/P, plus T where T < 16
// (planes.radix16_stride): 64-bit accesses are served a half warp (16
// lanes) at a time, and with this layout every exchange write (the first
// pass's at 16t + s for radix 16 and (t + T·q)·r + s for radix r, a later
// pass's at (t / ns)·16·ns + (t mod ns) + s·ns) and every read (t + T·m)
// of a half warp falls on 16 distinct bank pairs, also where rows share a
// half warp (N < 256). No exchange at N = 16, one pass: no shared memory.
// Twiddles copied into shared memory by each block were slower at N = 4096
// (the same script): the copy reads as many bytes from L2 as the block's
// row moves.
// planes.radix16_shared_bytes is the Python twin of shared_bytes below.
//
// Twiddles (planes.radix16_twiddles, built in float64 and rounded to f32):
// entry 0 is (0, ±1), the direction; then each pass p ≥ 1 (radix 16, span
// ns) has its e^{±2πi s·k/(16·ns)}, s = 1..15, k < ns, at 1 + (ns − r0) +
// (s − 1)·ns + k, r0 the first pass's radix: N − r0 + 1 entries. They are
// read through the read-only cache, consecutive threads at consecutive
// entries (a full-circle table indexed s·k·N/(16·ns) would read s entries
// apart at the last pass).
//
// Rows per block: R from planes.radix16_max_rows (RADIX16_BLOCK_POINTS / N,
// at most kThreads threads a block). The channel is blockIdx.y. Rows past
// M (the ragged last block) load zeros and are never stored. The passes
// (radix16::passes) are also the f32 fused natural kernel's
// (fused_rows_natural_f32.cuh).
//
// A length outside [16, 8192] or a block of more than kThreads threads
// returns cudaErrorInvalidValue; nothing falls back to the radix-2 stages.

#pragma once

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace tpu_fft {

namespace radix16 {

constexpr int kThreads = 512;

template <int kLog2N>
struct Plan {
  static constexpr int N = 1 << kLog2N;
  static constexpr int T = N / 16;                       // threads a row
  static constexpr int kLog2First = kLog2N % 4 == 0 ? 4 : kLog2N % 4;
  static constexpr int kFirst = 1 << kLog2First;         // the first radix
  static constexpr int kPasses = 1 + (kLog2N - kLog2First) / 4;
  // one pad every P = min(T, 16) points; a row's stride S
  static constexpr int kLog2Pad = kLog2N - 4 < 4 ? kLog2N - 4 : 4;
  static constexpr int S = N + (N >> kLog2Pad) + (T < 16 ? T : 0);
  __device__ __forceinline__ static int pad(int a) { return a + (a >> kLog2Pad); }
};

// Dynamic shared memory of a block of `rows` rows (planes.radix16_shared_bytes)
inline int shared_bytes(int rows, int n) {
  if (n == 16) return 0;
  const int t = n / 16;
  const int stride = n + n / (t < 16 ? t : 16) + (t < 16 ? t : 0);
  return static_cast<int>(rows * stride * sizeof(float2));
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// ±i·a, sg = +1 for the inverse
__device__ __forceinline__ float2 rot_i(float2 a, float sg) {
  return make_float2(-sg * a.y, sg * a.x);
}

// a · e^{±2πi E/16} for the exponents the 4 × 4 and 4 × 2 splits need
template <int E>
__device__ __forceinline__ float2 rot16(float2 a, float sg) {
  constexpr float kC = 0.92387953251128674f;   // cos π/8
  constexpr float kS = 0.38268343236508978f;   // sin π/8
  constexpr float kH = 0.70710678118654752f;   // √½
  if constexpr (E == 0) {
    return a;
  } else if constexpr (E == 4) {
    return rot_i(a, sg);
  } else if constexpr (E == 2) {               // (1 ± i)/√2
    return make_float2((a.x - sg * a.y) * kH, (a.y + sg * a.x) * kH);
  } else if constexpr (E == 6) {               // (−1 ± i)/√2
    return make_float2((-a.x - sg * a.y) * kH, (sg * a.x - a.y) * kH);
  } else {
    static_assert(E == 1 || E == 3 || E == 9, "no such exponent");
    constexpr float c = E == 1 ? kC : E == 3 ? kS : -kC;
    constexpr float s = E == 1 ? kS : E == 3 ? kC : -kS;
    const float ss = sg * s;
    return make_float2(a.x * c - a.y * ss, a.x * ss + a.y * c);
  }
}

__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = add(t, a1);
  a1 = sub(t, a1);
}

// in place, natural order
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float sg) {
  const float2 s02 = add(a0, a2), d02 = sub(a0, a2);
  const float2 s13 = add(a1, a3), j13 = rot_i(sub(a1, a3), sg);
  a0 = add(s02, s13);
  a1 = add(d02, j13);
  a2 = sub(s02, s13);
  a3 = sub(d02, j13);
}

// 4 × 2: s = 2·s2 + s1, k = k1 + 4·k2; in place, natural order
__device__ __forceinline__ void dft8(float2 (&u)[8], float sg) {
  dft4(u[0], u[2], u[4], u[6], sg);    // A[0][k1] at u[2·k1]
  dft4(u[1], u[3], u[5], u[7], sg);    // A[1][k1] at u[2·k1 + 1]
  u[3] = rot16<2>(u[3], sg);
  u[5] = rot16<4>(u[5], sg);
  u[7] = rot16<6>(u[7], sg);
  float2 y[8];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    y[k1] = add(u[2 * k1], u[2 * k1 + 1]);
    y[k1 + 4] = sub(u[2 * k1], u[2 * k1 + 1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = y[k];
}

// 4 × 4: s = 4·s2 + s1, k = k1 + 4·k2; in place, natural order
__device__ __forceinline__ void dft16(float2 (&v)[16], float sg) {
#pragma unroll
  for (int s1 = 0; s1 < 4; ++s1)        // A[s1][k1] at v[s1 + 4·k1]
    dft4(v[s1], v[s1 + 4], v[s1 + 8], v[s1 + 12], sg);
  v[5] = rot16<1>(v[5], sg);
  v[6] = rot16<2>(v[6], sg);
  v[7] = rot16<3>(v[7], sg);
  v[9] = rot16<2>(v[9], sg);
  v[10] = rot16<4>(v[10], sg);
  v[11] = rot16<6>(v[11], sg);
  v[13] = rot16<3>(v[13], sg);
  v[14] = rot16<6>(v[14], sg);
  v[15] = rot16<9>(v[15], sg);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)        // y[k1 + 4·k2] at v[4·k1 + k2]
    dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3], sg);
  float2 y[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) y[k] = v[4 * (k & 3) + (k >> 2)];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = y[k];
}

// The first pass (span 1, no twiddles): the 16/kR butterflies of radix kR
// a thread, butterfly q on v[q + s·16/kR], s < kR, in place.
template <int kR>
__device__ __forceinline__ void first_pass(float2 (&v)[16], float sg) {
  constexpr int kB = 16 / kR;
  if constexpr (kR == 16) {
    dft16(v, sg);
  } else {
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      float2 u[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s) u[s] = v[q + s * kB];
      if constexpr (kR == 2) {
        dft2(u[0], u[1]);
      } else if constexpr (kR == 4) {
        dft4(u[0], u[1], u[2], u[3], sg);
      } else {
        static_assert(kR == 8, "the first radix is 2, 4, 8 or 16");
        dft8(u, sg);
      }
#pragma unroll
      for (int s = 0; s < kR; ++s) v[q + s * kB] = u[s];
    }
  }
}

extern __shared__ float2 radix16_smem[];

// The passes of one row, whose 16 points t + T·m a thread holds in v: the
// first pass in registers, then for each later pass an exchange through
// `buf` (the row's R·S slot of radix16_smem) and a radix-16 pass. v ends
// as the last pass's outputs, output s at t + T·s. Every thread of the
// block calls it together (it holds barriers): on entry no thread may
// still read `buf`; on return this thread's last reads of `buf` are done
// but the block's need not be, so a caller that runs it again first waits
// at a barrier.
template <int kLog2N>
__device__ __forceinline__ void passes(float2 (&v)[16], float2* buf,
                                       const float2* __restrict__ tw, int t,
                                       float sg) {
  using P = Plan<kLog2N>;
  constexpr int T = P::T;
  first_pass<P::kFirst>(v, sg);
  if constexpr (P::kPasses > 1) {
    constexpr int kB = 16 / P::kFirst;
#pragma unroll
    for (int q = 0; q < kB; ++q)
#pragma unroll
      for (int s = 0; s < P::kFirst; ++s)
        buf[P::pad((t + T * q) * P::kFirst + s)] = v[q + s * kB];
    __syncthreads();
#pragma unroll
    for (int p = 1; p < P::kPasses; ++p) {
      const int ns = P::kFirst << (4 * (p - 1));
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = buf[P::pad(t + T * j)];
      // every thread has read its points before any writes the next ones
      if (p < P::kPasses - 1) __syncthreads();
      const int k = t & (ns - 1);
      const float2* w = tw + 1 + ns - P::kFirst + k;
#pragma unroll
      for (int s = 1; s < 16; ++s) v[s] = cmul(v[s], __ldg(w + (s - 1) * ns));
      dft16(v, sg);
      if (p < P::kPasses - 1) {
        const int b = (t - k) * 16 + k;     // (t / ns)·16·ns + t mod ns
#pragma unroll
        for (int s = 0; s < 16; ++s) buf[P::pad(b + s * ns)] = v[s];
        __syncthreads();
      }
    }
  }
}

// One block: R rows m0 .. m0 + R − 1 of channel blockIdx.y, T threads a row.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
radix16_rows_natural_kernel(const float* __restrict__ re,
                            const float* __restrict__ im,
                            float* __restrict__ out_re,
                            float* __restrict__ out_im,
                            const float2* __restrict__ tw, int M, int R) {
  using P = Plan<kLog2N>;
  constexpr int T = P::T;
  const int row = threadIdx.x >> (kLog2N - 4);
  const int t = threadIdx.x & (T - 1);
  const int m = blockIdx.x * R + row;
  const bool live = m < M;
  const size_t at =
      (static_cast<size_t>(blockIdx.y) * M + (live ? m : 0)) * P::N + t;
  const float sg = __ldg(&tw[0].y);

  float2 v[16];
  if (live) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = make_float2(__ldg(re + at + T * j), __ldg(im + at + T * j));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = make_float2(0.f, 0.f);
  }
  passes<kLog2N>(v, radix16_smem + row * P::S, tw, t, sg);

  // the last pass has span N/16: output s at t + T·s
  if (live) {
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      out_re[at + T * s] = v[s].x;
      out_im[at + T * s] = v[s].y;
    }
  }
}

template <int kLog2N>
int launch_n(const void* re, const void* im, void* out_re, void* out_im,
             const void* tables, int channels, int m, int rows,
             cudaStream_t stream) {
  const auto kernel = radix16_rows_natural_kernel<kLog2N>;
  if (rows < 1 || rows > (kThreads >> (kLog2N - 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(rows, 1 << kLog2N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, rows << (kLog2N - 4), smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace radix16

// Launches the f32 natural-store row kernel at length n (a power of two in
// [16, 8192]; anything else, or more than 512 threads a block, is refused
// with cudaErrorInvalidValue). `tables` are planes.radix16_twiddles(n,
// inverse).
inline int launch_rows_natural_f32(const void* re, const void* im,
                                   void* out_re, void* out_im,
                                   const void* tables, int channels, int m,
                                   int n, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_RADIX16_CASE(L)                                                  \
  case 1 << L:                                                               \
    return radix16::launch_n<L>(re, im, out_re, out_im, tables, channels, m, \
                                rows, s);
  switch (n) {
    TPU_RADIX16_CASE(4)
    TPU_RADIX16_CASE(5)
    TPU_RADIX16_CASE(6)
    TPU_RADIX16_CASE(7)
    TPU_RADIX16_CASE(8)
    TPU_RADIX16_CASE(9)
    TPU_RADIX16_CASE(10)
    TPU_RADIX16_CASE(11)
    TPU_RADIX16_CASE(12)
    TPU_RADIX16_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_RADIX16_CASE
}

}  // namespace tpu_fft
