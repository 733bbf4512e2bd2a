// The f32 fused natural-store kernel: fused_rows.cu's entry
// tpu_fused_rows_natural at tier f32, direct form.
//
// Replaces: tpu_ocean/ops/fused_spectrum_fft.py:196
// _fused_rowfft_kernel_natural (launched by assemble_rowfft_natural) at
// HIGHEST, with fused_rows.cu's contract, natural store:
//   in  h0r, h0i, h0cr, h0ci, φ: f32 [M, N], contiguous, the rows
//       row_offset .. row_offset + M − 1 of the N × N grid; kz: f32 [N];
//       N a power of two in [16, 8192]
//   out channels ch_start .. ch_start + C − 1 of the set, assembled
//       (fused_assembly.cuh) and row-transformed: (re, im) f32 [C, M, N].
//
// What bounds it on the H100: device memory. The five planes are read
// once (20 B a point) and each channel written once (8 B a point a
// channel): [4096, 4096] 469.8 MB, 0.140 ms at 3.35 TB/s for one channel,
// 1006.6 MB, 0.300 ms for five.
//
// What the kernel it replaces lost (fused_rows_kernel on stockham.cuh's
// stages): each block assembled one channel (the channel was blockIdx.y),
// so a launch of C channels read the five planes C times (C = 5 took 4.7×
// one channel's time on the H100, PERF.md §6), and the row ran through 12
// radix-2 stages in shared memory at N = 4096, each behind a barrier.
//
// What this design does about it: a block owns R rows, T = N/16 threads a
// row, and a thread the 16 points t + T·m of its row, the layout of the
// radix-16 row kernel (rows_natural_f32.cuh). Each thread
// - reads its points of the five planes once, kGroup points at a time
//   (5·kGroup loads in flight, consecutive threads at consecutive
//   addresses), and reduces each group at once to the terms no channel
//   changes (point_terms): 1/|k| stays in registers, h̃ goes to a second
//   shared buffer, R rows of N complex after the exchange buffer, at the
//   thread's own points t + T·m (each thread reads back only what it
//   wrote, so no barrier; consecutive threads at consecutive addresses);
//   kz is read again from the read-only cache for each channel;
// - then, channel by channel, forms the channel's 16 values
//   (channel_value), runs radix16::passes on them (the row kernel's passes
//   and twiddles, planes.radix16_twiddles) and stores the channel's plane
//   straight from registers, coalesced: the last pass leaves output s at
//   t + T·s.
// The grid has no channel axis: ⌈M/R⌉ blocks. The exchange buffer is the
// row kernel's (radix16::shared_bytes), reused by every channel behind a
// barrier. Holding h̃ in registers too (48 floats across the channel
// loop, beside the passes' 32 and their twiddles) spilled under the 128
// registers a thread of a 512-thread block may have, at every N ≥ 512,
// and read no faster over the paths' launches on the H100
// (tools/fused_radix16_variants.py keeps it as a variant; PERF.md §6).
// planes.fused_natural_shared_bytes is the Python twin of shared_bytes
// below; rows per block come from planes.fused_natural_max_rows.
// Rows past M (the ragged last block) assemble from zeros and are never
// stored.
//
// A length outside [16, 8192] or a block of more than kThreads threads
// returns cudaErrorInvalidValue; nothing falls back to the radix-2 stages.

#pragma once

#include <cuda_runtime.h>

#include "fused_assembly.cuh"
#include "rows_natural_f32.cuh"

namespace tpu_fft {

namespace fused_radix16 {

using radix16::Plan;
constexpr int kThreads = radix16::kThreads;
constexpr int kGroup = 8;     // points of a thread loaded together

// Dynamic shared memory of a block of `rows` rows
// (planes.fused_natural_shared_bytes): the exchange buffer, R rows of the
// padded stride S (Plan::S, also at N = 16), then h̃, R rows of N complex
inline int shared_bytes(int rows, int n) {
  const int t = n / 16;
  const int stride = n + n / (t < 16 ? t : 16) + (t < 16 ? t : 0);
  return static_cast<int>(rows * (stride + n) * sizeof(float2));
}

// The channel-independent terms of a thread's 16 points (t + T·m): h̃ in
// `slot`, the thread's row of N complex after the exchange buffer, 1/|k|
// in registers
template <int T>
struct HeldTerms {
  float2* ht;
  float invk[16];
  __device__ __forceinline__ HeldTerms(float2* slot, int t) : ht(slot + t) {}
  __device__ __forceinline__ void put(int m, const PointTerms& x) {
    ht[T * m] = make_float2(x.htr, x.hti);
    invk[m] = x.invk;
  }
  __device__ __forceinline__ PointTerms get(int m) const {
    const float2 h = ht[T * m];
    return PointTerms{h.x, h.y, invk[m]};
  }
};

// The grouped read of a thread's 16 points t + T·m of the five planes
// (row offset `at` of its first point; zeros where the row is not live),
// each group reduced at once to its terms in `held`. Shared by both f32
// fused kernels (this one and fused_rows_transposed_f32.cuh).
template <int kLog2N>
__device__ __forceinline__ void load_terms(
    const float* __restrict__ h0r, const float* __restrict__ h0i,
    const float* __restrict__ h0cr, const float* __restrict__ h0ci,
    const float* __restrict__ phase, const float* __restrict__ kz,
    size_t at, bool live, float kx, int t, const Assembly& p,
    HeldTerms<Plan<kLog2N>::T>& held) {
  constexpr int T = Plan<kLog2N>::T;
#pragma unroll
  for (int g = 0; g < 16; g += kGroup) {
    float x[kGroup][5];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const size_t i = at + T * (g + u);
      x[u][0] = live ? __ldg(h0r + i) : 0.f;
      x[u][1] = live ? __ldg(h0i + i) : 0.f;
      x[u][2] = live ? __ldg(h0cr + i) : 0.f;
      x[u][3] = live ? __ldg(h0ci + i) : 0.f;
      x[u][4] = live ? __ldg(phase + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      held.put(g + u, point_terms(x[u][0], x[u][1], x[u][2], x[u][3],
                                  x[u][4], kx, __ldg(kz + t + T * (g + u)),
                                  p));
  }
}

// Channel `ch` of a thread's 16 points from their held terms, through
// radix16::passes (which holds barriers: every thread of the block calls
// it together, none still reading `buf`): v ends as the last pass's
// outputs, output s at t + T·s of the row (global row `grow`).
template <int kLog2N>
__device__ __forceinline__ void channel_passes(
    float2 (&v)[16], const HeldTerms<Plan<kLog2N>::T>& held, float kx,
    const float* __restrict__ kz, int grow, int t, int ch,
    const Assembly& p, float2* buf, const float2* __restrict__ tw,
    float sg) {
  using P = Plan<kLog2N>;
  constexpr int T = P::T;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    v[j] = channel_value(held.get(j), kx, __ldg(kz + t + T * j), grow,
                         t + T * j, P::N, ch, p);
  radix16::passes<kLog2N>(v, buf, tw, t, sg);
}

// One block: R rows m0 .. m0 + R − 1, T threads a row, every channel.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
radix16_fused_rows_natural_kernel(
    const float* __restrict__ h0r, const float* __restrict__ h0i,
    const float* __restrict__ h0cr, const float* __restrict__ h0ci,
    const float* __restrict__ phase, const float* __restrict__ kz,
    float* __restrict__ out_re, float* __restrict__ out_im,
    const float2* __restrict__ tw, int M, int R, int ch_start, int C,
    Assembly p) {
  using P = Plan<kLog2N>;
  constexpr int T = P::T;
  const int row = threadIdx.x >> (kLog2N - 4);
  const int t = threadIdx.x & (T - 1);
  const int m = blockIdx.x * R + row;
  const bool live = m < M;
  const size_t at = static_cast<size_t>(live ? m : 0) * P::N + t;
  const int grow = p.row_offset + m;
  const float kx = row_kx(grow, P::N, p);
  const float sg = __ldg(&tw[0].y);
  float2* const buf = radix16::radix16_smem + row * P::S;
  HeldTerms<T> held(radix16::radix16_smem + R * P::S + row * P::N, t);

  // the five planes, read once
  load_terms<kLog2N>(h0r, h0i, h0cr, h0ci, phase, kz, at, live, kx, t, p,
                     held);

  const size_t plane = static_cast<size_t>(M) * P::N;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    // every thread's last reads of the exchange buffer for the channel
    // before are done before any writes it again
    if constexpr (P::kPasses > 1) {
      if (c > 0) __syncthreads();
    }
    float2 v[16];
    channel_passes<kLog2N>(v, held, kx, kz, grow, t, ch_start + c, p, buf,
                           tw, sg);
    // the last pass has span N/16: output s at t + T·s
    if (live) {
      const size_t o = c * plane + at;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        out_re[o + T * s] = v[s].x;
        out_im[o + T * s] = v[s].y;
      }
    }
  }
}

template <int kLog2N>
int launch_n(const void* h0r, const void* h0i, const void* h0cr,
             const void* h0ci, const void* phase, const void* kz,
             void* out_re, void* out_im, const void* tables, int channels,
             int ch_start, int m, int rows, const Assembly& p,
             cudaStream_t stream) {
  const auto kernel = radix16_fused_rows_natural_kernel<kLog2N>;
  if (rows < 1 || rows > (kThreads >> (kLog2N - 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(rows, 1 << kLog2N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + rows - 1) / rows, rows << (kLog2N - 4), smem, stream>>>(
      static_cast<const float*>(h0r), static_cast<const float*>(h0i),
      static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
      static_cast<const float*>(phase), static_cast<const float*>(kz),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, rows, ch_start, channels, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused_radix16

// Launches the f32 fused natural-store kernel at length n (a power of two
// in [16, 8192]; anything else, or more than 512 threads a block, is
// refused with cudaErrorInvalidValue). `tables` are
// planes.radix16_twiddles(n, inverse).
inline int launch_fused_rows_natural_f32(
    const void* h0r, const void* h0i, const void* h0cr, const void* h0ci,
    const void* phase, const void* kz, void* out_re, void* out_im,
    const void* tables, int channels, int ch_start, int m, int n, int rows,
    const Assembly& p, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_FUSED_RADIX16_CASE(L)                                          \
  case 1 << L:                                                             \
    return fused_radix16::launch_n<L>(h0r, h0i, h0cr, h0ci, phase, kz,     \
                                      out_re, out_im, tables, channels,    \
                                      ch_start, m, rows, p, s);
  switch (n) {
    TPU_FUSED_RADIX16_CASE(4)
    TPU_FUSED_RADIX16_CASE(5)
    TPU_FUSED_RADIX16_CASE(6)
    TPU_FUSED_RADIX16_CASE(7)
    TPU_FUSED_RADIX16_CASE(8)
    TPU_FUSED_RADIX16_CASE(9)
    TPU_FUSED_RADIX16_CASE(10)
    TPU_FUSED_RADIX16_CASE(11)
    TPU_FUSED_RADIX16_CASE(12)
    TPU_FUSED_RADIX16_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_FUSED_RADIX16_CASE
}

}  // namespace tpu_fft
