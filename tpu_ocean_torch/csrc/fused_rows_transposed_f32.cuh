// The f32 fused transposed-store kernel: fused_rows.cu's entry
// tpu_fused_rows_transposed at tier f32, direct form.
//
// Replaces: tpu_ocean/ops/fused_spectrum_fft.py:127 _fused_kernel
// (launched by assemble_rowfft) at HIGHEST, with fused_rows.cu's contract,
// transposed store:
//   in  h0r, h0i, h0cr, h0ci, φ: f32 [M, N], contiguous, the rows
//       row_offset .. row_offset + M − 1 of the N × N grid; kz: f32 [N];
//       N a power of two in [16, 8192]
//   out channels ch_start .. ch_start + C − 1 of the set, assembled
//       (fused_assembly.cuh) and row-transformed, stored transposed:
//       (re, im) f32 [C, N, M], out[c, k, m].
//
// What bounds it on the H100: device memory. The five planes are read
// once (20 B a point) and each channel written once (8 B a point a
// channel): [1024, 1024] 29.4 MB, 0.0088 ms at 3.35 TB/s for one channel,
// 46.1 MB, 0.0138 ms for three.
//
// What the kernel it replaces lost (fused_rows_kernel on stockham.cuh's
// stages): each block assembled one channel (the channel was blockIdx.y),
// so a launch of C channels read the five planes C times; the row ran
// through log2 N radix-2 stages in shared memory, each behind a barrier;
// and its two ping-pong buffers and twiddles (139 KB at N = 1024, R = 8)
// left one block an SM.
//
// What this design does about it: the f32 fused natural kernel's load
// and channel loop (fused_rows_natural_f32.cuh: load_terms, HeldTerms,
// channel_passes on radix16::passes), shared, not copied, and a store of
// its own. A block owns R rows, T = N/16 threads a row, a thread the 16
// points t + T·m of its row; it reads the five planes once, holds h̃ in
// shared memory and 1/|k| in registers, and makes every channel of the
// launch from them: the grid is ⌈M/R⌉ blocks, no channel axis. After the
// last pass, output s of a thread lies at k = t + T·s of its row. The
// store writes out[c, k, m0 + r] with r fastest, runs of R floats, as
// stockham.cuh's store_rows<false> did, through a tile in shared memory:
// each thread writes its row's outputs at r·G + k, G = gather_stride(R, N)
// (stockham.cuh), and the block reads the tile back R rows at one k, then
// the next k. The exchange buffer's own stride S = N + N/16 is ≡ 0 (mod
// 16) in complex units from N = 256 on, so a read-out of R rows at one k
// there would hit one bank pair R times; G ≡ 16/R (mod 16) spreads them
// (tests/test_torch_fused_transposed.py models both accesses at every N
// and R the wrapper picks: planes.fused_transposed_max_rows keeps R·T ≤
// 16 where T < 16, where rows share a half warp of the tile's writes).
//
// Shared memory: the fused natural kernel's, the exchange buffer (R rows
// of S, radix16::shared_bytes's layout) and h̃ (R rows of N); the tile
// (R rows of G) lies in the exchange buffer, which holds it at every N
// (G ≤ N + 15 < S). A third region for the tile would spare a barrier a
// channel (radix16::passes returns while other threads may still read
// the buffer) but read 6–12% slower at the paths' shapes on the H100
// (tools/fused_transposed_variants.py, PERF.md §6): at N = 1024, R = 8 it
// takes the block from 135 KB to 201 KB of the SM's 228 KB, and the L1
// cache, which the planes' loads and the twiddle and kz reads pass
// through, shrinks with it; a 512-thread block at 128 registers a thread
// has an SM to itself either way. Three barriers a channel: before its
// passes (no thread still reads the tile for the channel before), after
// them (none still reads the exchange buffer) and after the tile's
// writes. The block's shared memory is fused_radix16::shared_bytes
// (planes.fused_natural_shared_bytes); rows per block come from
// planes.fused_transposed_max_rows. Rows past M (the ragged last block)
// assemble from zeros and are never stored. No thread-block cluster: the
// store's runs are R floats, 8 at N ≤ 1024.
//
// A length outside [16, 8192], rows not a power of two, or a block of more
// than kThreads threads returns cudaErrorInvalidValue; nothing falls back
// to the radix-2 stages.

#pragma once

#include <cuda_runtime.h>

#include "fused_rows_natural_f32.cuh"

namespace tpu_fft {

namespace fused_transposed {

using radix16::Plan;
constexpr int kThreads = radix16::kThreads;

// One block: R = 2^log2r rows m0 .. m0 + R − 1, T threads a row, every
// channel.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
radix16_fused_rows_transposed_kernel(
    const float* __restrict__ h0r, const float* __restrict__ h0i,
    const float* __restrict__ h0cr, const float* __restrict__ h0ci,
    const float* __restrict__ phase, const float* __restrict__ kz,
    float* __restrict__ out_re, float* __restrict__ out_im,
    const float2* __restrict__ tw, int M, int log2r, int ch_start, int C,
    Assembly p) {
  using P = Plan<kLog2N>;
  constexpr int T = P::T;
  const int R = 1 << log2r;
  const int row = threadIdx.x >> (kLog2N - 4);
  const int t = threadIdx.x & (T - 1);
  const int m0 = blockIdx.x << log2r;
  const int m = m0 + row;
  const bool live = m < M;
  const size_t at = static_cast<size_t>(live ? m : 0) * P::N + t;
  const int grow = p.row_offset + m;
  const float kx = row_kx(grow, P::N, p);
  const float sg = __ldg(&tw[0].y);
  float2* const smem = radix16::radix16_smem;
  float2* const buf = smem + row * P::S;
  fused_radix16::HeldTerms<T> held(smem + R * P::S + row * P::N, t);
  const int G = gather_stride(R, P::N);
  float2* const tile = smem;      // in the exchange buffer
  const int live_rows = M - m0 < R ? M - m0 : R;

  // the five planes, read once
  fused_radix16::load_terms<kLog2N>(h0r, h0i, h0cr, h0ci, phase, kz, at,
                                    live, kx, t, p, held);

  const size_t plane = static_cast<size_t>(P::N) * M;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    // every thread's last reads of the tile for the channel before are
    // done before any writes the exchange buffer again
    if (c > 0) __syncthreads();
    float2 v[16];
    fused_radix16::channel_passes<kLog2N>(v, held, kx, kz, grow, t,
                                          ch_start + c, p, buf, tw, sg);
    // every thread's last reads of the exchange buffer are done
    __syncthreads();
    // the last pass has span N/16: output s at k = t + T·s
#pragma unroll
    for (int s = 0; s < 16; ++s) tile[row * G + t + T * s] = v[s];
    __syncthreads();
    // R rows at one k, then the next k: runs of R floats of out[c, k, ·]
    float* const o_re = out_re + c * plane + m0;
    float* const o_im = out_im + c * plane + m0;
#pragma unroll 4
    for (int i = threadIdx.x; i < (P::N << log2r); i += blockDim.x) {
      const int r = i & (R - 1);
      const int k = i >> log2r;
      if (r < live_rows) {
        const float2 x = tile[r * G + k];
        const size_t g = static_cast<size_t>(k) * M + r;
        o_re[g] = x.x;
        o_im[g] = x.y;
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
  const auto kernel = radix16_fused_rows_transposed_kernel<kLog2N>;
  if (rows < 1 || rows > (kThreads >> (kLog2N - 4)) || (rows & (rows - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the tile lies in the exchange buffer: the fused natural kernel's bytes
  const int smem = fused_radix16::shared_bytes(rows, 1 << kLog2N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + rows - 1) / rows, rows << (kLog2N - 4), smem, stream>>>(
      static_cast<const float*>(h0r), static_cast<const float*>(h0i),
      static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
      static_cast<const float*>(phase), static_cast<const float*>(kz),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, log2_of(rows), ch_start,
      channels, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused_transposed

// Launches the f32 fused transposed-store kernel at length n (a power of
// two in [16, 8192]; anything else, rows not a power of two, or more than
// 512 threads a block, is refused with cudaErrorInvalidValue). `tables`
// are planes.radix16_twiddles(n, inverse).
inline int launch_fused_rows_transposed_f32(
    const void* h0r, const void* h0i, const void* h0cr, const void* h0ci,
    const void* phase, const void* kz, void* out_re, void* out_im,
    const void* tables, int channels, int ch_start, int m, int n, int rows,
    const Assembly& p, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_FUSED_TRANSPOSED_CASE(L)                                       \
  case 1 << L:                                                             \
    return fused_transposed::launch_n<L>(h0r, h0i, h0cr, h0ci, phase, kz,  \
                                         out_re, out_im, tables, channels, \
                                         ch_start, m, rows, p, s);
  switch (n) {
    TPU_FUSED_TRANSPOSED_CASE(4)
    TPU_FUSED_TRANSPOSED_CASE(5)
    TPU_FUSED_TRANSPOSED_CASE(6)
    TPU_FUSED_TRANSPOSED_CASE(7)
    TPU_FUSED_TRANSPOSED_CASE(8)
    TPU_FUSED_TRANSPOSED_CASE(9)
    TPU_FUSED_TRANSPOSED_CASE(10)
    TPU_FUSED_TRANSPOSED_CASE(11)
    TPU_FUSED_TRANSPOSED_CASE(12)
    TPU_FUSED_TRANSPOSED_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_FUSED_TRANSPOSED_CASE
}

}  // namespace tpu_fft
