// The bf16 fused natural-store kernel: fused_rows.cu's entry
// tpu_fused_rows_natural at tier bf16, direct form.
//
// Replaces: tpu_ocean/ops/fused_spectrum_fft.py:196
// _fused_rowfft_kernel_natural (launched by assemble_rowfft_natural) at
// lax.Precision.DEFAULT, with fused_rows.cu's contract, natural store:
//   in  h0r, h0i, h0cr, h0ci, φ: f32 [M, N], contiguous, the rows
//       row_offset .. row_offset + M − 1 of the N × N grid; kz: f32 [N];
//       N a power of two in [16, 8192]; every pointer 16-byte aligned
//   out channels ch_start .. ch_start + C − 1 of the set, assembled
//       (fused_assembly.cuh) and row-transformed at bf16: (re, im) f32
//       [C, M, N].
//
// What bounds it on the H100: device memory. The five planes are read
// once (20 B a point) and the channel written once (8 B): [4096, 4096]
// 469.8 MB, 0.140 ms at 3.35 TB/s. The tensor-core work is 8·(n1 + n2)
// bf16 flops a point, 21.5 Gflop there, 0.022 ms of the dense rate.
//
// What the kernel it replaces lost (fused_rows_kernel on the matrix
// engine, matrix_dft_stages<kTierBf16, false>): the engine read every
// table entry from L2 and converted it at every k-step of every tile,
// twiddled each stage-2 input in f32 once for each of the 16 row tiles
// that read it, and read stage 2's inputs with 8-way bank conflicts; its
// rows sat in two f32 buffers, R·(N + 1)·8 bytes each.
//
// What this design does about it: it is the bf16 row kernel
// (dft_bf16_rows.cuh) with the row load replaced by the assembly. A block
// of 512 threads owns R rows of one channel (grid ⌈M/R⌉ × C, channel
// blockIdx.y). Each lane takes 4 consecutive points of a row at a time,
// as the row kernel does: one float4 from each of the five planes and
// kz's 4 entries from the read-only cache, kLoadsInFlight such groups
// issued before any is assembled; kx once a group (row_kx). Each point
// runs point_terms then channel_value in f32 (the assembly of every
// fused kernel), is rounded once to a bf16 pair (pack_rn, round to
// nearest even: where the plain version, which assembles in f32 and then
// runs rows_dft at tier bf16, rounds it), and the 4 pairs are stored as
// one 16-byte word at the row kernel's conflict-free address
// (r·n2 + s)·(n1 + 4) + t. From there the row kernel's own stages run
// unchanged: stage 1 with its C ⊙ T epilogue into bf16, stage 2 into the
// f32 result, store_rows<true>. The staged rows are those the row kernel
// would stage from the same f32 assembly, so on the card the two agree
// bit for bit wherever the card's assembly equals torch's (no 1/|k| term:
// torch's rsqrt and this 1/sqrt can differ by an ulp, which can flip a
// bf16 rounding).
// The inputs never sit in shared memory, so a block needs the row
// kernel's shared memory (bf16_rows::shared_bytes,
// planes.bf16_rows_shared_bytes) and takes its rows per block
// (planes.max_rows(n, True, "bf16"): BF16_NATURAL_BLOCK_POINTS // N).
// With 4 groups in flight a lane has all 5·16 loads of its 16 points
// issued at once at N = 4096, R = 2 (the block's whole 160 KB of input).
// F1's 64 fragment registers are issued after the load, while the block
// waits at the barrier, not before it as in the row kernel: beside the
// load groups they spill. Timed on the H100 against 1 and 2 groups, F1
// first and a pipelined load (tools/fused_bf16_variants.py, PERF.md §6).
// Rows past M (the ragged last block) stage as zeros and are never stored.
//
// A length outside [16, 8192], no rows, or an input that is not 16-byte
// aligned returns cudaErrorInvalidValue; nothing falls back to the matrix
// engine.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

#include "dft_bf16_rows.cuh"
#include "fused_assembly.cuh"

namespace tpu_fft {

namespace bf16_fused {

using bf16_rows::kThreads;
constexpr int kLoadsInFlight = 4;   // 4-point groups of a lane in flight

// One point assembled (channel ch, global row `row`, column j) and
// rounded to a bf16 pair
__device__ __forceinline__ uint32_t pair(float h0r, float h0i, float h0cr,
                                         float h0ci, float phase, float kx,
                                         float kz, int row, int j, int N,
                                         int ch, const Assembly& p) {
  const float2 v = channel_value(
      point_terms(h0r, h0i, h0cr, h0ci, phase, kx, kz, p), kx, kz, row, j,
      N, ch, p);
  return bf16_rows::pack_rn(v.x, v.y);
}

// One block: R rows m0 .. m0 + R − 1 of channel ch_start + blockIdx.y.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
bf16_fused_natural_kernel(
    const float* __restrict__ h0r, const float* __restrict__ h0i,
    const float* __restrict__ h0cr, const float* __restrict__ h0ci,
    const float* __restrict__ phase, const float* __restrict__ kz,
    float* __restrict__ out_re, float* __restrict__ out_im,
    const uint32_t* __restrict__ tables, int M, int R, int ch_start,
    Assembly p) {
  using G = bf16_rows::Geometry<kLog2N>;
  const int ch = ch_start + blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * G::N;
  const bf16_rows::Buffers<kLog2N> b(R);

  // The fused load: lane group idx holds points 4·idx .. 4·idx + 3 of
  // the block's rows
  {
    const int total = R * G::N / 4;
    const int valid = (M - m0 < R ? M - m0 : R) * G::N / 4;
    const size_t first = static_cast<size_t>(m0) * G::N;
    const float4* in0 = reinterpret_cast<const float4*>(h0r + first);
    const float4* in1 = reinterpret_cast<const float4*>(h0i + first);
    const float4* in2 = reinterpret_cast<const float4*>(h0cr + first);
    const float4* in3 = reinterpret_cast<const float4*>(h0ci + first);
    const float4* in4 = reinterpret_cast<const float4*>(phase + first);
    const float4* kz4 = reinterpret_cast<const float4*>(kz);
    for (int base = threadIdx.x; base < total;
         base += kLoadsInFlight * kThreads) {
      float4 v[kLoadsInFlight][5];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        const bool ok = idx < valid;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = ok ? __ldg(&in0[idx]) : z;
        v[u][1] = ok ? __ldg(&in1[idx]) : z;
        v[u][2] = ok ? __ldg(&in2[idx]) : z;
        v[u][3] = ok ? __ldg(&in3[idx]) : z;
        v[u][4] = ok ? __ldg(&in4[idx]) : z;
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= total) continue;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (idx < valid) {
          const int j = (idx * 4) & (G::N - 1);
          const int row = p.row_offset + m0 + ((idx * 4) >> kLog2N);
          const float kx = row_kx(row, G::N, p);
          const float4 k = __ldg(&kz4[j >> 2]);
          w.x = pair(v[u][0].x, v[u][1].x, v[u][2].x, v[u][3].x, v[u][4].x,
                     kx, k.x, row, j, G::N, ch, p);
          w.y = pair(v[u][0].y, v[u][1].y, v[u][2].y, v[u][3].y, v[u][4].y,
                     kx, k.y, row, j + 1, G::N, ch, p);
          w.z = pair(v[u][0].z, v[u][1].z, v[u][2].z, v[u][3].z, v[u][4].z,
                     kx, k.z, row, j + 2, G::N, ch, p);
          w.w = pair(v[u][0].w, v[u][1].w, v[u][2].w, v[u][3].w, v[u][4].w,
                     kx, k.w, row, j + 3, G::N, ch, p);
        }
        *reinterpret_cast<uint4*>(&b.xs[bf16_rows::x_word<kLog2N>(idx * 4)]) =
            w;
      }
    }
  }
  uint4 a2[G::kt2];
  bf16_rows::load_f1<kLog2N>(a2, tables);
  __syncthreads();
  bf16_rows::stage1<kLog2N>(b.xs, b.ys, tables, R);
  __syncthreads();
  bf16_rows::stage2<kLog2N>(b.ys, b.res, a2, R);
  __syncthreads();
  store_rows<true>(b.res, out_re + blockIdx.y * plane,
                   out_im + blockIdx.y * plane, M, G::N, kLog2N, R, m0);
}

template <int kLog2N>
int launch_n(const void* h0r, const void* h0i, const void* h0cr,
             const void* h0ci, const void* phase, const void* kz,
             void* out_re, void* out_im, const void* tables, int channels,
             int ch_start, int m, int rows, const Assembly& p,
             cudaStream_t stream) {
  const auto kernel = bf16_fused_natural_kernel<kLog2N>;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bf16_rows::shared_bytes(rows, 1 << kLog2N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h0r), static_cast<const float*>(h0i),
      static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
      static_cast<const float*>(phase), static_cast<const float*>(kz),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const uint32_t*>(tables), m, rows, ch_start, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16_fused

// Launches the bf16 fused natural-store kernel at length n (a power of two
// in [16, 8192]; anything else, no rows, or an input that is not 16-byte
// aligned is refused with cudaErrorInvalidValue). `tables` are
// planes.bf16_rows_tables(n, inverse).
inline int launch_fused_rows_natural_bf16(
    const void* h0r, const void* h0i, const void* h0cr, const void* h0ci,
    const void* phase, const void* kz, void* out_re, void* out_im,
    const void* tables, int channels, int ch_start, int m, int n, int rows,
    const Assembly& p, void* stream) {
  for (const void* in : {h0r, h0i, h0cr, h0ci, phase, kz})
    if (reinterpret_cast<uintptr_t>(in) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_BF16_FUSED_CASE(L)                                             \
  case 1 << L:                                                             \
    return bf16_fused::launch_n<L>(h0r, h0i, h0cr, h0ci, phase, kz,        \
                                   out_re, out_im, tables, channels,       \
                                   ch_start, m, rows, p, s);
  switch (n) {
    TPU_BF16_FUSED_CASE(4)
    TPU_BF16_FUSED_CASE(5)
    TPU_BF16_FUSED_CASE(6)
    TPU_BF16_FUSED_CASE(7)
    TPU_BF16_FUSED_CASE(8)
    TPU_BF16_FUSED_CASE(9)
    TPU_BF16_FUSED_CASE(10)
    TPU_BF16_FUSED_CASE(11)
    TPU_BF16_FUSED_CASE(12)
    TPU_BF16_FUSED_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_BF16_FUSED_CASE
}

}  // namespace tpu_fft
