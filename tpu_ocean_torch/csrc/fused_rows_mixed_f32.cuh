// The fused assembly + row DFT at even lengths that are not powers of two,
// either store, at every tier and form: fused_rows.cu's entries
// tpu_fused_rows_mixed (f32 in the direct form) and
// tpu_matrix_fused_rows_any (the other tiers and forms).
//
// Replaces: tpu_ocean/ops/fused_spectrum_fft.py:127 _fused_kernel
// (launched by assemble_rowfft, the transposed store), :161
// _fused_kernel_split3 (#5b, where 128 | N) and :196
// _fused_rowfft_kernel_natural (launched by assemble_rowfft_natural, the
// natural store) at HIGHEST, DEFAULT (bf16) and B3, at the lengths the
// power-of-two fused kernels do not take (N = 96, 1536, 3072, 2·53, …),
// with fused_rows.cu's contract:
//   in  h0r, h0i, h0cr, h0ci, φ: f32 [M, N], contiguous, the rows
//       row_offset .. row_offset + M − 1 of the N × N grid; kz: f32 [N]
//   out channels ch_start .. ch_start + C − 1 of the set, assembled
//       (fused_assembly.cuh) and row-transformed: (re, im) f32 [C, N, M]
//       transposed or [C, M, N] natural.
//
// What bounds it on the H100: device memory where N's odd part has small
// prime factors (20 B in and 8 B out a point a channel, against ~30 flops
// of assembly and a few a point a stage); the generic stage's N·p
// multiply-adds a row where p is a large prime (2042 = 2·1021).
//
// The design is the simple one, right first: the mixed-radix row kernel
// (rows_mixed_f32.cuh) with a load that assembles its rows instead of
// reading them. One block holds R rows of one channel (blockIdx.y = c,
// ch = ch_start + c): it copies the table into shared memory, assembles
// each point (global row row_offset + m0 + r, column j) of its live rows
// straight into the first of the two ping-pong buffers (assemble: the
// same f32 operations as every fused kernel), writes zeros for rows past
// M without reading the inputs, then runs the row kernel's stages
// (mixed::run_stages, the host's plan) and its transposed or natural store
// (mixed::store). Shared memory and rows per block are the row kernel's
// (planes.mixed_shared_bytes, planes.mixed_max_rows). A launch of C
// channels reads the five planes C times, once a block, mostly from L2 at
// C ≤ 5: reading them once for every channel, as the power-of-two f32
// fused kernels do, is later work. The other tiers and forms run the same
// kernel on dft_matrix.cuh's MatrixEngine in place of the mixed-radix
// stages (run_engine, as the row kernel): the assembly and the stores are
// unchanged, shared memory is the two buffers alone (matrix_smem_bytes),
// the tables are read from device memory.

#pragma once

#include "fused_assembly.cuh"
#include "rows_mixed_f32.cuh"

namespace tpu_fft {
namespace mixed {

template <bool kNatural, class Engine>
__global__ void __launch_bounds__(kMaxThreads)
mixed_fused_rows_kernel(const float* __restrict__ h0r,
                        const float* __restrict__ h0i,
                        const float* __restrict__ h0cr,
                        const float* __restrict__ h0ci,
                        const float* __restrict__ phase,
                        const float* __restrict__ kz,
                        float* __restrict__ out_re,
                        float* __restrict__ out_im,
                        const float2* __restrict__ table, int M, int R,
                        int log2r, int ch_start, const Assembly p,
                        const Plan plan) {
  extern __shared__ float2 smem[];
  const int N = plan.n;
  const int stride = N + 1;
  float2* src = smem;
  float2* dst = smem + R * stride;
  float2* tab = smem + 2 * R * stride;

  const int c = blockIdx.y;
  const int ch = ch_start + c;
  const int m0 = blockIdx.x * R;
  const int live = M - m0 < R ? M - m0 : R;

  stage_table<Engine>(tab, table, plan);
  {
    // R rows of each plane are one contiguous run from row m0
    const size_t first = static_cast<size_t>(m0) * N;
    const int valid = live * N;
    for (int idx = threadIdx.x; idx < R * N; idx += blockDim.x) {
      const int r = idx / N;
      const int j = idx - r * N;
      float2 v = make_float2(0.f, 0.f);
      if (idx < valid) {
        const size_t g = first + idx;
        v = assemble(h0r[g], h0i[g], h0cr[g], h0ci[g], phase[g], kz[j],
                     p.row_offset + m0 + r, j, N, ch, p);
      }
      src[r * stride + j] = v;
    }
  }
  __syncthreads();

  const float2* res = run_engine<Engine>(src, dst, tab, table, R, plan);
  const size_t plane = static_cast<size_t>(M) * N;
  store<kNatural>(res, out_re + c * plane, out_im + c * plane, M, N, R,
                  log2r, m0, live);
}

// Channels of a set: packed with 3 live fields 2, with 5 live fields 3;
// per-channel 5. 0 for a set that does not exist.
inline int set_channels(const Assembly& p) {
  if (!p.packed) return 5;
  return p.nch_live == 3 ? 2 : (p.nch_live == 5 ? 3 : 0);
}

}  // namespace mixed

// Launches the fused mixed-radix kernel: n even in [16, 8192], `plan` its
// stages (mixed::read_plan), rows a power of two whose block fits the
// card's shared memory, channels ch_start .. ch_start + channels − 1 inside
// the set, a row offset ≥ 0 (refused otherwise, never run on another
// kernel), `tables` planes.mixed_twiddles(n, inverse), `table` entries.
inline int launch_fused_rows_mixed(
    bool natural, const void* h0r, const void* h0i, const void* h0cr,
    const void* h0ci, const void* phase, const void* kz, void* out_re,
    void* out_im, const void* tables, int channels, int ch_start, int m,
    int n, int rows, const int* plan_rows, int stages, int table,
    const Assembly& p, void* stream) {
  const mixed::Plan plan = mixed::read_plan(n, plan_rows, stages, table);
  if (plan.stages == 0 || rows < 1 || (rows & (rows - 1)) || m < 1 ||
      channels < 1 || ch_start < 0 ||
      ch_start + channels > mixed::set_channels(p) || p.row_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = mixed::smem_bytes(rows, plan);
  auto kernel =
      natural ? &mixed::mixed_fused_rows_kernel<true, StockhamEngine>
              : &mixed::mixed_fused_rows_kernel<false, StockhamEngine>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, mixed::block_threads(rows, n), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0r), static_cast<const float*>(h0i),
      static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
      static_cast<const float*>(phase), static_cast<const float*>(kz),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, rows, log2_of(rows), ch_start,
      p, plan);
  return static_cast<int>(cudaGetLastError());
}

// Launches the same kernel on the matrix engine of (tier, split3): n an
// even length in [16, 8192] that is not a power of two (mixed::
// matrix_length), rows a power of two whose two buffers (matrix_smem_bytes)
// fit the card's shared memory, channels ch_start .. ch_start + channels − 1
// inside the set, a row offset ≥ 0, `tables` planes.matrix_tables(n,
// inverse, split3). f32 in the direct form (launch_fused_rows_mixed's), the
// three-factor form with the natural store or with n1 ≠ 128, and anything
// else are refused with cudaErrorInvalidValue, never run on another kernel.
template <bool kNatural>
int launch_fused_rows_matrix(const void* h0r, const void* h0i,
                             const void* h0cr, const void* h0ci,
                             const void* phase, const void* kz, void* out_re,
                             void* out_im, const void* tables, int channels,
                             int ch_start, int m, int n, int rows, int tier,
                             int split3, const Assembly& p, void* stream) {
  if (!mixed::matrix_length(n, split3 != 0) || rows < 1 ||
      (rows & (rows - 1)) || m < 1 || channels < 1 || ch_start < 0 ||
      ch_start + channels > mixed::set_channels(p) || p.row_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_engine(tier, split3, kNatural, [&](auto engine) {
    using Engine = decltype(engine);
    if constexpr (std::is_same_v<Engine, StockhamEngine>) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else if constexpr (kNatural && Engine::kThreeFactor) {
      // no natural three-factor store: with_engine refuses it first, and
      // this branch keeps that kernel from being instantiated
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      mixed::Plan plan{};
      plan.n = n;
      const int smem = matrix_smem_bytes(rows, n);
      auto kernel = &mixed::mixed_fused_rows_kernel<kNatural, Engine>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((m + rows - 1) / rows, channels);
      kernel<<<grid, Engine::threads(rows, n), smem,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(h0r), static_cast<const float*>(h0i),
          static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
          static_cast<const float*>(phase), static_cast<const float*>(kz),
          static_cast<float*>(out_re), static_cast<float*>(out_im),
          static_cast<const float2*>(tables), m, rows, log2_of(rows),
          ch_start, p, plan);
      return static_cast<int>(cudaGetLastError());
    }
  });
}

}  // namespace tpu_fft
