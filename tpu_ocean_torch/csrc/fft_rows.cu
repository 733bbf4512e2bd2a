// Batched 1-D DFT along the rows of (re, im) f32 planes, stored transposed
// or in natural order.
//
// Replaces: tpu_ocean/fft/pallas_fft.py,
//   _fft_block_kernel (launched by _fft1d_transposed_impl) — the transposed
//     store, entry tpu_fft_rows_transposed;
//   _rowfft_block_kernel_natural (launched by _fft1d_natural_large_impl) —
//     the natural store, entry tpu_fft_rows_natural.
// The contracts are held exactly:
//   in  (re, im) f32 [C, M, N], contiguous
//   out transposed (re, im) f32 [C, N, M], out[c, k, m] = Σ_n x[c, m, n]
//       e^{±2πi nk/N} (+ for the inverse), unnormalized;
//   out natural    (re, im) f32 [C, M, N], out[c, m, k] = the same sum.
// Two transposed calls make a full 2-D transform, because the second
// call's rows are the first call's columns. The natural store is the JAX
// package's row pass beyond N = 2048, followed by a column pass.
//
// What bounds it on the H100: device memory. Each pass reads and writes
// every point once as two f32 planes, 16 B per point (16.8 MB for one
// 1024² pass), against a few flops per point per stage.
//
// Which code runs a pass, by tier (0 f32, 1 bf16, 2 bf16x3) and form
// (split3 0 or 1; the three-factor form, _fft_block_kernel_split3, is for
// the transposed store only):
//   f32, direct, transposed store: stockham_rows_cluster.cuh, the radix-2
//     Stockham stages of stockham.cuh on R rows a block, then a
//     thread-block-cluster store (`tables` planes.twiddles);
//   f32, direct, natural store: rows_natural_f32.cuh, register-resident
//     radix-16 passes with one shared-memory exchange between two passes,
//     reading and writing device memory coalesced (`tables`
//     planes.radix16_twiddles);
//   bf16, direct, either store: dft_bf16_rows.cuh (bf16 tables pre-laid
//     out as mma fragments, the intermediate in bf16; `tables`
//     planes.bf16_rows_tables);
//   f32, three-factor: dft_split3_f32.cuh (FFMA, each thread whole
//     columns of a stage; `tables` planes.matrix_tables);
//   bf16x3, three-factor: dft_split3_bf16x3.cuh (stage 1 as the f32
//     kernel's, stage 2 on mma.sync with the split tables in registers;
//     `tables` planes.split3_bf16x3_tables);
//   bf16 three-factor: fft_rows_kernel below, the matrix-form engine of
//     dft_matrix.cuh between a coalesced load of R rows into shared
//     memory and stockham.cuh's stores (`tables` planes.matrix_tables).
// Those take powers of two. bf16x3 in the direct form, either store, runs
// dft_bf16_rows_mixed.cuh through bf16_rows_mixed.cu's tpu_bf16_rows_mixed
// at every even N (`tables` planes.bf16x3_rows_tables); these entries
// refuse it. At every other even N, f32 in the direct form runs the
// register-resident mixed-radix passes of rows_mixed_passes_f32.cuh
// through rows_mixed.cu's tpu_fft_rows_mixed (`tables`
// planes.passes_twiddles), bf16 in the direct form dft_bf16_rows_mixed.cuh
// through tpu_bf16_rows_mixed (`tables` planes.bf16_rows_tables); the
// three-factor form at every tier runs rows_mixed_f32.cuh's loads and
// stores around the matrix-form engine of dft_matrix.cuh,
// tpu_matrix_rows_any below (`tables` planes.matrix_tables).
// Twiddles and tables are built on the host in float64 and rounded to f32;
// nothing is computed with fast sin/cos.

#include <type_traits>

#include "dft_bf16_rows.cuh"
#include "dft_matrix.cuh"
#include "dft_split3_bf16x3.cuh"
#include "dft_split3_f32.cuh"
#include "rows_mixed_f32.cuh"
#include "rows_natural_f32.cuh"
#include "stockham_rows_cluster.cuh"

namespace {

using namespace tpu_fft;

template <bool kNatural, class Engine>
__global__ void __launch_bounds__(kMaxThreads)
fft_rows_kernel(const float* __restrict__ re, const float* __restrict__ im,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const float2* __restrict__ tables, int M, int N, int log2n,
                int R) {
  // the f32 direct passes run kernels of their own (launch below)
  static_assert(!std::is_same_v<Engine, StockhamEngine>);
  extern __shared__ float2 smem[];
  const int stride = N + 1;
  float2* src = smem;
  float2* dst = smem + R * stride;
  float2* tw = smem + 2 * R * stride;

  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * N;
  const float* in_re = re + c * plane;
  const float* in_im = im + c * plane;

  Engine::prologue(tw, tables, N);

  // Rows past M (the ragged last block) are zero and never stored.
  load_rows(src, in_re, in_im, M, N, log2n, R, m0);
  __syncthreads();

  const float2* res = Engine::run(src, dst, tw, tables, R, N, log2n);
  store_rows<kNatural>(res, out_re + c * plane, out_im + c * plane, M, N,
                       log2n, R, m0);
}

template <bool kNatural>
int launch(const void* re, const void* im, void* out_re, void* out_im,
           const void* tables, int channels, int m, int n, int rows,
           int tier, int split3, int cluster, void* stream) {
  return with_engine(tier, split3, kNatural, [&](auto engine) {
    using Engine = decltype(engine);
    constexpr bool kClustered =
        !kNatural && std::is_same_v<Engine, StockhamEngine>;
    if (!kClustered && cluster != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (kClustered) {
      return launch_cluster_rows(re, im, out_re, out_im, tables, channels, m,
                                 n, rows, cluster, stream);
    } else if constexpr (std::is_same_v<Engine, StockhamEngine>) {
      return launch_rows_natural_f32(re, im, out_re, out_im, tables, channels,
                                     m, n, rows, stream);
    } else if constexpr (std::is_same_v<Engine,
                                        MatrixEngine<kTierBf16, false>>) {
      return launch_bf16_rows<kNatural>(re, im, out_re, out_im, tables,
                                        channels, m, n, rows, stream);
    } else if constexpr (std::is_same_v<Engine,
                                        MatrixEngine<kTierBf16x3, false>>) {
      // bf16x3 direct runs bf16_rows_mixed.cu's tpu_bf16_rows_mixed
      return static_cast<int>(cudaErrorInvalidValue);
    } else if constexpr (kNatural && Engine::kThreeFactor) {
      // no natural three-factor store: with_engine refuses it first
      return static_cast<int>(cudaErrorInvalidValue);
    } else if constexpr (std::is_same_v<Engine, MatrixEngine<kTierF32, true>>) {
      return launch_split3_f32_rows(re, im, out_re, out_im, tables, channels,
                                    m, n, rows, stream);
    } else if constexpr (std::is_same_v<Engine,
                                        MatrixEngine<kTierBf16x3, true>>) {
      return launch_split3_bf16x3_rows(re, im, out_re, out_im, tables,
                                       channels, m, n, rows, stream);
    } else {
      const int smem = smem_bytes(rows, n);
      cudaError_t err = allow_smem(fft_rows_kernel<kNatural, Engine>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((m + rows - 1) / rows, channels);
      fft_rows_kernel<kNatural, Engine><<<grid, Engine::threads(rows, n),
                                          smem,
                                          static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(re), static_cast<const float*>(im),
          static_cast<float*>(out_re), static_cast<float*>(out_im),
          static_cast<const float2*>(tables), m, n, log2_of(n), rows);
      return static_cast<int>(cudaGetLastError());
    }
  });
}

}  // namespace

extern "C" {

// Each entry launches its kernel on `stream` and returns cudaGetLastError()
// as an int. The caller checks (planes.require_card_kernel): n a power of
// two in [16, 8192] for these two entries (an even n in that range that is
// not a power of two goes to rows_mixed.cu's tpu_fft_rows_mixed at f32
// direct, to bf16_rows_mixed.cu's tpu_bf16_rows_mixed at bf16 direct and
// to tpu_matrix_rows_any in the three-factor form; bf16x3 direct goes to
// tpu_bf16_rows_mixed at every n and is refused here), rows a
// power of two that keeps the shared memory within the card's limit,
// contiguous f32 planes, `tables` the Stockham twiddles (tier 0, split3 0,
// transposed),
// the radix-16 twiddles (tier 0, split3 0, natural), the bf16 row kernel's
// tables (tier 1, split3 0), the bf16x3 three-factor kernel's (tier 2,
// split3 1) or the matrix engine's tables for (n, tier, split3), which the
// three-factor f32 kernel also reads.
// The transposed entry also takes `cluster`, the blocks of one thread-block
// cluster of the f32 direct pass (planes.transposed_cluster: 1, 2, 4 or 8);
// every other pass takes 1.
int tpu_fft_rows_transposed(const void* re, const void* im, void* out_re,
                            void* out_im, const void* tables, int channels,
                            int m, int n, int rows, int tier, int split3,
                            int cluster, void* stream) {
  return launch<false>(re, im, out_re, out_im, tables, channels, m, n, rows,
                       tier, split3, cluster, stream);
}

int tpu_fft_rows_natural(const void* re, const void* im, void* out_re,
                         void* out_im, const void* tables, int channels,
                         int m, int n, int rows, int tier, int split3,
                         void* stream) {
  return launch<true>(re, im, out_re, out_im, tables, channels, m, n, rows,
                      tier, split3, 1, stream);
}

// The three-factor form (split3 1) at any tier at an even n in [16, 8192]
// that is not a power of two, with the transposed store (natural = 0)
// where 128 divides n; rows a power of two whose two buffers
// (planes.matrix_mixed_shared_bytes) fit the card's shared memory,
// `tables` planes.matrix_tables(n, inverse, split3). The direct form at
// every tier (f32: rows_mixed.cu's tpu_fft_rows_mixed; bf16 and bf16x3:
// bf16_rows_mixed.cu's tpu_bf16_rows_mixed), a power of two, an odd n or
// one outside that range, a three-factor form with n1 ≠ 128 or the
// natural store, and any other rows are refused, never run on another
// kernel.
int tpu_matrix_rows_any(const void* re, const void* im, void* out_re,
                        void* out_im, const void* tables, int channels, int m,
                        int n, int rows, int natural, int tier, int split3,
                        void* stream) {
  return natural ? launch_rows_matrix<true>(re, im, out_re, out_im, tables,
                                            channels, m, n, rows, tier,
                                            split3, stream)
                 : launch_rows_matrix<false>(re, im, out_re, out_im, tables,
                                             channels, m, n, rows, tier,
                                             split3, stream);
}

const char* tpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
