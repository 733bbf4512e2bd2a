// Fused spectrum assembly + row DFT: the evolved spectrum channel
// (Hermitian-packed or per-channel) is assembled on the chip (in shared
// memory, or in registers on the f32 natural store) and transformed there,
// so it never makes a round trip through device memory.
//
// Replaces: tpu_ocean/ops/fused_spectrum_fft.py,
//   _fused_kernel (launched by assemble_rowfft) — the transposed store,
//     entry tpu_fused_rows_transposed;
//   _fused_rowfft_kernel_natural (launched by assemble_rowfft_natural) —
//     the natural store, entry tpu_fused_rows_natural.
// Contract (fft layout; three channel sets, `Assembly::packed` and
// `Assembly::nch_live` as the JAX kernel's `packed` and `nch_live`):
//   in  h0r, h0i, h0cr, h0ci, φ: f32 [M, N], contiguous, the rows
//       row_offset .. row_offset + M − 1 of the N × N grid;
//       kz: f32 [N], 2π·wrapped(j)/L built in float64 on the host
//   out channel ch = ch_start + c, row-transformed: (re, im) f32 [C, N, M]
//       transposed or [C, M, N] natural, as fft_rows.cu stores them; ch
//       indexes the packed channels P = (A − iB)·h̃ (2 of them with 3 live
//       fields, 3 with 5) or the 5 per-channel spectra K_ch·h̃.
// The assembly of a point (fused_assembly.cuh) is the same in every
// kernel, store, tier and form.
//
// What bounds it on the H100: device memory. Five f32 planes in (20 B per
// point) and one complex channel out (8 B per point): 29.4 MB for a 1024²
// channel, against ~30 flops of assembly and 5·log2(N) of transform per
// point, in every channel set.
//
// What the design does about that, by store:
//   natural, f32 direct: fused_rows_natural_f32.cuh — a block reads its
//     rows of the five planes once, holds the terms no channel changes
//     (h̃ in shared memory, 1/|k| in registers) and makes every channel of
//     the launch from them, each on the radix-16 passes of
//     rows_natural_f32.cuh, stored from registers;
//   transposed, f32 direct: fused_rows_transposed_f32.cuh — the same load
//     and channel loop, stored through a tile in shared memory read back
//     R rows at one column, runs of R floats;
//   natural, bf16 direct: fused_rows_natural_bf16.cuh — the bf16 row
//     kernel's stages (dft_bf16_rows.cuh) behind a fused load that
//     assembles 4 points a lane and stages them as bf16 pairs;
//   either store, every tier and form, at an even N that is not a power of
//     two: fused_rows_mixed_f32.cuh — the mixed-radix row kernel's stages
//     (f32 direct) or the matrix engine's (the rest) and its stores
//     (rows_mixed_f32.cuh) behind a load that assembles each row into its
//     first buffer; a block per R rows of one channel; entries
//     tpu_fused_rows_mixed and tpu_matrix_fused_rows_any;
//   the other tiers and forms, either store, at powers of two:
//     fused_rows_kernel below on
//     dft_matrix.cuh's stages. The loads are the row kernel's, five planes
//     wide: one block reads R whole rows of each input plane with
//     row-contiguous (coalesced) loads, several in flight per thread, and
//     assembles each point straight into the first shared-memory buffer.
//     The TPU kernel visited the channels in an inner grid axis so Mosaic
//     could keep the input block; here each block assembles one channel
//     (blockIdx.y), and a C-channel call reads the inputs C times, mostly
//     from L2 at C ≤ 5.
//
// Precision tiers and the three-factor form (_fused_kernel_split3): the
// entries take a tier and a form as fft_rows.cu's do; the assembly is the
// same at every tier, only the stages after it change.

#include <type_traits>

#include "dft_matrix.cuh"
#include "fused_assembly.cuh"
#include "fused_rows_mixed_f32.cuh"
#include "fused_rows_natural_bf16.cuh"
#include "fused_rows_natural_f32.cuh"
#include "fused_rows_transposed_f32.cuh"

namespace {

using namespace tpu_fft;

constexpr int kLoadsInFlight = 4;

template <bool kNatural, class Engine>
__global__ void __launch_bounds__(kMaxThreads)
fused_rows_kernel(const float* __restrict__ h0r, const float* __restrict__ h0i,
                  const float* __restrict__ h0cr,
                  const float* __restrict__ h0ci,
                  const float* __restrict__ phase,
                  const float* __restrict__ kz, float* __restrict__ out_re,
                  float* __restrict__ out_im,
                  const float2* __restrict__ tables, int M, int N,
                  int log2n, int R, int ch_start, Assembly p) {
  // the f32 direct passes (both stores) and the bf16 direct natural store
  // run kernels of their own (launch below)
  static_assert(!std::is_same_v<Engine, StockhamEngine> &&
                !(kNatural &&
                  std::is_same_v<Engine, MatrixEngine<kTierBf16, false>>));
  extern __shared__ float2 smem[];
  const int stride = N + 1;
  float2* src = smem;
  float2* dst = smem + R * stride;
  float2* tw = smem + 2 * R * stride;

  const int ch = ch_start + blockIdx.y;
  const int m0 = blockIdx.x * R;

  Engine::prologue(tw, tables, N);

  // R rows of each input plane are one contiguous run from row m0. Rows
  // past M (the ragged last block) are zero and never stored.
  const size_t first = static_cast<size_t>(m0) * N;
  const int total = R * N;
  const int valid = (M - m0 < R ? M - m0 : R) * N;
  for (int base = threadIdx.x; base < total;
       base += kLoadsInFlight * blockDim.x) {
    float v[kLoadsInFlight][5];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < valid) {
        v[u][0] = h0r[first + idx];
        v[u][1] = h0i[first + idx];
        v[u][2] = h0cr[first + idx];
        v[u][3] = h0ci[first + idx];
        v[u][4] = phase[first + idx];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int r = idx >> log2n;
        const int j = idx & (N - 1);
        src[r * stride + j] =
            idx < valid ? assemble(v[u][0], v[u][1], v[u][2], v[u][3],
                                   v[u][4], kz[j], p.row_offset + m0 + r, j,
                                   N, ch, p)
                        : make_float2(0.f, 0.f);
      }
    }
  }
  __syncthreads();

  const float2* res = Engine::run(src, dst, tw, tables, R, N, log2n);
  const size_t plane = static_cast<size_t>(M) * N;
  store_rows<kNatural>(res, out_re + blockIdx.y * plane,
                       out_im + blockIdx.y * plane, M, N, log2n, R, m0);
}

template <bool kNatural>
int launch(const void* h0r, const void* h0i, const void* h0cr,
           const void* h0ci, const void* phase, const void* kz, void* out_re,
           void* out_im, const void* tables, int channels, int ch_start,
           int m, int n, int rows, int row_offset, int packed, int nch_live,
           int tier, int split3, float two_pi_over_l, float dz_sign,
           float epsilon, void* stream) {
  return with_engine(tier, split3, kNatural, [&](auto engine) {
    using Engine = decltype(engine);
    const Assembly p{two_pi_over_l, dz_sign, epsilon * epsilon, row_offset,
                     packed, nch_live};
    if constexpr (kNatural && std::is_same_v<Engine, StockhamEngine>) {
      return launch_fused_rows_natural_f32(h0r, h0i, h0cr, h0ci, phase, kz,
                                           out_re, out_im, tables, channels,
                                           ch_start, m, n, rows, p, stream);
    } else if constexpr (std::is_same_v<Engine, StockhamEngine>) {
      return launch_fused_rows_transposed_f32(h0r, h0i, h0cr, h0ci, phase,
                                              kz, out_re, out_im, tables,
                                              channels, ch_start, m, n, rows,
                                              p, stream);
    } else if constexpr (kNatural &&
                         std::is_same_v<Engine,
                                        MatrixEngine<kTierBf16, false>>) {
      return launch_fused_rows_natural_bf16(h0r, h0i, h0cr, h0ci, phase, kz,
                                            out_re, out_im, tables, channels,
                                            ch_start, m, n, rows, p, stream);
    } else {
      const int smem = smem_bytes(rows, n);
      cudaError_t err = allow_smem(fused_rows_kernel<kNatural, Engine>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((m + rows - 1) / rows, channels);
      fused_rows_kernel<kNatural, Engine><<<grid, Engine::threads(rows, n),
                                            smem,
                                            static_cast<cudaStream_t>(
                                                stream)>>>(
          static_cast<const float*>(h0r), static_cast<const float*>(h0i),
          static_cast<const float*>(h0cr), static_cast<const float*>(h0ci),
          static_cast<const float*>(phase), static_cast<const float*>(kz),
          static_cast<float*>(out_re), static_cast<float*>(out_im),
          static_cast<const float2*>(tables), m, n, log2_of(n), rows,
          ch_start, p);
      return static_cast<int>(cudaGetLastError());
    }
  });
}

}  // namespace

extern "C" {

// Each entry launches its kernel on `stream` and returns cudaGetLastError()
// as an int. The caller checks (planes.require_card_kernel): n a power of
// two in [16, 8192] for these two entries (an even n there that is not one
// goes to tpu_fused_rows_mixed at f32 direct, to tpu_matrix_fused_rows_any
// at the other tiers and forms), rows a power of two
// that keeps the shared memory within the card's limit, contiguous f32
// [m, n] input planes, ch_start + channels within the channel set (packed
// with nch_live 3: 2; with 5: 3; per-channel, packed 0: 5), `tables` the
// radix-16 twiddles (tier 0, split3 0, either store:
// planes.radix16_twiddles), the bf16 row
// kernel's tables (tier 1, split3 0, natural: planes.bf16_rows_tables) or
// the matrix engine's tables.
int tpu_fused_rows_transposed(const void* h0r, const void* h0i,
                              const void* h0cr, const void* h0ci,
                              const void* phase, const void* kz, void* out_re,
                              void* out_im, const void* tables,
                              int channels, int ch_start, int m, int n,
                              int rows, int row_offset, int packed,
                              int nch_live, int tier, int split3,
                              float two_pi_over_l, float dz_sign,
                              float epsilon, void* stream) {
  return launch<false>(h0r, h0i, h0cr, h0ci, phase, kz, out_re, out_im,
                       tables, channels, ch_start, m, n, rows, row_offset,
                       packed, nch_live, tier, split3, two_pi_over_l, dz_sign,
                       epsilon, stream);
}

int tpu_fused_rows_natural(const void* h0r, const void* h0i, const void* h0cr,
                           const void* h0ci, const void* phase, const void* kz,
                           void* out_re, void* out_im, const void* tables,
                           int channels, int ch_start, int m, int n, int rows,
                           int row_offset, int packed, int nch_live, int tier,
                           int split3, float two_pi_over_l, float dz_sign,
                           float epsilon, void* stream) {
  return launch<true>(h0r, h0i, h0cr, h0ci, phase, kz, out_re, out_im,
                      tables, channels, ch_start, m, n, rows, row_offset,
                      packed, nch_live, tier, split3, two_pi_over_l, dz_sign,
                      epsilon, stream);
}

// The f32 direct fused pass at an even n in [16, 8192] that is not a
// power of two, transposed (natural = 0) or natural (1) store: the other
// arguments as above, rows a power of two that keeps
// planes.mixed_shared_bytes within the card's limit, `tables`
// planes.mixed_twiddles(n, inverse) of `table` entries, `plan` the host
// array planes.mixed_plan_rows(n), (radix, span, roots offset) × `stages`.
// Any other n, rows, channels outside the set, a negative row offset, or a
// plan that is not a length-n transform inside the table is refused.
int tpu_fused_rows_mixed(const void* h0r, const void* h0i, const void* h0cr,
                         const void* h0ci, const void* phase, const void* kz,
                         void* out_re, void* out_im, const void* tables,
                         int channels, int ch_start, int m, int n, int rows,
                         int row_offset, int packed, int nch_live,
                         int natural, int stages, int table,
                         float two_pi_over_l, float dz_sign, float epsilon,
                         const void* plan, void* stream) {
  const Assembly p{two_pi_over_l, dz_sign, epsilon * epsilon, row_offset,
                   packed, nch_live};
  return launch_fused_rows_mixed(natural != 0, h0r, h0i, h0cr, h0ci, phase,
                                 kz, out_re, out_im, tables, channels,
                                 ch_start, m, n, rows,
                                 static_cast<const int*>(plan), stages, table,
                                 p, stream);
}

// Every other tier and form of the fused pass at an even n in [16, 8192]
// that is not a power of two, transposed (natural = 0) or natural (1)
// store: the other arguments as above, tier 1 (bf16) or 2 (bf16x3) in the
// direct form, or the three-factor form (split3 1) at any tier with the
// transposed store where 128 divides n; rows a power of two whose two
// buffers (planes.matrix_mixed_shared_bytes) fit the card's shared memory,
// `tables` planes.matrix_tables(n, inverse, split3). f32 direct
// (tpu_fused_rows_mixed's), a power of two, an odd n or one outside that
// range, a three-factor form with n1 ≠ 128 or the natural store, other
// rows, channels outside the set or a negative row offset are refused,
// never run on another kernel.
int tpu_matrix_fused_rows_any(const void* h0r, const void* h0i,
                              const void* h0cr, const void* h0ci,
                              const void* phase, const void* kz, void* out_re,
                              void* out_im, const void* tables, int channels,
                              int ch_start, int m, int n, int rows,
                              int row_offset, int packed, int nch_live,
                              int natural, int tier, int split3,
                              float two_pi_over_l, float dz_sign,
                              float epsilon, void* stream) {
  const Assembly p{two_pi_over_l, dz_sign, epsilon * epsilon, row_offset,
                   packed, nch_live};
  return natural
             ? launch_fused_rows_matrix<true>(h0r, h0i, h0cr, h0ci, phase, kz,
                                              out_re, out_im, tables, channels,
                                              ch_start, m, n, rows, tier,
                                              split3, p, stream)
             : launch_fused_rows_matrix<false>(h0r, h0i, h0cr, h0ci, phase,
                                               kz, out_re, out_im, tables,
                                               channels, ch_start, m, n, rows,
                                               tier, split3, p, stream);
}

}  // extern "C"
