// The bf16x3 three-factor row DFT: fft_rows.cu's entry
// tpu_fft_rows_transposed at tier bf16x3 in the three-factor form.
//
// Replaces tpu_ocean/fft/pallas_fft.py _fft_block_kernel_split3 at the
// bf16x3 tier B3 (launched by _fft1d_transposed_impl where _use_split3
// holds and KERNEL_B3_THRESHOLD is passed), and in this port the matrix
// engine (dft_matrix.cuh, matrix_dft_stages<kTierBf16x3, true>) for that
// one pass; the engine keeps the fused kernels' three-factor form.
// Contract: (re, im) f32 [C, M, N] → the transposed (re, im) f32 [C, N, M],
// unnormalized, + sign for the inverse, N = n2 · 128 a power of two in
// [128, 8192], any M and C.
//
// N = n2 · n1 with n1 = 128 = W · U = 8 · 16, t = w·U + u, k1 = a·W + b:
//   stage 1   C[k2, t]    = Σ_s F2[k2, s] · x[s·128 + t]  (depth n2, f32), ⊙ T
//   stage 2a  B[k2, b, u] = Σ_w F_W[b, w] · C[k2, w·16 + u]  (depth 8), ⊙ TW
//   stage 2b  X[(a·8 + b)·n2 + k2] = Σ_u F_U[a, u] · B[k2, b, u]  (depth 16)
// Numerics are those of the plain version (fft/matrix.py rows_dft at tier
// bf16x3 with the split3 tables) operand for operand: stage 1 in f32 (as
// the TPU kernel keeps it at B3, p1 = HIGHEST); each twiddle product and
// sum rounded alone; the stage-2 operands split into hi = bf16(x) and
// lo = bf16(x − hi) (round to nearest even), keeping hi·hi + hi·lo +
// lo·hi, accumulated in f32. Only the order of the f32 accumulation
// differs.
//
// What bounds it on the H100: device memory, 16 B a point (5.0 µs for
// [1, 1024, 1024] at 3.35 TB/s). Stage 1 and the twiddles are 8·n2 + 12
// f32 operations a point (80 Mflop there, 1.2 µs at 67 TFLOP/s); stage 2
// is 3 · 8 · (8 + 16) bf16 tensor-core operations a point (604 Mflop,
// 0.6 µs at 989 TFLOP/s). The engine it replaces read every table entry
// from L2 at every k-step of every tile, split both operands into hi and
// lo at every fragment load, re-twiddled each input for every tile that
// read it, ran stage 1 on the tensor cores at bf16x3 (against the TPU
// kernel's f32), and did two integer divisions a column a stage.
//
// The design:
// 1. Stage 1 at f32 is the f32 three-factor kernel's (dft_split3_f32.cuh
//    load_rows_f32 and stage1: coalesced row loads, whole columns a
//    thread, F2 broadcast from shared memory). Its epilogue here splits
//    C ⊙ T once and stores the (hi, lo) bf16 pairs.
// 2. Stages 2a and 2b on mma.sync.m16n8k16 (bf16 operands, f32
//    accumulation) in the real form [re; im] = [[Fr, −Fi], [Fi, Fr]] ·
//    [xr; xi], re and im of one complex depth adjacent, three products a
//    tile (hi·hi, hi·lo, lo·hi). F_W [8, 8] is one 16 × 16 A tile, F_U
//    [16, 16] 2 × 2; both split on the host (planes.mma_a_fragments_split)
//    and laid out in A-fragment order, so a lane holds 8 + 32 registers of
//    them, loaded once a block: at its start, with the rows, where stage 1
//    leaves the registers (n2 ≤ 8, N ≤ 1024: 128 registers, no spill),
//    else before each stage. Stage 2a's epilogue applies TW in f32 (a
//    lane's b = g and its u are fixed: 2 TW values in registers) and
//    splits again (split_pair: two packed conversions). A warp computes
//    one 8-column tile of stage 2a at a time (3 MMAs) and of stage 2b
//    (both 8-output tiles: 12 MMAs, the two accumulators alternating).
// 3. Stage 2b's D fragments go straight to device memory: its columns are
//    (j, r), j = b·n2 + k2, r the fastest, so lane (g, q) holds
//    X[a·8n2 + j] of the rows r = 2q and 2q + 1 of one j (at R = 8), and
//    writes them as one 8-byte run of each plane: a warp writes eight
//    32-byte runs (R = 8; R-float runs at smaller R). No result buffer,
//    no shared-memory transpose, one barrier less than the f32 kernel.
// 4. Padded or swizzled layouts (32 banks of 4 bytes; lane = 4g + q; a
//    64-bit access is served a half warp at a time, a 32-bit one a warp
//    at a time). Each intermediate is two planes of 32-bit words, hi and
//    lo, one word a complex value ((re, im) as two bf16, re low):
//    - A: the rows x[r, n] as complex f32 at r·N + n; later H2.
//    - H1 (C ⊙ T, stage 2a's B operand): column c1 = (r·n2 + k2)·16 + u
//      holds its 8 depths w at word c1·8 + (w ^ σ1(u)), σ1(u) =
//      2·((u >> 2) & 3). Stage 1's epilogue writes a warp's 32 lanes at
//      32 consecutive t (u = 0..15, two w): bank 8·(u & 3) + (w ^ σ1(u)),
//      32 distinct. Stage 2a's 64-bit B load of lane (g, q) reads column
//      8·tn + g, depths 2q, 2q + 1 (σ1 even keeps the pair in order):
//      a half warp at 4·(g & 3) + (q ^ σ1/2) in 8-byte units, 16 distinct.
//    - H2 (B ⊙ TW, stage 2b's B operand): column c2 = j·R + r at place
//      p = c2 + e·b (e = 1 where n2·R ≥ 4: one pad column a b), its 16
//      depths u at word p·16 + (u ^ 8·((p >> 1) & 1)). Stage 2a's
//      epilogue writes the pair u, u + 1 of lanes b = 0..3 (or 4..7) of
//      one (r, k2): the four p are consecutive mod 4, so the four 32-byte
//      halves they write fall on distinct banks; stage 2b's B load of
//      lanes g = 0..3 reads four consecutive columns, the same. (Where
//      n2·R = 2, N = 128 at R = 2 and N = 256 at R = 1, the epilogue's
//      writes meet 2-way.)
//    tests/test_torch_row_kernels.py models every access and counts its
//    conflicts.
//    Shared memory a block, R rows (planes.split3_bf16x3_shared_bytes):
//    8·(2·R·N + 128·e + n2²) bytes: 130 KB at N = 1024, R = 8; 66 KB at
//    N = 1024, R = 4; 137 KB at N = 4096, R = 2; 161 KB at N = 8192,
//    R = 1.
// 5. Rows a block: the transposed row passes' R = 8 (planes.max_rows),
//    whose store writes whole 32-byte runs; the fastest in the sweep
//    (chip_smoke.py --sweep-rows) at [1, 1024, 1024], where the 128 blocks
//    take one SM each, and R = 1 for the one-row pass.
// tools/split3_bf16x3_variants.py times the tables loaded before each
// stage at every N, blocks of 256 threads and two blocks an SM against
// this design, and reads the time of each phase (PERF.md §6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_bf16_rows.cuh"
#include "dft_matrix.cuh"
#include "dft_split3_f32.cuh"

namespace tpu_fft {

namespace split3_bf16x3 {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int kLog2N>
struct Geometry {
  static constexpr int N = 1 << kLog2N;
  static constexpr int log2n2 = kLog2N - 7;
  static constexpr int n2 = 1 << log2n2;
  // the tables, in 32-bit words: planes.matrix_tables(n, inverse, True)
  // (F2, T, F_W, TW, F_U as complex f32), then, at a 16-byte boundary,
  // the A fragments of F_W hi, F_W lo, F_U hi, F_U lo
  // (planes.split3_bf16x3_tables)
  static constexpr int f32_words = 2 * (n2 * n2 + N + 448);
  static constexpr int frag_words = (f32_words + 3) / 4 * 4;
  static constexpr int tw2_at = n2 * n2 + N + 64;  // TW [8, 16], complex
  // e, the pad columns a b in H2, and its words a plane
  __host__ __device__ static int pad(int rows) {
    return n2 * rows >= 4 ? 1 : 0;
  }
  __host__ __device__ static int h2_words(int rows) {
    return (8 * n2 * rows + 8 * pad(rows)) * 16;
  }
  // dynamic shared memory of a block of `rows` rows
  // (planes.split3_bf16x3_shared_bytes)
  static int shared_bytes(int rows) {
    return 8 * h2_words(rows) + 8 * rows * N + 8 * n2 * n2;
  }
};

extern __shared__ uint4 split3_bf16x3_smem[];

// One block: R rows m0 .. m0 + R − 1 of channel blockIdx.y.
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
split3_bf16x3_rows_kernel(const float* __restrict__ re,
                          const float* __restrict__ im,
                          float* __restrict__ out_re,
                          float* __restrict__ out_im,
                          const uint32_t* __restrict__ tables, int M, int R) {
  using G = Geometry<kLog2N>;
  constexpr int n2 = G::n2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const int log2r = 31 - __clz(R);
  const int rn = R * G::N;
  const size_t plane = static_cast<size_t>(M) * G::N;

  const float2* f32_tables = reinterpret_cast<const float2*>(tables);
  const float2* tw1 = f32_tables + n2 * n2;        // T [n2, 128]
  const float2* tw2 = f32_tables + G::tw2_at;         // TW [8, 16]
  const uint4* frags = reinterpret_cast<const uint4*>(tables + G::frag_words);

  // A: the rows, then H2's hi and lo planes; H1's hi and lo planes; F2
  const int h2w = G::h2_words(R);
  float2* xa = reinterpret_cast<float2*>(split3_bf16x3_smem);
  uint32_t* h2 = reinterpret_cast<uint32_t*>(split3_bf16x3_smem);
  uint32_t* h1 = h2 + 2 * h2w;
  float2* f2s = reinterpret_cast<float2*>(h1 + 2 * rn);

  // A lane's stage-2 tables in registers: F_W's and F_U's hi and lo
  // fragments (8 + 32) and the TW of its epilogue (a lane's b = g and u =
  // u0 + 2q + j are fixed: tiles tn = warp + 16·i give u0 = 8·(warp & 1)).
  // Loaded at the start, so that they arrive with the rows, where stage
  // 1 leaves the registers (n2 ≤ 8: at most 32 accumulators); else before
  // each stage.
  constexpr bool kEarlyTables = n2 <= 8;
  const int u0 = (warp & 1) * 8;
  uint4 fw_hi, fw_lo, fu_hi[2][2], fu_lo[2][2];
  float2 tw_j0, tw_j1;
  const auto load_fw = [&] {
    fw_hi = __ldg(&frags[lane]);
    fw_lo = __ldg(&frags[32 + lane]);
    tw_j0 = __ldg(&tw2[g * 16 + u0 + 2 * q]);
    tw_j1 = __ldg(&tw2[g * 16 + u0 + 2 * q + 1]);
  };
  const auto load_fu = [&] {
#pragma unroll
    for (int tm = 0; tm < 2; ++tm) {
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        fu_hi[tm][kb] = __ldg(&frags[64 + (tm * 2 + kb) * 32 + lane]);
        fu_lo[tm][kb] = __ldg(&frags[192 + (tm * 2 + kb) * 32 + lane]);
      }
    }
  };
  if constexpr (kEarlyTables) {
    load_fw();
    load_fu();
  }
  for (int i = tid; i < n2 * n2; i += kThreads) f2s[i] = f32_tables[i];
  split3_f32::load_rows_f32<kLog2N, kThreads>(xa, G::N, re + c * plane,
                                              im + c * plane, M, R, m0);
  __syncthreads();

  // Stage 1 at f32; C ⊙ T split once into H1
  split3_f32::stage1<kLog2N, kThreads>(
      xa, G::N, f2s, tw1, R, [&](int r, int k2, int t, float2 v) {
        const int u = t & 15;
        const int w = t >> 4;
        const int pos = (((r * n2 + k2) << 4) + u) * 8 + (w ^ ((u >> 1) & 6));
        uint32_t hi, lo;
        split_pair(v.x, v.y, hi, lo);
        h1[pos] = hi;
        h1[rn + pos] = lo;
      });
  __syncthreads();

  // Stage 2a: column tiles tn = warp, warp + 16, …: column 8·tn + g has
  // u = u0 + g
  {
    if constexpr (!kEarlyTables) load_fw();
    const int e = G::pad(R);
    const int tiles = rn >> 6;
    const int u = u0 + g;
    for (int tn = warp; tn < tiles; tn += kWarps) {
      const int rk = tn >> 1;                        // r·n2 + k2
      const int pos = ((rk << 4) + u) * 8 + ((2 * q) ^ ((u >> 1) & 6));
      const uint2 bh = *reinterpret_cast<const uint2*>(h1 + pos);
      const uint2 bl = *reinterpret_cast<const uint2*>(h1 + rn + pos);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      bf16_rows::mma(d, fw_hi, bh.x, bh.y);
      bf16_rows::mma(d, fw_hi, bl.x, bl.y);
      bf16_rows::mma(d, fw_lo, bh.x, bh.y);
      // out[b = g][u0 + 2q + j] = (d[j], d[j + 2]), ⊙ TW, split; to H2
      // column c2 = (b·n2 + k2)·R + r, depths u0 + 2q, + 1
      const float2 v0 = split3_f32::twiddle(make_float2(d[0], d[2]), tw_j0);
      const float2 v1 = split3_f32::twiddle(make_float2(d[1], d[3]), tw_j1);
      uint32_t hi0, lo0, hi1, lo1;
      split_pair(v0.x, v0.y, hi0, lo0);
      split_pair(v1.x, v1.y, hi1, lo1);
      const int r = rk >> G::log2n2;
      const int k2 = rk & (n2 - 1);
      const int p = (((g << G::log2n2) + k2) << log2r) + r + e * g;
      const int at = p * 16 + ((u0 + 2 * q) ^ (((p >> 1) & 1) << 3));
      *reinterpret_cast<uint2*>(h2 + at) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(h2 + h2w + at) = make_uint2(lo0, lo1);
    }
  }
  __syncthreads();

  // Stage 2b: column tiles of c2 = j·R + r, both output tiles (a = g and
  // 8 + g), straight to device memory
  {
    if constexpr (!kEarlyTables) load_fu();
    const int log2b = G::log2n2 + log2r;             // columns a b: n2·R
    const int e = G::pad(R);
    const int tiles = rn >> 7;
    const bool pairs = R >= 2 && (M & 1) == 0;
    float* o_re = out_re + c * plane;
    float* o_im = out_im + c * plane;
    for (int tn = warp; tn < tiles; tn += kWarps) {
      const int c2 = (tn << 3) + g;
      const int p = c2 + e * (c2 >> log2b);
      const int sw = ((p >> 1) & 1) << 3;
      uint2 bh[2], bl[2];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int at = p * 16 + ((kb * 8 + 2 * q) ^ sw);
        bh[kb] = *reinterpret_cast<const uint2*>(h2 + at);
        bl[kb] = *reinterpret_cast<const uint2*>(h2 + h2w + at);
      }
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bh[kb].x, bh[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_hi[tm][kb], bl[kb].x, bl[kb].y);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
          bf16_rows::mma(d[tm], fu_lo[tm][kb], bh[kb].x, bh[kb].y);
      }
      // lane (g, q): X[a·8n2 + j] of row r for a = 8·tm + g and the
      // columns 8·tn + 2q + jj = j·R + r
      const int col = (tn << 3) + 2 * q;
      if (pairs) {
        // r and r + 1 (r even) of one j: 8-byte runs, aligned as M is even
        const int j = col >> log2r;
        const int m = m0 + (col & (R - 1));
        if (m < M) {
#pragma unroll
          for (int tm = 0; tm < 2; ++tm) {
            const size_t at = static_cast<size_t>(
                ((tm * 8 + g) << (G::log2n2 + 3)) + j) * M + m;
            *reinterpret_cast<float2*>(o_re + at) =
                make_float2(d[tm][0], d[tm][1]);
            *reinterpret_cast<float2*>(o_im + at) =
                make_float2(d[tm][2], d[tm][3]);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = (col + jj) >> log2r;
          const int m = m0 + ((col + jj) & (R - 1));
          if (m >= M) continue;
#pragma unroll
          for (int tm = 0; tm < 2; ++tm) {
            const size_t at = static_cast<size_t>(
                ((tm * 8 + g) << (G::log2n2 + 3)) + j) * M + m;
            o_re[at] = d[tm][jj];
            o_im[at] = d[tm][jj + 2];
          }
        }
      }
    }
  }
}

template <int kLog2N>
int launch_n(const void* re, const void* im, void* out_re, void* out_im,
             const void* tables, int channels, int m, int rows,
             cudaStream_t stream) {
  const auto kernel = split3_bf16x3_rows_kernel<kLog2N>;
  const int smem = Geometry<kLog2N>::shared_bytes(rows);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const uint32_t*>(tables), m, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split3_bf16x3

// Launches the bf16x3 three-factor transposed row kernel at length n (a
// power of two in [128, 8192]; anything else is refused with
// cudaErrorInvalidValue). `tables` are planes.split3_bf16x3_tables(n,
// inverse).
inline int launch_split3_bf16x3_rows(const void* re, const void* im,
                                     void* out_re, void* out_im,
                                     const void* tables, int channels, int m,
                                     int n, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TPU_SPLIT3_BF16X3_CASE(L)                                             \
  case 1 << L:                                                                \
    return split3_bf16x3::launch_n<L>(re, im, out_re, out_im, tables,         \
                                      channels, m, rows, s);
  switch (n) {
    TPU_SPLIT3_BF16X3_CASE(7)
    TPU_SPLIT3_BF16X3_CASE(8)
    TPU_SPLIT3_BF16X3_CASE(9)
    TPU_SPLIT3_BF16X3_CASE(10)
    TPU_SPLIT3_BF16X3_CASE(11)
    TPU_SPLIT3_BF16X3_CASE(12)
    TPU_SPLIT3_BF16X3_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPU_SPLIT3_BF16X3_CASE
}

}  // namespace tpu_fft
