// The matrix-form DFT engine of the row kernels (fft_rows.cu, fused_rows.cu,
// and at even lengths that are not powers of two rows_mixed_f32.cuh and
// fused_rows_mixed_f32.cuh): the precision tiers and the three-factor form
// of the TPU kernels.
//
// Replaces, in tpu_ocean/fft/pallas_fft.py: the products of
// _fft_block_kernel and _rowfft_core at precision DEFAULT (one bf16 pass)
// and at the hand-rolled bf16x3 tier B3 (_split_bf16, _dot_mid), and
// _fft_block_kernel_split3 / _stage2_split3 (stage 2 as 128 = 8 · 16); in
// tpu_ocean/ops/fused_spectrum_fft.py the same stages of _fused_kernel,
// _fused_kernel_split3 and _fused_rowfft_kernel_natural. The row passes
// have kernels of their own but two: bf16 in the direct form, both stores
// (dft_bf16_rows.cuh at powers of two, dft_bf16_rows_mixed.cuh elsewhere),
// bf16x3 in the direct form at every length (dft_bf16_rows_mixed.cuh), and
// the three-factor form at f32 (dft_split3_f32.cuh) and at bf16x3
// (dft_split3_bf16x3.cuh) at powers of two; the engine runs the bf16
// three-factor row pass at powers of two, the three-factor row passes at
// the other even lengths, and every fused tier but bf16 natural.
//
// matrix_dft_stages<Tier, kSplit3> is a drop-in for stockham_stages: the R
// rows of length N sit in the first shared buffer (stride N + 1 float2),
// and it leaves natural-order rows in the buffer it returns. It runs the
// four-step N = n2 · n1 (n1 = lanes_n1(N): 128 where 128 | N, else N / 2,
// as _split_lanes):
//   C[k2, t]        = Σ_s F2[k2, s] · x[s·n1 + t]
//   X[k1·n2 + k2]   = Σ_t F1[k1, t] · (C ⊙ T)[k2, t]
// or, with kSplit3, stage 2 as two contractions of depth 8 and 16 with the
// in-block twiddle TW between them. The tables are complex f32, built in
// float64 on the host and read from device memory (L2-resident where n1 =
// 128: F1 alone is 128 KB, which does not fit beside the rows at N = 8192;
// at n1 = N / 2 it is n1² complex, 8.3 MB at N = 2042 and 134 MB at 8190,
// more than the 50 MB L2).
//
// Every contraction is a complex matrix product out[i, col] =
// Σ_k F[i, k] · in[k, col] over the columns col = (row, other digits). A
// warp computes 8 complex outputs × 8 columns at a time:
//   bf16, bf16x3: warp-level mma.sync.m16n8k16 (bf16 operands, f32
//     accumulation) on the real form of the complex product, re and im of
//     one complex k adjacent along the depth and re, im of one output 8
//     rows apart:  [re; im] = [[Fr, −Fi], [Fi, Fr]] · [xr; xi].
//     Operands are rounded to bf16 (round to nearest even) as they are
//     loaded into fragments. bf16x3 splits each f32 operand into hi + lo
//     bf16 parts and keeps hi·hi + hi·lo + lo·hi, on the stage-2
//     contractions only: stage 1 runs at f32, as the TPU kernels run it
//     at B3 (p1 = HIGHEST).
//   f32 (the three-factor form, and stage 1 at bf16x3): FFMA, each lane
//     2 complex outputs.
// Depths that are not a multiple of 8 complex (n2 = 2, 4, and 1 at N = 128;
// n2 = 3, 6, 12 at N = 384, 768, 1536; n1 = 53 at N = 106) are zero-padded
// to the next multiple; rows past the table's size are dropped.
//
// What bounds it on the H100: device memory, as the Stockham kernels (16 B
// a point for a row pass). At N = 1024 the direct form does 8·(n1 + n2) =
// 1088 real flops a point (at bf16x3 8·n2 on FFMA and 3·8·n1 on the
// tensor cores), ~1.1 µs of the tensor cores'
// 989 TFLOP/s for a [1024, 1024] pass against a 5 µs byte bound; the
// three-factor form does 8·(n2 + 8 + 16) on FFMA at f32. Where 128 does not
// divide N, n1 = N / 2 makes stage 2 a dense DFT of half the row: 8·(N/2 +
// 2) flops a point, and each block reads all of F1 once for its R rows
// (R = 1 from N = 4096 on natural, so at N = 8186 the 134 MB F1 once a row,
// through L2). This first engine
// converts operands at every fragment load and reads the tables through
// L1 without staging them: simple and right before it is fast.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>

#include "stockham.cuh"

namespace tpu_fft {

enum Tier : int { kTierF32 = 0, kTierBf16 = 1, kTierBf16x3 = 2 };
constexpr int kSplitW = 8;     // stage 2 of the three-factor form: 128 = W·U
constexpr int kSplitU = 16;

// n1 of the four-step N = n2 · n1 at an even N (pallas_fft._split_lanes):
// 128 where 128 divides N, else N / 2 (the largest divisor of N up to N / 2),
// so n2 = 2 at every even N that 128 does not divide
__host__ __device__ constexpr int lanes_n1(int n) {
  return n % 128 == 0 ? 128 : n / 2;
}
// at powers of two the rule the power-of-two kernels were written for:
// N / 2 below 128, then 128
static_assert(lanes_n1(16) == 8 && lanes_n1(64) == 32 &&
                  lanes_n1(128) == 128 && lanes_n1(1024) == 128 &&
                  lanes_n1(8192) == 128,
              "lanes_n1 at powers of two");
static_assert(lanes_n1(96) == 48 && lanes_n1(106) == 53 &&
                  lanes_n1(1536) == 128 && lanes_n1(8186) == 4093,
              "lanes_n1 at other even lengths");

// One contraction: out[pos_out(i, col)] = Σ_k table[i, k] · in[pos_in(k, col)]
// (· tw[pos_in & tw_mask] when tw is set), for each column col = r·o + oh·o_lo
// + ol of R rows, with pos_in = k·in_k + ol·in_lo + oh·in_hi and pos_out =
// i·out_i + ol·out_lo + oh·out_hi inside row r.
struct Stage {
  const float2* table;   // [m, k] complex, row-major
  const float2* tw;      // twiddle multiplied into each input, or nullptr
  int tw_mask;
  int m, k;
  int o_lo, o;           // the other digits: o = o_lo · (count of oh)
  int in_k, in_lo, in_hi;
  int out_i, out_lo, out_hi;
};

// A column's row offset (r·stride) and its input and output positions
struct Column {
  int row, in, out;
  bool ok;
};

__device__ __forceinline__ Column column(const Stage& s, int col, int cols,
                                         int stride) {
  Column c{0, 0, 0, col < cols};
  if (!c.ok) return c;
  const int r = col / s.o;
  const int oo = col - r * s.o;
  const int oh = oo / s.o_lo;
  const int ol = oo - oh * s.o_lo;
  c.row = r * stride;
  c.in = ol * s.in_lo + oh * s.in_hi;
  c.out = ol * s.out_lo + oh * s.out_hi;
  return c;
}

__device__ __forceinline__ float2 load_table(const Stage& s, int i, int kk) {
  return (i < s.m && kk < s.k) ? __ldg(&s.table[i * s.k + kk])
                               : make_float2(0.f, 0.f);
}

// in[k, col], twiddled in f32 with each product and sum rounded on its own
// (as the plain version's torch ops round them)
__device__ __forceinline__ float2 load_input(const float2* src, const Stage& s,
                                             const Column& c, int kk) {
  if (!c.ok || kk >= s.k) return make_float2(0.f, 0.f);
  const int pos = c.in + kk * s.in_k;
  const float2 v = src[c.row + pos];
  if (s.tw == nullptr) return v;
  const float2 w = __ldg(&s.tw[pos & s.tw_mask]);
  return make_float2(__fsub_rn(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y)),
                     __fadd_rn(__fmul_rn(v.x, w.y), __fmul_rn(v.y, w.x)));
}

// two floats as one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (hi, lo) registers of the pair (a, b): hi = bf16(x), lo = bf16(x − hi),
// each a packed conversion of the pair
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
  memcpy(&hi, &h, sizeof(hi));
  memcpy(&lo, &l, sizeof(lo));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor cores' f32 accumulation is not a sum rounded to nearest at
// every step: over a deep contraction it drifts from one (on the H100, the
// bf16x3 tier at n1 = 4093 summed on the tensor cores alone read 2.7e-5 x
// max against float64, the plain version 3.4e-6; tools/
// bf16x3_sums_variants.py). So a tile's mma accumulator covers
// kPromoteBlocks depth blocks (128 complex values, all of n1 = 128) and is
// then added into an f32 sum rounded to nearest and zeroed (3.5e-6 there).
// Up to that depth the result is the single accumulator's, bit for bit.
constexpr int kPromoteBlocks = 16;

__device__ __forceinline__ void promote(float (&acc)[4], float (&d)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] = __fadd_rn(acc[j], d[j]);
    d[j] = 0.f;
  }
}

// One contraction on the tensor cores. Lane (g = lane / 4, q = lane % 4) of
// a warp's 8 × 8 complex tile holds, in m16n8k16's fragment layout:
//   A rows g (re) and g + 8 (im) of output i = 8·tm + g, depth columns
//     2q, 2q + 1 (re, im of k = 8·kb + q) and 2q + 8, 2q + 9 (k + 4);
//   B column g (col = 8·tn + g), the same depth rows;
//   D rows g, g + 8 and columns 2q, 2q + 1: out[i, col] = (d0, d2) and
//     out[i, col + 1] = (d1, d3) with col = 8·tn + 2q.
template <int kTier>
__device__ __forceinline__ void contract_mma(const float2* src, float2* dst,
                                             const Stage& s, int R,
                                             int stride) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int cols = R * s.o;
  const int mt = (s.m + 7) >> 3;
  const int nt = (cols + 7) >> 3;
  const int kt = (s.k + 7) >> 3;
  for (int tile = threadIdx.x >> 5; tile < mt * nt;
       tile += blockDim.x >> 5) {
    const int tm = tile / nt;
    const int tn = tile - tm * nt;
    const int i = tm * 8 + g;
    const Column bc = column(s, tn * 8 + g, cols, stride);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < kt; kc += kPromoteBlocks) {
      const int kend = min(kt, kc + kPromoteBlocks);
      for (int kb = kc; kb < kend; ++kb) {
        const int k0 = kb * 8 + q;
        const float2 f0 = load_table(s, i, k0);
        const float2 f1 = load_table(s, i, k0 + 4);
        const float2 x0 = load_input(src, s, bc, k0);
        const float2 x1 = load_input(src, s, bc, k0 + 4);
        if constexpr (kTier == kTierBf16) {
          const uint32_t a[4] = {
              pack_bf16(__float2bfloat16_rn(f0.x), __float2bfloat16_rn(-f0.y)),
              pack_bf16(__float2bfloat16_rn(f0.y), __float2bfloat16_rn(f0.x)),
              pack_bf16(__float2bfloat16_rn(f1.x), __float2bfloat16_rn(-f1.y)),
              pack_bf16(__float2bfloat16_rn(f1.y), __float2bfloat16_rn(f1.x))};
          const uint32_t b[2] = {
              pack_bf16(__float2bfloat16_rn(x0.x), __float2bfloat16_rn(x0.y)),
              pack_bf16(__float2bfloat16_rn(x1.x), __float2bfloat16_rn(x1.y))};
          mma_bf16(d, a, b);
        } else {
          uint32_t ah[4], al[4], bh[2], bl[2];
          split_pair(f0.x, -f0.y, ah[0], al[0]);
          split_pair(f0.y, f0.x, ah[1], al[1]);
          split_pair(f1.x, -f1.y, ah[2], al[2]);
          split_pair(f1.y, f1.x, ah[3], al[3]);
          split_pair(x0.x, x0.y, bh[0], bl[0]);
          split_pair(x1.x, x1.y, bh[1], bl[1]);
          mma_bf16(d, ah, bh);
          mma_bf16(d, ah, bl);
          mma_bf16(d, al, bh);
        }
      }
      promote(acc, d);
    }
    if (i < s.m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Column oc = column(s, tn * 8 + 2 * q + j, cols, stride);
        if (oc.ok)
          dst[oc.row + oc.out + i * s.out_i] = make_float2(acc[j], acc[j + 2]);
      }
    }
  }
}

// One contraction in f32 FFMA, over the same tiles: each lane computes
// out[i, col] and out[i, col + 1], i = 8·tm + g, col = 8·tn + 2q.
__device__ __forceinline__ void contract_ffma(const float2* src, float2* dst,
                                              const Stage& s, int R,
                                              int stride) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int cols = R * s.o;
  const int mt = (s.m + 7) >> 3;
  const int nt = (cols + 7) >> 3;
  for (int tile = threadIdx.x >> 5; tile < mt * nt;
       tile += blockDim.x >> 5) {
    const int tm = tile / nt;
    const int tn = tile - tm * nt;
    const int i = tm * 8 + g;
    if (i >= s.m) continue;
    const Column c0 = column(s, tn * 8 + 2 * q, cols, stride);
    const Column c1 = column(s, tn * 8 + 2 * q + 1, cols, stride);
    float2 acc0 = make_float2(0.f, 0.f);
    float2 acc1 = make_float2(0.f, 0.f);
    for (int kk = 0; kk < s.k; ++kk) {
      const float2 f = load_table(s, i, kk);
      const float2 x0 = load_input(src, s, c0, kk);
      const float2 x1 = load_input(src, s, c1, kk);
      acc0.x = fmaf(f.x, x0.x, fmaf(-f.y, x0.y, acc0.x));
      acc0.y = fmaf(f.x, x0.y, fmaf(f.y, x0.x, acc0.y));
      acc1.x = fmaf(f.x, x1.x, fmaf(-f.y, x1.y, acc1.x));
      acc1.y = fmaf(f.x, x1.y, fmaf(f.y, x1.x, acc1.y));
    }
    if (c0.ok) dst[c0.row + c0.out + i * s.out_i] = acc0;
    if (c1.ok) dst[c1.row + c1.out + i * s.out_i] = acc1;
  }
}

template <int kTier>
__device__ __forceinline__ void contract(const float2* src, float2* dst,
                                         const Stage& s, int R, int stride) {
  if constexpr (kTier == kTierF32) {
    contract_ffma(src, dst, s, R, stride);
  } else {
    contract_mma<kTier>(src, dst, s, R, stride);
  }
  __syncthreads();
}

// The tables' layout in one complex f32 buffer (fft/planes.py
// matrix_tables): F2 [n2, n2], T [n2, n1], then F1 [n1, n1] (direct) or
// F_W [8, 8], TW [8, 16], F_U [16, 16] (three-factor).
template <int kTier, bool kSplit3>
__device__ __forceinline__ const float2* matrix_dft_stages(
    float2* src, float2* dst, const float2* __restrict__ tables, int R,
    int N) {
  const int stride = N + 1;
  const int n1 = lanes_n1(N);
  const int n2 = N / n1;
  const float2* f2 = tables;
  const float2* t = f2 + n2 * n2;
  const float2* rest = t + n2 * n1;
  // stage 1: C[k2, t] = Σ_s F2[k2, s] x[s·n1 + t], in place of x's layout;
  // at f32 in the bf16x3 tier
  constexpr int kTier1 = kTier == kTierBf16x3 ? kTierF32 : kTier;
  contract<kTier1>(src, dst, Stage{f2, nullptr, 0, n2, n2, n1, n1, n1, 1, 0,
                                   n1, 1, 0}, R, stride);
  if (!kSplit3) {
    // stage 2: X[k1·n2 + k2] = Σ_t F1[k1, t] (C ⊙ T)[k2, t]
    contract<kTier>(dst, src, Stage{rest, t, -1, n1, n1, n2, n2, 1, n1, 0,
                                    n2, 1, 0}, R, stride);
    return src;
  }
  // t = w·U + u, k1 = a·W + b:
  // B[b, u] = Σ_w F_W[b, w] (C ⊙ T)[k2, w·U + u], kept at k2·n1 + b·U + u
  const float2* fw = rest;
  const float2* tw = fw + kSplitW * kSplitW;
  const float2* fu = tw + kSplitW * kSplitU;
  contract<kTier>(dst, src, Stage{fw, t, -1, kSplitW, kSplitW, kSplitU,
                                  kSplitU * n2, kSplitU, 1, n1, kSplitU, 1,
                                  n1}, R, stride);
  // X[(a·W + b)·n2 + k2] = Σ_u F_U[a, u] (B ⊙ TW)[b, u]
  contract<kTier>(src, dst, Stage{fu, tw, n1 - 1, kSplitU, kSplitU, n2,
                                  n2 * kSplitW, 1, n1, kSplitU,
                                  kSplitW * n2, 1, n2}, R, stride);
  return dst;
}

// The stage engines a row kernel is instantiated with: each loads what it
// needs before the rows arrive (prologue) and transforms them (run).
// StockhamEngine only names f32 in the direct form, whose passes run
// kernels of their own (stockham_rows_cluster.cuh, rows_natural_f32.cuh,
// fused_rows_natural_f32.cuh, fused_rows_transposed_f32.cuh, and
// rows_mixed_f32.cuh's mixed-radix stages). kThreeFactor: the
// three-factor form, which has the transposed store only.
struct StockhamEngine {
  static constexpr bool kThreeFactor = false;
};

template <int kTier, bool kSplit3>
struct MatrixEngine {
  __device__ static void prologue(float2*, const float2*, int) {}
  __device__ static const float2* run(float2* src, float2* dst,
                                      const float2* /*tw*/,
                                      const float2* tables, int R, int N,
                                      int /*log2n*/) {
    return matrix_dft_stages<kTier, kSplit3>(src, dst, tables, R, N);
  }
  static constexpr bool kThreeFactor = kSplit3;
  // whole warps, at least one: mma.sync needs all 32 lanes (rows · n / 2
  // is a whole number of warps at powers of two from n = 64 on, not at
  // n = 106)
  static int threads(int rows, int n) {
    const int t = block_threads(rows, n);
    return t < 32 ? 32 : (t + 31) / 32 * 32;
  }
};

// Dynamic shared memory of one block of the engine behind the mixed-radix
// kernels' loads and stores (rows_mixed_f32.cuh, fused_rows_mixed_f32.cuh):
// two buffers of `rows` rows of n + 1 complex values, no table (the engine
// reads its tables from device memory)
inline int matrix_smem_bytes(int rows, int n) {
  return static_cast<int>(2 * rows * (n + 1) * sizeof(float2));
}

// Calls fn(engine) with the engine of (tier, split3): StockhamEngine for
// f32 direct, else the matrix engine. The three-factor form exists for
// the transposed store only (as in the TPU package); anything else is
// refused with cudaErrorInvalidValue.
template <class Fn>
int with_engine(int tier, int split3, bool natural, Fn&& fn) {
  if (split3 && natural) return static_cast<int>(cudaErrorInvalidValue);
  switch (tier * 2 + (split3 ? 1 : 0)) {
    case kTierF32 * 2: return fn(StockhamEngine{});
    case kTierF32 * 2 + 1: return fn(MatrixEngine<kTierF32, true>{});
    case kTierBf16 * 2: return fn(MatrixEngine<kTierBf16, false>{});
    case kTierBf16 * 2 + 1: return fn(MatrixEngine<kTierBf16, true>{});
    case kTierBf16x3 * 2: return fn(MatrixEngine<kTierBf16x3, false>{});
    case kTierBf16x3 * 2 + 1: return fn(MatrixEngine<kTierBf16x3, true>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tpu_fft
