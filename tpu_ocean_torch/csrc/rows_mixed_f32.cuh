// The f32 row DFT at even lengths that are not powers of two, either
// store: fft_rows.cu's entry tpu_fft_rows_mixed.
//
// Replaces: tpu_ocean/fft/pallas_fft.py _fft_block_kernel (launched by
// _fft1d_transposed_impl) and _rowfft_block_kernel_natural (launched by
// _fft1d_natural_large_impl) at HIGHEST, at the lengths the power-of-two
// kernels do not take (N = 96, 1536, 3072, 2·53, …). The JAX kernels run
// there as a four-step matrix DFT on any split N = n2·n1 (_split_lanes),
// a form chosen for the TPU's matrix unit; this kernel computes the same
// sums, fft_rows.cu's contract:
//   in  (re, im) f32 [C, M, N], contiguous
//   out transposed (re, im) f32 [C, N, M], out[c, k, m] = Σ_n x[c, m, n]
//       e^{±2πi nk/N} (+ for the inverse), unnormalized;
//   out natural    (re, im) f32 [C, M, N], out[c, m, k] = the same sum.
//
// What bounds it on the H100: device memory where N's odd part has small
// prime factors (16 B a point against a few flops a point a stage); where
// it is a large prime p (2042 = 2·1021, 8186 = 2·4093) the p-point DFT,
// N·p complex multiply-adds a row, read from shared memory.
//
// The design is the simple one, right first (making it fast is later
// work): a block loads R rows into two ping-pong shared buffers of R rows
// of N + 1 complex (stockham.cuh's layout), then its table, and runs
// mixed-radix Stockham stages (autosort, no bit reversal): for the stage
// of radix P at span ns (the product of the radices before), the
// butterfly j < N/P of a row reads x[j + r·N/P], r < P, twiddles input r
// by e^{±2πi r·k/(ns·P)} with k = j mod ns, takes the P-point DFT and
// writes output q at (j − k)·P + k + q·ns. After the last stage the row is
// in natural order. The stages come from the host (planes.mixed_plan, the
// one place they are planned; the entry only checks that they describe a
// length-N transform inside the table): radix 2 where N's power-of-two
// part is an odd power, then radix 4, then one generic stage for each odd
// prime factor p. The generic stage twiddles its inputs in place, then
// computes each output (q, j) as Σ_r x[j + r·N/p]·ω^{(r·q) mod p}, ω the
// p-th roots from the table, the exponent kept mod p by an add and a
// compare (never a growing angle), in 8 accumulators taken in turn, whose
// pairwise sum is folded into a total every 8 rounds (64 terms): one
// accumulator's rounding puts a row beyond 1e-6·max of float64 at
// p = 1021 and 4093 (a numpy model of these sums,
// tests/test_torch_sizes.py); 8 without the fold read 8.7e-7·max at
// p = 4093 on an H100 80GB HBM3 at 700 W, with it 4.3e-7, at no cost in
// time (tools/mixed_sums_variants.py). The table (planes.mixed_table, f32 from
// float64): entry 0 is ±i (the direction), the stage at span ns has its
// twiddles at ns + (r − 1)·ns + k, then the odd stages' roots, p each.
// The stores are stockham.cuh's two, by division instead of shifts.
//
// Rows per block R (planes.rows_per_block with planes.mixed_shared_bytes):
// a power of two, at most 8 for the transposed store (8-float runs), at
// most 4096 / N for the natural one; at N = 8190 one row takes 196 KB.
// Rows past M (the ragged last block) load as zeros and are never stored.

#pragma once

#include "stockham.cuh"

namespace tpu_fft {
namespace mixed {

constexpr int kMinN = 16;
constexpr int kMaxN = 8192;
// N ≤ 8192 has at most 13 prime factors
constexpr int kMaxStages = 16;
constexpr int kAccumulators = 8;
// rounds of kAccumulators terms between two folds into the total
constexpr int kRounds = 8;

// The stages, as the host gives them (planes.mixed_plan_rows): radix, span
// and, for an odd radix, the table offset of its p roots.
struct Plan {
  int n;
  int stages;
  int radix[kMaxStages];
  int span[kMaxStages];
  int roots[kMaxStages];
  int table;                // table entries
};

// The plan from the host's rows (radix, span, roots) × stages, or stages = 0
// where they do not describe a length-n transform that stays inside a table
// of `table` entries.
inline Plan read_plan(int n, const int* rows, int stages, int table) {
  Plan p{};
  p.n = n;
  p.table = table;
  if (n < kMinN || n > kMaxN || (n & 1) || stages < 1 ||
      stages > kMaxStages || table < n)
    return p;
  int span = 1;
  for (int s = 0; s < stages; ++s) {
    const int radix = rows[3 * s];
    p.radix[s] = radix;
    p.span[s] = rows[3 * s + 1];
    p.roots[s] = rows[3 * s + 2];
    if (radix < 2 || (!(radix & 1) && radix != 2 && radix != 4) ||
        p.span[s] != span ||
        ((radix & 1) && (p.roots[s] < n || p.roots[s] + radix > table)))
      return p;
    span *= radix;
  }
  if (span == n) p.stages = stages;
  return p;
}

inline int smem_bytes(int rows, const Plan& plan) {
  return static_cast<int>((2 * rows * (plan.n + 1) + plan.table) *
                          sizeof(float2));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// the pairwise sum of kAccumulators = 8 values
static_assert(kAccumulators == 8, "sum8 adds 8 accumulators");
__device__ __forceinline__ float2 sum8(const float2* a) {
  return cadd(cadd(cadd(a[0], a[1]), cadd(a[2], a[3])),
              cadd(cadd(a[4], a[5]), cadd(a[6], a[7])));
}

// acc + x·w, each part two fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.x = fmaf(-x.y, w.y, acc.x);
  acc.y = fmaf(x.x, w.y, acc.y);
  acc.y = fmaf(x.y, w.x, acc.y);
  return acc;
}

// Radix 2 at span ns: butterflies j < N/2 of every row.
__device__ __forceinline__ void stage2(const float2* src, float2* dst,
                                       const float2* tw, int R, int N,
                                       int ns) {
  const int stride = N + 1;
  const int L = N >> 1;
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
    const int r = idx / L;
    const int j = idx - r * L;
    const int k = j % ns;
    const float2* row = src + r * stride;
    const float2 a = row[j];
    float2 b = row[j + L];
    if (ns > 1) b = cmul(b, tw[k]);
    float2* orow = dst + r * stride + (j - k) * 2 + k;
    orow[0] = cadd(a, b);
    orow[ns] = csub(a, b);
  }
}

// Radix 4 at span ns; `sign` is +1 for the inverse, −1 for the forward
// transform (the twiddle of the second and fourth outputs is ±i).
__device__ __forceinline__ void stage4(const float2* src, float2* dst,
                                       const float2* tw, int R, int N, int ns,
                                       float sign) {
  const int stride = N + 1;
  const int L = N >> 2;
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
    const int r = idx / L;
    const int j = idx - r * L;
    const int k = j % ns;
    const float2* row = src + r * stride;
    const float2 a0 = row[j];
    float2 a1 = row[j + L];
    float2 a2 = row[j + 2 * L];
    float2 a3 = row[j + 3 * L];
    if (ns > 1) {
      a1 = cmul(a1, tw[k]);
      a2 = cmul(a2, tw[ns + k]);
      a3 = cmul(a3, tw[2 * ns + k]);
    }
    const float2 t0 = cadd(a0, a2);
    const float2 t1 = csub(a0, a2);
    const float2 t2 = cadd(a1, a3);
    const float2 t3 = csub(a1, a3);
    const float2 u = make_float2(-sign * t3.y, sign * t3.x);   // ±i·t3
    float2* orow = dst + r * stride + (j - k) * 4 + k;
    orow[0] = cadd(t0, t2);
    orow[ns] = cadd(t1, u);
    orow[2 * ns] = csub(t0, t2);
    orow[3 * ns] = csub(t1, u);
  }
}

// The generic stage of an odd prime radix p at span ns. Ends with the
// block synchronised after the twiddle pass (where there is one), not
// after the outputs.
__device__ __forceinline__ void stage_odd(float2* src, float2* dst,
                                          const float2* tw,
                                          const float2* roots, int R, int N,
                                          int ns, int p) {
  const int stride = N + 1;
  const int L = N / p;
  const int points = R * N;
  if (ns > 1) {
    // input q of butterfly j times e^{±2πi q·k/(ns·p)}, in place
    for (int idx = threadIdx.x; idx < points; idx += blockDim.x) {
      const int r = idx / N;
      const int i = idx - r * N;
      const int q = i / L;
      if (q == 0) continue;
      const int k = (i - q * L) % ns;
      float2* v = src + r * stride + i;
      *v = cmul(*v, tw[(q - 1) * ns + k]);
    }
    __syncthreads();
  }
  // output q of butterfly j: consecutive threads take consecutive j, so
  // the reads of a warp are consecutive and, where L ≥ 32, its roots one
  // broadcast
  for (int idx = threadIdx.x; idx < points; idx += blockDim.x) {
    const int r = idx / N;
    const int o = idx - r * N;
    const int q = o / L;
    const int j = o - q * L;
    const int k = j % ns;
    const float2* x = src + r * stride + j;
    float2 acc[kAccumulators];
#pragma unroll
    for (int u = 0; u < kAccumulators; ++u) acc[u] = make_float2(0.f, 0.f);
    float2 total = make_float2(0.f, 0.f);
    int e = 0;                                   // (t·q) mod p
    int t = 0;
    // blocks of kRounds rounds, each folded into the total
    for (; t + kAccumulators * kRounds <= p; t += kAccumulators * kRounds) {
#pragma unroll
      for (int i = 0; i < kAccumulators * kRounds; ++i) {
        const int u = i % kAccumulators;
        acc[u] = cmac(acc[u], x[(t + i) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
      total = cadd(total, sum8(acc));
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) acc[u] = make_float2(0.f, 0.f);
    }
    for (; t + kAccumulators <= p; t += kAccumulators) {
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) {
        acc[u] = cmac(acc[u], x[(t + u) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
    }
#pragma unroll
    for (int u = 0; u < kAccumulators; ++u) {
      if (t + u < p) {
        acc[u] = cmac(acc[u], x[(t + u) * L], roots[e]);
        e += q;
        if (e >= p) e -= p;
      }
    }
    dst[r * stride + (j - k) * p + k + q * ns] = cadd(total, sum8(acc));
  }
}

template <bool kNatural>
__global__ void __launch_bounds__(kMaxThreads)
mixed_rows_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  const float2* __restrict__ table, int M, int R, int log2r,
                  const Plan plan) {
  extern __shared__ float2 smem[];
  const int N = plan.n;
  const int stride = N + 1;
  float2* src = smem;
  float2* dst = smem + R * stride;
  float2* tab = smem + 2 * R * stride;

  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * N;
  const int live = M - m0 < R ? M - m0 : R;

  for (int t = threadIdx.x; t < plan.table; t += blockDim.x) tab[t] = table[t];
  {
    const float* in_re = re + c * plane + static_cast<size_t>(m0) * N;
    const float* in_im = im + c * plane + static_cast<size_t>(m0) * N;
    const int valid = live * N;
    for (int idx = threadIdx.x; idx < R * N; idx += blockDim.x) {
      const int r = idx / N;
      src[r * stride + idx - r * N] =
          idx < valid ? make_float2(in_re[idx], in_im[idx])
                      : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();

  const float sign = tab[0].y;
  for (int s = 0; s < plan.stages; ++s) {
    const int radix = plan.radix[s];
    const int ns = plan.span[s];
    const float2* tw = tab + ns;
    if (radix == 2) {
      stage2(src, dst, tw, R, N, ns);
    } else if (radix == 4) {
      stage4(src, dst, tw, R, N, ns, sign);
    } else {
      stage_odd(src, dst, tw, tab + plan.roots[s], R, N, ns, radix);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }

  float* o_re = out_re + c * plane;
  float* o_im = out_im + c * plane;
  if (kNatural) {
    const size_t first = static_cast<size_t>(m0) * N;
    for (int idx = threadIdx.x; idx < live * N; idx += blockDim.x) {
      const int r = idx / N;
      const float2 v = src[r * stride + idx - r * N];
      o_re[first + idx] = v.x;
      o_im[first + idx] = v.y;
    }
  } else {
    // out[k, m0 + r], r the fastest thread index: runs of R floats
    for (int idx = threadIdx.x; idx < R * N; idx += blockDim.x) {
      const int r = idx & (R - 1);
      const int k = idx >> log2r;
      if (r < live) {
        const float2 v = src[r * stride + k];
        const size_t g = static_cast<size_t>(k) * M + m0 + r;
        o_re[g] = v.x;
        o_im[g] = v.y;
      }
    }
  }
}

}  // namespace mixed

// Launches the mixed-radix kernel: n even in [16, 8192], `plan` its stages
// (read_plan), rows a power of two whose block fits the card's shared
// memory (refused otherwise, never run on another kernel), `tables`
// planes.mixed_twiddles(n, inverse), `table` entries.
inline int launch_rows_mixed(bool natural, const void* re, const void* im,
                             void* out_re, void* out_im, const void* tables,
                             int channels, int m, int n, int rows,
                             const int* plan_rows, int stages, int table,
                             void* stream) {
  const mixed::Plan plan = mixed::read_plan(n, plan_rows, stages, table);
  if (plan.stages == 0 || rows < 1 || (rows & (rows - 1)) || m < 1 ||
      channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = mixed::smem_bytes(rows, plan);
  auto kernel = natural ? &mixed::mixed_rows_kernel<true>
                        : &mixed::mixed_rows_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = rows * n / 2;
  const int threads = work >= kMaxThreads ? kMaxThreads : (work + 31) / 32 * 32;
  const dim3 grid((m + rows - 1) / rows, channels);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tables), m, rows, log2_of(rows), plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpu_fft
