// The spectrum assembly of the fused kernels (fused_rows.cu's two stores,
// fused_rows_natural_f32.cuh): one point of one channel from the five
// input planes, in f32 and in the order of _assemble_block
// (tpu_ocean/ops/fused_spectrum_fft.py:58-124), with w_i = [ch = i]:
//   c, s = cos φ, sin φ
//   h̃ = ((h0r + h0cr)·c + (h0ci − h0i)·s,  (h0i + h0ci)·c + (h0r − h0cr)·s)
//   kx = f32(2π/L)·wrapped(row), wrapped(row) = row − N for row ≥ N/2
//   invk = kx² + kz² < ε² ? 0 : 1/sqrt(kx² + kz²)
//   packed: rowmask = [row ≠ N/2], colmask = [j ≠ N/2],
//     rx = kx·invk·rowmask, rz = dz_sign·kz·invk·colmask
//     nch_live = 3: a = w0·(1 + rx),                  b = w1·rz
//     nch_live = 5: a = w0·(1 + rx) + w1·(−kx)·rowmask,
//                   b = w1·rz + w2·(−kz)·colmask
//     P = (a·h̃r + b·h̃i,  a·h̃i − b·h̃r)
//   per-channel: k = w0 + w1·kx·invk + w2·dz_sign·kz·invk + w3·(−kx)
//                    + w4·(−kz),  S = (k·h̃r, k·h̃i)
// Each product and sum is rounded on its own (no FMA contraction), as the
// plain version's torch ops round them; sin/cos and the square root are
// the precise library functions. The Nyquist masks and the weights w_i are
// integer tests (the masks select the texels of the JAX package's float
// compares); a weight multiplies a 0/1 value, so the selected term comes
// out exact and the others add signed zeros.
//
// Two parts, composed by assemble(): point_terms (h̃ and invk, the same
// for every channel) and channel_value (the weights, masks and the
// products with h̃). A kernel that makes several channels of one point
// computes the first once and the second per channel; the composition
// rounds the same products and sums as one call of assemble().

#pragma once

#include <cuda_runtime.h>

namespace tpu_fft {

struct Assembly {
  float two_pi_over_l;   // f32(2π/L), rounded once on the host
  float dz_sign;         // −1 with the oracle's sign quirk, else +1
  float eps2;            // ε·ε in f32
  int row_offset;        // global row of the batch's first row
  int packed;            // 1: the Hermitian-packed channels; 0: per-channel
  int nch_live;          // live fields of the packed set, 3 or 5
};

// The terms of one point that do not depend on the channel
struct PointTerms {
  float htr, hti;        // h̃
  float invk;            // 1/|k|, 0 below ε
};

// kx of global row `row`
__device__ __forceinline__ float row_kx(int row, int N, const Assembly& p) {
  const int wrapped = row < (N >> 1) ? row : row - N;
  return __fmul_rn(p.two_pi_over_l, static_cast<float>(wrapped));
}

__device__ __forceinline__ PointTerms point_terms(float h0r, float h0i,
                                                  float h0cr, float h0ci,
                                                  float phase, float kx,
                                                  float kz,
                                                  const Assembly& p) {
  float s, c;
  sincosf(phase, &s, &c);
  PointTerms a;
  a.htr = __fadd_rn(__fmul_rn(__fadd_rn(h0r, h0cr), c),
                    __fmul_rn(__fsub_rn(h0ci, h0i), s));
  a.hti = __fadd_rn(__fmul_rn(__fadd_rn(h0i, h0ci), c),
                    __fmul_rn(__fsub_rn(h0r, h0cr), s));
  const float kmag2 = __fadd_rn(__fmul_rn(kx, kx), __fmul_rn(kz, kz));
  a.invk = kmag2 < p.eps2 ? 0.f : __fdiv_rn(1.f, __fsqrt_rn(kmag2));
  return a;
}

// Channel `ch` of the point (global row `row`, column j) with terms `a`
__device__ __forceinline__ float2 channel_value(const PointTerms& a, float kx,
                                                float kz, int row, int j,
                                                int N, int ch,
                                                const Assembly& p) {
  const float w0 = ch == 0 ? 1.f : 0.f;
  const float w1 = ch == 1 ? 1.f : 0.f;
  const float w2 = ch == 2 ? 1.f : 0.f;
  if (!p.packed) {
    const float w3 = ch == 3 ? 1.f : 0.f;
    const float w4 = ch == 4 ? 1.f : 0.f;
    float k = __fadd_rn(__fmul_rn(w0, 1.f),
                        __fmul_rn(__fmul_rn(w1, kx), a.invk));
    k = __fadd_rn(k,
                  __fmul_rn(__fmul_rn(__fmul_rn(w2, p.dz_sign), kz), a.invk));
    k = __fadd_rn(k, __fmul_rn(w3, -kx));
    k = __fadd_rn(k, __fmul_rn(w4, -kz));
    return make_float2(__fmul_rn(k, a.htr), __fmul_rn(k, a.hti));
  }
  const int half = N >> 1;
  const float rowmask = row != half ? 1.f : 0.f;
  const float colmask = j != half ? 1.f : 0.f;
  const float rx = __fmul_rn(__fmul_rn(kx, a.invk), rowmask);
  const float rz =
      __fmul_rn(__fmul_rn(__fmul_rn(p.dz_sign, kz), a.invk), colmask);
  float av = __fmul_rn(w0, __fadd_rn(1.f, rx));
  float bv = __fmul_rn(w1, rz);
  if (p.nch_live == 5) {
    av = __fadd_rn(av, __fmul_rn(__fmul_rn(w1, -kx), rowmask));
    bv = __fadd_rn(bv, __fmul_rn(__fmul_rn(w2, -kz), colmask));
  }
  return make_float2(__fadd_rn(__fmul_rn(av, a.htr), __fmul_rn(bv, a.hti)),
                     __fsub_rn(__fmul_rn(av, a.hti), __fmul_rn(bv, a.htr)));
}

// One point of channel `ch`: the two parts composed
__device__ __forceinline__ float2 assemble(float h0r, float h0i, float h0cr,
                                           float h0ci, float phase, float kz,
                                           int row, int j, int N, int ch,
                                           const Assembly& p) {
  const float kx = row_kx(row, N, p);
  return channel_value(point_terms(h0r, h0i, h0cr, h0ci, phase, kx, kz, p),
                       kx, kz, row, j, N, ch, p);
}

}  // namespace tpu_fft
