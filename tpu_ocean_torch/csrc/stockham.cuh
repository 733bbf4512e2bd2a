// Shared pieces of the row-DFT kernels (fft_rows.cu, fused_rows.cu): the
// shared-memory layout, the radix-2 Stockham stages and the two stores.
//
// A block transforms R rows of length N held in shared memory as two
// ping-pong buffers of R rows of (N + 1) float2 (one pad element per row
// staggers the banks of the transposed read-out), then the N − 1 stage
// twiddles. The kernel that includes this loads its rows into the first
// buffer (from planes, or assembled from the spectrum's inputs), runs
// stockham_stages, and stores the result transposed or in natural order.

#pragma once

#include <cuda_runtime.h>

namespace tpu_fft {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Dynamic shared memory of a block of `rows` rows of length `n`.
inline int smem_bytes(int rows, int n) {
  return static_cast<int>((2 * rows * (n + 1) + n - 1) * sizeof(float2));
}

inline int log2_of(int n) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return log2n;
}

inline int block_threads(int rows, int n) {
  const int threads = rows * n / 2;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

// Row stride, in complex (8-byte) units, of a tile of `kr` rows of `w`
// columns that a transposed store reads kr rows at one column, then the
// next column (the cluster kernel's gathered tile, stockham_rows_cluster.cuh,
// and the f32 fused transposed kernel's, fused_rows_transposed_f32.cuh):
// the least S ≥ w with S ≡ 16/kr (mod 16), S odd from kr = 16 on. 64-bit
// shared accesses are served a half warp (16 lanes) at a time, and two
// lanes conflict when their addresses differ and agree mod 16. The
// store's half warp reads kr rows at 16/kr consecutive k (kr ≤ 16) or 16
// rows at one k, at addresses r·S + k: all distinct mod 16 with this S.
// The tile's writers write 16 consecutive k of one row where a row has 16
// writers or more.
__host__ __device__ __forceinline__ int gather_stride(int kr, int w) {
  const int want = kr >= 16 ? 1 : (16 / kr) & 15;
  return w + ((want - w) & 15);
}

// Above 48 KB dynamic shared memory needs an opt-in, per kernel. A size
// the card refuses is returned here and cleared from the runtime's last
// error, so that the next launch's cudaGetLastError does not report it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

__device__ __forceinline__ void load_twiddles(float2* tw,
                                              const float2* __restrict__ table,
                                              int n) {
  for (int t = threadIdx.x; t < n - 1; t += blockDim.x) tw[t] = table[t];
}

// Radix-2 Stockham autosort: at span ns the butterfly j reads x[j] and
// x[j + N/2], twiddles the second by e^{±2πi (j mod ns)/(2 ns)} and writes
// positions (j / ns)·2ns + (j mod ns) and that + ns. After log2(N) stages
// the row is in natural order, in the buffer this returns. Starts and ends
// with the block synchronised.
__device__ __forceinline__ const float2* stockham_stages(float2* src,
                                                         float2* dst,
                                                         const float2* tw,
                                                         int R, int N,
                                                         int log2n) {
  const int stride = N + 1;
  const int half = N >> 1;
  const int nbfly = R * half;
  for (int s = 0; s < log2n; ++s) {
    const int ns = 1 << s;
    const float2* tw_s = tw + ns - 1;
    for (int idx = threadIdx.x; idx < nbfly; idx += blockDim.x) {
      const int r = idx >> (log2n - 1);
      const int j = idx & (half - 1);
      const int k = j & (ns - 1);
      const float2* row = src + r * stride;
      const float2 a = row[j];
      const float2 b = cmul(row[j + half], tw_s[k]);
      float2* orow = dst + r * stride;
      const int d = ((j >> s) << (s + 1)) + k;
      orow[d] = make_float2(a.x + b.x, a.y + b.y);
      orow[d + ns] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Stores rows m0 .. m0 + R − 1 of one channel's [M, N] batch (rows past M,
// the ragged last block, are dropped).
//   kNatural = false: out[k, m0 + r], a [N, M] plane. r is the fastest
//     thread index, so a warp writes 32 / R runs of R consecutive floats.
//   kNatural = true:  out[m0 + r, k], an [M, N] plane. The R rows are one
//     contiguous run of device memory, written fully coalesced.
template <bool kNatural>
__device__ __forceinline__ void store_rows(const float2* res,
                                           float* __restrict__ o_re,
                                           float* __restrict__ o_im,
                                           int M, int N, int log2n, int R,
                                           int m0) {
  const int stride = N + 1;
  const int total = R * N;
  if (kNatural) {
    const int valid = (M - m0 < R ? M - m0 : R) * N;
    float* b_re = o_re + static_cast<size_t>(m0) * N;
    float* b_im = o_im + static_cast<size_t>(m0) * N;
    for (int idx = threadIdx.x; idx < valid; idx += blockDim.x) {
      const float2 v = res[(idx >> log2n) * stride + (idx & (N - 1))];
      b_re[idx] = v.x;
      b_im[idx] = v.y;
    }
  } else {
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx & (R - 1);
      const int k = idx / R;
      if (m0 + r < M) {
        const float2 v = res[r * stride + k];
        const size_t g = static_cast<size_t>(k) * M + m0 + r;
        o_re[g] = v.x;
        o_im[g] = v.y;
      }
    }
  }
}

}  // namespace tpu_fft
