// Batched 1-D DFT along the rows of (re, im) f32 planes, stored transposed.
//
// Replaces: tpu_ocean/fft/pallas_fft.py, _fft_block_kernel (launched by
// _fft1d_transposed_impl). The contract is held exactly:
//   in  (re, im) f32 [C, M, N], contiguous
//   out (re, im) f32 [C, N, M], out[c, k, m] = sum_n x[c, m, n] e^{±2πi nk/N}
//   (+ for the inverse), unnormalized.
// Two calls make a full 2-D transform, because the second call's rows are
// the first call's columns.
//
// What bounds it on the H100: device memory. Each pass reads and writes
// every point once as two f32 planes, 16 B per point (16.8 MB for one
// 1024² pass), against a few flops per point per stage.
//
// What the design does about that: one block loads R whole rows of one
// channel into shared memory with row-contiguous (coalesced) reads, runs
// all log2(N) radix-2 Stockham autosort stages there (the network of the
// reference's Stockham.shader, ping-ponging between two shared buffers so
// no stage touches device memory), and writes the transposed result so
// that consecutive threads write consecutive m: R = 8 rows give 32-byte
// runs, one full sector each. A block takes about as long whatever R is,
// so the wrapper picks R ≤ 8 to give about one block per SM (R = 4 for the
// 512-row half pass, 1 for the one-row Nyquist pass). The TPU kernel's
// Bailey four-step existed to feed the MXU; there is no matrix unit in
// this f32 path, so the butterfly network does O(N log N) work instead of
// O(N·(N1+N2)).
//
// Twiddles come from a host table built in float64 and rounded to f32 (the
// same rounding as pallas_fft._tables_np); nothing is computed with fast
// sin/cos. The table holds each stage's twiddles contiguously,
// e^{±2πi k/(2ns)} for k < ns at offset ns − 1 (N − 1 entries), so a warp
// reads consecutive entries: from one N/2-entry table indexed k·N/(2ns),
// the early stages' reads all fell in one shared-memory bank.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLoadsInFlight = 8;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Shared memory: two ping-pong buffers of R rows of (N + 1) float2 (one pad
// element per row staggers the banks of the transposed read-out), then the
// N − 1 stage twiddles.
__global__ void __launch_bounds__(kMaxThreads)
fft_rows_transposed_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           float* __restrict__ out_re,
                           float* __restrict__ out_im,
                           const float2* __restrict__ twiddles,
                           int M, int N, int log2n, int R) {
  extern __shared__ float2 smem[];
  const int stride = N + 1;
  const int half = N >> 1;
  float2* src = smem;
  float2* dst = smem + R * stride;
  float2* tw = smem + 2 * R * stride;

  const int c = blockIdx.y;
  const int m0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(M) * N;
  const float* in_re = re + c * plane;
  const float* in_im = im + c * plane;

  for (int t = threadIdx.x; t < N - 1; t += blockDim.x) tw[t] = twiddles[t];

  // Load R rows (contiguous in memory from row m0) with kLoadsInFlight
  // loads started per thread before any is waited on: one block per SM has
  // too few warps to hide device-memory latency one load at a time. Rows
  // past M (the ragged last block) are zero and never stored.
  const int total = R * N;
  const float* block_re = in_re + static_cast<size_t>(m0) * N;
  const float* block_im = in_im + static_cast<size_t>(m0) * N;
  const int valid = (M - m0 < R ? M - m0 : R) * N;
  for (int base = threadIdx.x; base < total;
       base += kLoadsInFlight * blockDim.x) {
    float2 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      v[u] = idx < valid ? make_float2(block_re[idx], block_im[idx])
                         : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) src[(idx >> log2n) * stride + (idx & (N - 1))] = v[u];
    }
  }
  __syncthreads();

  // Radix-2 Stockham autosort: at span ns the butterfly j reads x[j] and
  // x[j + N/2], twiddles the second by e^{±2πi (j mod ns)/(2 ns)} and writes
  // positions (j / ns)·2ns + (j mod ns) and that + ns. After log2(N) stages
  // the row is in natural order.
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

  // Transposed store out[c, k, m0 + r]: r is the fastest thread index, so a
  // warp writes 32 / R runs of R consecutive floats.
  float* o_re = out_re + c * plane;
  float* o_im = out_im + c * plane;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx & (R - 1);
    const int k = idx / R;
    if (m0 + r < M) {
      const float2 v = src[r * stride + k];
      const size_t g = static_cast<size_t>(k) * M + m0 + r;
      o_re[g] = v.x;
      o_im[g] = v.y;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// The caller checks: n a power of two >= 16, rows a power of two that
// keeps the shared memory within the card's limit, contiguous f32 planes.
int tpu_fft_rows_transposed(const void* re, const void* im, void* out_re,
                            void* out_im, const void* twiddles, int channels,
                            int m, int n, int rows, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const int smem =
      static_cast<int>((2 * rows * (n + 1) + n - 1) * sizeof(float2));
  if (smem > 48 * 1024) {
    // above 48 KB dynamic shared memory needs an opt-in, per device
    cudaError_t err = cudaFuncSetAttribute(
        fft_rows_transposed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = rows * n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((m + rows - 1) / rows, channels);
  fft_rows_transposed_kernel<<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(twiddles), m, n, log2n, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* tpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
