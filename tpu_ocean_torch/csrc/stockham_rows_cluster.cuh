// The f32 transposed row DFT with a thread-block-cluster store:
// fft_rows.cu's entry tpu_fft_rows_transposed at tier f32, direct form.
//
// Replaces: tpu_ocean/fft/pallas_fft.py _fft_block_kernel (launched by
// _fft1d_transposed_impl) at HIGHEST, with fft_rows.cu's contract:
//   in  (re, im) f32 [C, M, N], contiguous
//   out (re, im) f32 [C, N, M], out[c, k, m] = Σ_n x[c, m, n] e^{±2πi nk/N}.
//
// What bounds it on the H100: device memory, 16 B a point against a few
// flops a point a stage. What held the block-per-R-rows kernel back was its
// store: written transposed with the row fastest, a block of R rows writes
// runs of R consecutive floats into each output row, and at N = 4096 only
// R = 2 rows fit one block (two ping-pong buffers of R·(N + 1) complex and
// the twiddles, 164 KB): 8-byte runs, a quarter of a 32-byte sector.
//
// What the design does about that: K blocks of one cluster (K = 1, 2, 4
// or 8, from planes.transposed_cluster) hold K·R rows together. Each block
// loads its R rows and runs stockham.cuh's stages on them unchanged. Then
// block j (its rank in the cluster) gathers the columns [j·N/K, (j+1)·N/K)
// of all K·R rows from the cluster's shared memory (distributed shared
// memory through cluster.map_shared_rank, reads along k, contiguous) and
// stores that column range transposed with the row fastest: runs of K·R
// floats, a full 32-byte sector at K·R = 8.
//
// Shared memory (complex units): the stages' result buffer at 0 (the rows
// load at 0 for an even log2 N, at R·(N + 1) for an odd one, so the last
// stage writes at 0 in every block of the cluster), the other buffer at
// R·(N + 1), the twiddles after it. After the stages everything from
// R·(N + 1) on is free; the gathered tile goes there: K·R rows of S =
// gather_stride(K·R, N/K) complex, padded so that the gather's writes
// (along k) and the store's reads (K·R rows at one k, then the next k) meet
// no bank conflict. Where the tile needs more than the free area (small N,
// large K·R), the block's shared memory grows by the difference
// (cluster_smem_bytes; planes.cluster_rows_shared_bytes is its twin).
//
// A cluster of one block (K = 1, where a block holds 8 rows or M is one
// row) stores from its result buffer with stockham.cuh's store_rows: a
// copy into a tile would only add a pass through shared memory.
//
// Rows per block (planes.cluster_max_rows): 8 where they fit one block
// (N ≤ 1024, K = 1); beyond, 4096 points (R = 2 at N = 2048, 1 at 4096),
// so that two blocks share an SM and one block's gather and store overlap
// the other's loads and stages, in clusters of 8 / R blocks.
//
// Barriers: cluster.sync() after the stages, so every block's result is
// whole before any block reads it; after its gather a block arrives at the
// cluster barrier (it reads no other block's memory any more), stores from
// its own tile, and waits for the whole cluster before it exits, so no
// block's shared memory goes away while another still reads it. A block
// whose rows all lie past M (grid.x is rounded up to whole clusters) loads
// zeros and joins every barrier; its rows are never stored.
//
// A launch that the card cannot place (no cluster of K such blocks fits,
// cudaOccupancyMaxActiveClusters reads 0) returns an error; nothing falls
// back to another K or to the block-per-R-rows store.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "stockham.cuh"

namespace tpu_fft {

namespace cg = cooperative_groups;

constexpr int kRowLoadsInFlight = 8;
// the portable cluster size limit
constexpr int kMaxCluster = 8;

// Loads rows m0 .. m0 + R − 1 of one channel's [M, N] batch into src (rows
// of `stride` complex) with kRowLoadsInFlight loads started per thread
// before any is waited on: one block per SM has too few warps to hide
// device-memory latency one load at a time. Rows past M are zero.
__device__ __forceinline__ void load_rows(float2* src,
                                          const float* __restrict__ in_re,
                                          const float* __restrict__ in_im,
                                          int M, int N, int log2n, int R,
                                          int m0) {
  const int stride = N + 1;
  const int total = R * N;
  const int live = M - m0 < R ? M - m0 : R;
  const int valid = (live > 0 ? live : 0) * N;
  const float* block_re = in_re + static_cast<size_t>(m0) * N;
  const float* block_im = in_im + static_cast<size_t>(m0) * N;
  for (int base = threadIdx.x; base < total;
       base += kRowLoadsInFlight * blockDim.x) {
    float2 v[kRowLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kRowLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      v[u] = idx < valid ? make_float2(block_re[idx], block_im[idx])
                         : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kRowLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) src[(idx >> log2n) * stride + (idx & (N - 1))] = v[u];
    }
  }
}

// Dynamic shared memory of one block: the stages' two buffers and
// twiddles, or the result buffer and the gathered tile (none at K = 1),
// whichever is more.
inline int cluster_smem_bytes(int rows, int n, int cluster) {
  const int stride = n + 1;
  const int stages = 2 * rows * stride + n - 1;
  const int gathered =
      cluster == 1 ? 0
                   : rows * stride + cluster * rows *
                                         gather_stride(cluster * rows,
                                                       n / cluster);
  return static_cast<int>((stages > gathered ? stages : gathered) *
                          sizeof(float2));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
stockham_rows_cluster_kernel(const float* __restrict__ re,
                             const float* __restrict__ im,
                             float* __restrict__ out_re,
                             float* __restrict__ out_im,
                             const float2* __restrict__ tables, int M, int N,
                             int log2n, int log2r, int log2k) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = 1 << log2r;
  const int stride = N + 1;
  float2* res = smem;
  float2* other = smem + R * stride;
  float2* tw = smem + 2 * R * stride;

  const int c = blockIdx.y;
  const size_t plane = static_cast<size_t>(M) * N;
  load_twiddles(tw, tables, N);
  float2* src = (log2n & 1) ? other : res;
  load_rows(src, re + c * plane, im + c * plane, M, N, log2n, R,
            blockIdx.x * R);
  __syncthreads();
  stockham_stages(src, (log2n & 1) ? res : other, tw, R, N, log2n);
  if (log2k == 0) {
    // a cluster of one block has nothing to gather: its tile would be a
    // copy of its own result, so it stores from there (runs of R floats)
    store_rows<false>(res, out_re + c * plane, out_im + c * plane, M, N,
                      log2n, R, blockIdx.x * R);
    return;
  }

  // Gather: columns [j·W, (j+1)·W) of the cluster's K·R rows, row q·R + r
  // of the tile from row r of block q, kRowLoadsInFlight remote reads started
  // per thread before any is written.
  cluster.sync();
  const int j = static_cast<int>(cluster.block_rank());
  const int log2w = log2n - log2k;
  const int W = 1 << log2w;
  const int kr = R << log2k;
  const int S = gather_stride(kr, W);
  float2* tile = other;
  const int total = R * N;      // = K·R·W, the tile's points
  for (int base = threadIdx.x; base < total;
       base += kRowLoadsInFlight * blockDim.x) {
    float2 v[kRowLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kRowLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int row = idx >> log2w;            // q·R + r
        const float2* from =
            cluster.map_shared_rank(res, row >> log2r);
        v[u] = from[(row & (R - 1)) * stride + j * W + (idx & (W - 1))];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) tile[(idx >> log2w) * S + (idx & (W - 1))] = v[u];
    }
  }
  __syncthreads();
  cluster_arrive();

  // Store: out[c, j·W + k, m_c + rr] with rr fastest, runs of K·R floats;
  // m_c is the cluster's first row, rows past M are dropped.
  const int mc = (static_cast<int>(blockIdx.x) - j) * R;
  float* o_re = out_re + c * plane;
  float* o_im = out_im + c * plane;
  const int log2kr = log2r + log2k;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int rr = idx & (kr - 1);
    const int k = idx >> log2kr;
    if (mc + rr < M) {
      const float2 v = tile[rr * S + k];
      const size_t g = static_cast<size_t>(j * W + k) * M + mc + rr;
      o_re[g] = v.x;
      o_im[g] = v.y;
    }
  }
  cluster_wait();
}

// cudaOccupancyMaxActiveClusters of one launch shape, asked once per
// (device, shared memory, threads, cluster size) in a process.
inline cudaError_t cluster_fits(const cudaLaunchConfig_t& config, int cluster) {
  static std::mutex lock;
  static std::map<std::tuple<int, size_t, unsigned, int>, int> known;
  int device = 0;
  cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  const auto key = std::make_tuple(device, config.dynamicSmemBytes,
                                   config.blockDim.x, cluster);
  std::lock_guard<std::mutex> guard(lock);
  auto it = known.find(key);
  if (it == known.end()) {
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &active, stockham_rows_cluster_kernel, &config);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, active).first;
  }
  return it->second > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

inline int launch_cluster_rows(const void* re, const void* im, void* out_re,
                               void* out_im, const void* tables, int channels,
                               int m, int n, int rows, int cluster,
                               void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      cluster > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = cluster_smem_bytes(rows, n, cluster);
  cudaError_t err = allow_smem(stockham_rows_cluster_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + rows - 1) / rows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((blocks + cluster - 1) / cluster * cluster, channels);
  config.blockDim = dim3(block_threads(rows, n));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  err = cluster_fits(config, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, stockham_rows_cluster_kernel,
                           static_cast<const float*>(re),
                           static_cast<const float*>(im),
                           static_cast<float*>(out_re),
                           static_cast<float*>(out_im),
                           static_cast<const float2*>(tables), m, n,
                           log2_of(n), log2_of(rows), log2_of(cluster));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpu_fft
