// Surface-fields stencil, the halo form: normals, Jacobian and whitecap foam
// from four edge cross products.
//
// Replaces: tpu_ocean/ops/fields_pallas.py, _fields_kernel (launched by
// _fields_pallas_impl when FIELDS_KERNEL_V2 is False). Per point (i, j) of
// [M, N] planes p = (dx, h, dz), periodic on both axes
// (OceanNormal.shader:39-56, WhiteCap.shader:33-45), in the TPU kernel's
// order (fields_pallas.py:104-140):
//   right  = p[i+1, j] − p + (texel, 0, 0)    left   = p[i−1, j] − p + (−texel, 0, 0)
//   top    = p[i, j−1] − p + (0, 0, −texel)   bottom = p[i, j+1] − p + (0, 0, texel)
//   n = c1 + c2 + c3 + c4, c1 = right × top, c2 = top × left,
//       c3 = left × bottom, c4 = bottom × right;  n ← n·(1/|n|)
//   dd*_x/z = −0.5·(a[i−1] − a[i+1])/8 and −0.5·(a[j−1] − a[j+1])/8 of dx, dz
//   J = (1 + ddx_x)(1 + ddy_z) − ddx_z·ddy_x
//   foam = smoothstep(clamp(1 − J + 0.3·sqrt(nx² + nz²), 0, 1))
// Outputs: the normal interleaved as [M, N, 3], foam and J. Every product
// and sum is rounded on its own (no FMA contraction), in the order of the
// plain version's torch ops (ops/fields_stencil.py, fields_stencil_v1_plain).
//
// What bounds it on the H100: device memory, 3 planes in and 5 out, 32 B
// per point (33.5 MB at 1024²), against ~70 flops per point; the halo adds
// reads that mostly hit L2.
//
// What the design does about that: the GPU form of the TPU kernel's halo
// DMA. Each block stages a tile of kTileRows × kTileCols points of the
// three input planes in shared memory, with one wrapped halo row above and
// below and one wrapped halo column on each side (periodic wrap by modular
// indices), so every input byte is read from device memory about once and
// the four neighbours come from shared memory. The TPU kernel kept whole
// rows resident (the column neighbours were lane rolls); whole rows of
// three planes exceed a block's shared memory at N = 8192 and leave one
// block per SM at 4096, so the tile is two-dimensional. The TPU's 8-row
// halo bands and its M % 8 rule came from Mosaic's DMA alignment and are
// not carried over: any [M, N] works.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 32;                  // one warp along a row
constexpr int kThreadRows = 8;                 // blockDim (32, 8)
constexpr int kRowsPerThread = 2;
constexpr int kTileRows = kThreadRows * kRowsPerThread;
constexpr int kStride = kTileCols + 2;         // halo column on each side

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec cross(const Vec& a, const Vec& b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

__device__ __forceinline__ float whitecap_diff(float back, float fwd) {
  // −0.5·(back − fwd)/8, as the TPU kernel writes it
  return __fdiv_rn(__fmul_rn(-0.5f, __fsub_rn(back, fwd)), 8.0f);
}

__global__ void __launch_bounds__(kTileCols * kThreadRows)
fields_stencil_v1_kernel(const float* __restrict__ dx,
                         const float* __restrict__ h,
                         const float* __restrict__ dz,
                         float* __restrict__ normal, float* __restrict__ foam,
                         float* __restrict__ jac, int M, int N, float texel) {
  __shared__ float tile[3][kTileRows + 2][kStride];
  const int i0 = blockIdx.y * kTileRows;
  const int j0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;

  // the tile and its halo, wrapped; rows and columns past M and N (the
  // ragged last tiles) wrap too and are never stored
  for (int idx = tid; idx < (kTileRows + 2) * kStride;
       idx += kTileCols * kThreadRows) {
    const int r = idx / kStride, c = idx % kStride;
    int gi = (i0 - 1 + r) % M;
    int gj = (j0 - 1 + c) % N;
    if (gi < 0) gi += M;
    if (gj < 0) gj += N;
    const size_t g = static_cast<size_t>(gi) * N + gj;
    tile[0][r][c] = dx[g];
    tile[1][r][c] = h[g];
    tile[2][r][c] = dz[g];
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  const int c = threadIdx.x + 1;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + k * kThreadRows + 1;
    const int i = i0 + r - 1;
    if (i >= M || j >= N) continue;
    const Vec p = {tile[0][r][c], tile[1][r][c], tile[2][r][c]};

    auto edge = [&](int rr, int cc, float ox, float oz) -> Vec {
      return {__fadd_rn(__fsub_rn(tile[0][rr][cc], p.x), ox),
              __fsub_rn(tile[1][rr][cc], p.y),
              __fadd_rn(__fsub_rn(tile[2][rr][cc], p.z), oz)};
    };
    const Vec right = edge(r + 1, c, texel, 0.f);
    const Vec left = edge(r - 1, c, -texel, 0.f);
    const Vec top = edge(r, c - 1, 0.f, -texel);
    const Vec bottom = edge(r, c + 1, 0.f, texel);
    const Vec c1 = cross(right, top), c2 = cross(top, left),
              c3 = cross(left, bottom), c4 = cross(bottom, right);
    float nx = __fadd_rn(__fadd_rn(__fadd_rn(c1.x, c2.x), c3.x), c4.x);
    float ny = __fadd_rn(__fadd_rn(__fadd_rn(c1.y, c2.y), c3.y), c4.y);
    float nz = __fadd_rn(__fadd_rn(__fadd_rn(c1.z, c2.z), c3.z), c4.z);
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz))));
    nx = __fmul_rn(nx, inv);
    ny = __fmul_rn(ny, inv);
    nz = __fmul_rn(nz, inv);

    const float ddx_x = whitecap_diff(tile[0][r - 1][c], tile[0][r + 1][c]);
    const float ddx_z = whitecap_diff(tile[2][r - 1][c], tile[2][r + 1][c]);
    const float ddy_x = whitecap_diff(tile[0][r][c - 1], tile[0][r][c + 1]);
    const float ddy_z = whitecap_diff(tile[2][r][c - 1], tile[2][r][c + 1]);
    const float j_val =
        __fsub_rn(__fmul_rn(__fadd_rn(1.f, ddx_x), __fadd_rn(1.f, ddy_z)),
                  __fmul_rn(ddx_z, ddy_x));
    const float noise = __fmul_rn(
        0.3f, __fsqrt_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(nz, nz))));
    float t = __fadd_rn(__fsub_rn(1.f, j_val), noise);
    t = fminf(fmaxf(t, 0.f), 1.f);

    const size_t q = static_cast<size_t>(i) * N + j;
    normal[3 * q] = nx;
    normal[3 * q + 1] = ny;
    normal[3 * q + 2] = nz;
    foam[q] = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.f, __fmul_rn(2.f, t)));
    jac[q] = j_val;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// The caller checks shapes, types and contiguity.
int tpu_fields_stencil_v1(const void* dx, const void* h, const void* dz,
                          void* normal, void* foam, void* jac, int m, int n,
                          float texel, void* stream) {
  const dim3 block(kTileCols, kThreadRows);
  const dim3 grid((n + kTileCols - 1) / kTileCols,
                  (m + kTileRows - 1) / kTileRows);
  fields_stencil_v1_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dx), static_cast<const float*>(h),
      static_cast<const float*>(dz), static_cast<float*>(normal),
      static_cast<float*>(foam), static_cast<float*>(jac), m, n, texel);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
