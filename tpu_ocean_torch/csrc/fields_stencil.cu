// Fused surface-fields stencil: normals, Jacobian and whitecap foam.
//
// Replaces: tpu_ocean/ops/fields_pallas.py, _fields_kernel_v2 (launched by
// fields_pallas_v2). Per point (i, j) of [M, N] planes, periodic on both
// axes (OceanNormal.shader:39-56, WhiteCap.shader:33-45):
//   dd* = a[i+1] − a[i−1]  and  dz* = a[j−1] − a[j+1]  of dx, h, dz
//   u = (ddx + 2·texel, ddh, ddz),  v = (dzx, dzh, dzz − 2·texel)
//   n = cross(u, v) / |cross(u, v)|
//   J = (1 + ddx/16)(1 − dzz/16) − (ddz/16)(−dzx/16)
//   foam = smoothstep(clamp(1 − J + 0.3·sqrt(nx² + nz²), 0, 1))
// Inputs are the chop-scaled displacements and the height; outputs are the
// normal interleaved as [M, N, 3], foam and J.
//
// What bounds it on the H100: device memory, 3 planes in and 5 out, 32 B
// per point (33.5 MB at 1024²), against about 40 flops per point.
//
// What the design does about that: one thread per point, a warp along a
// row, so every plane read and the interleaved normal write are coalesced.
// The four neighbours come through the L1 cache, which serves the rows a
// block shares; each input byte comes from device memory about once. The
// TPU kernel's boundary-row gather and 8-row block rule were artefacts of
// its VMEM blocking: here neighbour rows are read with modular indices.
// The normal is divided by an IEEE sqrt, not rsqrtf, as the plain version
// divides it.

#include <cuda_runtime.h>

namespace {

__global__ void fields_stencil_kernel(const float* __restrict__ dx,
                                      const float* __restrict__ h,
                                      const float* __restrict__ dz,
                                      float* __restrict__ normal,
                                      float* __restrict__ foam,
                                      float* __restrict__ jac,
                                      int M, int N, float texel) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= M || j >= N) return;
  const size_t row = static_cast<size_t>(i) * N;
  const size_t ip = static_cast<size_t>(i + 1 == M ? 0 : i + 1) * N;
  const size_t im = static_cast<size_t>(i == 0 ? M - 1 : i - 1) * N;
  const int jm = j == 0 ? N - 1 : j - 1;
  const int jp = j + 1 == N ? 0 : j + 1;

  const float ddx = dx[ip + j] - dx[im + j];
  const float ddh = h[ip + j] - h[im + j];
  const float ddz = dz[ip + j] - dz[im + j];
  const float dzx = dx[row + jm] - dx[row + jp];
  const float dzh = h[row + jm] - h[row + jp];
  const float dzz = dz[row + jm] - dz[row + jp];

  const float ux = ddx + 2.0f * texel, uy = ddh, uz = ddz;
  const float vx = dzx, vy = dzh, vz = dzz - 2.0f * texel;
  // Where u and v are nearly parallel the cross product cancels and the
  // normalization amplifies its rounding by 1/sin(u, v), so these products
  // are rounded one by one (no FMA contraction), as the plain version's
  // separate torch ops round them.
  float nx = __fsub_rn(__fmul_rn(uy, vz), __fmul_rn(uz, vy));
  float ny = __fsub_rn(__fmul_rn(uz, vx), __fmul_rn(ux, vz));
  float nz = __fsub_rn(__fmul_rn(ux, vy), __fmul_rn(uy, vx));
  const float inv = 1.0f / sqrtf(__fadd_rn(
      __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
  nx *= inv;
  ny *= inv;
  nz *= inv;

  const float j_val = (1.0f + ddx * (1.0f / 16.0f)) *
                          (1.0f + dzz * (-1.0f / 16.0f)) -
                      (ddz * (1.0f / 16.0f)) * (dzx * (-1.0f / 16.0f));
  float t = 1.0f - j_val + 0.3f * sqrtf(nx * nx + nz * nz);
  t = fminf(fmaxf(t, 0.0f), 1.0f);

  const size_t p = row + j;
  normal[3 * p] = nx;
  normal[3 * p + 1] = ny;
  normal[3 * p + 2] = nz;
  foam[p] = t * t * (3.0f - 2.0f * t);
  jac[p] = j_val;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// The caller checks shapes, types and contiguity.
int tpu_fields_stencil(const void* dx, const void* h, const void* dz,
                       void* normal, void* foam, void* jac, int m, int n,
                       float texel, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + block.x - 1) / block.x, (m + block.y - 1) / block.y);
  fields_stencil_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dx), static_cast<const float*>(h),
      static_cast<const float*>(dz), static_cast<float*>(normal),
      static_cast<float*>(foam), static_cast<float*>(jac), m, n, texel);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
