// Gerstner wave bank: W trochoidal waves summed per grid point.
//
// Replaces: tpu_ocean/ops/gerstner_pallas.py, _gerstner_kernel (launched by
// gerstner_pallas). Per point (x, z) of [M, N] f32 grids and per wave w of
// the [6, W] bank (amps, steeps, dirs_x, dirs_z, freqs, omegas):
//   φ = f·(x·dx + z·dz) + ω·t
//   ox += s·a·dx·cos φ,  oz += s·a·dz·cos φ,  oy += a·sin φ
//   nx −= dx·f·a·cos φ,  nz −= dz·f·a·cos φ,  ny −= s·f·a·sin φ
// then, "analytic", n = (nx, 1 + ny, nz)·(1/√(nx² + (1 + ny)² + nz²)); or
// "flat", the reference's n = (0, 1, 0) (MistralWaterLib.cginc:98).
// Outputs: ox, oy, oz as [M, N] planes and the normal interleaved [M, N, 3].
//
// Every product and sum is rounded on its own (no FMA contraction), in the
// order of the plain version's torch ops (ops/gerstner_bank.py); the
// per-wave products of bank scalars (s·a·dx, ω·t, ...) are rounded once, in
// that left-to-right order, as the plain version forms them from 0-d f32
// tensors. sin and cos come from the precise sincosf: the phases reach
// several hundred radians at 512² (|x|, |z| up to 256), where the error of
// the __sincosf intrinsic grows with |φ|. The normal is divided by an IEEE
// square root and reciprocal, as the plain version divides it.
//
// What bounds it on the H100: arithmetic at W = 16. Memory is 32 B per point
// (x, z in; ox, oy, oz and the normal out): 537 MB at 4096², 0.16 ms at
// 3.35 TB/s. Operations are the TPU kernel's cost estimate, 20 per wave per
// point, plus one sincosf, whose fast path (|φ| < 105615) is 20 f32
// instructions in the SASS for sm_90a (11 FFMA, 2 FMUL, 4 FSEL, FSETP, F2I,
// I2FP): 640 a point at W = 16, also 0.16 ms at 67 TFLOP/s at 4096². The
// compiled loop issues 57 instructions per wave (integer, shared loads and
// the branch included), so the instruction issue rate, not HBM, sets the
// pace.
//
// What the design does about that: one thread per point, a warp along a
// row, so the loads and stores are coalesced and each byte moves once. The
// per-wave constants (f, dx, dz, ω·t and the six products of bank scalars)
// are formed once per block and staged in shared memory, where every
// thread of a warp reads the same wave at once (a broadcast); the loop then
// does 5 operations for the phase, one sincosf, and 12 (analytic) or 6
// (flat) for the sums. The TPU kernel's row blocking (_pick_rows) was VMEM
// sizing and is not carried over: any [M, N] and any W up to kMaxWaves.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWaves = 1024;   // 40 B each: 40 KB of shared memory

struct Wave {
  float f, dx, dz, wt;   // frequency, direction, ω·t
  float cx, cz, a;       // s·a·dx, s·a·dz, a: the offsets' weights
  float nxc, nzc, nyc;   // dx·f·a, dz·f·a, s·f·a: the normal's weights
};

template <bool kAnalytic>
__global__ void __launch_bounds__(kThreads)
gerstner_bank_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     const float* __restrict__ bank, float* __restrict__ ox,
                     float* __restrict__ oy, float* __restrict__ oz,
                     float* __restrict__ normal, long long points, int W,
                     float t) {
  extern __shared__ Wave waves[];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float amp = bank[w], steep = bank[W + w], dx = bank[2 * W + w],
                dz = bank[3 * W + w], f = bank[4 * W + w],
                omega = bank[5 * W + w];
    Wave v;
    v.f = f;
    v.dx = dx;
    v.dz = dz;
    v.wt = __fmul_rn(omega, t);
    v.cx = __fmul_rn(__fmul_rn(steep, amp), dx);
    v.cz = __fmul_rn(__fmul_rn(steep, amp), dz);
    v.a = amp;
    v.nxc = __fmul_rn(__fmul_rn(dx, f), amp);
    v.nzc = __fmul_rn(__fmul_rn(dz, f), amp);
    v.nyc = __fmul_rn(__fmul_rn(steep, f), amp);
    waves[w] = v;
  }
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= points) return;
  const float px = x[p], pz = z[p];
  float sx = 0.f, sy = 0.f, sz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  for (int w = 0; w < W; ++w) {
    const Wave& v = waves[w];
    const float phase = __fadd_rn(
        __fmul_rn(v.f, __fadd_rn(__fmul_rn(px, v.dx), __fmul_rn(pz, v.dz))),
        v.wt);
    float s, c;
    sincosf(phase, &s, &c);
    sx = __fadd_rn(sx, __fmul_rn(v.cx, c));
    sz = __fadd_rn(sz, __fmul_rn(v.cz, c));
    sy = __fadd_rn(sy, __fmul_rn(v.a, s));
    if (kAnalytic) {
      nx = __fsub_rn(nx, __fmul_rn(v.nxc, c));
      nz = __fsub_rn(nz, __fmul_rn(v.nzc, c));
      ny = __fsub_rn(ny, __fmul_rn(v.nyc, s));
    }
  }
  ox[p] = sx;
  oy[p] = sy;
  oz[p] = sz;
  if (kAnalytic) {
    const float ny1 = __fadd_rn(1.f, ny);
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny1, ny1)), __fmul_rn(nz, nz))));
    normal[3 * p] = __fmul_rn(nx, inv);
    normal[3 * p + 1] = __fmul_rn(ny1, inv);
    normal[3 * p + 2] = __fmul_rn(nz, inv);
  } else {
    normal[3 * p] = 0.f;
    normal[3 * p + 1] = 1.f;
    normal[3 * p + 2] = 0.f;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int,
// or cudaErrorInvalidValue for a bank of no waves or more than kMaxWaves.
// The caller checks shapes, types and contiguity.
int tpu_gerstner_bank(const void* x, const void* z, const void* bank,
                      void* ox, void* oy, void* oz, void* normal, int m, int n,
                      int w, float t, int analytic, void* stream) {
  if (w <= 0 || w > kMaxWaves) return static_cast<int>(cudaErrorInvalidValue);
  const long long points = static_cast<long long>(m) * n;
  const unsigned blocks = static_cast<unsigned>((points + kThreads - 1) / kThreads);
  const size_t smem = sizeof(Wave) * static_cast<size_t>(w);
  auto kernel = analytic ? gerstner_bank_kernel<true> : gerstner_bank_kernel<false>;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(bank), static_cast<float*>(ox),
      static_cast<float*>(oy), static_cast<float*>(oz),
      static_cast<float*>(normal), points, w, t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
