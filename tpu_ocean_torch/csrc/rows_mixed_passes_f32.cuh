// The f32 row DFT at even lengths that are not powers of two, either
// store, with register-resident mixed-radix passes: rows_mixed.cu's
// entry tpu_fft_rows_mixed (f32 in the direct form).
//
// Replaces: tpu_ocean/fft/pallas_fft.py:235 _fft_block_kernel (launched by
// _fft1d_transposed_impl) and :677 _rowfft_block_kernel_natural (launched
// by _fft1d_natural_large_impl) at HIGHEST, at the lengths the power-of-two
// kernels do not take (N = 96, 1536, 3072, 2·53, …). The JAX kernels run
// there as a four-step matrix DFT on any split N = n2·n1 (_split_lanes
// :44), a form chosen for the TPU's matrix unit; this kernel computes the
// same sums, with fft_rows.cu's contract:
//   in  (re, im) f32 [C, M, N], contiguous, N even in [16, 8192], not a
//       power of two
//   out transposed (re, im) f32 [C, N, M], out[c, k, m] = Σ_n x[c, m, n]
//       e^{±2πi nk/N} (+ for the inverse), unnormalized;
//   out natural    (re, im) f32 [C, M, N], out[c, m, k] = the same sum.
//
// What bounds it on the H100: device memory where N's primes are small, 16
// B a point (8 read, 8 written): 37.7 MB, 0.0113 ms at 3.35 TB/s for
// [1, 1536, 1536]; where N has a large prime p (2042 = 2·1021, 8186 =
// 2·4093) the generic p-point pass, N·p complex multiply-adds a row, read
// from shared memory.
//
// What the stages it replaces lost (rows_mixed_f32.cuh's, 0.12–0.20 of
// the bound at the paths' shapes on an H100 80GB HBM3 at 700 W): every
// factor of N ran as a stage through two ping-pong shared buffers behind
// a barrier (6 stages and a separate twiddle pass at 1536 = 2·4⁴·3), the
// load and the store were two more trips through shared memory, every
// point of every stage paid integer divisions, a radix 3, 5 or 7 ran the
// generic p-point sum, and the two buffers and the table (209 KB at 1536,
// R = 8) left one block an SM.
//
// What this design does about it, after the radix-16 natural kernel
// (rows_natural_f32.cuh):
// - The plan (planes.passes_plan, the one place it is planned; the entry
//   only checks it, read_plan) writes N = s · Π p, s the part in primes 2,
//   3, 5, 7, p the larger primes. s runs as Stockham autosort passes of
//   radix ρ ∈ {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16}, the fewest
//   passes (1536 = 16·16·6, 3072 = 16·16·12, 768 = 16·16·3, 6144 =
//   16·16·8·3), largest first; each p one generic pass after them (8190 =
//   15·14·3 · 13, 106 = 2 · 53). Pass i of radix ρ and span ns (the product
//   of the radices before it) takes butterfly j < L = N/ρ's inputs at
//   j + s·L, twiddles input s by e^{±2πi s·(j mod ns)/(ρ·ns)} and writes
//   output s at (j / ns)·ρ·ns + (j mod ns) + s·ns. After the last pass the
//   row is in natural order.
// - A row takes T threads (planes.passes_threads): in a register pass a
//   thread holds the butterflies j = t + T·q, q < 16/ρ, in registers (16
//   points at most); T is the least number that covers every pass so, and
//   a generic pass with one item a thread where at most 512 threads do
//   (rounded up to a power of two below 16, else to a multiple of 16).
//   Lanes past a pass's L idle in it.
// - The butterflies run in registers: 2, 4, 8 and 16 on radix16's; 3, 5 and
//   7 as sums over conjugate pairs (x_s ± x_{ρ−s}); 6, 9, 10, 12, 14 and 15
//   as two of those with compile-time twiddles (dft_split). Every constant
//   is cos and sin of 2π·m/ρ rounded from float64. The twiddles of a pass
//   are read from the table (planes.passes_twiddles) through the read-only
//   cache, consecutive threads at consecutive entries.
// - The first pass reads x from device memory, all of a thread's loads
//   issued before any is used; the natural store's last pass writes `out`
//   from registers (its span is L, so output s of butterfly j lies at
//   j + s·L): consecutive threads at consecutive addresses, coalesced.
// - Between two passes one exchange through one buffer: a pass reads its
//   inputs, waits at a barrier, writes its outputs, waits again. 1536 takes
//   2 exchanges (5 before) and 4 barriers.
// - The index maps: j mod ns and j / L by a multiply-high with a reciprocal
//   the host computes from the plan (exact for j·ns < 2^32); no division
//   runs a point.
// - A generic pass (a prime p > 7) keeps the stage it replaces' arithmetic
//   bit for bit (rows_mixed_f32.cuh stage_odd): its inputs twiddled in place
//   in the buffer, then each output (q, j) as Σ_t x[j + t·L]·ω^{(t·q) mod p}
//   in 8 accumulators taken in turn, folded into a total every 64 terms;
//   the p-th roots, and its twiddles where at most 2048, staged in shared
//   memory at the start; at N = 2p (L = 2) a thread takes the pair (q, 0),
//   (q, 1) together, one 16-byte read and one root a term for both sums.
//   Its outputs go straight to `out` or to a tile beside the buffer, and
//   wait in a local array where they go back into the buffer. The
//   generic sums are bound by shared-memory reads of the roots (a warp's
//   lanes read up to 16 different roots a term), as the stages' were.
// - Three builds of the kernel (Code), so that each plan runs no more code
//   than it needs: the register passes alone; with the generic pass too;
//   radix 2 and the generic pass (N = 2p). With the generic pass's code in
//   the same kernel the register passes ran up to 2.4× slower on the
//   H100. The natural store of register passes at up to 128 registers a
//   thread, where its block has at most 512 threads (64 spilled: [1, 3072,
//   3072] 0.1106 against 0.0773 ms); the transposed store at 64, two
//   blocks of 512 threads an SM (128: [1, 3072, 3072] 0.1360 against
//   0.1115 ms), as the kernels with a generic pass
//   (tools/mixed_passes_variants.py).
//
// Shared memory (mixed_passes::shared_bytes, planes.passes_shared_bytes its
// twin): the exchange buffer, R rows of S = planes.passes_stride(N) complex;
// point a of a row at a + (a >> e), e = 4 (a pad every 16 points) where the
// first radix is even, none where it is odd or the plan has a generic pass
// (planes.passes_pad). 64-bit accesses are served a half warp at a time;
// the first pass writes output s of butterfly j at ρ·j + s, and with an
// even ρ the pad puts 16 consecutive j on 16 bank pairs (at ρ = 16 without
// it all share one), with an odd ρ the stride alone does and a pad would
// not (15 of 16 on one pair at ρ = 15). Later passes write runs of ns
// consecutive points and every pass reads runs of consecutive points, on
// distinct pairs but where a run crosses a pad. Rows with fewer than 16
// threads share a half warp: S is then ≡ T (mod 16). Then the transposed
// store's tile where it lies beside the buffer, a cluster's gathered tile,
// the table's staged tail and the plan's passes.
//
// The transposed store writes out[c, k, m0 + r] with r fastest, through a
// tile of R rows at stride G = gather_stride(R, N) (stockham.cuh), in the
// exchange buffer (beside it in a plan with a generic pass), into which
// the last pass writes its outputs: with a cluster of K = 1 the block
// reads R rows at one k, runs of R floats (the tile store of
// fused_rows_transposed_f32.cuh); with K > 1 blocks of a thread-block
// cluster (planes.passes_cluster: K·R = 8 where the grid allows, from N =
// 512 on) block j gathers the columns [j·N/K, (j+1)·N/K) of the K·R rows
// through distributed shared memory and stores runs of K·R floats (the
// cluster store of stockham_rows_cluster.cuh). Rows per block
// (planes.passes_rows): at most 4096 / N natural and 8 transposed (1 where
// a row takes 256 threads or more, in clusters of 8), at most 512 threads
// a block where a row takes fewer, a power of two. Rows past M (the ragged
// last block) load zeros and are never stored.
//
// A length, plan, block or cluster it does not take returns
// cudaErrorInvalidValue; nothing falls back to another kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "rows_natural_f32.cuh"
#include "stockham.cuh"

namespace tpu_fft {
namespace mixed_passes {

namespace cg = cooperative_groups;

constexpr int kMinN = 16;
constexpr int kMaxN = 8192;
constexpr int kMaxPasses = 16;
// the points a thread holds in a register pass (planes.PASS_POINTS) and
// the outputs it holds in a generic pass (planes.PASS_GENERIC_POINTS)
constexpr int kPoints = 16;
constexpr int kGenericPoints = 16;
constexpr int kMaxThreads = 1024;
// blocks of at most this many threads run the kernel built for them, at
// up to 128 registers a thread; larger ones (one row of more than 512
// threads) the one built for kMaxThreads, at 64
constexpr int kBlockThreads = 512;
// the pad shift of a row with no pad (a >> 31 is 0 for every index)
constexpr int kNoPad = 31;
constexpr int kMaxCluster = 8;
constexpr int kAccumulators = 8;
// rounds of kAccumulators terms between two folds into the total
constexpr int kRounds = 8;
constexpr int kGatherInFlight = 8;
// the generic passes' twiddles are staged in shared memory with their
// roots where they are at most this many (planes.PASS_STAGED_TWIDDLES)
constexpr int kStagedTwiddles = 2048;

// One pass: its radix, span ns, lanes L = N/radix, its twiddles' table
// offset, the multipliers of j mod ns and o / L, and for a generic pass
// the offsets of its roots and (where they are staged, else −1) of its
// twiddles in the table's staged tail.
struct Pass {
  int radix;
  int span;
  int lanes;
  int twiddles;
  unsigned span_magic;
  unsigned lanes_magic;
  int roots;
  int staged_twiddles;
};

struct Plan {
  int n;
  int passes;       // 0: refused
  int threads;      // T, threads a row
  int pad;          // point a of a row at a + (a >> pad)
  int stride;       // a row of the exchange buffer, complex
  int roots;        // the generic passes' roots (0: no generic pass)
  int stage_from;   // the table's tail from this entry, staged in shared
  int staged;       // memory: this many entries
  Pass pass[kMaxPasses];
};

// radices run in registers (planes.PASS_RADICES)
inline bool register_radix(int r) {
  switch (r) {
    case 2: case 3: case 4: case 5: case 6: case 7: case 8: case 9: case 10:
    case 12: case 14: case 15: case 16:
      return true;
    default:
      return false;
  }
}

// ⌈2^32 / d⌉ (2^32/d + 1 at a power of two): j / d = umulhi(j, magic) for
// every j with j·d < 2^32
inline unsigned magic(int d) {
  return d > 1 ? 0xFFFFFFFFu / static_cast<unsigned>(d) + 1u : 0u;
}

// The plan from the host's rows (planes.passes_plan_rows): a head (T, pad
// shift, stride, 0), then (radix, span, twiddle offset, roots offset) a
// pass; passes = 0 where they do not describe a length-n transform this
// kernel takes with its table of `table` entries: a register radix whose
// butterflies do not fit T threads of 16 points, a generic pass first or
// of more than 16 outputs a thread, offsets outside the table, spans that
// do not chain to n.
inline Plan read_plan(int n, const int* rows, int passes, int table) {
  Plan p{};
  p.n = n;
  if (n < kMinN || n > kMaxN || (n & 1) || !(n & (n - 1)) || passes < 1 ||
      passes > kMaxPasses || table < 1)
    return p;
  const int T = rows[0];
  p.threads = T;
  p.pad = rows[1];
  p.stride = rows[2];
  if (T < 1 || T > kMaxThreads || p.pad < 1 || p.pad > 31 ||
      p.stride < n + ((n - 1) >> p.pad))
    return p;
  int span = 1;
  int root_table = -1;
  int first_twiddle = table;
  for (int s = 0; s < passes; ++s) {
    const int* r = rows + 4 * (s + 1);
    Pass& ps = p.pass[s];
    ps.radix = r[0];
    ps.span = r[1];
    ps.twiddles = r[2];
    const int root_at = r[3];
    if (ps.radix < 2 || ps.span != span || (n / span) % ps.radix) return p;
    ps.lanes = n / ps.radix;
    ps.span_magic = magic(span);
    ps.lanes_magic = magic(ps.lanes);
    if (span > 1 && (ps.twiddles < 1 ||
                     ps.twiddles + (ps.radix - 1) * span > table))
      return p;
    ps.roots = -1;
    ps.staged_twiddles = -1;
    if (register_radix(ps.radix)) {
      if ((ps.lanes + T - 1) / T > kPoints / ps.radix) return p;
    } else {
      // a generic pass: never the first (which reads device memory), its
      // roots after the previous generic pass's
      // its outputs a thread: the pairs (q, 0), (q, 1) of L = 2, else one
      // output at a time
      const bool pairs = ps.lanes == 2;
      const int items = pairs ? ps.radix : n;
      if (s == 0 || p.pad != kNoPad || root_at < 1 ||
          root_at + ps.radix > table ||
          (items + T - 1) / T > kGenericPoints / (pairs ? 2 : 1))
        return p;
      if (root_table < 0) root_table = root_at;
      if (root_at != root_table + p.roots) return p;
      ps.roots = p.roots;
      p.roots += ps.radix;
      if (ps.twiddles < first_twiddle) first_twiddle = ps.twiddles;
    }
    span *= ps.radix;
  }
  if (span != n) return p;
  if (p.roots > 0) {
    // the roots staged, and the generic passes' twiddles with them (they
    // lie just before the roots) where they are few
    const int count = root_table - first_twiddle;
    p.stage_from =
        count >= 0 && count <= kStagedTwiddles ? first_twiddle : root_table;
    p.staged = root_table + p.roots - p.stage_from;
    for (int s = 0; s < passes; ++s) {
      Pass& ps = p.pass[s];
      if (ps.roots < 0) continue;
      ps.roots += root_table - p.stage_from;
      if (p.stage_from < root_table)
        ps.staged_twiddles = ps.twiddles - p.stage_from;
    }
  }
  p.passes = passes;
  return p;
}

// The exchange buffer and the transposed store's tile of a block of `rows`
// rows, complex: the tile lies in the buffer, but beside it in a plan with
// a generic pass (whose outputs go to the tile while the buffer is read);
// the natural store has none.
__host__ __device__ __forceinline__ int exchange_area(int rows,
                                                      const Plan& plan,
                                                      bool natural) {
  const int tile = gather_stride(rows, plan.n);
  if (natural) return rows * plan.stride;
  if (plan.roots > 0) return rows * (plan.stride + tile);
  return rows * (plan.stride > tile ? plan.stride : tile);
}

// Dynamic shared memory of a block of `rows` rows in clusters of `cluster`
// blocks (planes.passes_shared_bytes): the exchange buffer and the tile,
// the gathered tile of a cluster store, the roots, the plan.
inline int shared_bytes(int rows, const Plan& plan, int cluster,
                        bool natural) {
  int area = exchange_area(rows, plan, natural);
  if (cluster > 1)
    area += cluster * rows * gather_stride(cluster * rows, plan.n / cluster);
  return static_cast<int>((area + plan.staged) * sizeof(float2) +
                          plan.passes * sizeof(Pass));
}

__device__ __forceinline__ int padded(int a, int e) { return a + (a >> e); }

// j / d by its multiplier (d > 1), or j (d = 1)
__device__ __forceinline__ int div_by(int j, int d, unsigned mul) {
  return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(j), mul))
               : j;
}

// (cos, sin) of 2π·m/P, rounded from float64
template <int P>
__device__ __forceinline__ float2 turn(int m) {
  if constexpr (P == 3) {
    constexpr float c[] = {1.0f, -0.5f, -0.5f};
    constexpr float s[] = {0.0f, 0.866025388f, -0.866025388f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 5) {
    constexpr float c[] = {1.0f, 0.309017003f, -0.809017003f, -0.809017003f,
        0.309017003f};
    constexpr float s[] = {0.0f, 0.95105654f, 0.587785244f, -0.587785244f,
        -0.95105654f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 6) {
    constexpr float c[] = {1.0f, 0.5f, -0.5f, -1.0f, -0.5f, 0.5f};
    constexpr float s[] = {0.0f, 0.866025388f, 0.866025388f, 0.0f,
        -0.866025388f, -0.866025388f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 7) {
    constexpr float c[] = {1.0f, 0.623489797f, -0.222520933f, -0.90096885f,
        -0.90096885f, -0.222520933f, 0.623489797f};
    constexpr float s[] = {0.0f, 0.781831503f, 0.974927902f, 0.433883727f,
        -0.433883727f, -0.974927902f, -0.781831503f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 9) {
    constexpr float c[] = {1.0f, 0.766044438f, 0.173648179f, -0.5f,
        -0.939692616f, -0.939692616f, -0.5f, 0.173648179f, 0.766044438f};
    constexpr float s[] = {0.0f, 0.642787635f, 0.98480773f, 0.866025388f,
        0.342020154f, -0.342020154f, -0.866025388f, -0.98480773f,
        -0.642787635f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 10) {
    constexpr float c[] = {1.0f, 0.809017003f, 0.309017003f, -0.309017003f,
        -0.809017003f, -1.0f, -0.809017003f, -0.309017003f, 0.309017003f,
        0.809017003f};
    constexpr float s[] = {0.0f, 0.587785244f, 0.95105654f, 0.95105654f,
        0.587785244f, 0.0f, -0.587785244f, -0.95105654f, -0.95105654f,
        -0.587785244f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 12) {
    constexpr float c[] = {1.0f, 0.866025388f, 0.5f, 0.0f, -0.5f,
        -0.866025388f, -1.0f, -0.866025388f, -0.5f, 0.0f, 0.5f, 0.866025388f};
    constexpr float s[] = {0.0f, 0.5f, 0.866025388f, 1.0f, 0.866025388f, 0.5f,
        0.0f, -0.5f, -0.866025388f, -1.0f, -0.866025388f, -0.5f};
    return make_float2(c[m], s[m]);
  } else if constexpr (P == 14) {
    constexpr float c[] = {1.0f, 0.90096885f, 0.623489797f, 0.222520933f,
        -0.222520933f, -0.623489797f, -0.90096885f, -1.0f, -0.90096885f,
        -0.623489797f, -0.222520933f, 0.222520933f, 0.623489797f,
        0.90096885f};
    constexpr float s[] = {0.0f, 0.433883727f, 0.781831503f, 0.974927902f,
        0.974927902f, 0.781831503f, 0.433883727f, 0.0f, -0.433883727f,
        -0.781831503f, -0.974927902f, -0.974927902f, -0.781831503f,
        -0.433883727f};
    return make_float2(c[m], s[m]);
  } else {
    static_assert(P == 15, "no table for this radix");
    constexpr float c[] = {1.0f, 0.91354543f, 0.669130623f, 0.309017003f,
        -0.104528464f, -0.5f, -0.809017003f, -0.978147626f, -0.978147626f,
        -0.809017003f, -0.5f, -0.104528464f, 0.309017003f, 0.669130623f,
        0.91354543f};
    constexpr float s[] = {0.0f, 0.406736642f, 0.74314481f, 0.95105654f,
        0.994521916f, 0.866025388f, 0.587785244f, 0.207911685f, -0.207911685f,
        -0.587785244f, -0.866025388f, -0.994521916f, -0.95105654f,
        -0.74314481f, -0.406736642f};
    return make_float2(c[m], s[m]);
  }
}

// a · e^{±2πi·m/P}, sg = +1 for the inverse
template <int P>
__device__ __forceinline__ float2 twist(float2 a, int m, float sg) {
  const float2 w = turn<P>(m);
  const float s = sg * w.y;
  return make_float2(a.x * w.x - a.y * s, a.x * s + a.y * w.x);
}

template <int P>
__device__ __forceinline__ void dft(float2 (&u)[P], float sg);

// The P-point DFT of an odd prime P over conjugate pairs: a_s = u_s +
// u_{P−s}, b_s = u_s − u_{P−s}, y_q = u_0 + Σ_s a_s·cos(2π·sq/P) ±
// i·Σ_s b_s·sin(2π·sq/P), y_{P−q} the same with the sign of the second sum
// turned; in place, natural order.
template <int P>
__device__ __forceinline__ void dft_odd(float2 (&u)[P], float sg) {
  constexpr int H = (P - 1) / 2;
  float2 a[H + 1], b[H + 1];
  float2 y0 = u[0];
#pragma unroll
  for (int s = 1; s <= H; ++s) {
    a[s] = radix16::add(u[s], u[P - s]);
    b[s] = radix16::sub(u[s], u[P - s]);
    y0 = radix16::add(y0, a[s]);
  }
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 even = u[0];
    float2 odd = make_float2(0.f, 0.f);
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      const float2 w = turn<P>((s * q) % P);
      even = make_float2(fmaf(a[s].x, w.x, even.x), fmaf(a[s].y, w.x, even.y));
      odd = make_float2(fmaf(b[s].x, w.y, odd.x), fmaf(b[s].y, w.y, odd.y));
    }
    const float2 j = radix16::rot_i(odd, sg);
    u[q] = radix16::add(even, j);
    u[P - q] = radix16::sub(even, j);
  }
  u[0] = y0;
}

// The P = A·B point DFT as B DFTs of A points, twiddles e^{±2πi·n2·k1/P},
// A DFTs of B points: input n = B·n1 + n2, output k = k1 + A·k2; in place,
// natural order.
template <int A, int B>
__device__ __forceinline__ void dft_split(float2 (&u)[A * B], float sg) {
  constexpr int P = A * B;
  float2 y[B][A];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    float2 w[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) w[n1] = u[B * n1 + n2];
    dft<A>(w, sg);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1)
      y[n2][k1] = n2 * k1 == 0 ? w[k1] : twist<P>(w[k1], n2 * k1, sg);
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 z[B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) z[n2] = y[n2][k1];
    dft<B>(z, sg);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) u[k1 + A * k2] = z[k2];
  }
}

// The P-point DFT in registers, in place, natural order
template <int P>
__device__ __forceinline__ void dft(float2 (&u)[P], float sg) {
  if constexpr (P == 2) {
    radix16::dft2(u[0], u[1]);
  } else if constexpr (P == 4) {
    radix16::dft4(u[0], u[1], u[2], u[3], sg);
  } else if constexpr (P == 8) {
    radix16::dft8(u, sg);
  } else if constexpr (P == 16) {
    radix16::dft16(u, sg);
  } else if constexpr (P == 3 || P == 5 || P == 7) {
    dft_odd<P>(u, sg);
  } else if constexpr (P == 6 || P == 10 || P == 14) {
    dft_split<2, P / 2>(u, sg);
  } else if constexpr (P == 12) {
    dft_split<4, 3>(u, sg);
  } else {
    static_assert(P == 9 || P == 15, "no such radix");
    dft_split<3, P / 3>(u, sg);
  }
}

// Where a pass writes its outputs: the exchange buffer (a pass before the
// last), `out` in natural order (the natural store's last pass), the tile
// (the transposed store's last pass)
enum Dest { kToBuffer, kToOutput, kToTile };

// One row's view of the block: its input and natural output, its slots of
// the exchange buffer and of the tile, thread t of T
struct Row {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  float2* buf;
  float2* tile;
  int t;
  int T;
  int pad;
  bool live;
};

// A register pass of radix P: this thread's butterflies j = t + T·q < L,
// q < 16/P, input s of butterfly q in v[q·P + s]. Every thread of the block
// calls it together (it holds barriers); one that reads the buffer waits
// before it writes it, one that writes the buffer waits after.
template <int P>
__device__ __forceinline__ void register_pass(float2 (&v)[kPoints],
                                              const Pass& ps, const Row& w,
                                              const float2* __restrict__ tw,
                                              float sg, bool first, Dest to) {
  constexpr int G = kPoints / P;
  const int L = ps.lanes;
  const int ns = ps.span;
  if (first) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = w.t + w.T * q;
      const bool on = w.live && j < L;
#pragma unroll
      for (int s = 0; s < P; ++s)
        v[q * P + s] = on ? make_float2(__ldg(w.in_re + j + s * L),
                                        __ldg(w.in_im + j + s * L))
                          : make_float2(0.f, 0.f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = w.t + w.T * q;
      if (j < L) {
#pragma unroll
        for (int s = 0; s < P; ++s)
          v[q * P + s] = w.buf[padded(j + s * L, w.pad)];
      }
    }
    // every thread has read its inputs before any writes its outputs
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = w.t + w.T * q;
    if (j < L) {
      float2 u[P];
#pragma unroll
      for (int s = 0; s < P; ++s) u[s] = v[q * P + s];
      if (ns > 1) {
        const int k = j - div_by(j, ns, ps.span_magic) * ns;
        const float2* at = tw + ps.twiddles + k;
#pragma unroll
        for (int s = 1; s < P; ++s)
          u[s] = cmul(u[s], __ldg(at + (s - 1) * ns));
      }
      dft<P>(u, sg);
#pragma unroll
      for (int s = 0; s < P; ++s) v[q * P + s] = u[s];
    }
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = w.t + w.T * q;
    if (j >= L) continue;
    if (to == kToBuffer) {
      const int k = j - div_by(j, ns, ps.span_magic) * ns;
      const int base = (j - k) * P + k;
#pragma unroll
      for (int s = 0; s < P; ++s)
        w.buf[padded(base + s * ns, w.pad)] = v[q * P + s];
    } else if (to == kToOutput) {
      // the last pass's span is L: output s at j + s·L
      if (w.live) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
          w.out_re[j + s * L] = v[q * P + s].x;
          w.out_im[j + s * L] = v[q * P + s].y;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < P; ++s) w.tile[j + s * L] = v[q * P + s];
    }
  }
  if (to == kToBuffer) __syncthreads();
}

// acc + x·w, each part two fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.x = fmaf(-x.y, w.y, acc.x);
  acc.y = fmaf(x.x, w.y, acc.y);
  acc.y = fmaf(x.y, w.x, acc.y);
  return acc;
}

// the pairwise sum of kAccumulators = 8 values
static_assert(kAccumulators == 8, "sum8 adds 8 accumulators");
__device__ __forceinline__ float2 sum8(const float2* a) {
  using radix16::add;
  return add(add(add(a[0], a[1]), add(a[2], a[3])),
             add(add(a[4], a[5]), add(a[6], a[7])));
}

// Output q of butterfly j of a generic pass of radix p over the (twiddled)
// row at x = buf + j: Σ_t x[t·L]·roots[(t·q) mod p], term t into
// accumulator t mod 8, the 8 summed pairwise into the total every kRounds
// rounds (64 terms) and at the end: rows_mixed_f32.cuh's stage_odd, term
// for term.
__device__ __forceinline__ float2 prime_sum(const float2* x, int L, int p,
                                            int q, const float2* roots) {
  float2 acc[kAccumulators];
#pragma unroll
  for (int u = 0; u < kAccumulators; ++u) acc[u] = make_float2(0.f, 0.f);
  float2 total = make_float2(0.f, 0.f);
  int e = 0;                                   // (t·q) mod p
  int t = 0;
  for (; t + kAccumulators * kRounds <= p; t += kAccumulators * kRounds) {
#pragma unroll
    for (int i = 0; i < kAccumulators * kRounds; ++i) {
      const int u = i % kAccumulators;
      acc[u] = cmac(acc[u], x[(t + i) * L], roots[e]);
      e += q;
      if (e >= p) e -= p;
    }
    total = radix16::add(total, sum8(acc));
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
  return radix16::add(total, sum8(acc));
}

// Outputs (q, 0) and (q, 1) of a generic pass whose L is 2 (N = 2p, the
// last pass) over the row at x: prime_sum's sums for j = 0 and 1 together,
// term for term, so that a term's two inputs are one 16-byte read and its
// root is read once for both.
__device__ __forceinline__ void prime_sum_pair(const float2* x, int p, int q,
                                               const float2* roots,
                                               float2& y0, float2& y1) {
  const float4* x2 = reinterpret_cast<const float4*>(x);
  float2 a0[kAccumulators], a1[kAccumulators];
#pragma unroll
  for (int u = 0; u < kAccumulators; ++u)
    a0[u] = a1[u] = make_float2(0.f, 0.f);
  float2 t0 = make_float2(0.f, 0.f), t1 = t0;
  int e = 0;                                   // (t·q) mod p
  int t = 0;
  for (; t + kAccumulators * kRounds <= p; t += kAccumulators * kRounds) {
    // a round at a time: twice prime_sum's accumulators in registers
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int u = 0; u < kAccumulators; ++u) {
        const float4 v = x2[t + r * kAccumulators + u];
        const float2 w = roots[e];
        a0[u] = cmac(a0[u], make_float2(v.x, v.y), w);
        a1[u] = cmac(a1[u], make_float2(v.z, v.w), w);
        e += q;
        if (e >= p) e -= p;
      }
    }
    t0 = radix16::add(t0, sum8(a0));
    t1 = radix16::add(t1, sum8(a1));
#pragma unroll
    for (int u = 0; u < kAccumulators; ++u)
      a0[u] = a1[u] = make_float2(0.f, 0.f);
  }
  for (; t < p; t += kAccumulators) {
#pragma unroll
    for (int u = 0; u < kAccumulators; ++u) {
      if (t + u < p) {
        const float4 v = x2[t + u];
        const float2 w = roots[e];
        a0[u] = cmac(a0[u], make_float2(v.x, v.y), w);
        a1[u] = cmac(a1[u], make_float2(v.z, v.w), w);
        e += q;
        if (e >= p) e -= p;
      }
    }
  }
  y0 = radix16::add(t0, sum8(a0));
  y1 = radix16::add(t1, sum8(a1));
}

// A generic pass of radix p (a prime above 7), never the first, on a row
// with no pad (read_plan): its inputs twiddled in place, then this
// thread's outputs o = t + T·u < N one at a time (one copy of the sums in
// the code; where L = 2, the pair (q, 0), (q, 1) for q = t + T·u < p),
// held in a local array of kGenericPoints where they go back into the
// buffer or the tile it lies in, written at once to `out` by the natural
// store's last pass. Every thread of the block calls it together.
__device__ __forceinline__ void generic_pass(const Pass& ps, const Row& w,
                                             int N,
                                             const float2* __restrict__ tw,
                                             const float2* staged, Dest to) {
  const int p = ps.radix;
  const int L = ps.lanes;
  const int ns = ps.span;
  const float2* const roots = staged + ps.roots;
  // input q of butterfly j times e^{±2πi q·(j mod ns)/(ns·p)}, in place,
  // the twiddle from shared memory where it is staged
  for (int i = w.t; i < N; i += w.T) {
    const int q = div_by(i, L, ps.lanes_magic);
    if (q == 0) continue;
    const int j = i - q * L;
    const int k = j - div_by(j, ns, ps.span_magic) * ns;
    const int at = (q - 1) * ns + k;
    w.buf[i] = cmul(w.buf[i], ps.staged_twiddles >= 0
                                  ? staged[ps.staged_twiddles + at]
                                  : __ldg(tw + ps.twiddles + at));
  }
  __syncthreads();
  if (L == 2) {
    // N = 2p, the last pass: this thread's q = t + T·u < p, both outputs
    // (q, 0) and (q, 1), at 2q and 2q + 1
#pragma unroll 1
    for (int q = w.t; q < p; q += w.T) {
      float2 y0, y1;
      prime_sum_pair(w.buf, p, q, roots, y0, y1);
      if (to == kToOutput) {
        if (w.live) {
          reinterpret_cast<float2*>(w.out_re)[q] = make_float2(y0.x, y1.x);
          reinterpret_cast<float2*>(w.out_im)[q] = make_float2(y0.y, y1.y);
        }
      } else {
        w.tile[2 * q] = y0;
        w.tile[2 * q + 1] = y1;
      }
    }
    return;
  }
  if (to != kToBuffer) {
    // the last pass's span is L: output (q, j) at o, in `out` or in the
    // tile beside the buffer
#pragma unroll 1
    for (int o = w.t; o < N; o += w.T) {
      const int q = div_by(o, L, ps.lanes_magic);
      const float2 y = prime_sum(w.buf + o - q * L, L, p, q, roots);
      if (to == kToTile) {
        w.tile[o] = y;
      } else if (w.live) {
        w.out_re[o] = y.x;
        w.out_im[o] = y.y;
      }
    }
    return;
  }
  float2 held[kGenericPoints];
  int u = 0;
#pragma unroll 1
  for (int o = w.t; o < N; o += w.T, ++u) {
    const int q = div_by(o, L, ps.lanes_magic);
    held[u] = prime_sum(w.buf + o - q * L, L, p, q, roots);
  }
  // every thread has read the buffer before any writes it
  __syncthreads();
  u = 0;
#pragma unroll 1
  for (int o = w.t; o < N; o += w.T, ++u) {
    const int q = div_by(o, L, ps.lanes_magic);
    const int j = o - q * L;
    const int k = j - div_by(j, ns, ps.span_magic) * ns;
    w.buf[(j - k) * p + k + q * ns] = held[u];
  }
  __syncthreads();
}

// The passes a kernel is built for: the register passes (kRegister), those
// and the generic pass (kAll), or radix 2 and the generic pass, the plans
// of N = 2p (kTwoPrime): a kernel with less code is faster (the register
// passes with the generic pass's code beside them ran up to 2.4× slower on
// the H100, [3, 106, 106] on the whole kernel 5% slower than the stages)
enum Code { kRegister, kAll, kTwoPrime };

// pass `ps` on this row, the block together: its radix's register pass, or
// the generic pass, as far as the kernel's Code has them
template <Code kCode>
__device__ __forceinline__ void run_pass(float2 (&v)[kPoints], const Pass& ps,
                                         const Row& w, int N,
                                         const float2* __restrict__ tw,
                                         const float2* staged, float sg,
                                         bool first, Dest to) {
  if constexpr (kCode == kTwoPrime) {
    if (ps.radix == 2)
      register_pass<2>(v, ps, w, tw, sg, first, to);
    else
      generic_pass(ps, w, N, tw, staged, to);
    return;
  }
  switch (ps.radix) {
    case 2: register_pass<2>(v, ps, w, tw, sg, first, to); break;
    case 3: register_pass<3>(v, ps, w, tw, sg, first, to); break;
    case 4: register_pass<4>(v, ps, w, tw, sg, first, to); break;
    case 5: register_pass<5>(v, ps, w, tw, sg, first, to); break;
    case 6: register_pass<6>(v, ps, w, tw, sg, first, to); break;
    case 7: register_pass<7>(v, ps, w, tw, sg, first, to); break;
    case 8: register_pass<8>(v, ps, w, tw, sg, first, to); break;
    case 9: register_pass<9>(v, ps, w, tw, sg, first, to); break;
    case 10: register_pass<10>(v, ps, w, tw, sg, first, to); break;
    case 12: register_pass<12>(v, ps, w, tw, sg, first, to); break;
    case 14: register_pass<14>(v, ps, w, tw, sg, first, to); break;
    case 15: register_pass<15>(v, ps, w, tw, sg, first, to); break;
    case 16: register_pass<16>(v, ps, w, tw, sg, first, to); break;
    default:
      if constexpr (kCode == kAll) generic_pass(ps, w, N, tw, staged, to);
      break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

// One block: R = 2^log2r rows m0 .. of channel blockIdx.y, T threads a
// row, at most kBound threads; the transposed store in clusters of K =
// 2^log2k blocks.
template <bool kNatural, int kBound, Code kCode>
__global__ void __launch_bounds__(kBound)
rows_mixed_passes_kernel(const float* __restrict__ re,
                         const float* __restrict__ im,
                         float* __restrict__ out_re,
                         float* __restrict__ out_im,
                         const float2* __restrict__ tw, int M, int log2r,
                         int log2k, const Plan plan) {
  extern __shared__ float2 smem[];
  const int N = plan.n;
  const int R = 1 << log2r;
  const int row = threadIdx.x / plan.threads;
  const int m0 = blockIdx.x << log2r;
  const int m = m0 + row;
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t at =
      blockIdx.y * plane + static_cast<size_t>(m < M ? m : 0) * N;
  const int tile_stride = gather_stride(R, N);
  // the tile: in the exchange buffer, or beside it (exchange_area)
  float2* const tile =
      smem + (!kNatural && plan.roots > 0 ? R * plan.stride : 0);
  const int area =
      exchange_area(R, plan, kNatural) +
      (log2k ? (R << log2k) * gather_stride(R << log2k, N >> log2k) : 0);
  float2* const staged = smem + area;
  Pass* const passes = reinterpret_cast<Pass*>(staged + plan.staged);

  // the passes after the first and the table's staged tail (the generic
  // passes' roots, and their twiddles where few) into shared memory; the
  // first pass ends at a barrier before either is read (a generic pass is
  // never the first)
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kMaxPasses; ++i)
      if (i < plan.passes) passes[i] = plan.pass[i];
  }
  for (int i = threadIdx.x; i < plan.staged; i += blockDim.x)
    staged[i] = __ldg(tw + plan.stage_from + i);

  Row w;
  w.in_re = re + at;
  w.in_im = im + at;
  w.out_re = out_re + at;
  w.out_im = out_im + at;
  w.buf = smem + row * plan.stride;
  w.tile = tile + row * tile_stride;
  w.t = threadIdx.x - row * plan.threads;
  w.T = plan.threads;
  w.pad = plan.pad;
  w.live = m < M;
  const float sg = __ldg(&tw[0].y);
  constexpr Dest kLast = kNatural ? kToOutput : kToTile;

  float2 v[kPoints];
  run_pass<kCode>(v, plan.pass[0], w, N, tw, staged, sg, true,
           plan.passes > 1 ? kToBuffer : kLast);
  for (int i = 1; i < plan.passes; ++i) {
    const Pass ps = passes[i];
    run_pass<kCode>(v, ps, w, N, tw, staged, sg, false,
             i < plan.passes - 1 ? kToBuffer : kLast);
  }
  if constexpr (!kNatural) {
    float* const o_re = out_re + blockIdx.y * plane;
    float* const o_im = out_im + blockIdx.y * plane;
    if (log2k == 0) {
      // R rows at one k, then the next k: runs of R floats of out[c, k, ·]
      __syncthreads();
      const int live_rows = M - m0 < R ? M - m0 : R;
      for (int i = threadIdx.x; i < (N << log2r); i += blockDim.x) {
        const int r = i & (R - 1);
        const int k = i >> log2r;
        if (r < live_rows) {
          const float2 x = tile[r * tile_stride + k];
          const size_t g = static_cast<size_t>(k) * M + m0 + r;
          o_re[g] = x.x;
          o_im[g] = x.y;
        }
      }
    } else {
      // Gather: block j of the cluster takes columns [j·W, (j+1)·W) of its
      // K·R rows, row q·R + r of its tile from row r of block q, reads
      // along k; kGatherInFlight remote reads a thread before any write.
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int jr = static_cast<int>(cluster.block_rank());
      const int W = N >> log2k;
      const unsigned w_magic = 0xFFFFFFFFu / static_cast<unsigned>(W) + 1u;
      const int kr = R << log2k;
      const int S = gather_stride(kr, W);
      float2* const gathered = smem + area - kr * S;
      const int total = R * N;   // = K·R·W
      for (int base = threadIdx.x; base < total;
           base += kGatherInFlight * blockDim.x) {
        float2 x[kGatherInFlight];
#pragma unroll
        for (int u = 0; u < kGatherInFlight; ++u) {
          const int idx = base + u * blockDim.x;
          if (idx < total) {
            const int rr = div_by(idx, W, w_magic);
            const float2* from = cluster.map_shared_rank(tile, rr >> log2r);
            x[u] = from[(rr & (R - 1)) * tile_stride + jr * W + idx - rr * W];
          }
        }
#pragma unroll
        for (int u = 0; u < kGatherInFlight; ++u) {
          const int idx = base + u * blockDim.x;
          if (idx < total) {
            const int rr = div_by(idx, W, w_magic);
            gathered[rr * S + idx - rr * W] = x[u];
          }
        }
      }
      __syncthreads();
      // no block reads another's memory any more
      cluster_arrive();
      // out[c, j·W + k, mc + rr] with rr fastest: runs of K·R floats; mc
      // the cluster's first row, rows past M dropped
      const int mc = (static_cast<int>(blockIdx.x) - jr) << log2r;
      const int log2kr = log2r + log2k;
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int rr = i & (kr - 1);
        const int k = i >> log2kr;
        if (mc + rr < M) {
          const float2 x = gathered[rr * S + k];
          const size_t g = static_cast<size_t>(jr * W + k) * M + mc + rr;
          o_re[g] = x.x;
          o_im[g] = x.y;
        }
      }
      cluster_wait();
    }
  }
}

// cudaOccupancyMaxActiveClusters of one launch shape, asked once per
// (device, kernel, shared memory, threads, cluster size) in a process.
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel, const cudaLaunchConfig_t& config,
                         int cluster) {
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
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&active, kernel, &config);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, active).first;
  }
  return it->second > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// One store's launch. rows_mixed_natural.cu instantiates the natural
// store's, rows_mixed.cu the transposed one's: two files that nvcc builds
// side by side.
template <bool kNatural>
int launch(const void* re, const void* im, void* out_re, void* out_im,
           const void* tables, int channels, int m, int rows, int cluster,
           const Plan& plan, cudaStream_t stream) {
  // the generic pass's code only in the kernels for plans that have one
  // (with it the register passes ran up to 2.4× slower on the H100); the
  // natural store at 128 registers where its block allows, the transposed
  // store at 64 (more blocks an SM for its store read faster)
  const bool small = rows * plan.threads <= kBlockThreads;
  auto kernel = rows_mixed_passes_kernel<kNatural, kMaxThreads, kRegister>;
  if (plan.passes == 2 && plan.pass[0].radix == 2 && plan.roots > 0 &&
      small) {
    kernel = rows_mixed_passes_kernel<kNatural, kBlockThreads, kTwoPrime>;
  } else if (plan.roots > 0) {
    kernel = rows_mixed_passes_kernel<kNatural, kMaxThreads, kAll>;
  } else if constexpr (kNatural) {
    if (small)
      kernel = rows_mixed_passes_kernel<kNatural, kBlockThreads, kRegister>;
  }
  const int smem = shared_bytes(rows, plan, cluster, kNatural);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + rows - 1) / rows;
  const dim3 grid((blocks + cluster - 1) / cluster * cluster, channels);
  const int threads = rows * plan.threads;
  const auto in_re = static_cast<const float*>(re);
  const auto in_im = static_cast<const float*>(im);
  const auto o_re = static_cast<float*>(out_re);
  const auto o_im = static_cast<float*>(out_im);
  const auto tw = static_cast<const float2*>(tables);
  if (cluster == 1) {
    kernel<<<grid, threads, smem, stream>>>(in_re, in_im, o_re, o_im, tw, m,
                                            log2_of(rows), 0, plan);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cluster_fits(kernel, config, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, kernel, in_re, in_im, o_re, o_im, tw, m,
                           log2_of(rows), log2_of(cluster), plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// built in rows_mixed_natural.cu
extern template int launch<true>(const void*, const void*, void*, void*,
                                 const void*, int, int, int, int,
                                 const Plan&, cudaStream_t);

}  // namespace mixed_passes

}  // namespace tpu_fft
