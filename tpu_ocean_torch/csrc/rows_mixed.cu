// The f32 row DFT in the direct form at even lengths that are not powers of
// two, either store: rows_mixed_passes_f32.cuh's register-resident
// mixed-radix passes, the entry and the transposed store's kernels in a
// file of their own (the natural store's in rows_mixed_natural.cu) so that
// nvcc builds them beside fft_rows.cu. The other tiers and forms at those
// lengths run fft_rows.cu's tpu_matrix_rows_any.

#include "rows_mixed_passes_f32.cuh"

namespace tpu_fft {

// Launches the kernel: n even in [16, 8192] and not a power of two, `plan`
// the host's rows (mixed_passes::read_plan) of `passes` passes, rows a
// power of two of at most 1024 threads whose block fits the card's shared
// memory, `cluster` 1 for the natural store, 1, 2, 4 or 8 dividing n for
// the transposed one, `tables` planes.passes_twiddles(n, inverse) of
// `table` entries. Anything else is refused with cudaErrorInvalidValue,
// never run on another kernel.
inline int launch_rows_mixed_passes(bool natural, const void* re,
                                    const void* im, void* out_re,
                                    void* out_im, const void* tables,
                                    int channels, int m, int n, int rows,
                                    const int* plan_rows, int passes,
                                    int table, int cluster, void* stream) {
  const mixed_passes::Plan plan =
      mixed_passes::read_plan(n, plan_rows, passes, table);
  if (plan.passes == 0 || rows < 1 || (rows & (rows - 1)) || m < 1 ||
      channels < 1 || rows * plan.threads > mixed_passes::kMaxThreads ||
      cluster < 1 || cluster > mixed_passes::kMaxCluster ||
      (cluster & (cluster - 1)) || n % cluster || (natural && cluster != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return natural ? mixed_passes::launch<true>(re, im, out_re, out_im, tables,
                                              channels, m, rows, 1, plan, s)
                 : mixed_passes::launch<false>(re, im, out_re, out_im, tables,
                                               channels, m, rows, cluster,
                                               plan, s);
}

}  // namespace tpu_fft

extern "C" {

// The f32 direct pass at an even n in [16, 8192] that is not a power of
// two, transposed (natural = 0) or natural (1) store: rows a power of two
// of at most 1024 threads whose block (planes.passes_shared_bytes) fits the
// card's shared memory, `cluster` the blocks of a thread-block cluster of
// the transposed store (planes.passes_cluster; 1 for the natural one),
// `tables` planes.passes_twiddles(n, inverse) of `table` entries, `plan`
// the host array planes.passes_plan_rows(n): a head and `passes` rows.
// Any other n, rows, cluster, or a plan that is not a length-n transform
// this kernel takes inside the table is refused, never run.
int tpu_fft_rows_mixed(const void* re, const void* im, void* out_re,
                       void* out_im, const void* tables, int channels, int m,
                       int n, int rows, int natural, int passes, int table,
                       int cluster, const void* plan, void* stream) {
  return tpu_fft::launch_rows_mixed_passes(
      natural != 0, re, im, out_re, out_im, tables, channels, m, n, rows,
      static_cast<const int*>(plan), passes, table, cluster, stream);
}

}  // extern "C"
