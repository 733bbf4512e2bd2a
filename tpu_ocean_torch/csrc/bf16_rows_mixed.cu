// The bf16 row DFT at even lengths that are not powers of two
// (dft_bf16_rows_mixed.cuh): the entry, regime 2's kernels and regime 1's
// transposed store; regime 1's natural store builds in
// bf16_rows_mixed_natural.cu, beside this file.

#include "dft_bf16_rows_mixed.cuh"

extern "C" {

// The bf16 row DFT in the direct form at an even n in [16, 8192] that is
// not a power of two, transposed (natural = 0) or natural (1) store:
// `tables` planes.bf16_rows_tables(n, inverse); where n1 = lanes_n1(n) ≤
// 128, rows a power of two whose block (planes.bf16_rows_shared_bytes)
// fits the card's shared memory and no scratch; where n1 = n / 2 > 128,
// rows 1 and `scratch` planes.bf16_rows_scratch_words(channels, m, n)
// 32-bit words. Anything else is refused, never run on another kernel.
int tpu_bf16_rows_mixed(const void* re, const void* im, void* out_re,
                        void* out_im, const void* tables, void* scratch,
                        int channels, int m, int n, int rows, int natural,
                        void* stream) {
  return natural ? tpu_fft::launch_bf16_rows_mixed<true>(
                       re, im, out_re, out_im, tables, scratch, channels, m,
                       n, rows, stream)
                 : tpu_fft::launch_bf16_rows_mixed<false>(
                       re, im, out_re, out_im, tables, scratch, channels, m,
                       n, rows, stream);
}

}  // extern "C"
