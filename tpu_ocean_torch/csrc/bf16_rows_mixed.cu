// The bf16 and bf16x3 row DFTs in the direct form (dft_bf16_rows_mixed.cuh):
// the entry, regime 2's kernels and regime 1's transposed store; regime 1's
// natural store builds in bf16_rows_mixed_natural.cu, beside this file.

#include "dft_bf16_rows_mixed.cuh"

extern "C" {

// The row DFT in the direct form at tier `tier`, transposed (natural = 0)
// or natural (1) store: bf16 (tier 1) at an even n in [16, 8192] that is
// not a power of two, `tables` planes.bf16_rows_tables(n, inverse); bf16x3
// (tier 2) at every even n in [16, 8192], `tables`
// planes.bf16x3_rows_tables(n, inverse). Where n1 = lanes_n1(n) ≤ 128,
// rows a power of two whose block (planes.bf16_rows_shared_bytes,
// bf16x3_rows_shared_bytes) fits the card's shared memory and no scratch;
// where n1 = n / 2 > 128, rows 1 and `scratch`
// planes.bf16_rows_scratch_words(channels, m, n) (bf16x3_rows_scratch_words
// at tier 2) 32-bit words. Anything else is refused, never run on another
// kernel.
int tpu_bf16_rows_mixed(const void* re, const void* im, void* out_re,
                        void* out_im, const void* tables, void* scratch,
                        int channels, int m, int n, int rows, int natural,
                        int tier, void* stream) {
  return natural ? tpu_fft::launch_bf16_rows_mixed<true>(
                       re, im, out_re, out_im, tables, scratch, channels, m,
                       n, rows, tier, stream)
                 : tpu_fft::launch_bf16_rows_mixed<false>(
                       re, im, out_re, out_im, tables, scratch, channels, m,
                       n, rows, tier, stream);
}

}  // extern "C"
