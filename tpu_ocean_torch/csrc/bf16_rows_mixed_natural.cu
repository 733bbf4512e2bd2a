// The natural store's builds of dft_bf16_rows_mixed.cuh's regime-1 kernel
// at both tiers, which bf16_rows_mixed.cu's entry tpu_bf16_rows_mixed
// launches: in a file of their own so that nvcc builds them beside the
// transposed store's.

#include "dft_bf16_rows_mixed.cuh"

template int tpu_fft::bf16_mixed::launch<tpu_fft::kTierBf16, true>(
    const void*, const void*, void*, void*, const void*, int, int, int, int,
    cudaStream_t);
template int tpu_fft::bf16_mixed::launch<tpu_fft::kTierBf16x3, true>(
    const void*, const void*, void*, void*, const void*, int, int, int, int,
    cudaStream_t);
