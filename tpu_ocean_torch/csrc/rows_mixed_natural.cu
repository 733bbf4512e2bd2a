// The natural store's builds of rows_mixed_passes_f32.cuh's kernel, which
// rows_mixed.cu's entry tpu_fft_rows_mixed launches: in a file of their
// own so that nvcc builds them beside the transposed store's.

#include "rows_mixed_passes_f32.cuh"

template int tpu_fft::mixed_passes::launch<true>(
    const void*, const void*, void*, void*, const void*, int, int, int, int,
    const tpu_fft::mixed_passes::Plan&, cudaStream_t);
