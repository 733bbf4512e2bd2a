"""2-D inverse FFT backends, all computing the UNNORMALIZED inverse
transform F[i, j] = Σ_{n,m} X[n, m] e^{+2πi(ni + mj)/N} over the trailing
two axes of a complex tensor.

JAX counterpart: ``tpu_ocean/fft/__init__.py``:

* ``reference`` — torch.fft (cuFFT on the card), fft/reference.py;
* ``stockham``  — the radix-2 Stockham loop in plain torch, fft/stockham.py;
* ``matmul``    — the DFT as matrix products, fft/matmul.py;
* ``pallas``    — the row-DFT kernels on (re, im) planes, fft/planes.py
                  ``ifft2_pallas``.

The solver-level ``pallas_fused`` backend consumes (h0, phase) rather than
spectra (ops/fused_spectrum.py ``ifft2_fused``), so the solver selects it
itself. The row-DFT passes on planes live in fft/planes.py.
"""

import functools

from tpu_ocean_torch.fft.reference import ifft2_unnorm, centered_modulation

BACKENDS = ("reference", "stockham", "matmul", "pallas")


def get_ifft2(backend: str, n: int, precision: str = "float32"):
    """fn(x[..., N, N] complex) → its unnormalized inverse FFT2;
    ``precision`` ("float32" or "bfloat16") reaches the backends that honor
    it, ``matmul`` and ``pallas``."""
    if backend == "reference":
        return ifft2_unnorm
    if backend == "stockham":
        from tpu_ocean_torch.fft.stockham import ifft2_stockham
        return ifft2_stockham
    if backend == "matmul":
        from tpu_ocean_torch.fft.matmul import ifft2_matmul
        return functools.partial(ifft2_matmul, precision=precision)
    if backend == "pallas":
        from tpu_ocean_torch.fft.planes import ifft2_pallas
        return functools.partial(ifft2_pallas, precision=precision)
    raise ValueError(f"unknown fft backend {backend!r}; choose from {BACKENDS}")
