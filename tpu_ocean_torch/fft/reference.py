"""torch.fft's 2-D inverse transform, the ``reference`` backend, and the
centered layout's modulation grids.

JAX counterpart: ``tpu_ocean/fft/reference.py``. Every backend computes the
UNNORMALIZED inverse DFT

    F[i, j] = Σ_{n,m} X[n, m] · e^{+2πi(ni + mj)/N}

because the oracle sums e^{+i k·x} with no normalization
(FFTMesh.cs:205-211). On the card torch.fft is cuFFT.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ocean_torch.grids import centered_ifft_factors


def ifft2_unnorm(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized inverse FFT over the last two axes (any leading batch)."""
    return torch.fft.ifft2(x, norm="forward")


def centered_modulation(n: int, length: float, unit_width: float,
                        dtype=np.complex64):
    """(pre[N, N], post[N, N]) numpy modulation grids of the centered-grid
    transform (grids.centered_ifft_factors), built in float64 and cast once
    to ``dtype``. Requires length == n · unit_width."""
    if abs(length - n * unit_width) > 1e-9 * max(1.0, length):
        raise ValueError(
            f"centered FFT evaluation requires length == resolution*unit_width "
            f"(got L={length}, N*w={n * unit_width}); use the 'direct' "
            f"evaluation mode for incommensurate grids")
    pre1, post1 = centered_ifft_factors(n, length, unit_width)
    return (np.asarray(np.outer(pre1, pre1), dtype=dtype),
            np.asarray(np.outer(post1, post1), dtype=dtype))
