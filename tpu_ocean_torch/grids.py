"""Wavevector and coordinate grids, float64 numpy.

JAX counterpart: the numpy part of ``tpu_ocean/grids.py``. Two wavevector
conventions: ``centered`` k_n = 2π(n − N/2)/L (FFTMesh.cs:201) and ``fft``
k_n = 2π·wrap(n)/L with wrap(n) = n if n < N/2 else n − N
(FFTCommon.cginc:58-67). Axis 0 indexes x, axis 1 indexes z.
"""

from __future__ import annotations

import numpy as np

from tpu_ocean_torch.config import PI


def wavenumbers_1d(n: int, length: float, layout: str = "centered") -> np.ndarray:
    """1-D wavenumber array k_i for grid side ``n`` and patch length ``length``."""
    idx = np.arange(n, dtype=np.float64)
    if layout == "centered":
        k = 2.0 * PI * (idx - n / 2.0) / length      # FFTMesh.cs:201
    elif layout == "fft":
        wrapped = np.where(idx < n / 2.0, idx, idx - n)  # FFTCommon.cginc:63-64
        k = 2.0 * PI * wrapped / length
    else:
        raise ValueError(f"bad layout {layout!r}")
    return k


def wavevector_grid(n: int, length: float, layout: str = "centered"):
    """(kx, kz, k_mag) as [N, N] float64 numpy arrays, axis0 = x, axis1 = z."""
    k = wavenumbers_1d(n, length, layout)
    kx = k[:, None] * np.ones((1, n))
    kz = np.ones((n, 1)) * k[None, :]
    k_mag = np.sqrt(kx * kx + kz * kz)
    return kx, kz, k_mag


def coordinate_1d(n: int, unit_width: float) -> np.ndarray:
    """Reference mesh coordinates: x_i = (i − N/2)·w (+ w/2 for even N),
    FFTMesh.cs:107,111-112."""
    idx = np.arange(n, dtype=np.float64)
    x = (idx - n // 2) * unit_width
    if n % 2 == 0:
        x = x + unit_width / 2.0
    return x


def coordinate_grid(n: int, unit_width: float):
    """(x, z) position grids, [N, N] float64, axis0 = x, axis1 = z."""
    c = coordinate_1d(n, unit_width)
    x = c[:, None] * np.ones((1, n))
    z = np.ones((n, 1)) * c[None, :]
    return x, z


def centered_ifft_factors(n: int, length: float, unit_width: float):
    """Pre/post modulation vectors turning a standard unnormalized IFFT into
    the oracle's centered direct sum h(x_i) = Σ_n H_n · e^{i k_n x_i}, with
    k_n = 2π(n − N/2)/L and x_i = (i − N/2 + η)·w, w = L/N:

        pre(n)  = e^{−2πi n (N/2 − η)/N}
        post(i) = (−1)^i · e^{iπ(N/2 − η)}

    so that h = post ⊗ post · IFFT2_unnorm(pre ⊗ pre · H). η = ½ for both
    parities: even N adds the half cell explicitly (coordinate_1d), odd N
    gets it from the floor (⌊N/2⌋ = N/2 − ½). Exact only when length ==
    n · unit_width; callers enforce that. Returns (pre[n], post[n])
    complex128."""
    eta = 0.5
    shift = n / 2.0 - eta
    idx = np.arange(n, dtype=np.float64)
    pre = np.exp(-2j * np.pi * idx * shift / n)
    post = np.exp(-1j * np.pi * idx) * np.exp(1j * np.pi * shift)
    return pre, post
