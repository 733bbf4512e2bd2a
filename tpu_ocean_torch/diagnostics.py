"""Physical diagnostics of the simulated sea state.

JAX counterpart: ``tpu_ocean/diagnostics.py``. The scalar statistics are
torch reductions on the fields' device (population moments, as jnp.std and
jnp.var take them); the spectrum and the peak period are host analysis in
numpy float64, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ocean_torch.config import G


def significant_wave_height(height: torch.Tensor) -> torch.Tensor:
    """Hs ≈ 4·σ(η), the spectral estimate from the surface variance."""
    return 4.0 * torch.std(height, correction=0)


def surface_variance(height: torch.Tensor) -> torch.Tensor:
    return torch.var(height, correction=0)


def foam_coverage(foam: torch.Tensor) -> torch.Tensor:
    """Fraction of the surface breaking (foam coverage > ½)."""
    return torch.mean((foam > 0.5).to(torch.float32))


#: the JAX package's deprecated alias of foam_coverage (it never measured
#: wave steepness), kept so that code written against either package runs
steepness = foam_coverage


def omnidirectional_spectrum(height, length: float, nbins: int = 0):
    """(k_bins, E(k)): the azimuthally integrated variance density of the
    heightfield, host numpy float64 (an analysis utility)."""
    if isinstance(height, torch.Tensor):
        height = height.detach().cpu().numpy()
    h = np.asarray(height, dtype=np.float64)
    n = h.shape[0]
    hk = np.fft.fft2(h) / (n * n)
    e2 = np.abs(hk) ** 2
    k1 = 2 * np.pi * np.fft.fftfreq(n, d=length / n)
    kx, kz = np.meshgrid(k1, k1, indexing="ij")
    km = np.sqrt(kx ** 2 + kz ** 2)
    nbins = nbins or n // 2
    k_edges = np.linspace(0, km.max() + 1e-12, nbins + 1)
    which = np.digitize(km.ravel(), k_edges) - 1
    e = np.bincount(which.clip(0, nbins - 1), weights=e2.ravel(),
                    minlength=nbins)
    widths = np.diff(k_edges)
    centers = 0.5 * (k_edges[1:] + k_edges[:-1])
    return centers, e / np.maximum(widths, 1e-300)


def peak_period(height, length: float) -> float:
    """T_p from the spectral peak wavenumber by deep-water dispersion."""
    k, e = omnidirectional_spectrum(height, length)
    kp = float(k[1:][np.argmax(e[1:])])   # skip the DC bin
    if kp <= 0:
        return float("inf")
    return float(2 * np.pi / np.sqrt(G * kp))


def energy_budget(fields) -> dict:
    """Scalar summary block for the observability stream."""
    return {
        "hs": float(significant_wave_height(fields.height)),
        "var": float(surface_variance(fields.height)),
        "foam_cover": float(foam_coverage(fields.foam)),
        "max_disp": float(torch.max(torch.sqrt(fields.disp_x ** 2
                                               + fields.disp_z ** 2))),
        "min_jacobian": float(torch.min(fields.jacobian)),
    }
