"""Phase evolution and Hermitian-packed spectrum assembly.

JAX counterpart: ``tpu_ocean/evolve.py``. The tables (ω, the channel
coefficients and the packed coefficients) are float64 numpy, cast to f32
once by the solver exactly as ``tpu_ocean/solver.py`` does, so they are
bit-equal to the JAX package's. The per-step functions are torch.

Coefficient conventions (oracle signs, FFTMesh.cs:205-215):
    C_height = 1, C_disp_x = +kx/|k|, C_disp_z = ∓kz/|k| (sign quirk
    flag-gated), C_slope_x = −kx, C_slope_z = −kz; zero where |k| < EPSILON.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_ocean_torch.config import EPSILON, OceanConfig
from tpu_ocean_torch.grids import wavevector_grid
from tpu_ocean_torch.spectra import dispersion


def omega_grid(cfg: OceanConfig) -> np.ndarray:
    """ω[N, N] in float64: the quantized mode's floor() is discontinuous,
    and evaluating it in f32 can flip a mode across the boundary."""
    _, _, k_mag = wavevector_grid(cfg.resolution, cfg.length, cfg.spectrum_layout)
    return dispersion(k_mag, cfg.dispersion_mode, cfg.length)


def spectrum_coefficients(cfg: OceanConfig) -> np.ndarray:
    """[5, N, N] float64 per-channel multipliers."""
    kx, kz, k_mag = wavevector_grid(cfg.resolution, cfg.length, cfg.spectrum_layout)
    inv_k = np.where(k_mag < EPSILON, 0.0, 1.0 / np.maximum(k_mag, 1e-300))
    dz_sign = -1.0 if cfg.oracle_sign_quirk else 1.0
    return np.stack([
        np.ones_like(kx),          # height
        kx * inv_k,                # disp_x
        dz_sign * kz * inv_k,      # disp_z
        -kx,                       # slope_x
        -kz,                       # slope_z
    ])


def packed_coefficients(cfg: OceanConfig, nch: int) -> np.ndarray:
    """Hermitian-packed channel multipliers for the 'fft' layout, [2P, N, N]
    float64: rows 0..P−1 hold the real parts A, rows P..2P−1 the parts B of
    the packed coefficient A − i·B. With P = 2 (stencil normals, nch = 3):

        P0 = (1 + r_x)·h̃   → height = Re F0, disp_x = Im F0
        P1 = (−i·r_z)·h̃    → disp_z = Re F1

    Each multiplier is replaced by its odd part under the index negation
    map, which zeroes the self-paired k = 0 and Nyquist lines' content that
    the extraction discards anyway (see the JAX docstring for the proof).
    """
    if cfg.spectrum_layout != "fft":
        raise ValueError("packed channels require spectrum_layout='fft'")
    if nch not in (3, 5):
        raise ValueError(f"nch must be 3 or 5, got {nch}")
    coeffs = spectrum_coefficients(cfg)
    n = coeffs.shape[-1]
    neg = (-np.arange(n)) % n

    def odd(r):                      # odd part under the index negation map
        return 0.5 * (r - r[np.ix_(neg, neg)])

    zero = np.zeros_like(coeffs[0])
    if nch == 3:
        a = [coeffs[0] + odd(coeffs[1]), zero]
        b = [zero, odd(coeffs[2])]
    else:
        a = [coeffs[0] + odd(coeffs[1]), odd(coeffs[3]), zero]
        b = [zero, odd(coeffs[2]), odd(coeffs[4])]
    return np.stack(a + b)


def evolve_phase_accumulate(phase: torch.Tensor, omega: torch.Tensor,
                            dt: float) -> torch.Tensor:
    """φ ← (φ + ω·dt) mod 2π (Dispersion.shader:32-41). ``dt`` must already
    be an f32 value. The argument is never negative, so fmod is the exact
    remainder that ``jnp.mod`` lowers to, and the phase stays bit-equal to
    the JAX package's (``torch.remainder`` computes a − b·floor(a/b) and can
    differ by an ulp)."""
    return torch.fmod(phase + omega * dt, 2.0 * math.pi)


def evolve_phase_absolute(omega: torch.Tensor, t) -> torch.Tensor:
    """φ(k) = ω·t, the absolute-time mode (FFTMesh.cs:183); ``t`` an f32
    value or 0-d f32 tensor."""
    return omega * t


def _evolved(h0_planes, phase: torch.Tensor):
    """h̃ = h0·e^{iφ} + h0*·e^{−iφ} in real planes: (re, im) f32 [N, N]."""
    h0r, h0i, h0cr, h0ci = h0_planes
    c = torch.cos(phase)
    s = torch.sin(phase)
    return ((h0r + h0cr) * c + (h0ci - h0i) * s,
            (h0i + h0ci) * c + (h0r - h0cr) * s)


def assemble_spectra_real(h0_planes, phase: torch.Tensor,
                          coeffs: torch.Tensor):
    """h̃, then each channel times its real coefficient: returns (re, im)
    f32 [..., C, N, N]; ``coeffs`` is the f32 [..., C, N, N] table
    (spectrum_coefficients, first C channels). Any leading batch (a
    cascade's bands) rides in front of the planes' [N, N]."""
    htr, hti = _evolved(h0_planes, phase)
    return coeffs * htr.unsqueeze(-3), coeffs * hti.unsqueeze(-3)


def assemble_spectra_packed_real(h0_planes, phase: torch.Tensor,
                                 pack: torch.Tensor):
    """h̃, then P = (A − iB)·h̃: returns (re, im) f32 [..., P, N, N];
    ``pack`` is the f32 [..., 2P, N, N] table."""
    p = pack.shape[-3] // 2
    a, b = pack[..., :p, :, :], pack[..., p:, :, :]
    htr, hti = _evolved(h0_planes, phase)
    htr, hti = htr.unsqueeze(-3), hti.unsqueeze(-3)
    return a * htr + b * hti, a * hti - b * htr


def negflip(x: torch.Tensor) -> torch.Tensor:
    """x indexed at (−m) mod N along its last two axes (the fft layout's
    k → −k), whatever batch leads them."""
    return torch.roll(torch.flip(x, (-2, -1)), shifts=(1, 1), dims=(-2, -1))


def hermitize_planes(r1, i1, r2, i2):
    """Project the (h0, h0_conj) planes onto their Hermitian part:
    a = ½(h0 + conj(h0c∘neg)), h0c ← conj(a∘neg). Bitwise idempotent."""
    ar = 0.5 * (r1 + negflip(r2))
    ai = 0.5 * (i1 - negflip(i2))
    return ar, ai, negflip(ar), -negflip(ai)


def assemble_spectra(h0: torch.Tensor, h0_conj: torch.Tensor,
                     phase: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """The complex state's spectra, complex64 [..., C, N, N]: h̃ = h0·e^{iφ}
    + h0*·e^{−iφ} (FFTMesh.cs:188, Spectrum.shader:44-45), times each
    channel's real coefficient (``coeffs``, f32 [..., C, N, N])."""
    pv = torch.complex(torch.cos(phase), torch.sin(phase))
    h = h0 * pv + h0_conj * pv.conj()
    return coeffs * h.unsqueeze(-3)


def assemble_spectra_packed(h0: torch.Tensor, h0_conj: torch.Tensor,
                            phase: torch.Tensor,
                            pack: torch.Tensor) -> torch.Tensor:
    """Complex twin of assemble_spectra_packed_real: P = (A − iB)·h̃,
    complex64 [..., P, N, N]; ``pack`` is the f32 [..., 2P, N, N] table."""
    p = pack.shape[-3] // 2
    pv = torch.complex(torch.cos(phase), torch.sin(phase))
    h = h0 * pv + h0_conj * pv.conj()
    return (torch.complex(pack[..., :p, :, :], -pack[..., p:, :, :])
            * h.unsqueeze(-3))


def hermitize_pair(h0: torch.Tensor, h0_conj: torch.Tensor):
    """Complex twin of hermitize_planes: a = ½(h0 + conj(h0c∘neg)),
    h0c ← conj(a∘neg). Bitwise idempotent."""
    a = 0.5 * (h0 + negflip(h0_conj).conj_physical())
    return a, negflip(a).conj_physical()
