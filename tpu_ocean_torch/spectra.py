"""Phillips and JONSWAP spectra, dispersion relations and h0 sampling.

JAX counterpart: ``tpu_ocean/spectra.py``. The spectra and dispersions are
float64 numpy here (they are host-side tables, computed once per solver).
h0 is drawn from an explicit CPU ``torch.Generator``, so one seed gives the
same h0 on every device; it does not replay ``jax.random``, which is why
parity tests inject one shared h0 into both packages.

Reference formulas:
  * Phillips   — FFTCommon.cginc:69-85 (damping 0.01), FFTMesh.cs:149-166
                 (damping 0.001): P(k) = A·exp(−1/(|k|²l²))/|k|⁴·(k̂·ŵ)²
                 ·exp(−|k|²l²d²), l = |w|²/g, zero below EPSILON.
  * h0         — h̃₀(k) = (ξ₁ + iξ₂)·sqrt(P(k)/2), ξ ~ N(0, 1).
  * dispersion — capillary ω = sqrt(g|k|(1 + |k|²/370²)) (FFTCommon.cginc:
                 106-114); quantized ω = floor(sqrt(g|k|)/ω₀)·ω₀, ω₀ = 2π/L
                 (FFTMesh.cs:141-147).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_ocean_torch.config import G, PI, EPSILON
from tpu_ocean_torch.grids import wavevector_grid


def phillips(kx, kz, amplitude: float, wind, damping: float, g: float = G):
    """Phillips spectrum P(k) over float64 wavevector arrays."""
    wx, wz = float(wind[0]), float(wind[1])
    w_len = np.sqrt(wx * wx + wz * wz)
    l = w_len * w_len / g                       # largest wave from wind speed
    l2 = l * l
    big_l2 = l2 * damping * damping             # suppression of tiny waves

    k_mag = np.sqrt(kx * kx + kz * kz)
    k2 = k_mag * k_mag
    k4 = k2 * k2
    k_dot_w = (kx * wx + kz * wz) / np.maximum(k_mag * w_len, 1e-30)
    k_dot_w2 = k_dot_w * k_dot_w

    safe_k2 = np.maximum(k2, 1e-30)
    safe_k4 = np.maximum(k4, 1e-30)
    p = (
        amplitude
        * np.exp(-1.0 / (safe_k2 * l2))
        / safe_k4
        * k_dot_w2
        * np.exp(-safe_k2 * big_l2)
    )
    return np.where(k_mag < EPSILON, np.zeros_like(p), p)


def jonswap(kx, kz, amplitude: float, wind, fetch: float = 100e3,
            gamma: float = 3.3, g: float = G, length: float = None,
            spreading: float = 2.0, depth: float = None):
    """JONSWAP directional wavenumber spectrum (Hasselmann et al. 1973),
    converted from the frequency form by deep-water dispersion, with cosˢ
    spreading over the downwind half-plane, the optional TMA finite-depth
    factor and, with ``length``, the mode area (2π/L)². Same formula as the
    JAX package's ``spectra.jonswap``."""
    wx, wz = float(wind[0]), float(wind[1])
    u = float(np.hypot(wx, wz)) or 1e-6
    f = max(float(fetch), 1.0)
    alpha = 0.076 * (u * u / (f * g)) ** 0.22
    omega_p = 22.0 * (g * g / (u * f)) ** (1.0 / 3.0)

    k_mag = np.sqrt(kx * kx + kz * kz)
    safe_k = np.maximum(k_mag, 1e-12)
    omega = np.sqrt(g * safe_k)
    sigma = np.where(omega <= omega_p, 0.07, 0.09)
    rr = np.exp(-((omega - omega_p) ** 2)
                / (2.0 * sigma * sigma * omega_p * omega_p))
    s_w = (alpha * g * g / np.maximum(omega, 1e-12) ** 5
           * np.exp(-1.25 * (omega_p / np.maximum(omega, 1e-12)) ** 4)
           * gamma ** rr)
    psi = s_w * (g / (2.0 * np.maximum(omega, 1e-12))) / safe_k

    cos_t = (kx * wx + kz * wz) / (safe_k * u)
    norm = (math.sqrt(math.pi) * math.gamma((spreading + 1.0) / 2.0)
            / math.gamma(spreading / 2.0 + 1.0))
    spread = np.where(cos_t > 0.0,
                      np.maximum(cos_t, 0.0) ** spreading / norm, 0.0)

    p = amplitude * psi * spread

    if depth is not None:
        ws = omega * np.sqrt(max(float(depth), 1e-6) / g)
        phi = np.where(ws <= 1.0, 0.5 * ws * ws,
                       np.where(ws < 2.0, 1.0 - 0.5 * (2.0 - ws) ** 2, 1.0))
        p = p * phi
    if length is not None:
        dk = 2.0 * PI / float(length)
        p = p * (dk * dk)
    return np.where(k_mag < EPSILON, np.zeros_like(p), p)


def spectrum_fn(model: str):
    """'phillips' (the reference's) or 'jonswap'."""
    if model == "phillips":
        return phillips
    if model == "jonswap":
        return jonswap
    raise ValueError(f"bad spectrum model {model!r}")


def _spectrum_pair(kx, kz, amplitude, wind, damping, length,
                   model: str, jonswap_kw):
    """(P(k), P(−k)) under the selected spectrum model."""
    spec = spectrum_fn(model)
    if model == "phillips":
        return (spec(kx, kz, amplitude, wind, damping),
                spec(-kx, -kz, amplitude, wind, damping))
    kw = dict(jonswap_kw or {})
    kw.pop("length", None)
    return (spec(kx, kz, amplitude, wind, length=length, **kw),
            spec(-kx, -kz, amplitude, wind, length=length, **kw))


def _sample_planes(generator: torch.Generator, spec: np.ndarray):
    """(re, im) f32 planes of (ξ₁ + iξ₂)·sqrt(P/2) on the CPU."""
    scale = torch.sqrt(torch.from_numpy(np.asarray(spec, np.float32)) / 2.0)
    noise = torch.randn(spec.shape + (2,), generator=generator,
                        dtype=torch.float32)
    return noise[..., 0] * scale, noise[..., 1] * scale


def sample_h0(generator: torch.Generator, spec: np.ndarray) -> torch.Tensor:
    """h̃₀(k) = (ξ₁ + iξ₂)·sqrt(P(k)/2), complex64 on the CPU: the draw of
    _sample_planes joined."""
    return torch.complex(*_sample_planes(generator, spec))


def _pair_planes(generator, layout, n, length, amplitude, wind, damping,
                 model, jonswap_kw):
    """(h0_re, h0_im, h0c_re, h0c_im) in ``layout``: h0 drawn at P(k), its
    partner drawn independently at P(−k) and conjugated
    (FFTMesh.cs:114-116; in the centered layout k at index (N−n, N−m) is
    −k_n exactly)."""
    kx, kz, _ = wavevector_grid(n, length, layout)
    p_pos, p_neg = _spectrum_pair(kx, kz, amplitude, wind, damping, length,
                                  model, jonswap_kw)
    r1, i1 = _sample_planes(generator, p_pos)
    r2, i2 = _sample_planes(generator, p_neg)
    return r1, i1, r2, -i2


def h0_pair_fft_planes(generator: torch.Generator, n: int, length: float,
                       amplitude: float, wind, damping: float,
                       model: str = "phillips", jonswap_kw: dict = None):
    """(h0_re, h0_im, h0c_re, h0c_im) f32 CPU planes in the fft layout."""
    return _pair_planes(generator, "fft", n, length, amplitude, wind,
                        damping, model, jonswap_kw)


def h0_pair_fft(generator: torch.Generator, n: int, length: float,
                amplitude: float, wind, damping: float,
                model: str = "phillips", jonswap_kw: dict = None):
    """(h0, h0_conj) complex64 CPU tensors in the fft layout: the draw of
    h0_pair_fft_planes joined, so one generator state gives both states
    the same h0."""
    r1, i1, r2, i2 = h0_pair_fft_planes(generator, n, length, amplitude,
                                        wind, damping, model, jonswap_kw)
    return torch.complex(r1, i1), torch.complex(r2, i2)


def h0_pair_centered(generator: torch.Generator, n: int, length: float,
                     amplitude: float, wind, damping: float,
                     model: str = "phillips", jonswap_kw: dict = None):
    """(h0, h0_conj) complex64 CPU tensors in the oracle's centered layout
    (FFTMesh.cs:114-116): h0 at P(k_{n,m}), the partner drawn
    independently at P(k_{N−n,N−m}) = P(−k) and conjugated."""
    r1, i1, r2, i2 = _pair_planes(generator, "centered", n, length,
                                  amplitude, wind, damping, model, jonswap_kw)
    return torch.complex(r1, i1), torch.complex(r2, i2)


def dispersion_capillary(k_mag, g: float = G, k_m: float = 370.0):
    """ω(k) = sqrt(g|k|(1 + |k|²/k_m²)) (FFTCommon.cginc:106-114)."""
    return np.sqrt(g * k_mag * (1.0 + (k_mag * k_mag) / (k_m * k_m)))


def dispersion_quantized(k_mag, length: float, g: float = G):
    """ω(k) = floor(sqrt(g|k|)/ω₀)·ω₀ with ω₀ = 2π/L (FFTMesh.cs:141-147)."""
    w0 = 2.0 * PI / length
    return np.floor(np.sqrt(g * k_mag) / w0) * w0


def dispersion(k_mag, mode: str, length: float, g: float = G):
    if mode == "capillary":
        return dispersion_capillary(k_mag, g)
    if mode == "quantized":
        return dispersion_quantized(k_mag, length, g)
    raise ValueError(f"bad dispersion mode {mode!r}")
