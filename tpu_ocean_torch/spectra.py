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
  * shader h0  — h0_pair_gpu_hash: the GPU path's frac(sin(dot)) hash and
                 Box–Muller (FFTCommon.cginc:87-99), float32 numpy, texel
                 for texel.
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


# ---------------------------------------------------------------------------
# The shader-hash h0 (the InitialSpectrum pass, texel for texel)
# ---------------------------------------------------------------------------

def uv_random_f32(uv_x, uv_y, salt: float, random: float):
    """frac(sin(dot(uv + (salt, random), (12.9898, 78.233))) · 43758.5453)
    with every intermediate held in float32, as the shader's ALU holds it.
    numpy on the host: one ulp of sin becomes ~4e-3 of the result, so the
    card's sin would not replay the texels."""
    f32 = np.float32
    x = (np.asarray(uv_x, f32) + f32(salt))
    y = (np.asarray(uv_y, f32) + f32(random))
    d = (x * f32(12.9898) + y * f32(78.233)).astype(f32)
    v = (np.sin(d, dtype=f32) * f32(43758.5453)).astype(f32)
    return (v - np.floor(v)).astype(f32)


def h0_pair_gpu_hash(n: int, length: float, amplitude: float, wind,
                     seed1: float, seed2: float, damping: float = 0.01):
    """(h0, h0_conj) complex64 numpy, as the InitialSpectrum pass computes
    them (InitialSpectrum.shader:42-54, hTilde0 FFTCommon.cginc:87-99), in
    float32 on the host; the fft layout. Texel-center uv = (i + ½)/N, so
    the shader's n = uv·N = i + ½ feeds GetWave's −½ offset; h0 =
    hTilde0(uv, seed1/2, seed2·2, P(n, m)) and h0_conj = conj(hTilde0(uv,
    seed1, seed2, P(N − n, N − m))); hTilde0 draws two uv_random_f32
    values (salts 10.612 and 11.899), clamps them to [0.01, 1] and takes
    Box–Muller × sqrt(P/2). The reference binds seed1, seed2 from Unity's
    Random.value (OceanRenderer.cs:147-148)."""
    f32 = np.float32
    idx = np.arange(n, dtype=f32)
    uv1 = (idx + f32(0.5)) / f32(n)
    ux, uy = np.meshgrid(uv1, uv1, indexing="ij")
    nn = ux * f32(n)
    mm = uy * f32(n)

    def phillips_shader(pn, pm):
        # Phillips at GetWave's wrapped k (FFTCommon.cginc:58-85)
        a = pn - f32(0.5)
        b = pm - f32(0.5)
        a = np.where(a < n * 0.5, a, a - f32(n)).astype(f32)
        b = np.where(b < n * 0.5, b, b - f32(n)).astype(f32)
        kx = f32(2 * PI) * a / f32(length)
        kz = f32(2 * PI) * b / f32(length)
        return np.asarray(phillips(kx.astype(np.float64),
                                   kz.astype(np.float64),
                                   amplitude, wind, damping), f32)

    def htilde0(r1, r2, phi):
        rand1 = np.clip(uv_random_f32(ux, uy, 10.612, r1),
                        0.01, 1.0).astype(f32)
        rand2 = np.clip(uv_random_f32(ux, uy, 11.899, r2),
                        0.01, 1.0).astype(f32)
        x = np.sqrt(f32(-2.0) * np.log(rand1, dtype=f32)).astype(f32)
        y = (f32(2 * PI) * rand2).astype(f32)
        scale = np.sqrt(phi / f32(2.0)).astype(f32)
        return ((x * np.cos(y, dtype=f32)) * scale
                + 1j * (x * np.sin(y, dtype=f32)) * scale
                ).astype(np.complex64)

    phi1 = phillips_shader(nn, mm)
    phi2 = phillips_shader(f32(n) - nn, f32(n) - mm)
    h0 = htilde0(f32(seed1) / 2, f32(seed2) * 2, phi1)
    h0_conj = np.conj(htilde0(f32(seed1), f32(seed2), phi2))
    return h0, h0_conj
