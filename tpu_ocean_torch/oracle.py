"""The reference's CPU direct-DFT ocean in float64 numpy (component C12).

JAX counterpart: ``tpu_ocean/oracle.py``, whose code this copies; it is a
copy and not an import because ``import tpu_ocean.oracle`` runs
``tpu_ocean/__init__``, which imports jax. ``Oracle(cfg, rng=...)`` draws
the same h0 pair from the same numpy generator and evaluates the same
fields, bit for bit (tests/test_torch_oracle.py). The ``fftmesh`` demo
scene holds the solver against it.

It is a faithful re-implementation of ``FFTMesh.cs``, the reference's
self-contained "theory" path that evaluates the Tessendorf sum by brute
force. Per vertex x and per wavevector k (FFTMesh.cs:192-220):

    h̃(k,t)   = h0(k)·e^{iωt} + h0*(k)·e^{−iωt}          (FFTMesh.cs:178-190)
    h(x)     += Re[ h̃ · e^{+i k·x} ]                     (:208-211)
    n        += (−kx, 0, −kz) · Im[ h̃ · e^{i k·x} ]      (:212)
    d        += (kx/|k|, −kz/|k|) · Im[ h̃ · e^{i k·x} ]  (:215, note the −kz
                                                          sign quirk on z)
    normal    = normalize((0,1,0) − n)                    (:218)
    pos       = (x0 − chop·d.x, h, z0 − chop·d.z)         (:243-245)

with k = 2π(i − N/2)/L (:201,204), quantized dispersion
ω = floor(sqrt(g|k|)/ω0)·ω0, ω0 = 2π/L (:141-147), and Jacobian foam from
one-sided finite differences of d (:253-276).

Because every term factorizes as H[n,m]·e^{i kx_n x_i}·e^{i kz_m z_j}, the
O(N⁴) double loop collapses into two complex matrix products per field —
O(N³) total — without changing a single operation's mathematical value
(summation order differs; float64 makes that immaterial).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tpu_ocean_torch.config import G, PI, EPSILON, OceanConfig
from tpu_ocean_torch.grids import coordinate_1d


def _smoothstep01(t: np.ndarray) -> np.ndarray:
    """Unity Mathf.SmoothStep(0, 1, t): clamp01 then 3t² − 2t³ (FFTMesh.cs:273)."""
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass
class OracleFields:
    """All prognostic fields after one oracle evaluation, [N, N] float64,
    axis0 = x (loop i), axis1 = z (loop j)."""

    height: np.ndarray          # h(x), FFTMesh.cs:243 (vertMeow.y)
    disp_x: np.ndarray          # raw d.x before choppiness (hds[:,0], :247)
    disp_z: np.ndarray          # raw d.z before choppiness (hds[:,1], :247)
    pos_x: np.ndarray           # displaced x = x0 − chop·d.x (:245)
    pos_z: np.ndarray           # displaced z = z0 − chop·d.z (:244)
    normal: np.ndarray          # [N, N, 3] unit normals (:218,246)
    foam: np.ndarray            # smoothstepped turbulence (:268-274)
    jacobian: np.ndarray        # raw Jacobian determinant (:268)


class Oracle:
    """Reference-exact direct-DFT evaluator.

    Parameters
    ----------
    config : OceanConfig — uses resolution, length, wind, amplitude (raw, the
        CPU path applies no 1e−4 scale), choppiness, unit_width.
    h0, h0_conj : optional complex[N, N] arrays. The reference draws these with
        Unity's global RNG (FFTMesh.cs:168-176), which is not reproducible;
        parity tests inject the SAME arrays into oracle and solver
        (SURVEY.md §7 "Two RNG regimes"). When omitted, fresh Gaussians are
        drawn from ``rng`` exactly per the reference recipe.
    """

    def __init__(self, config: OceanConfig,
                 h0: Optional[np.ndarray] = None,
                 h0_conj: Optional[np.ndarray] = None,
                 rng: Optional[np.random.Generator] = None):
        self.cfg = config
        n = config.resolution
        self.n = n
        self.length = float(config.length)

        idx = np.arange(n, dtype=np.float64)
        # k = 2π(i − N/2)/L  ==  π(2i − N)/L  (FFTMesh.cs:144-145,201,204)
        self.k1d = 2.0 * PI * (idx - n / 2.0) / self.length
        self.kx = self.k1d[:, None] * np.ones((1, n))
        self.kz = np.ones((n, 1)) * self.k1d[None, :]
        self.k_mag = np.sqrt(self.kx ** 2 + self.kz ** 2)

        # Quantized dispersion (FFTMesh.cs:141-147).
        w0 = 2.0 * PI / self.length
        self.omega = np.floor(np.sqrt(G * self.k_mag) / w0) * w0

        # Mesh sample positions (FFTMesh.cs:107,111-112).
        self.x1d = coordinate_1d(n, config.unit_width)

        if h0 is None or h0_conj is None:
            rng = rng or np.random.default_rng(config.seed)
            h0, h0_conj = self._draw_h0(rng)
        self.h0 = np.asarray(h0, dtype=np.complex128)
        self.h0_conj = np.asarray(h0_conj, dtype=np.complex128)

        # DFT basis matrices E[n, i] = e^{i k_n x_i}; the x and z factors are
        # identical because the grid is square with equal spacing.
        self.ex = np.exp(1j * np.outer(self.k1d, self.x1d))  # [n_k, n_x]

    # -- reference h0 recipe ------------------------------------------------

    def _phillips_at(self, n_idx: np.ndarray, m_idx: np.ndarray) -> np.ndarray:
        """Phillips evaluated at raw integer indices, formula-wise — including
        out-of-range indices like N (FFTMesh.cs:115 calls htilde0(N−i, N−j),
        which for i=0 evaluates Phillips(N, N))."""
        kx = (2.0 * n_idx - self.n) / self.length * PI
        kz = (2.0 * m_idx - self.n) / self.length * PI
        k_mag = np.sqrt(kx * kx + kz * kz)
        wind = np.asarray(self.cfg.wind, dtype=np.float64)
        w_len = np.linalg.norm(wind)
        l = w_len * w_len / G
        l2 = l * l
        damping = self.cfg.damping
        big_l2 = l2 * damping * damping
        k2 = np.maximum(k_mag * k_mag, 1e-300)
        k4 = np.maximum(k2 * k2, 1e-300)
        k_dot_w = (kx * wind[0] + kz * wind[1]) / np.maximum(k_mag * w_len, 1e-300)
        p = (self.cfg.amplitude * np.exp(-1.0 / (k2 * l2)) / k4
             * k_dot_w ** 2 * np.exp(-k2 * big_l2))
        return np.where(k_mag < EPSILON, 0.0, p)

    def _draw_h0(self, rng: np.random.Generator):
        """Box–Muller h0 pairs per FFTMesh.cs:114-116,168-176."""
        n = self.n
        i_idx = np.arange(n, dtype=np.float64)[:, None] * np.ones((1, n))
        j_idx = np.ones((n, 1)) * np.arange(n, dtype=np.float64)[None, :]

        def bm(shape):
            z1 = np.clip(rng.random(shape), 1e-12, 1.0)
            z2 = rng.random(shape)
            r = np.sqrt(-2.0 * np.log(z1))
            return r * np.cos(2 * PI * z2) + 1j * r * np.sin(2 * PI * z2)

        h0 = bm((n, n)) * np.sqrt(self._phillips_at(i_idx, j_idx) / 2.0)
        h0b = bm((n, n)) * np.sqrt(self._phillips_at(n - i_idx, n - j_idx) / 2.0)
        return h0, np.conj(h0b)

    # -- evaluation ----------------------------------------------------------

    def htilde(self, t: float) -> np.ndarray:
        """h̃(k, t) = h0·e^{iωt} + h0*·e^{−iωt} (FFTMesh.cs:178-190)."""
        phase = np.exp(1j * self.omega * t)
        return self.h0 * phase + self.h0_conj * np.conj(phase)

    def _sum(self, coeff_times_h: np.ndarray) -> np.ndarray:
        """Σ_{n,m} C[n,m] · e^{i kx_n x_i} · e^{i kz_m z_j} → [N_x, N_z]."""
        return self.ex.T @ coeff_times_h @ self.ex

    def fields(self, t: float) -> OracleFields:
        n = self.n
        h = self.htilde(t)

        s_h = self._sum(h)
        height = s_h.real                                     # FFTMesh.cs:211,219

        inv_k = np.where(self.k_mag < EPSILON, 0.0, 1.0 / np.maximum(self.k_mag, 1e-300))
        disp_x = self._sum(h * (self.kx * inv_k)).imag        # :215 (+kx/|k|·Im)
        disp_z = self._sum(h * (-self.kz * inv_k)).imag       # :215 (−kz/|k|·Im)

        n_x = self._sum(h * (-self.kx)).imag                  # :212
        n_z = self._sum(h * (-self.kz)).imag
        normal = np.stack([-n_x, np.ones_like(n_x), -n_z], axis=-1)  # :218
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)

        chop = self.cfg.choppiness
        x0 = self.x1d[:, None] * np.ones((1, n))
        z0 = np.ones((n, 1)) * self.x1d[None, :]
        pos_x = x0 - disp_x * chop                            # :245
        pos_z = z0 - disp_z * chop                            # :244

        # Jacobian foam (FFTMesh.cs:253-276): one-sided differences, zero at
        # the far boundary; dDdx steps along i (x), dDdy along j (z).
        hds = np.stack([disp_x, disp_z], axis=-1)
        d_dx = np.zeros_like(hds)
        d_dy = np.zeros_like(hds)
        d_dx[:-1, :, :] = 0.5 * (hds[:-1, :, :] - hds[1:, :, :])   # :262
        d_dy[:, :-1, :] = 0.5 * (hds[:, :-1, :] - hds[:, 1:, :])   # :266
        jacobian = (1.0 + d_dx[..., 0]) * (1.0 + d_dy[..., 1]) - d_dx[..., 1] * d_dy[..., 0]
        noise = 0.3 * np.stack([np.abs(normal[..., 0]), np.abs(normal[..., 2])], axis=-1)
        turb = np.maximum(1.0 - jacobian + np.linalg.norm(noise, axis=-1), 0.0)  # :270
        foam = _smoothstep01(turb)                            # :273

        return OracleFields(height=height, disp_x=disp_x, disp_z=disp_z,
                            pos_x=pos_x, pos_z=pos_z, normal=normal,
                            foam=foam, jacobian=jacobian)
