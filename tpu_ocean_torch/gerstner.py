"""Gerstner / sinusoid wave-bank pond solver.

JAX counterpart: ``tpu_ocean/gerstner.py``. The reference evaluates
trochoidal wave superpositions per vertex in the pond vertex shader
(MistralWaterLib.cginc): ``Gerstner`` (:71-99, a packed 4-wave bank whose
normal is overwritten with (0, 1, 0), kept as ``normal_mode="flat"``),
``GerstnerLevelOne`` (:101-125, 5 hard-coded waves) and ``Wave`` (:127-152,
a sinusoid sheet with a finite-difference normal). Here the bank is an
array of W waves (BASELINE config 3 runs 16) evaluated per grid point.

``PondSolver`` holds the f32 coordinate grids on one device. With
``use_pallas=True`` the ``"gerstner"`` mode goes through the wave-bank
kernel (``ops/gerstner_bank.py``: the hand-written CUDA kernel on the card,
its plain version on the CPU); otherwise through ``gerstner_eval``, the
torch broadcast over a trailing W axis that mirrors the JAX package's
jnp path. The other functions here are plain torch on whatever device
their inputs are on.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_ocean_torch import grids
from tpu_ocean_torch.config import PondConfig
from tpu_ocean_torch.ops.gerstner_bank import gerstner_bank, pack_bank


@dataclasses.dataclass(frozen=True)
class WaveBank:
    """W superposed trochoidal waves. All fields are length-W tuples so the
    bank is hashable."""

    amps: tuple          # vertical amplitude a_w
    steeps: tuple        # horizontal (choppiness) factor s_w
    dirs_x: tuple        # direction x (NOT normalized — the reference never does)
    dirs_z: tuple
    freqs: tuple         # spatial frequency f_w
    omegas: tuple        # temporal frequency ω_w (phase = f·dot(d,p) + ω·t)

    def __len__(self):
        return len(self.amps)

    def as_arrays(self, dtype=np.float32):
        return {k: np.asarray(getattr(self, k), dtype=dtype)
                for k in ("amps", "steeps", "dirs_x", "dirs_z", "freqs", "omegas")}

    @staticmethod
    def from_packed4(cfg: PondConfig) -> "WaveBank":
        """The packed-4 Gerstner bank (MistralWaterLib.cginc:71-99): shared
        amplitude/frequency/steepness, per-wave direction (AB.xy, AB.zw,
        CD.xy, CD.zw) and speed; ω_w = speed_w (t4 = _Time·speed, :81)."""
        a = cfg.amplitude * cfg.amplitude_scale   # call site ·0.01 (:172)
        ab, cd = cfg.w_direction_ab, cfg.w_direction_cd
        dirs = [(ab[0], ab[1]), (ab[2], ab[3]), (cd[0], cd[1]), (cd[2], cd[3])]
        return WaveBank(
            amps=(a,) * 4,
            steeps=(cfg.steepness,) * 4,
            dirs_x=tuple(d[0] for d in dirs),
            dirs_z=tuple(d[1] for d in dirs),
            freqs=(cfg.frequency,) * 4,
            omegas=tuple(cfg.w_speed),
        )

    @staticmethod
    def level_one(cfg: PondConfig) -> "WaveBank":
        """The 5-wave hard-coded bank (MistralWaterLib.cginc:105-109):
        per-wave factors multiply the global parameters; ω_w = speed_w·f_w."""
        amps = (0.7, 0.6, 0.6, 0.7, 0.9)
        steeps = (0.95, 0.615, 0.821, 0.462, 0.611)
        speeds = (-2.112, 0.6124, -0.878, -3.6234, 1.0)
        dirs = ((1, -0.2), (-0.9, 1), (0.2, 0.2), (-1.0, 0.77), (0.99, -1.145))
        fs = (0.954, 1.52, 0.44, 0.21, 0.8)
        a = cfg.amplitude * cfg.amplitude_scale
        freqs = tuple(cfg.frequency * f for f in fs)
        return WaveBank(
            amps=tuple(a * x for x in amps),
            steeps=tuple(cfg.steepness * s for s in steeps),
            dirs_x=tuple(d[0] for d in dirs),
            dirs_z=tuple(d[1] for d in dirs),
            freqs=freqs,
            omegas=tuple(s * f for s, f in zip(speeds, freqs)),
        )

    @staticmethod
    def random(seed: int, num_waves: int, amplitude: float = 0.1,
               freq_range=(0.1, 2.0), speed_range=(0.5, 3.0),
               steepness: float = 0.8) -> "WaveBank":
        """A reproducible W-wave bank (BASELINE config 3 uses W=16); the same
        seed gives the JAX package's bank (numpy's default_rng)."""
        rng = np.random.default_rng(seed)
        theta = rng.uniform(0, 2 * np.pi, num_waves)
        freqs = rng.uniform(*freq_range, num_waves)
        # amplitude ∝ 1/frequency keeps the superposition non-self-intersecting
        amps = amplitude / np.maximum(freqs, 1e-3)
        omegas = rng.uniform(*speed_range, num_waves) * freqs
        return WaveBank(
            amps=tuple(amps.tolist()),
            steeps=(steepness / num_waves,) * num_waves,
            dirs_x=tuple(np.cos(theta).tolist()),
            dirs_z=tuple(np.sin(theta).tolist()),
            freqs=tuple(freqs.tolist()),
            omegas=tuple(omegas.tolist()),
        )


class PondFields(NamedTuple):
    offset_x: torch.Tensor
    offset_y: torch.Tensor   # height
    offset_z: torch.Tensor
    normal: torch.Tensor     # [N, N, 3]

    # serving aliases, the ocean's wire names. SIGN: the ocean's rule is
    # displaced_x = x − chop·disp_x (FFTMesh.cs:245) while the pond shader
    # ADDS its offsets (MistralWaterLib.cginc Displacement: vertex.xyz +=
    # offs), so the aliases negate the offsets: x − disp_x == x + offset_x.
    @property
    def height(self):
        return self.offset_y

    @property
    def disp_x(self):
        return -self.offset_x

    @property
    def disp_z(self):
        return -self.offset_z


def _time(t, like: torch.Tensor) -> torch.Tensor:
    """t as a 0-d f32 tensor on ``like``'s device (JAX: jnp.asarray(t, f32))."""
    return torch.tensor(float(np.float32(t)), dtype=torch.float32,
                        device=like.device)


def _normalize(n: torch.Tensor) -> torch.Tensor:
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def gerstner_eval(bank: WaveBank, x, z, t, normal_mode: str = "analytic"):
    """Evaluate the wave bank at positions (x, z), time t, as a broadcast
    over a trailing W axis.

    normal_mode:
      * 'flat'     — reference parity: normal forced to (0,1,0)
                     (MistralWaterLib.cginc:98,121).
      * 'analytic' — exact trochoidal normal
                     n = (−Σ d_x f a cos, 1 − Σ s f a sin, −Σ d_z f a cos).
    """
    amps, steeps, dx, dz, freqs, omegas = pack_bank(bank, x.device)
    phase = (freqs * (x[..., None] * dx + z[..., None] * dz)
             + omegas * _time(t, x))
    c = torch.cos(phase)
    s = torch.sin(phase)
    off_x = torch.sum(steeps * amps * dx * c, dim=-1)
    off_z = torch.sum(steeps * amps * dz * c, dim=-1)
    off_y = torch.sum(amps * s, dim=-1)
    if normal_mode == "flat":
        n = torch.stack([torch.zeros_like(off_y), torch.ones_like(off_y),
                         torch.zeros_like(off_y)], dim=-1)
    elif normal_mode == "analytic":
        nx = -torch.sum(dx * freqs * amps * c, dim=-1)
        nz = -torch.sum(dz * freqs * amps * c, dim=-1)
        ny = 1.0 - torch.sum(steeps * freqs * amps * s, dim=-1)
        n = _normalize(torch.stack([nx, ny, nz], dim=-1))
    else:
        raise ValueError(f"bad normal_mode {normal_mode!r}")
    return PondFields(off_x, off_y, off_z, n)


def sinusoid_eval(cfg: PondConfig, x, z, t):
    """The _DISPLACEMENTMODE_WAVE sheet (MistralWaterLib.cginc:127-152).

    y(p) = A·sin(s·t + p.x·f) − A·cos(s·t + p.z·f), A = amplitude·0.01 (:134);
    normal from two finite-difference taps at +0.05 in x and z (:130-131) with
    the smoothing blend (:144-145): dy ← dy·smoothing before the cross product
    cross(v2−v0, v1−v0) (:147).
    """
    a = cfg.amplitude * 0.01
    f = cfg.frequency
    st = cfg.speed * _time(t, x)

    def height(px, pz):
        return torch.sin(st + px * f) * a - torch.cos(st + pz * f) * a

    y0 = height(x, z)
    eps = 0.05
    y1 = height(x + eps, z)       # v1 = v0 + (0.05, 0, 0)
    y2 = height(x, z + eps)       # v2 = v0 + (0, 0, 0.05)
    dy1 = (y1 - y0) * cfg.smoothing
    dy2 = (y2 - y0) * cfg.smoothing
    # v2−v0 = (0, dy2, eps); v1−v0 = (eps, dy1, 0); n = cross(v2−v0, v1−v0)
    n = _normalize(torch.stack([-eps * dy1, torch.full_like(y0, eps * eps),
                                -eps * dy2], dim=-1))
    zeros = torch.zeros_like(y0)
    return PondFields(zeros, y0, zeros, n)


def gerstner_velocity(bank: WaveBank, x, z, t):
    """Analytic vertical surface velocity ∂y/∂t of the Gerstner bank:
    y = Σ a_w sin(f_w·dot(d_w, p) + ω_w t)  ⇒  ∂y/∂t = Σ a_w ω_w cos(...)."""
    amps, _, dx, dz, freqs, omegas = pack_bank(bank, x.device)
    phase = (freqs * (x[..., None] * dx + z[..., None] * dz)
             + omegas * _time(t, x))
    return torch.sum(amps * omegas * torch.cos(phase), dim=-1)


def sinusoid_velocity(cfg: PondConfig, x, z, t):
    """∂y/∂t of the _DISPLACEMENTMODE_WAVE sheet (MistralWaterLib.cginc:134):
    y = A·sin(s·t + x·f) − A·cos(s·t + z·f)
    ⇒ ∂y/∂t = A·s·(cos(s·t + x·f) + sin(s·t + z·f))."""
    a = cfg.amplitude * 0.01
    st = cfg.speed * _time(t, x)
    return a * cfg.speed * (torch.cos(st + x * cfg.frequency)
                            + torch.sin(st + z * cfg.frequency))


class PondSolver:
    """Pond solver over a regular grid on one device (BASELINE config 3:
    512², 16 waves). ``device`` defaults to the CUDA card; pass
    ``device="cpu"`` for the plain versions (without a card the default
    raises, as torch does)."""

    def __init__(self, cfg: PondConfig, bank: Optional[WaveBank] = None,
                 normal_mode: str = "analytic", use_pallas: bool = False, *,
                 device="cuda"):
        self.cfg = cfg
        if bank is None and cfg.displacement_mode == "gerstner":
            bank = WaveBank.from_packed4(cfg)
        self.bank = bank
        self.normal_mode = normal_mode
        self.use_pallas = use_pallas
        self.device = torch.device(device)
        x, z = grids.coordinate_grid(cfg.resolution, cfg.unit_width)
        # float64 grids cast once to f32, as tpu_ocean/gerstner.py:263-264
        self._x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(self.device)
        self._z = torch.from_numpy(np.asarray(z, dtype=np.float32)).to(self.device)
        # the kernel's [6, W] bank, moved to the device once
        self._packed = (pack_bank(bank, self.device)
                        if use_pallas and bank is not None else None)

    def fields(self, t: float) -> PondFields:
        """PondFields at time ``t`` (rounded to f32)."""
        t = float(np.float32(t))
        mode = self.cfg.displacement_mode
        if mode == "gerstner":
            if self.use_pallas:
                return PondFields(*gerstner_bank(self._packed, self._x, self._z,
                                                 t, self.normal_mode))
            return gerstner_eval(self.bank, self._x, self._z, t,
                                 self.normal_mode)
        if mode == "wave":
            return sinusoid_eval(self.cfg, self._x, self._z, t)
        # 'off' — flat rest surface
        zeros = torch.zeros_like(self._x)
        flat = torch.stack([zeros, torch.ones_like(zeros), zeros], dim=-1)
        return PondFields(zeros, zeros, zeros, flat)

    def velocity(self, t) -> torch.Tensor:
        """Vertical surface velocity ∂h/∂t [N, N] at time ``t``, analytic for
        both wave families. The pond is stateless in t, so the 'state' a
        serving runtime holds is the clock: runtime.PondSimulation passes
        its t here."""
        t = float(np.float32(t))
        mode = self.cfg.displacement_mode
        if mode == "gerstner":
            return gerstner_velocity(self.bank, self._x, self._z, t)
        if mode == "wave":
            return sinusoid_velocity(self.cfg, self._x, self._z, t)
        return torch.zeros_like(self._x)
