"""The ocean solver: init() and step() over an all-f32 plane state.

JAX counterpart: ``tpu_ocean/solver.py`` (``OceanSolver`` with
``fft_backend="pallas"`` or ``"pallas_fused"``, ``real_state=True,
pack_channels=True, half_spectrum=True, pallas_fields=True``:
``_step_impl_real`` → ``_fields_from_phase_real`` →
``_extract_fields_planes``). One step:

  1. φ ← (φ + ω·dt·mult) mod 2π;
  2. ``pallas``: Hermitian-packed assembly of 2 channels in torch
     (evolve.assemble_spectra_packed_real), then channel 0 (height +
     i·disp_x) through the full 2-D inverse DFT and channel 1 (disp_z)
     through the half-spectrum C2R route (fft/planes.py);
     ``pallas_fused``: the same transforms, with each channel assembled
     inside its first row pass (ops/fused_spectrum.py) and only the
     Nyquist row of channel 1 assembled in torch;
  3. the fields stencil on chop·disp, then pos = x0 − chop·disp.

Kernel launches per step on a CUDA device, by regime (N ≤
fft.planes.MAX_TRANSPOSED_N = 2048 transposed, above it natural):

  ``pallas``, transposed:        row DFT transposed 5, fields 1
  ``pallas``, natural:           row DFT natural 3, transposed 2, fields 1
  ``pallas_fused``, transposed:  fused transposed 2, row DFT transposed 3,
                                 fields 1
  ``pallas_fused``, natural:     fused natural 2, row DFT natural 1,
                                 transposed 2, fields 1

Each row-DFT and fused launch runs at the tier and form of its pass
(fft.planes.engine): with ``cfg.precision = "float32"`` and the module
switches at their defaults, every pass is the f32 Stockham kernel; with
``"bfloat16"`` every pass is the matrix engine at bf16 (the same counts,
in fft.planes.matrix_launches). Lowering fft.planes.KERNEL_B3_THRESHOLD
moves float32 passes longer than it to bf16x3, and lowering
THREE_FACTOR_THRESHOLD moves transposed-store passes longer than it (n1
= 128) to the three-factor form, pass by pass: at 1024² with both at
512, the 1024-long passes (``pallas``: row DFT 4; ``pallas_fused``:
fused 2, row DFT 2) run bf16x3 three-factor and the half channel's
512-long column pass stays on the f32 Stockham kernel.

The C2R fold, the interleave, the positions, the phase and (``pallas``)
the assembly are plain torch elementwise work. Any other solver
configuration raises NotImplementedError naming the ROADMAP.md item that
ports it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_ocean_torch.config import EPSILON, OceanConfig
from tpu_ocean_torch.evolve import (
    omega_grid,
    packed_coefficients,
    evolve_phase_accumulate,
    assemble_spectra_packed_real,
    hermitize_planes,
)
from tpu_ocean_torch.fft.planes import (
    check_size,
    ifft2_planes_auto,
    ifft2_planes_half,
)
from tpu_ocean_torch.ops.fields_stencil import fields_stencil
from tpu_ocean_torch.ops.fused_spectrum import ifft2_fused_planes_half
from tpu_ocean_torch.spectra import h0_pair_fft_planes


class OceanStateReal(NamedTuple):
    """All-f32 solver state: h0 carried as (re, im) planes [N, N], the
    accumulated phase [N, N], the clock and step count (0-d) and the
    persistent foam [N, N] (zeros when cfg.foam_decay == 0)."""
    h0_re: torch.Tensor
    h0_im: torch.Tensor
    h0c_re: torch.Tensor
    h0c_im: torch.Tensor
    phase: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor
    foam_accum: torch.Tensor


class OceanFields(NamedTuple):
    """Output fields, [N, N] (normal: [N, N, 3]); axis0 = x, axis1 = z."""
    height: torch.Tensor
    disp_x: torch.Tensor      # raw horizontal displacement (pre-choppiness)
    disp_z: torch.Tensor
    pos_x: torch.Tensor       # displaced positions: x0 − chop·disp_x
    pos_z: torch.Tensor
    normal: torch.Tensor
    foam: torch.Tensor
    jacobian: torch.Tensor


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpu_ocean_torch "
                               f"yet (ROADMAP.md {item})")


class OceanSolver:
    """Owns the f32 tables for one OceanConfig on one device and runs the
    packed + half-spectrum step through the row-DFT (or fused assembly +
    row-DFT) and fields kernels. ``device`` defaults to the CUDA card;
    pass ``device="cpu"`` for the plain versions (there is no fallback:
    without a card the default raises, as torch does)."""

    def __init__(self, cfg: OceanConfig, *, device="cuda",
                 fft_backend: str = "pallas",
                 eval_mode: str = "fft", real_state: bool = True,
                 pack_channels: bool = True, half_spectrum: bool = True,
                 pallas_fields: bool = True):
        rest = "Queue 1 item 7"
        if fft_backend not in ("pallas", "pallas_fused"):
            raise _not_ported(f"fft_backend={fft_backend!r}", rest)
        if eval_mode != "fft":
            raise _not_ported(f"eval_mode={eval_mode!r}", rest)
        for name, value, want in (
                ("spectrum_layout", cfg.spectrum_layout, "fft"),
                ("evolution_mode", cfg.evolution_mode, "phase"),
                ("normals_mode", cfg.normals_mode, "stencil")):
            if value != want:
                raise _not_ported(f"{name}={value!r}", rest)
        for name, value in (("real_state", real_state),
                            ("pack_channels", pack_channels),
                            ("half_spectrum", half_spectrum),
                            ("pallas_fields", pallas_fields)):
            if not value:
                raise _not_ported(f"{name}=False", rest)
        n = cfg.resolution
        if n % 16 != 0 or n < 64:
            raise ValueError("half_spectrum needs resolution % 16 == 0 "
                             "and >= 64")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # rows and full columns; the half channel's columns. The fused
            # kernels take the row kernel's shared memory, so the same N
            # fit both (N = 8192: 192 KB a block at one row).
            check_size(n)
            check_size(n // 2)
        self.cfg = cfg
        self.fft_backend = fft_backend
        # every transform's precision (tpu_ocean/solver.py _mxu_precision)
        self.precision = cfg.precision
        self.dz_sign = -1.0 if cfg.oracle_sign_quirk else 1.0

        def table(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(self.device)

        # float64 tables cast once to f32, as tpu_ocean/solver.py:254-276;
        # the fused route assembles in its kernels and keeps only the
        # packed table's Nyquist row (pack_nyq, tpu_ocean/solver.py:263)
        self.omega = table(omega_grid(cfg))
        pack = packed_coefficients(cfg, 3)
        if fft_backend == "pallas_fused":
            self.pack_nyq = table(pack[:, n // 2:n // 2 + 1, :])
        else:
            self.pack = table(pack)
        x1d = np.arange(n, dtype=np.float64) * (cfg.length / n)
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self.x0 = table(x0)
        self.z0 = table(z0)

    # ------------------------------------------------------------------ init

    def symmetrize(self, state: OceanStateReal) -> OceanStateReal:
        """Project the h0 pair onto its Hermitian part (bitwise idempotent),
        which the packed extraction and the C2R route rely on."""
        ar, ai, acr, aci = hermitize_planes(
            state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        return state._replace(h0_re=ar, h0_im=ai, h0c_re=acr, h0c_im=aci)

    def init(self, generator: Optional[torch.Generator] = None,
             h0=None, h0_conj=None) -> OceanStateReal:
        """Initial state: sample h0 from ``generator`` (a CPU generator;
        default seeded with cfg.seed), or inject a complex (h0, h0_conj)
        pair (numpy or anything np.asarray takes). Phase starts at 0."""
        cfg = self.cfg
        n = cfg.resolution
        if h0 is None:
            if generator is None:
                generator = torch.Generator().manual_seed(cfg.seed)
            planes = h0_pair_fft_planes(
                generator, n, cfg.length, cfg.phillips_amplitude, cfg.wind,
                cfg.damping, model=cfg.spectrum_model,
                jonswap_kw=cfg.jonswap_kw)
        else:
            h0_np, h0c_np = np.asarray(h0), np.asarray(h0_conj)
            planes = [torch.from_numpy(np.asarray(a, dtype=np.float32))
                      for a in (np.real(h0_np), np.imag(h0_np),
                                np.real(h0c_np), np.imag(h0c_np))]
        r1, i1, r2, i2 = (p.to(self.device) for p in planes)
        zeros = torch.zeros((n, n), dtype=torch.float32, device=self.device)
        return self.symmetrize(OceanStateReal(
            h0_re=r1, h0_im=i1, h0c_re=r2, h0c_im=i2,
            phase=zeros,
            t=torch.zeros((), dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            foam_accum=zeros.clone()))

    # ------------------------------------------------------------------ step

    def step(self, state: OceanStateReal, dt: float = 1.0 / 60.0):
        """Advance one step; returns (new_state, OceanFields)."""
        cfg = self.cfg
        dt32 = np.float32(dt)
        # dt·mult rounded to f32 first, as the JAX step forms it
        phase = evolve_phase_accumulate(
            state.phase, self.omega, float(dt32 * np.float32(cfg.dt_multiplier)))
        out = self._fields_from_phase(state, phase)

        foam_accum = state.foam_accum
        if cfg.foam_decay > 0.0:
            # persistent foam: new crests refresh it, old foam e-folds away
            decay = np.exp(np.float32(-cfg.foam_decay) * dt32, dtype=np.float32)
            foam_accum = torch.maximum(out.foam, state.foam_accum * float(decay))
            out = out._replace(foam=foam_accum)

        new_state = state._replace(phase=phase, t=state.t + float(dt32),
                                   step=state.step + 1, foam_accum=foam_accum)
        return new_state, out

    def _fields_from_phase(self, state: OceanStateReal, phase) -> OceanFields:
        pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        if self.fft_backend == "pallas_fused":
            re_f, im_f, disp_z = ifft2_fused_planes_half(
                pair, phase, self.cfg.length, self.dz_sign, self.pack_nyq,
                epsilon=EPSILON, precision=self.precision)
            return self._extract_fields(re_f[0], im_f[0], disp_z)
        re, im = assemble_spectra_packed_real(pair, phase, self.pack)
        mh = self.cfg.resolution // 2
        re_f, im_f = ifft2_planes_auto(re[:-1], im[:-1], True, self.precision)
        disp_z = ifft2_planes_half(re[-1:, :mh + 1], im[-1:, :mh + 1], True,
                                   self.precision)[0]
        return self._extract_fields(re_f[0], im_f[0], disp_z)

    def _extract_fields(self, height, disp_x, disp_z) -> OceanFields:
        cfg = self.cfg
        chop_dx = cfg.choppiness * disp_x
        chop_dz = cfg.choppiness * disp_z
        normal, foam, jac = fields_stencil(chop_dx, height, chop_dz,
                                           cfg.length / cfg.resolution)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=self.x0 - chop_dx, pos_z=self.z0 - chop_dz,
                           normal=normal, foam=foam, jacobian=jac)
