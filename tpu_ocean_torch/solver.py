"""The ocean solver: init(), step(), fields_at() and velocity() over an
all-f32 plane state.

JAX counterpart: ``tpu_ocean/solver.py`` (``OceanSolver`` with
``real_state=True`` in the fft layout: ``_step_impl_real`` →
``_fields_from_phase_real`` → ``_extract_fields_planes``, ``fields_at``,
``_velocity_real_impl``). Every switch of that step is here:
``fft_backend`` "pallas" or "pallas_fused"; the channel sets per-channel
(``pack_channels=False``), packed, or packed + half (``half_spectrum``);
stencil or spectral normals (``cfg.normals_mode``, 3 or 5 live fields);
the fields kernel on or off (``pallas_fields``); phase or absolute time
(``cfg.evolution_mode``). One step:

  1. phase mode: φ ← (φ + ω·dt·mult) mod 2π; absolute mode: t ← t +
     dt/t_division and φ = ω·t (the state keeps its phase);
  2. ``pallas``: the assembly in torch (evolve.assemble_spectra_real or
     assemble_spectra_packed_real), then every channel through the full
     2-D inverse DFT, or with half_spectrum all but the last packed
     channel, which takes the half-spectrum C2R route (fft/planes.py);
     ``pallas_fused``: the same transforms, with each channel assembled
     inside its first row pass (ops/fused_spectrum.py) and, with
     half_spectrum, only the Nyquist row of the half channel assembled in
     torch;
  3. the fields: the fields kernel on chop·disp, or in plain torch
     (fields.normals_stencil or normals_spectral, then whitecap_gpu), as
     the JAX package computes them outside Pallas; pos = x0 − chop·disp.

Kernel launches per step on a CUDA device (C = channels transformed: with
stencil normals 3 per-channel, 2 packed; with spectral normals 5 and 3),
by regime (N ≤ fft.planes.MAX_TRANSPOSED_N = 2048 transposed, above it
natural), and one fields launch with ``pallas_fields``:

  packed + half, ``pallas``, transposed:  row DFT transposed 5
                 ``pallas``, natural:     row DFT natural 3, transposed 2
                 ``pallas_fused``, tr.:   fused transposed 2, row DFT
                                          transposed 3
                 ``pallas_fused``, nat.:  fused natural 2, row DFT natural
                                          1, transposed 2
  otherwise (all C channels in one launch a pass),
                 ``pallas``, transposed:  row DFT transposed 2
                 ``pallas``, natural:     row DFT natural 1, transposed 1
                 ``pallas_fused``, tr.:   fused transposed 1, row DFT
                                          transposed 1
                 ``pallas_fused``, nat.:  fused natural 1, row DFT
                                          transposed 1

Each row-DFT and fused launch runs at the tier and form of its pass
(fft.planes.engine): with ``cfg.precision = "float32"`` and the module
switches at their defaults, every pass is the f32 Stockham kernel; with
``"bfloat16"`` every pass is the matrix engine at bf16 (the same counts,
in fft.planes.named_launches). A fused launch outside the packed set with
3 live fields counts there too, under its channel set
("fused_transposed[per_channel]", "fused_natural[packed5]"). Lowering fft.planes.KERNEL_B3_THRESHOLD
moves float32 passes longer than it to bf16x3, and lowering
THREE_FACTOR_THRESHOLD moves transposed-store passes longer than it (n1
= 128) to the three-factor form, pass by pass: at 1024² packed + half
with both at 512, the 1024-long passes (``pallas``: row DFT 4;
``pallas_fused``: fused 2, row DFT 2) run bf16x3 three-factor and the
half channel's 512-long column pass stays on the f32 Stockham kernel.

The C2R fold, the interleave, the positions, the phase and (``pallas``)
the assembly are plain torch elementwise work. The complex state
(``real_state=False``), the other backends, the centered layout,
``eval_mode="direct"``, ``reconfigure`` and ``gpu_hash_seeds`` raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_ocean_torch import fields as field_ops
from tpu_ocean_torch.config import EPSILON, OceanConfig
from tpu_ocean_torch.evolve import (
    omega_grid,
    spectrum_coefficients,
    packed_coefficients,
    evolve_phase_absolute,
    evolve_phase_accumulate,
    assemble_spectra_real,
    assemble_spectra_packed_real,
    hermitize_planes,
)
from tpu_ocean_torch.fft.planes import (
    check_size,
    ifft2_planes_auto,
    ifft2_planes_half,
)
from tpu_ocean_torch.ops.fields_stencil import fields_stencil
from tpu_ocean_torch.ops.fused_spectrum import (
    ifft2_fused_planes, ifft2_fused_planes_half)
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
                               f"yet (ROADMAP.md Queue 1 item {item})")


#: the JAX package's complex-state backends (tpu_ocean/fft/__init__.py)
_COMPLEX_BACKENDS = ("reference", "stockham", "matmul")


class OceanSolver:
    """Owns the f32 tables for one OceanConfig on one device and runs the
    real-state step through the row-DFT (or fused assembly + row-DFT) and
    fields kernels. ``device`` defaults to the CUDA card; pass
    ``device="cpu"`` for the plain versions (there is no fallback: without
    a card the default raises, as torch does). The switches default to
    OCEAN_DEMO's packed + half step with the fields kernel; they take
    every value the JAX ``OceanSolver(real_state=True)`` takes in the fft
    layout and raise ValueError where it raises ValueError."""

    def __init__(self, cfg: OceanConfig, *, device="cuda",
                 fft_backend: str = "pallas",
                 eval_mode: str = "fft", real_state: bool = True,
                 pack_channels: bool = True, half_spectrum: bool = True,
                 pallas_fields: bool = True):
        if eval_mode not in ("fft", "direct"):
            raise ValueError(f"bad eval_mode {eval_mode!r}")
        if eval_mode == "direct":
            raise _not_ported("eval_mode='direct'", "7b")
        if not real_state:
            raise _not_ported("real_state=False (the complex state)", "7a")
        if fft_backend in _COMPLEX_BACKENDS:
            raise _not_ported(f"fft_backend={fft_backend!r}", "7a")
        if fft_backend not in ("pallas", "pallas_fused"):
            raise ValueError(f"unknown fft backend {fft_backend!r}")
        if cfg.spectrum_layout != "fft":
            raise _not_ported(f"spectrum_layout={cfg.spectrum_layout!r}",
                              "7a")
        n = cfg.resolution
        # the JAX package's rules (tpu_ocean/solver.py:128-137, 219-253)
        if pallas_fields and (cfg.normals_mode != "stencil" or n % 8 != 0):
            raise ValueError("pallas_fields requires normals_mode='stencil', "
                             "spectrum_layout='fft', and a resolution "
                             "divisible by 8")
        if half_spectrum:
            if not pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if n % 16 != 0 or n < 64:
                raise ValueError("half_spectrum needs resolution % 16 == 0 "
                                 "and >= 64")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # rows and full columns; with half_spectrum the half channel's
            # columns. The fused kernels take the row kernel's shared
            # memory, so the same N fit both (N = 8192: 192 KB a block at
            # one row).
            check_size(n)
            if half_spectrum:
                check_size(n // 2)
        self.cfg = cfg
        self.fft_backend = fft_backend
        self.pack_channels = bool(pack_channels)
        self.half_spectrum = bool(half_spectrum)
        self.pallas_fields = bool(pallas_fields)
        # every transform's precision (tpu_ocean/solver.py _mxu_precision)
        self.precision = cfg.precision
        self.dz_sign = -1.0 if cfg.oracle_sign_quirk else 1.0
        # live fields (stencil normals never read the slope channels) and
        # the channels transformed
        self._nch = 3 if cfg.normals_mode == "stencil" else 5
        self._pch = ((2 if self._nch == 3 else 3) if self.pack_channels
                     else self._nch)

        def table(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(self.device)

        # float64 tables cast once to f32, as tpu_ocean/solver.py:254-276;
        # the fused route assembles in its kernels and keeps only the
        # packed table's Nyquist row (pack_nyq, tpu_ocean/solver.py:263)
        self.omega = table(omega_grid(cfg))
        if not self.pack_channels:
            if fft_backend == "pallas":
                self.coeffs = table(spectrum_coefficients(cfg).real[:self._nch])
        else:
            pack = packed_coefficients(cfg, self._nch)
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
        """Packed solvers: project the h0 pair onto its Hermitian part
        (bitwise idempotent), which the packed extraction and the C2R
        route rely on. Per-channel solvers return the state unchanged."""
        if not self.pack_channels:
            return state
        ar, ai, acr, aci = hermitize_planes(
            state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        return state._replace(h0_re=ar, h0_im=ai, h0c_re=acr, h0c_im=aci)

    def init(self, generator: Optional[torch.Generator] = None,
             h0=None, h0_conj=None, gpu_hash_seeds=None) -> OceanStateReal:
        """Initial state: sample h0 from ``generator`` (a CPU generator;
        default seeded with cfg.seed), or inject a complex (h0, h0_conj)
        pair (numpy or anything np.asarray takes). Phase and clock start
        at 0."""
        if gpu_hash_seeds is not None:
            raise _not_ported("gpu_hash_seeds (the shader-hash h0)", "7c")
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

    def reconfigure(self, state, new_cfg, key=None):
        """Live parameter change (JAX: OceanSolver.reconfigure)."""
        raise _not_ported("reconfigure", "7b")

    # ------------------------------------------------------------------ step

    def step(self, state: OceanStateReal, dt: float = 1.0 / 60.0):
        """Advance one step; returns (new_state, OceanFields)."""
        cfg = self.cfg
        dt32 = np.float32(dt)
        if cfg.evolution_mode == "absolute":
            # dt / t_division and the sum each rounded to f32, as the JAX
            # step forms them (an f32 dt, weak-typed Python floats)
            t_new = state.t + float(dt32 / np.float32(cfg.t_division))
            phase = evolve_phase_absolute(self.omega, t_new)
            phase_state = state.phase
        else:
            # dt·mult rounded to f32 first, as the JAX step forms it
            phase = evolve_phase_accumulate(
                state.phase, self.omega,
                float(dt32 * np.float32(cfg.dt_multiplier)))
            phase_state = phase
            t_new = state.t + float(dt32)
        out = self._fields_from_phase(state, phase)

        foam_accum = state.foam_accum
        if cfg.foam_decay > 0.0:
            # persistent foam: new crests refresh it, old foam e-folds away
            decay = np.exp(np.float32(-cfg.foam_decay) * dt32, dtype=np.float32)
            foam_accum = torch.maximum(out.foam, state.foam_accum * float(decay))
            out = out._replace(foam=foam_accum)

        new_state = state._replace(phase=phase_state, t=t_new,
                                   step=state.step + 1, foam_accum=foam_accum)
        return new_state, out

    def fields_at(self, state: OceanStateReal, t: float) -> OceanFields:
        """The fields at absolute time ``t`` without advancing the state
        (absolute mode only; JAX: OceanSolver.fields_at)."""
        if self.cfg.evolution_mode != "absolute":
            raise ValueError("fields_at evaluates the stateless absolute-"
                             "time form (ω·t); this solver runs "
                             "evolution_mode='phase' — use step() and read "
                             "the returned fields")
        return self._fields_from_phase(
            state, evolve_phase_absolute(self.omega, float(np.float32(t))))

    def velocity(self, state: OceanStateReal,
                 t: Optional[float] = None) -> torch.Tensor:
        """Vertical surface velocity ∂h/∂t [N, N], exact from the
        dispersion relation (JAX: _velocity_real_impl):

            ∂ₜ h̃ = iρω·(h0·e^{iφ} − h0*·e^{−iφ}),   v = Re F(∂ₜ h̃)

        with ρ = dt_multiplier in phase mode (φ advances by ω·dt·ρ) and 1
        in absolute mode. Absolute mode evaluates at ``t`` (default: the
        state's clock); phase mode at the state's phase (pass no t). With
        half_spectrum the spectrum is Hermitian under the packed state's
        projection, so it takes the half-spectrum route, else the full
        transform (both on the row-DFT kernel)."""
        cfg = self.cfg
        if cfg.evolution_mode == "absolute":
            tt = state.t if t is None else float(np.float32(t))
            phase = evolve_phase_absolute(self.omega, tt)
        else:
            if t is not None:
                raise ValueError("phase mode accumulates incrementally: "
                                 "velocity is defined at the state's "
                                 "current phase (pass no t)")
            phase = state.phase
        rate = np.float32(cfg.dt_multiplier
                          if cfg.evolution_mode == "phase" else 1.0)
        cph, sph = torch.cos(phase), torch.sin(phase)
        a, b = state.h0_re, state.h0_im
        cc, d = state.h0c_re, state.h0c_im
        # h0·e^{iφ} − h0*·e^{−iφ} = [(a−c)C − (b+d)S] + i[(b−d)C + (a+c)S]
        diff_re = (a - cc) * cph - (b + d) * sph
        diff_im = (b - d) * cph + (a + cc) * sph
        w = float(rate) * self.omega
        re, im = -(w * diff_im), w * diff_re
        if self.half_spectrum:
            mh = cfg.resolution // 2
            return ifft2_planes_half(re[None, :mh + 1], im[None, :mh + 1],
                                     True, self.precision)[0]
        return ifft2_planes_auto(re[None], im[None], True, self.precision)[0][0]

    # ------------------------------------------------------------- internals

    def _fields_from_phase(self, state: OceanStateReal, phase) -> OceanFields:
        """Assembly, transforms and field extraction at ``phase``
        (_fields_from_phase_real)."""
        pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
        spectral = self._nch == 5
        if self.half_spectrum:
            if self.fft_backend == "pallas_fused":
                re_f, im_f, last = ifft2_fused_planes_half(
                    pair, phase, self.cfg.length, self.dz_sign, self.pack_nyq,
                    epsilon=EPSILON, ch_count=self._pch, nch_live=self._nch,
                    precision=self.precision)
            else:
                re, im = assemble_spectra_packed_real(pair, phase, self.pack)
                mh = self.cfg.resolution // 2
                re_f, im_f = ifft2_planes_auto(re[:-1], im[:-1], True,
                                               self.precision)
                last = ifft2_planes_half(re[-1:, :mh + 1], im[-1:, :mh + 1],
                                         True, self.precision)[0]
            if spectral:
                return self._extract_fields(re_f[0], im_f[0], re_f[1],
                                            im_f[1], last)
            return self._extract_fields(re_f[0], im_f[0], last)
        if self.fft_backend == "pallas_fused":
            re, im = ifft2_fused_planes(
                pair, phase, self.cfg.length, self.dz_sign, epsilon=EPSILON,
                ch_count=self._pch, packed=self.pack_channels,
                nch_live=self._nch, precision=self.precision)
        else:
            if self.pack_channels:
                re, im = assemble_spectra_packed_real(pair, phase, self.pack)
            else:
                re, im = assemble_spectra_real(pair, phase, self.coeffs)
            re, im = ifft2_planes_auto(re, im, True, self.precision)
        if self.pack_channels:
            # the fields alternate Re/Im down the packed channel list
            # (evolve.packed_coefficients)
            if spectral:
                return self._extract_fields(re[0], im[0], re[1], im[1], re[2])
            return self._extract_fields(re[0], im[0], re[1])
        if spectral:
            return self._extract_fields(re[0], im[1], im[2], im[3], im[4])
        return self._extract_fields(re[0], im[1], im[2])

    def _extract_fields(self, height, disp_x, disp_z, slope_x=None,
                        slope_z=None) -> OceanFields:
        """The output fields from the transformed planes
        (_extract_fields_planes): the fields kernel, or the normals
        (stencil or spectral) and the foam in plain torch."""
        cfg = self.cfg
        chop_dx = cfg.choppiness * disp_x
        chop_dz = cfg.choppiness * disp_z
        if self.pallas_fields:
            normal, foam, jac = fields_stencil(chop_dx, height, chop_dz,
                                               cfg.length / cfg.resolution)
        else:
            if cfg.normals_mode == "spectral":
                normal = field_ops.normals_spectral(slope_x, slope_z)
            else:
                normal = field_ops.normals_stencil(
                    chop_dx, height, chop_dz, cfg.length / cfg.resolution)
            foam, jac = field_ops.whitecap_gpu(chop_dx, chop_dz, normal)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=self.x0 - chop_dx, pos_z=self.z0 - chop_dz,
                           normal=normal, foam=foam, jacobian=jac)
