"""The ocean solver: init(), step(), fields_at(), velocity() and
reconfigure() over the complex state or the all-f32 plane state.

JAX counterpart: ``tpu_ocean/solver.py`` ``OceanSolver``, with its
defaults (``fft_backend="reference"``, ``eval_mode="fft"``, the complex
state, no packing, no half spectrum, the fields in torch), so
``OceanSolver(OceanConfig())`` means what it means in JAX.

The complex state (``real_state=False``; ``_step_impl`` →
``_evolved_transform`` → ``_transform`` → ``_extract_fields``): the h0
pair as complex64, the spectra assembled in torch (evolve.assemble_spectra
or, packed, assemble_spectra_packed), then the backend's 2-D transform
(fft.get_ifft2: ``reference`` torch.fft, ``stockham``, ``matmul``, or
``pallas``, the row-DFT kernels on planes, fft.planes.ifft2_pallas), with
the centered layout's pre/post modulation around it (fft/reference.py
centered_modulation); ``pallas_fused`` runs the fused kernels on the h0
pair's planes (ops.fused_spectrum.ifft2_fused). In the centered layout the
foam takes the oracle's convention (fields.whitecap_oracle) and the rest
positions the reference mesh's (grids.coordinate_1d).

The real state (``real_state=True``, the fft layout, ``pallas`` or
``pallas_fused``; ``_step_impl_real`` → ``_fields_from_phase_real`` →
``_extract_fields_planes``, ``_velocity_real_impl``): the channel sets
per-channel (``pack_channels=False``), packed, or packed + half
(``half_spectrum``); stencil or spectral normals (``cfg.normals_mode``, 3
or 5 live fields); the fields kernel on or off (``pallas_fields``). One
step, either state:

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
     (fields.normals_stencil or normals_spectral, then whitecap_gpu, or in
     the centered layout whitecap_oracle), as the JAX package computes
     them outside Pallas; pos = x0 − chop·disp.

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

The complex state's ``pallas`` transform has the same counts with C =
every live channel (5 with spectral normals); ``pallas_fused`` those of
"otherwise" above. ``reference``, ``stockham`` and ``matmul`` launch no
hand kernel: the JAX package computes them outside Pallas.

The C2R fold, the interleave, the positions, the phase, the modulation
and (``pallas``) the assembly are plain torch elementwise work.

``eval_mode="direct"`` (the centered layout only, the complex state) takes
the oracle's direct sum as complex matrix products, F_c = Eᵀ·C_c·E with
E[n, i] = e^{i·k_n·x_i} built in float64 and cast once to complex64, in
f32 whatever ``cfg.precision`` (JAX: an einsum at Precision.HIGHEST
outside any Pallas kernel), each contraction in blocks of DIRECT_BLOCK
terms whose partial products are added: exact at any length, so it
evaluates FFT_MESH_DEMO's L = 12.39 over a 12² unit grid, which the
centered FFT refuses; it launches no hand kernel, on any backend.
``init(gpu_hash_seeds=(s1, s2))`` replays the
shader's hash spectrum (spectra.h0_pair_gpu_hash, numpy float32 on the
host) as an injected pair. ``reconfigure`` changes the config live: a
change of init-only fields shares every table and draws a fresh h0 only.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
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
    assemble_spectra,
    assemble_spectra_packed,
    assemble_spectra_real,
    assemble_spectra_packed_real,
    hermitize_pair,
    hermitize_planes,
)
from tpu_ocean_torch.fft import BACKENDS, get_ifft2
from tpu_ocean_torch.fft.matrix import require_f32_matmul
from tpu_ocean_torch.fft.planes import (
    check_card_sizes,
    ifft2_planes_auto,
    ifft2_planes_half,
)
from tpu_ocean_torch.fft.reference import centered_modulation, ifft2_unnorm
from tpu_ocean_torch.grids import coordinate_1d, wavenumbers_1d
from tpu_ocean_torch.ops.fields_stencil import fields_stencil
from tpu_ocean_torch.ops.fused_spectrum import (
    ifft2_fused, ifft2_fused_planes, ifft2_fused_planes_half)
from tpu_ocean_torch.spectra import (
    h0_pair_centered, h0_pair_fft, h0_pair_fft_planes, h0_pair_gpu_hash)


class OceanState(NamedTuple):
    """The complex state (``real_state=False``): the h0 pair as complex64
    [N, N], the accumulated phase [N, N], the clock and step count (0-d)
    and the persistent foam [N, N] (zeros when cfg.foam_decay == 0)."""
    h0: torch.Tensor
    h0_conj: torch.Tensor
    phase: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor
    foam_accum: torch.Tensor


class OceanStateReal(NamedTuple):
    """All-f32 solver state (``real_state=True``): h0 carried as (re, im)
    planes [N, N], the accumulated phase [N, N], the clock and step count
    (0-d) and the persistent foam [N, N] (zeros when cfg.foam_decay == 0)."""
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


#: the plane-based backends, the only ones of the real state
_PLANE_BACKENDS = ("pallas", "pallas_fused")
#: the JAX package's fused transposed-store cap (pallas_fft.MAX_FUSED_N)
_JAX_MAX_FUSED_N = 2048
#: terms of the direct sum's contraction taken in one matrix product; the
#: partial products are then added. One product over all N terms
#: accumulates an f32 error that grows with N: at N = 1024 on an NVIDIA
#: H100 it put the Jacobian 1.09e-5·max from the FFT route's (chip_smoke.py
#: path (xxiv)); blocks of 64 cut the error against float64 2.5-fold on
#: the CPU
DIRECT_BLOCK = 64


def _jax_pallas_supported(n: int, fused: bool) -> bool:
    """The JAX package's size rule for a pallas-flavored pipeline
    (pallas_fft.pallas_supported: even N ≥ 16, 8-divisible beyond the
    fused cap); the N it refuses go to ``matmul`` on the complex state."""
    if n < 16 or n % 2:
        return False
    return not (fused and n > _JAX_MAX_FUSED_N and n % 8)


def advance(cfg: OceanConfig, omega, state, dt: float):
    """The step's clock and phase: (the phase to transform at, the phase
    the new state keeps, the new clock). Phase mode: φ ← (φ + ω·dt·mult)
    mod 2π with dt·mult rounded to f32 first, as the JAX step forms it;
    absolute mode: t ← t + dt/t_division, each rounded to f32 (an f32 dt,
    weak-typed Python floats), φ = ω·t, and the state keeps its phase."""
    dt32 = np.float32(dt)
    if cfg.evolution_mode == "absolute":
        t_new = state.t + float(dt32 / np.float32(cfg.t_division))
        return evolve_phase_absolute(omega, t_new), state.phase, t_new
    phase = evolve_phase_accumulate(
        state.phase, omega, float(dt32 * np.float32(cfg.dt_multiplier)))
    return phase, phase, state.t + float(dt32)


def finish_step(cfg: OceanConfig, state, out, phase_state, t_new,
                dt: float):
    """(new state, fields) of a step: with cfg.foam_decay > 0 the persistent
    foam (new crests refresh it, old foam e-folds away) replaces the
    fields' foam; the step count advances."""
    foam_accum = state.foam_accum
    if cfg.foam_decay > 0.0:
        decay = np.exp(np.float32(-cfg.foam_decay) * np.float32(dt),
                       dtype=np.float32)
        foam_accum = torch.maximum(out.foam, state.foam_accum * float(decay))
        out = out._replace(foam=foam_accum)
    return state._replace(phase=phase_state, t=t_new, step=state.step + 1,
                          foam_accum=foam_accum), out


def velocity_phase(cfg: OceanConfig, omega, state, t):
    """The phase ``velocity`` evaluates at: ω·t in absolute mode (``t``
    default the state's clock), the state's phase in phase mode (which
    takes no t)."""
    if cfg.evolution_mode == "absolute":
        return evolve_phase_absolute(
            omega, state.t if t is None else float(np.float32(t)))
    if t is not None:
        raise ValueError("phase mode accumulates incrementally: "
                         "velocity is defined at the state's "
                         "current phase (pass no t)")
    return state.phase


def velocity_planes(cfg: OceanConfig, omega, phase, a, b, cc, d):
    """∂ₜh̃ = iρω·(h0·e^{iφ} − h0*·e^{−iφ}) expanded into f32 (re, im)
    planes from the h0 pair's planes (a + ib, cc + id), ρ = dt_multiplier
    in phase mode (φ advances by ω·dt·ρ) and 1 in absolute mode."""
    rate = np.float32(cfg.dt_multiplier
                      if cfg.evolution_mode == "phase" else 1.0)
    cph, sph = torch.cos(phase), torch.sin(phase)
    # h0·e^{iφ} − h0*·e^{−iφ} = [(a−c)C − (b+d)S] + i[(b−d)C + (a+c)S]
    diff_re = (a - cc) * cph - (b + d) * sph
    diff_im = (b - d) * cph + (a + cc) * sph
    w = float(rate) * omega
    return -(w * diff_im), w * diff_re


def h0_pair(cfg: OceanConfig, real_state: bool,
            generator: Optional[torch.Generator] = None, h0=None,
            h0_conj=None):
    """The h0 pair on the CPU, in the state's form: drawn from
    ``generator`` (a CPU generator; default seeded with cfg.seed) in the
    config's layout, or an injected complex (h0, h0_conj) pair (numpy or
    anything np.asarray takes); the four f32 planes for the real state,
    two complex64 tensors for the complex one."""
    if h0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        draw = (h0_pair_fft_planes if real_state else
                h0_pair_centered if cfg.spectrum_layout == "centered"
                else h0_pair_fft)
        return list(draw(generator, cfg.resolution, cfg.length,
                         cfg.phillips_amplitude, cfg.wind, cfg.damping,
                         model=cfg.spectrum_model, jonswap_kw=cfg.jonswap_kw))
    if real_state:
        h0_np, h0c_np = np.asarray(h0), np.asarray(h0_conj)
        return [torch.from_numpy(np.asarray(a, dtype=np.float32))
                for a in (np.real(h0_np), np.imag(h0_np),
                          np.real(h0c_np), np.imag(h0c_np))]
    return [torch.from_numpy(np.asarray(a, dtype=np.complex64))
            for a in (h0, h0_conj)]


def channel_fields(re, im, nch: int, packed: bool, half=None):
    """The spatial planes (height, disp_x, disp_z[, slope_x, slope_z]) from
    the transformed channels' (re, im): packed, the fields alternate Re/Im
    down the packed channel list (evolve.packed_coefficients), the last
    one ``half`` where the last packed channel took the half-spectrum
    route; per-channel, Re of the height channel and Im of the others."""
    if not packed:
        return (re[0], *(im[c] for c in range(1, nch)))
    parts = [im[c // 2] if c % 2 else re[c // 2]
             for c in range(nch - (half is not None))]
    return (*parts, half) if half is not None else tuple(parts)


class OceanSolver:
    """Owns the f32 tables for one OceanConfig on one device and runs the
    step. ``device`` defaults to the CUDA card; pass ``device="cpu"`` for
    the plain versions (there is no fallback: without a card the default
    raises, as torch does). The switches take the JAX ``OceanSolver``'s
    defaults: ``fft_backend="reference"``, ``eval_mode="fft"``, the
    complex state, no packing, no half spectrum, the fields in torch. They
    take every value the JAX solver takes and raise ValueError where it
    raises ValueError. On the card ``pallas``/``pallas_fused`` take every
    even N in [16, 8192] at every precision, tier and form, fused or not
    (fft.planes.require_card_kernel); an N above 8192 raises ValueError at
    construction. The N below 16 or odd,
    which the JAX package sends to ``matmul`` on the complex state, go
    there with its warning."""

    #: config fields only init() reads (the InitialSpectrum pass): a change
    #: restricted to them keeps every table (JAX: _INIT_ONLY_FIELDS)
    INIT_ONLY_FIELDS = frozenset({
        "wind", "amplitude", "amplitude_scale", "damping", "seed",
        "spectrum_model", "jonswap_fetch", "jonswap_gamma",
        "jonswap_spreading", "jonswap_depth"})

    def __init__(self, cfg: OceanConfig, *, device="cuda",
                 fft_backend: str = "reference", eval_mode: str = "fft",
                 pallas_fields: bool = False, real_state: bool = False,
                 pack_channels: Optional[bool] = None,
                 half_spectrum: bool = False):
        # the JAX package's rules (tpu_ocean/solver.py:119-160, 214-250,
        # 296-301) in its order
        if eval_mode not in ("fft", "direct"):
            raise ValueError(f"bad eval_mode {eval_mode!r}")
        if real_state:
            if fft_backend not in _PLANE_BACKENDS:
                raise ValueError("real_state supports the plane-based "
                                 "backends 'pallas'/'pallas_fused' only")
            if cfg.spectrum_layout != "fft" or eval_mode != "fft":
                raise ValueError("real_state requires spectrum_layout='fft' "
                                 "and eval_mode='fft'")
        n = cfg.resolution
        if pallas_fields and (cfg.normals_mode != "stencil"
                              or cfg.spectrum_layout != "fft"
                              or n % 8 != 0):
            raise ValueError("pallas_fields requires normals_mode='stencil', "
                             "spectrum_layout='fft', and a resolution "
                             "divisible by 8")
        if eval_mode == "direct" and cfg.spectrum_layout != "centered":
            raise ValueError("direct evaluation implements the centered "
                             "(oracle) layout only")
        if (fft_backend in _PLANE_BACKENDS
                and not _jax_pallas_supported(n, fft_backend == "pallas_fused")):
            if real_state:
                raise ValueError(
                    f"N={n} is outside the pallas planes pipeline (needs "
                    f"even N ≥ 16, 8-divisible beyond "
                    f"{'the fused cap' if fft_backend == 'pallas_fused' else 'the cap'}) "
                    f"and real_state cannot fall back to 'matmul'")
            warnings.warn(f"{fft_backend} unsupported at N={n}; "
                          f"falling back to 'matmul'")
            fft_backend = "matmul"
        if fft_backend not in BACKENDS + ("pallas_fused",):
            raise ValueError(f"unknown fft backend {fft_backend!r}; choose "
                             f"from {BACKENDS + ('pallas_fused',)}")
        if pack_channels and cfg.spectrum_layout != "fft":
            raise ValueError("pack_channels requires spectrum_layout='fft' "
                             "and eval_mode='fft' (the centered/direct "
                             "channels do not Re/Im-separate — see "
                             "evolve.packed_coefficients)")
        if half_spectrum:
            if not pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if not real_state or fft_backend not in _PLANE_BACKENDS:
                raise ValueError("half_spectrum supports the plane-based "
                                 "real_state 'pallas'/'pallas_fused' "
                                 "pipelines only")
            if n % 16 != 0 or n < 64:
                raise ValueError("half_spectrum needs resolution % 16 == 0 "
                                 "and >= 64")
        direct = eval_mode == "direct"
        if (fft_backend == "pallas_fused" and not direct
                and cfg.spectrum_layout != "fft"):
            raise ValueError("pallas_fused requires spectrum_layout='fft'")
        modulation = (centered_modulation(n, cfg.length, cfg.unit_width)
                      if cfg.spectrum_layout == "centered" and not direct
                      else None)
        self.device = torch.device(device)
        if (self.device.type == "cuda" and fft_backend in _PLANE_BACKENDS
                and not direct):
            # rows and full columns; with half_spectrum the half channel's
            # columns, each at the tier and form its length runs at. Every
            # tier and form has a kernel at every even N in [16, 8192],
            # fused or not: powers of two their own kernels, the other N
            # the mixed-radix kernel and its fused twin, on their own
            # stages at f32 direct and on the matrix engine otherwise
            check_card_sizes(n, cfg.precision,
                             fused=fft_backend == "pallas_fused",
                             half=half_spectrum)
        self.cfg = cfg
        self.fft_backend = fft_backend
        self.eval_mode = eval_mode
        self.real_state = bool(real_state)
        self.pack_channels = bool(pack_channels)
        self.half_spectrum = bool(half_spectrum)
        self.pallas_fields = bool(pallas_fields)
        # every transform's precision (tpu_ocean/solver.py _mxu_precision);
        # reference and stockham are always full precision
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
        # direct evaluation assembles in torch on every backend, as JAX's
        # _evolved_transform does outside eval_mode="fft"
        fused = fft_backend == "pallas_fused" and not direct
        if not self.pack_channels:
            if not fused:
                self.coeffs = table(spectrum_coefficients(cfg).real[:self._nch])
        else:
            pack = packed_coefficients(cfg, self._nch)
            if fused:
                self.pack_nyq = table(pack[:, n // 2:n // 2 + 1, :])
            else:
                self.pack = table(pack)
        if cfg.spectrum_layout == "centered":
            x1d = coordinate_1d(n, cfg.unit_width)
        else:
            x1d = np.arange(n, dtype=np.float64) * (cfg.length / n)
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self.x0 = table(x0)
        self.z0 = table(z0)
        # the complex state's transform, with the centered layout's pre/post
        # modulation as complex64 from f32 parts (tpu_ocean/solver.py:327);
        # direct evaluation: the basis E[n, i] = e^{i·k_n·x_i} in float64,
        # cast once (tpu_ocean/solver.py:312-318)
        self._ifft2 = (None if fused or direct or self.real_state else
                       get_ifft2(fft_backend, n, self.precision))
        self.basis = None
        if direct:
            ex = np.exp(1j * np.outer(wavenumbers_1d(n, cfg.length, "centered"),
                                      x1d))
            self.basis = torch.complex(table(ex.real), table(ex.imag))
        self.pre = self.post = None
        if modulation is not None:
            pre, post = modulation
            self.pre = torch.complex(table(pre.real), table(pre.imag))
            self.post = torch.complex(table(post.real), table(post.imag))

    # ------------------------------------------------------------------ init

    def symmetrize(self, state):
        """Packed solvers: project the h0 pair onto its Hermitian part
        (bitwise idempotent), which the packed extraction and the C2R
        route rely on. Per-channel solvers return the state unchanged."""
        if not self.pack_channels:
            return state
        if self.real_state:
            ar, ai, acr, aci = hermitize_planes(
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            return state._replace(h0_re=ar, h0_im=ai, h0c_re=acr, h0c_im=aci)
        a, ac = hermitize_pair(state.h0, state.h0_conj)
        return state._replace(h0=a, h0_conj=ac)

    def init(self, generator: Optional[torch.Generator] = None,
             h0=None, h0_conj=None, gpu_hash_seeds=None):
        """Initial state (OceanState, or OceanStateReal with real_state):
        sample h0 from ``generator`` (a CPU generator; default seeded with
        cfg.seed) in the config's layout, inject a complex (h0, h0_conj)
        pair (numpy or anything np.asarray takes), or pass
        ``gpu_hash_seeds=(s1, s2)`` to replay the shader's hash spectrum
        (spectra.h0_pair_gpu_hash, fft layout only), which then goes to the
        device like an injected pair. Phase and clock start at 0. One
        generator state gives both states the same h0."""
        cfg = self.cfg
        n = cfg.resolution
        if h0 is None and gpu_hash_seeds is not None:
            if cfg.spectrum_layout != "fft":
                raise ValueError("gpu_hash_seeds replays the shader's "
                                 "fft-layout spectrum; it requires "
                                 "spectrum_layout='fft'")
            h0, h0_conj = h0_pair_gpu_hash(
                n, cfg.length, cfg.phillips_amplitude, cfg.wind,
                gpu_hash_seeds[0], gpu_hash_seeds[1], cfg.damping)
        pair = [p.to(self.device) for p in h0_pair(
            cfg, self.real_state, generator, h0, h0_conj)]
        zeros = torch.zeros((n, n), dtype=torch.float32, device=self.device)
        rest = dict(phase=zeros,
                    t=torch.zeros((), dtype=torch.float32, device=self.device),
                    step=torch.zeros((), dtype=torch.int32, device=self.device),
                    foam_accum=zeros.clone())
        if self.real_state:
            return self.symmetrize(OceanStateReal(*pair, **rest))
        return self.symmetrize(OceanState(*pair, **rest))

    def reconfigure(self, state, new_cfg: OceanConfig,
                    generator: Optional[torch.Generator] = None):
        """Live parameter change (the reference's re-init,
        OceanRenderer.cs:98-109): returns (new solver, new state), with h0
        drawn afresh from ``generator`` (default seeded with
        new_cfg.seed). A change of INIT_ONLY_FIELDS only shares every
        table of this solver (a shallow copy) and keeps the phase, clock,
        step and foam; any other change builds a new solver with the same
        switches (packing and half spectrum kept only in the same layout),
        which keeps them only at the same N and layout (JAX:
        OceanSolver.reconfigure)."""
        return reconfigured(
            self, state, new_cfg, generator,
            lambda pack, half: OceanSolver(
                new_cfg, device=self.device, fft_backend=self.fft_backend,
                eval_mode=self.eval_mode, pallas_fields=self.pallas_fields,
                real_state=self.real_state, pack_channels=pack,
                half_spectrum=half))

    # ------------------------------------------------------------------ step

    def step(self, state, dt: float = 1.0 / 60.0):
        """Advance one step; returns (new_state, OceanFields)."""
        phase, phase_state, t_new = advance(self.cfg, self.omega, state, dt)
        out = self._fields_from_phase(state, phase)
        return finish_step(self.cfg, state, out, phase_state, t_new, dt)

    def fields_at(self, state, t: float) -> OceanFields:
        """The fields at absolute time ``t`` without advancing the state
        (absolute mode only; JAX: OceanSolver.fields_at)."""
        if self.cfg.evolution_mode != "absolute":
            raise ValueError("fields_at evaluates the stateless absolute-"
                             "time form (ω·t); this solver runs "
                             "evolution_mode='phase' — use step() and read "
                             "the returned fields")
        return self._fields_from_phase(
            state, evolve_phase_absolute(self.omega, float(np.float32(t))))

    def velocity(self, state, t: Optional[float] = None) -> torch.Tensor:
        """Vertical surface velocity ∂h/∂t [N, N], exact from the
        dispersion relation:

            ∂ₜ h̃ = iρω·(h0·e^{iφ} − h0*·e^{−iφ}),   v = Re F(∂ₜ h̃)

        with ρ = dt_multiplier in phase mode (φ advances by ω·dt·ρ) and 1
        in absolute mode. Absolute mode evaluates at ``t`` (default: the
        state's clock); phase mode at the state's phase (pass no t).

        The real state (JAX: _velocity_real_impl) expands the algebra into
        f32 planes; with half_spectrum the spectrum is Hermitian under the
        packed state's projection, so it takes the half-spectrum route,
        else the full transform (both on the row-DFT kernel). The complex
        state takes the solver's transform with its modulation, or on
        ``pallas_fused``, which has no standalone transform, torch.fft, as
        the JAX package takes jnp.fft there."""
        cfg = self.cfg
        phase = velocity_phase(cfg, self.omega, state, t)
        if not self.real_state:
            rate = np.float32(cfg.dt_multiplier
                              if cfg.evolution_mode == "phase" else 1.0)
            pv = torch.complex(torch.cos(phase), torch.sin(phase))
            vspec = ((1j * float(rate)) * self.omega
                     * (state.h0 * pv - state.h0_conj * pv.conj()))
            if self._ifft2 is None and self.basis is None:
                return ifft2_unnorm(vspec).real.contiguous()
            return self._transform(vspec[None])[0].real.contiguous()
        re, im = velocity_planes(cfg, self.omega, phase, state.h0_re,
                                 state.h0_im, state.h0c_re, state.h0c_im)
        if self.half_spectrum:
            mh = cfg.resolution // 2
            return ifft2_planes_half(re[None, :mh + 1], im[None, :mh + 1],
                                     True, self.precision)[0]
        return ifft2_planes_auto(re[None], im[None], True, self.precision)[0][0]

    # ------------------------------------------------------------- internals

    def _fields_from_phase(self, state, phase) -> OceanFields:
        """Assembly, transforms and field extraction at ``phase``: the
        complex state's _evolved_transform and _extract_fields, or the real
        state's _fields_from_phase_real."""
        return self._extract_fields(*self._planes_from_phase(state, phase))

    def _planes_from_phase(self, state, phase):
        """Assembly and transforms at ``phase``: the spatial planes
        (height, disp_x, disp_z[, slope_x, slope_z]) the fields are made
        from."""
        if not self.real_state:
            f = self._evolved_transform(state, phase)
            return tuple(p.contiguous() for p in channel_fields(
                f.real, f.imag, self._nch, self.pack_channels))
        pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
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
            return channel_fields(re_f, im_f, self._nch, True, last)
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
        return channel_fields(re, im, self._nch, self.pack_channels)

    def _evolved_transform(self, state: OceanState, phase) -> torch.Tensor:
        """phase [N, N] → complex64 [C, N, N] spatial fields: the assembly
        and the transform, or on ``pallas_fused`` the fused pipeline on the
        h0 pair's planes."""
        if self.fft_backend == "pallas_fused" and self.basis is None:
            pair = tuple(p.contiguous() for p in (
                state.h0.real, state.h0.imag,
                state.h0_conj.real, state.h0_conj.imag))
            return ifft2_fused(pair, phase, self.cfg.length, self.dz_sign,
                               epsilon=EPSILON, ch_count=self._pch,
                               packed=self.pack_channels, nch_live=self._nch,
                               precision=self.precision)
        if self.pack_channels:
            spectra = assemble_spectra_packed(state.h0, state.h0_conj, phase,
                                              self.pack)
        else:
            spectra = assemble_spectra(state.h0, state.h0_conj, phase,
                                       self.coeffs)
        return self._transform(spectra)

    def _transform(self, spectra: torch.Tensor) -> torch.Tensor:
        """Complex [C, N, N] spectra → [C, N, N] spatial fields, with the
        centered layout's pre/post modulation around the transform, or
        the direct sum F_c = Eᵀ·C_c·E in f32, each contraction in blocks
        of DIRECT_BLOCK terms."""
        if self.basis is not None:
            # JAX runs the direct sum at Precision.HIGHEST
            require_f32_matmul(spectra, "eval_mode='direct' and its basis")
            e = self.basis
            p = torch.zeros_like(spectra)
            for s in range(0, e.shape[0], DIRECT_BLOCK):
                p += spectra[..., s:s + DIRECT_BLOCK] @ e[s:s + DIRECT_BLOCK]
            f = torch.zeros_like(p)
            for s in range(0, e.shape[0], DIRECT_BLOCK):
                f += e[s:s + DIRECT_BLOCK].transpose(0, 1) @ p[:, s:s + DIRECT_BLOCK]
            return f
        if self.pre is not None:
            spectra = spectra * self.pre[None]
        f = self._ifft2(spectra)
        if self.post is not None:
            f = f * self.post[None]
        return f

    def _extract_fields(self, height, disp_x, disp_z, slope_x=None,
                        slope_z=None) -> OceanFields:
        """The output fields from the transformed planes
        (_extract_fields_planes): the fields kernel, or the normals
        (stencil or spectral) and the foam in plain torch, in the oracle's
        convention on the centered layout (raw displacements) and the GPU
        shaders' on the fft layout."""
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
            if cfg.spectrum_layout == "centered":
                foam, jac = field_ops.whitecap_oracle(disp_x, disp_z, normal)
            else:
                foam, jac = field_ops.whitecap_gpu(chop_dx, chop_dz, normal)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=self.x0 - chop_dx, pos_z=self.z0 - chop_dz,
                           normal=normal, foam=foam, jacobian=jac)


def reconfigured(solver, state, new_cfg: OceanConfig, generator, build):
    """``solver.reconfigure``'s rule (JAX: OceanSolver.reconfigure), for
    OceanSolver and DistributedOceanSolver: h0 drawn afresh from
    ``generator`` (default seeded with new_cfg.seed); a change of
    OceanSolver.INIT_ONLY_FIELDS only keeps every table (a shallow copy)
    and the phase, clock, step and foam; any other change takes
    ``build(pack_channels, half_spectrum)``, the new solver with the same
    switches (packing and half spectrum kept only in the same layout),
    which keeps them only at the same N and layout. Returns (solver,
    state)."""
    changed = {f.name for f in dataclasses.fields(new_cfg)
               if getattr(new_cfg, f.name) != getattr(solver.cfg, f.name)}
    if generator is None:
        generator = torch.Generator().manual_seed(new_cfg.seed)
    keep = dict(phase=state.phase, t=state.t, step=state.step,
                foam_accum=state.foam_accum)
    if changed <= OceanSolver.INIT_ONLY_FIELDS:
        new = copy.copy(solver)
        new.cfg = new_cfg
        return new, new.init(generator)._replace(**keep)
    same_layout = new_cfg.spectrum_layout == solver.cfg.spectrum_layout
    new = build(solver.pack_channels if same_layout else None,
                solver.half_spectrum if same_layout else False)
    fresh = new.init(generator)
    if new_cfg.resolution == solver.cfg.resolution and same_layout:
        fresh = fresh._replace(**keep)
    return new, fresh
