"""Multi-band spectral cascades: B patches of one N and different lengths,
stepped together and summed at shared UV.

JAX counterpart: ``tpu_ocean/cascade.py``. A single Tessendorf patch tiles
visibly at its length L; production renderers superpose B independent
bands (e.g. 1000 m / 130 m / 17 m) so that each wave band is resolved at
its own scale and the tiling decorrelates. Every per-band table is a
leading-[B] device tensor built once in ``__init__``, and the bands ride
the leading axis of every step operation: no Python loop over bands
launches anything.

Combined surface at display point (u, v) ∈ [0, 1)²:
    height(u,v)  = Σ_b h_b(u·N, v·N)           (per-band physical x = uv·L_b)
    disp/slopes sum likewise; normals and Jacobian foam are computed from the
    COMBINED fields, with world spacing display_length / N.

Each band carries its OWN choppiness, so the returned OceanFields.disp_x /
disp_z are the EFFECTIVE (post-choppiness) combined displacements, and
pos = x0 − disp directly; the single-patch contract ("disp = raw, pos =
x0 − chop·disp") cannot hold a per-band-weighted sum.

The real state (``real_state=True``, ``fft_backend="pallas"``) assembles
every band's channels in torch and transforms the [B·C, N, N] stack in
one launch a pass (fft.planes.ifft2_planes_auto); with ``half_spectrum``
the last packed channel of every band goes through one half-spectrum call
on the contiguous [B, N/2+1, N] slab. At 1024² packed + half that is 5
row-DFT launches a step at C = B, and one fields-kernel launch with
``pallas_fields``. The complex state takes fft.get_ifft2's backends on
the [B, C, N, N] spectra (``pallas``: the same row kernels, C = B·P).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpu_ocean_torch import fields as field_ops
from tpu_ocean_torch.config import OceanConfig
from tpu_ocean_torch.evolve import (
    assemble_spectra, assemble_spectra_packed, assemble_spectra_packed_real,
    assemble_spectra_real, evolve_phase_absolute, evolve_phase_accumulate,
    hermitize_pair, hermitize_planes, omega_grid, packed_coefficients,
    spectrum_coefficients)
from tpu_ocean_torch.fft import get_ifft2
from tpu_ocean_torch.fft.planes import (
    check_card_sizes, ifft2_planes_auto, ifft2_planes_half)
from tpu_ocean_torch.ops.fields_stencil import fields_stencil
from tpu_ocean_torch.solver import OceanFields, OceanSolver
from tpu_ocean_torch.spectra import h0_pair_fft, h0_pair_fft_planes


class CascadeState(NamedTuple):
    """The complex state: the h0 pair as complex64 [B, N, N], the phase
    [B, N, N], the clock and step count (0-d)."""
    h0: torch.Tensor
    h0_conj: torch.Tensor
    phase: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor


class CascadeStateReal(NamedTuple):
    """All-f32 twin of CascadeState: the h0 pair as (re, im) planes
    [B, N, N] each."""
    h0_re: torch.Tensor
    h0_im: torch.Tensor
    h0c_re: torch.Tensor
    h0c_im: torch.Tensor
    phase: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor


def extract_live_planes_real(re: torch.Tensor, im: torch.Tensor, nch: int,
                             packed: bool) -> torch.Tensor:
    """Real-plane twin of extract_live_planes: (re, im) [S, C_t, N, N] f32
    transform planes → [S, C_live, N, N] live field planes."""
    if packed:
        rows = [re[:, 0], im[:, 0], re[:, 1]]
        if nch == 5:
            rows += [im[:, 1], re[:, 2]]
    else:
        rows = [re[:, 0], im[:, 1], im[:, 2]]
        if nch == 5:
            rows += [im[:, 3], im[:, 4]]
    return torch.stack(rows, dim=1)


def extract_live_planes(f: torch.Tensor, nch: int,
                        packed: bool) -> torch.Tensor:
    """[S, C_transform, N, N] complex transforms → [S, C_live, N, N] live
    field planes (height, disp_x, disp_z[, slope_x, slope_z]): packed, the
    fields alternate Re/Im down the packed channels
    (evolve.packed_coefficients); else Re of the height channel and Im of
    the others. CascadeSolver and lod.LODCascadeSolver both consume it."""
    return extract_live_planes_real(f.real, f.imag, nch, packed)


class CascadeSolver:
    """B spectral bands stepped and combined in one call.

    ``cfgs`` must share resolution and mode switches; lengths, winds,
    amplitudes and choppiness may differ per band. The switches and their
    ValueErrors are the JAX ``CascadeSolver``'s, in its order; ``mesh`` (the
    JAX package's 'expert' axis) raises NotImplementedError. ``device``
    defaults to the CUDA card; pass ``device="cpu"`` for the plain
    versions."""

    def __init__(self, cfgs: Sequence[OceanConfig],
                 fft_backend: str = "reference",
                 display_length: Optional[float] = None,
                 mesh=None,
                 pack_channels: bool = False,
                 real_state: bool = False,
                 pallas_fields: bool = False,
                 half_spectrum: bool = False, *, device="cuda"):
        if not cfgs:
            raise ValueError("need at least one band config")
        if any(c.foam_decay for c in cfgs):
            # CascadeState carries no per-band foam accumulator
            raise ValueError("foam_decay (persistent foam) is not "
                             "implemented for cascades; use foam_decay=0 "
                             "here, or a single-patch OceanSolver/"
                             "DistributedOceanSolver which support it")
        if pallas_fields and (cfgs[0].normals_mode != "stencil"
                              or cfgs[0].resolution % 8 != 0):
            raise ValueError("pallas_fields requires normals_mode='stencil' "
                             "and a resolution divisible by 8")
        if real_state and fft_backend != "pallas":
            raise ValueError("real_state cascades require "
                             "fft_backend='pallas'")
        n = cfgs[0].resolution
        for c in cfgs[1:]:
            if (c.resolution != n
                    or c.evolution_mode != cfgs[0].evolution_mode
                    or c.dispersion_mode != cfgs[0].dispersion_mode
                    or c.spectrum_layout != cfgs[0].spectrum_layout):
                raise ValueError("cascade bands must share resolution and "
                                 "mode switches")
        if cfgs[0].spectrum_layout != "fft":
            raise ValueError("cascades use the 'fft' (GPU) spectrum layout")
        if half_spectrum:
            if not pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if not real_state:
                raise ValueError("half_spectrum cascades require "
                                 "real_state=True (the plane pipeline)")
            if n % 16 != 0 or n < 64:
                raise ValueError("half_spectrum needs resolution % 16 == 0 "
                                 "and >= 64 (the N/2-length column kernels)")
        # the complex state's transform (JAX builds it after the tables; a
        # backend it does not know raises ValueError there)
        ifft2 = None if real_state else get_ifft2(fft_backend, n)
        if mesh is not None:
            raise NotImplementedError(
                "CascadeSolver(mesh=...), the band axis sharded over an "
                "'expert' mesh axis, is not ported to tpu_ocean_torch yet "
                "(ROADMAP.md Queue 1 item 14b)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and fft_backend == "pallas":
            # every tier and form has a kernel at every even N in
            # [16, 8192]: this refuses N above 8192 only
            check_card_sizes(n, cfgs[0].precision, half=half_spectrum)
        self.pallas_fields = bool(pallas_fields)
        self.real_state = bool(real_state)
        self.cfgs = list(cfgs)
        self.n = n
        self.b = len(cfgs)
        self.mesh = mesh
        self.fft_backend = fft_backend
        self._display_length_arg = display_length   # None → from the bands
        self.display_length = (display_length if display_length is not None
                               else max(c.length for c in cfgs))
        # stencil normals never read the slope spectra: B×3 transforms, not
        # B×5; packing pairs the fields into B×2 (B×3) transforms
        self._nch = 3 if cfgs[0].normals_mode == "stencil" else 5
        self.pack_channels = bool(pack_channels)
        self.half_spectrum = bool(half_spectrum)

        def table(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.device)

        # float64 tables cast once to f32 and stacked over the bands
        self._omega = table(np.stack([np.asarray(omega_grid(c), np.float32)
                                      for c in cfgs]))             # [B, N, N]
        if pack_channels:
            self._coeffs = table(np.stack(
                [np.asarray(packed_coefficients(c, self._nch), np.float32)
                 for c in cfgs]))                                  # [B, 2P, N, N]
        else:
            self._coeffs = table(np.stack(
                [np.asarray(spectrum_coefficients(c).real, np.float32)[:self._nch]
                 for c in cfgs]))                                  # [B, C, N, N]
        # per band [B, 1, 1]: the choppiness, and the velocity's rate
        # (dt_multiplier in phase mode, 1 in absolute mode); the
        # dt_multipliers stay on the host, where the phase steps are formed
        self._dtmul = np.asarray([c.dt_multiplier for c in cfgs], np.float32)
        self._chop = table([[[c.choppiness]] for c in cfgs])
        self._rate = table(self._dtmul[:, None, None]
                           if cfgs[0].evolution_mode == "phase"
                           else np.ones((self.b, 1, 1), np.float32))
        x1d = (np.arange(n, dtype=np.float32)
               * np.float32(self.display_length / n))
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self._x0 = table(x0)
        self._z0 = table(z0)
        self._ifft2 = ifft2
        self.precision = cfgs[0].precision
        # (dt, the per-band phase steps dt·dt_multiplier as a [B, 1, 1]
        # device tensor) of the last step's dt
        self._dt_steps = (None, None)

    # ---------------------------------------------------------------- init

    def init(self, generator: Optional[torch.Generator] = None,
             h0=None, h0_conj=None):
        """Initial state: each band's h0 drawn in band order from one CPU
        ``generator`` (default seeded with cfgs[0].seed), or an injected
        complex [B, N, N] pair; hermitized per band when packing. Phase and
        clock start at 0."""
        if h0 is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.cfgs[0].seed)
            draw = h0_pair_fft_planes if self.real_state else h0_pair_fft
            pairs = [draw(generator, c.resolution, c.length,
                          c.phillips_amplitude, c.wind, c.damping,
                          model=c.spectrum_model, jonswap_kw=c.jonswap_kw)
                     for c in self.cfgs]
            pair = [torch.stack([p[j] for p in pairs])
                    for j in range(len(pairs[0]))]
        elif self.real_state:
            h0_np, h0c_np = np.asarray(h0), np.asarray(h0_conj)
            pair = [torch.from_numpy(np.array(a, dtype=np.float32))
                    for a in (np.real(h0_np), np.imag(h0_np),
                              np.real(h0c_np), np.imag(h0c_np))]
        else:
            pair = [torch.from_numpy(np.array(a, dtype=np.complex64))
                    for a in (h0, h0_conj)]
        shape = (self.b, self.n, self.n)
        if any(tuple(p.shape) != shape for p in pair):
            raise ValueError(f"h0 planes must be [B, N, N] = {list(shape)}")
        pair = [p.to(self.device) for p in pair]
        rest = dict(
            phase=torch.zeros(shape, dtype=torch.float32, device=self.device),
            t=torch.zeros((), dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        kind = CascadeStateReal if self.real_state else CascadeState
        return self.symmetrize(kind(*pair, **rest))

    def reconfigure(self, state, new_cfgs: Sequence[OceanConfig],
                    generator: Optional[torch.Generator] = None):
        """Live per-band parameter change: returns (new_solver, new_state),
        with every band's h0 drawn afresh from ``generator`` (default seeded
        with new_cfgs[0].seed). A change of OceanSolver.INIT_ONLY_FIELDS
        only shares every table of this solver (a shallow copy) and keeps
        phase, t and step; any other change builds a new solver with the
        same switches, which keeps them at the same N and layout (JAX:
        CascadeSolver.reconfigure; OceanRenderer.cs:98-109)."""
        new_cfgs = list(new_cfgs)
        if len(new_cfgs) != self.b:
            raise ValueError(f"got {len(new_cfgs)} band configs for a "
                             f"{self.b}-band cascade; reconfigure cannot "
                             f"add/remove bands (rebuild instead)")
        changed = set()
        for old, new in zip(self.cfgs, new_cfgs):
            changed |= {f.name for f in dataclasses.fields(new)
                        if getattr(new, f.name) != getattr(old, f.name)}
        if generator is None:
            generator = torch.Generator().manual_seed(new_cfgs[0].seed)
        keep = dict(phase=state.phase, t=state.t, step=state.step)
        if changed <= OceanSolver.INIT_ONLY_FIELDS:
            solver = copy.copy(self)
            solver.cfgs = new_cfgs
            return solver, solver.init(generator)._replace(**keep)
        solver = CascadeSolver(new_cfgs, fft_backend=self.fft_backend,
                               display_length=self._display_length_arg,
                               mesh=self.mesh,
                               pack_channels=self.pack_channels,
                               real_state=self.real_state,
                               pallas_fields=self.pallas_fields,
                               half_spectrum=self.half_spectrum,
                               device=self.device)
        fresh = solver.init(generator)
        if (new_cfgs[0].resolution == self.cfgs[0].resolution
                and new_cfgs[0].spectrum_layout
                == self.cfgs[0].spectrum_layout):
            fresh = fresh._replace(**keep)
        return solver, fresh

    def symmetrize(self, state):
        """Per-band Hermitian projection when packing (bitwise idempotent,
        as OceanSolver.symmetrize); the state unchanged otherwise. Applied
        to resumed checkpoints so that pre-packing snapshots continue
        correctly."""
        if not self.pack_channels:
            return state
        if isinstance(state, CascadeStateReal):
            r1, i1, r2, i2 = hermitize_planes(
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            return state._replace(h0_re=r1, h0_im=i1, h0c_re=r2, h0c_im=i2)
        a, ac = hermitize_pair(state.h0, state.h0_conj)
        return state._replace(h0=a, h0_conj=ac)

    # ---------------------------------------------------------------- step

    def step(self, state, dt: float = 1.0 / 60.0):
        """Advance every band one step; returns (new_state, OceanFields)."""
        cfg0 = self.cfgs[0]
        dt32 = np.float32(dt)
        if cfg0.evolution_mode == "absolute":
            # dt / t_division and the sum each rounded to f32, as the JAX
            # step forms them
            t_new = state.t + float(dt32 / np.float32(cfg0.t_division))
            phase = evolve_phase_absolute(self._omega, t_new)
            phase_state = state.phase
        else:
            phase = evolve_phase_accumulate(state.phase, self._omega,
                                            self._phase_steps(dt32))
            phase_state = phase
            t_new = state.t + float(dt32)
        if self.real_state:
            pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            planes = self._real_planes(pair, phase, self._coeffs)
        else:
            planes = self._complex_planes(state.h0, state.h0_conj, phase,
                                          self._coeffs)
        out = self._combine_fields(planes)
        return state._replace(phase=phase_state, t=t_new,
                              step=state.step + 1), out

    def _phase_steps(self, dt32: np.float32) -> torch.Tensor:
        """dt·dt_multiplier of every band, each product rounded to f32 on
        the host as the JAX step forms it, as a [B, 1, 1] device tensor
        (made again only when dt changes)."""
        if self._dt_steps[0] != dt32:
            self._dt_steps = (dt32, torch.from_numpy(
                (dt32 * self._dtmul)[:, None, None]).to(self.device))
        return self._dt_steps[1]

    def velocity(self, state, t: Optional[float] = None) -> torch.Tensor:
        """Combined vertical surface velocity ∂h/∂t [N, N]: Σ over bands of
        the per-band iω-weighted spectrum (OceanSolver.velocity lifted over
        the band axis; each band's own dt_multiplier rate in phase mode).
        Absolute mode evaluates at ``t`` (default: the state's clock); phase
        mode at the state's phase (pass no t). The real state takes the row
        kernels over the band batch (the half-spectrum route with
        half_spectrum); the complex state torch.fft, as JAX takes
        jnp.fft."""
        cfg0 = self.cfgs[0]
        if cfg0.evolution_mode == "absolute":
            tt = state.t if t is None else float(np.float32(t))
        else:
            if t is not None:
                raise ValueError("phase mode accumulates incrementally: "
                                 "velocity is defined at the state's "
                                 "current phase (pass no t)")
            tt = state.t
        return self._velocity(state, tt, held_phase=False)

    def velocity_at_held_phase(self, state) -> torch.Tensor:
        """Velocity with every band evaluated at ``state.phase`` whatever the
        evolution mode: the LOD scheduler keeps each band's last-refresh
        phase there, so the rate matches the displayed (held) surface, not
        the clock. Rate: dt_multiplier in phase mode, 1 in absolute mode."""
        return self._velocity(state, state.t, held_phase=True)

    def _velocity(self, state, tt, held_phase: bool) -> torch.Tensor:
        if self.cfgs[0].evolution_mode == "absolute" and not held_phase:
            phase = evolve_phase_absolute(self._omega, tt)
        else:
            phase = state.phase
        w = self._rate * self._omega
        if not isinstance(state, CascadeStateReal):
            pv = torch.complex(torch.cos(phase), torch.sin(phase))
            vspec = 1j * w * (state.h0 * pv - state.h0_conj * pv.conj())
            n = self.n
            return torch.sum(torch.fft.ifft2(vspec).real * (n * n), dim=0)
        cph, sph = torch.cos(phase), torch.sin(phase)
        a, b = state.h0_re, state.h0_im
        cc, d = state.h0c_re, state.h0c_im
        # h0·e^{iφ} − h0*·e^{−iφ} = [(a−c)C − (b+d)S] + i[(b−d)C + (a+c)S]
        diff_re = (a - cc) * cph - (b + d) * sph
        diff_im = (b - d) * cph + (a + cc) * sph
        re, im = -(w * diff_im), w * diff_re
        if self.half_spectrum:
            # every band's v̂ is Hermitian under the packed projection: one
            # half-spectrum call over the band axis
            mh = self.n // 2
            return torch.sum(ifft2_planes_half(
                re[:, :mh + 1], im[:, :mh + 1], True, self.precision), dim=0)
        return torch.sum(ifft2_planes_auto(re, im, True, self.precision)[0],
                         dim=0)

    # ----------------------------------------------------------- internals

    def _complex_planes(self, h0, h0_conj, phase, coeffs) -> torch.Tensor:
        """The complex state's banded assembly and transform → [S, C_live,
        N, N] live planes."""
        if self.pack_channels:
            spectra = assemble_spectra_packed(h0, h0_conj, phase, coeffs)
        else:
            spectra = assemble_spectra(h0, h0_conj, phase, coeffs)
        return extract_live_planes(self._ifft2(spectra), self._nch,
                                   self.pack_channels)

    def _real_planes(self, pair, phase, coeffs) -> torch.Tensor:
        """Banded all-f32 assembly, then ONE plane transform over the
        flattened band×channel batch → [S, C_live, N, N] live planes (the
        refresh math of the step and of lod.LODCascadeSolver). With
        half_spectrum, the last packed channel of every band goes through
        one half-spectrum call on the [S, N/2+1, N] slab."""
        if self.pack_channels:
            re, im = assemble_spectra_packed_real(pair, phase, coeffs)
        else:
            re, im = assemble_spectra_real(pair, phase, coeffs)
        s, ct, n = re.shape[0], re.shape[1], re.shape[-1]
        if self.half_spectrum:
            mh = n // 2
            re_f, im_f = ifft2_planes_auto(
                re[:, :-1].reshape(s * (ct - 1), n, n).contiguous(),
                im[:, :-1].reshape(s * (ct - 1), n, n).contiguous(), True,
                self.precision)
            re_f = re_f.reshape(s, ct - 1, n, n)
            im_f = im_f.reshape(s, ct - 1, n, n)
            last = ifft2_planes_half(re[:, -1, :mh + 1, :],
                                     im[:, -1, :mh + 1, :], True,
                                     self.precision)               # [S, N, N]
            rows = [re_f[:, 0], im_f[:, 0],
                    last if self._nch == 3 else re_f[:, 1]]
            if self._nch == 5:
                rows += [im_f[:, 1], last]
            return torch.stack(rows, dim=1)
        re, im = ifft2_planes_auto(re.reshape(s * ct, n, n),
                                   im.reshape(s * ct, n, n), True,
                                   self.precision)
        return extract_live_planes_real(re.reshape(s, ct, n, n),
                                        im.reshape(s, ct, n, n),
                                        self._nch, self.pack_channels)

    def _combine_fields(self, planes: torch.Tensor) -> OceanFields:
        """[B, C, N, N] live planes → combined OceanFields: Σ over bands
        with each band's choppiness, then the normals and foam on the
        combined fields (the fields kernel with pallas_fields, on the
        effective displacements with no further chop)."""
        cfg0 = self.cfgs[0]
        height = torch.sum(planes[:, 0], dim=0)
        disp_x = torch.sum(self._chop * planes[:, 1], dim=0)
        disp_z = torch.sum(self._chop * planes[:, 2], dim=0)
        texel = self.display_length / self.n
        if cfg0.normals_mode == "spectral":
            normal = field_ops.normals_spectral(torch.sum(planes[:, 3], dim=0),
                                                torch.sum(planes[:, 4], dim=0))
            foam, jac = field_ops.whitecap_gpu(disp_x, disp_z, normal)
        elif self.pallas_fields:
            normal, foam, jac = fields_stencil(disp_x, height, disp_z, texel)
        else:
            normal = field_ops.normals_stencil(disp_x, height, disp_z, texel)
            foam, jac = field_ops.whitecap_gpu(disp_x, disp_z, normal)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=self._x0 - disp_x, pos_z=self._z0 - disp_z,
                           normal=normal, foam=foam, jacobian=jac)


def default_cascade(n: int = 256, lengths=(1000.0, 130.0, 17.0),
                    wind=(14.0, 12.0), amplitude: float = 0.4,
                    choppiness: float = 0.6) -> List[OceanConfig]:
    """A standard 3-band production cascade parameterization."""
    return [OceanConfig(resolution=n, length=l, wind=wind,
                        amplitude=amplitude, amplitude_scale=1e-4,
                        choppiness=choppiness,
                        evolution_mode="phase", dispersion_mode="capillary",
                        spectrum_layout="fft", normals_mode="stencil",
                        damping=0.01, oracle_sign_quirk=False, seed=i)
            for i, l in enumerate(lengths)]
