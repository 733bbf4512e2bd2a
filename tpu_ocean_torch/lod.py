"""LOD cascade scheduling: per-band refresh rates over a CascadeSolver.

JAX counterpart: ``tpu_ocean/lod.py``. Production renderers do not refresh
every cascade every frame: the long patch (L ~ 1000 m) holds slow swell
whose fastest temporal frequency is far below the display rate, while the
short patch (L ~ 17 m) carries capillary chop that must tick at full rate.

The schedule is static. Frames are periodic with period P = lcm(band
periods) = max(periods) (powers of two); for each frame slot the set of
refreshing bands is fixed, and the solver keeps one static index tensor a
distinct subset, built once on the device. A frame gathers the refreshing
bands, transforms only them (C = |subset| · channels a launch), and
scatters the fresh planes into a copy of the [B, C, N, N] plane cache:
``index_copy``, not ``index_copy_``, because callers keep the previous
state (a resume, a checkpoint manager, a held-band check). Held bands keep
their cached planes and their phase; on their next refresh they advance by
the period·dt they slept, so each band's trajectory is the every-frame
trajectory sampled at its refresh frames. init() primes every band's
planes at t = 0, so frame f ∈ {1, 2, ...} refreshes band b iff
f % period_b == 0. The combine (Σ over B, normals and foam) runs every
frame from the cache.

Refresh periods default to each band's temporal Nyquist margin:
k_max = π·N/L, ω_max = sqrt(g·k_max·(1 + (k_max/370)²)) with capillary
dispersion, and a band stays sampled while its refresh interval is at most
(2π/ω_max)/oversample. ``periods_for_distance`` stretches the periods of
the bands finer than a distant camera resolves.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_ocean_torch.cascade import (
    CascadeSolver, CascadeState, CascadeStateReal)
from tpu_ocean_torch.config import G, OceanConfig
from tpu_ocean_torch.evolve import (
    evolve_phase_absolute, evolve_phase_accumulate)
from tpu_ocean_torch.solver import OceanSolver


def band_max_omega(cfg: OceanConfig) -> float:
    """Fastest temporal frequency resolved by a band's grid (rad/s)."""
    k_max = math.pi * cfg.resolution / cfg.length
    w2 = G * k_max
    if cfg.dispersion_mode == "capillary":
        # spectra.dispersion_capillary: ω² = g·k·(1 + (k/370)²)
        w2 *= 1.0 + (k_max / 370.0) ** 2
    return math.sqrt(w2)


def nyquist_periods(cfgs: Sequence[OceanConfig], dt: float,
                    oversample: float = 8.0,
                    max_period: int = 8) -> List[int]:
    """Per-band refresh periods keeping each band temporally oversampled:
    band b may be refreshed every p frames while p·dt ≤ (2π/ω_max) /
    oversample, clamped to [1, max_period] and rounded down to a power of
    two so that lcm(periods) stays small."""
    out = []
    for c in cfgs:
        limit = (2.0 * math.pi / band_max_omega(c)) / (oversample * dt)
        p = max(1, min(max_period, int(limit)))
        out.append(2 ** int(math.log2(p)))
    return out


def periods_for_distance(cfgs: Sequence[OceanConfig], dt: float,
                         camera_distance: float,
                         reference_distance: float = 100.0,
                         oversample: float = 8.0,
                         max_period: int = 8) -> List[int]:
    """Camera-driven LOD: at ``reference_distance`` or nearer the schedule
    is nyquist_periods; each doubling of distance doubles the period of
    every band whose patch length is below the camera distance, capped at
    ``max_period``. Long bands keep their physics-derived rates."""
    base = nyquist_periods(cfgs, dt, oversample, max_period)
    if camera_distance <= reference_distance:
        return base
    stretch = int(camera_distance / reference_distance)
    stretch = 2 ** int(math.log2(max(1, stretch)))
    out = []
    for c, p in zip(cfgs, base):
        if c.length < camera_distance:      # band finer than the eye resolves
            p = min(max_period, p * stretch)
            p = 2 ** int(math.log2(p))
        out.append(p)
    return out


class LODState(NamedTuple):
    """The cascade state (held bands' phases not advanced; the real-plane
    twin with real_state), the cached live planes [B, C, N, N] (C = 3 with
    stencil normals, 5 with spectral, whether or not the refresh was
    packed) and the frame count, a host int (the schedule slot is known
    without reading the device)."""
    cascade: "CascadeState | CascadeStateReal"
    planes: torch.Tensor
    frame: int


class LODCascadeSolver:
    """CascadeSolver with a static per-band refresh schedule:
    ``periods[b]`` refreshes band b every that many frames (a power of
    two). ``step`` runs the sub-step of the frame's slot; a band refreshed
    after p held frames advances its phase by the full p·dt it slept."""

    def __init__(self, cfgs: Sequence[OceanConfig],
                 periods: Optional[Sequence[int]] = None,
                 fft_backend: str = "reference",
                 display_length: Optional[float] = None,
                 dt: float = 1.0 / 60.0,
                 pack_channels: bool = False,
                 real_state: bool = False,
                 pallas_fields: bool = False,
                 half_spectrum: bool = False,
                 mesh=None, *, device="cuda"):
        self.inner = CascadeSolver(cfgs, fft_backend=fft_backend,
                                   display_length=display_length,
                                   mesh=mesh,
                                   pack_channels=pack_channels,
                                   real_state=real_state,
                                   pallas_fields=pallas_fields,
                                   half_spectrum=half_spectrum,
                                   device=device)
        b = self.inner.b
        self.dt = float(dt)
        if periods is None:
            periods = nyquist_periods(cfgs, self.dt)
        if len(periods) != b:
            raise ValueError(f"{len(periods)} periods for {b} bands")
        for p in periods:
            if p < 1 or (p & (p - 1)):
                raise ValueError("periods must be powers of two ≥ 1")
        self.periods = [int(p) for p in periods]
        self.schedule_len = max(self.periods)   # lcm of powers of two
        # slot (= frame % len) → the refreshing band indices; frames are
        # 1-based (init is the shared refresh at frame 0, t 0)
        self._slots: List[Tuple[int, ...]] = [
            tuple(i for i, p in enumerate(self.periods) if slot % p == 0)
            for slot in range(self.schedule_len)]
        # distinct subset → (its index tensor on the device; the per-band
        # phase steps (dt·period)·dt_multiplier, each rounded to f32 on the
        # host as the JAX sub-step forms them, [S, 1, 1])
        dev = self.inner.device
        self._substeps = {}
        for subset in set(self._slots):
            pmul = np.asarray([self.periods[i] for i in subset],
                              np.float32)[:, None, None]
            dtm = np.asarray([self.inner.cfgs[i].dt_multiplier
                              for i in subset], np.float32)[:, None, None]
            self._substeps[subset] = (
                torch.tensor(subset, dtype=torch.int64, device=dev),
                torch.from_numpy(np.float32(self.dt) * pmul * dtm).to(dev))

    # ---------------------------------------------------------------- init

    def init(self, generator: Optional[torch.Generator] = None,
             h0=None, h0_conj=None) -> LODState:
        """The cascade's init, with every band's planes primed at t = 0
        (phase 0): the shared last refresh every schedule counts from."""
        cst = self.inner.init(generator, h0, h0_conj)
        return LODState(cascade=cst,
                        planes=self._planes_at(cst, self.inner._coeffs),
                        frame=0)

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def plane_count(self) -> int:
        """Cached planes per band (the inner solver's live channels)."""
        return self.inner._nch

    def symmetrize(self, state: LODState) -> LODState:
        """Hermitize the cascade h0 pair when packing (idempotent); the
        plane cache is the held display content and stays as written."""
        return state._replace(cascade=self.inner.symmetrize(state.cascade))

    def reconfigure(self, state: LODState, new_cfgs,
                    generator: Optional[torch.Generator] = None):
        """Live per-band parameter change under the schedule: returns
        (new_solver, new_state), CascadeSolver.reconfigure lifted over the
        plane cache. An init-only change shares every table and sub-step
        (a shallow copy) and renders the cache once at each band's held
        phase: no motion pop, no schedule reset. Any other change rebuilds
        the solver (same periods and dt), carrying phase, t and step and
        re-priming the cache when the grid and layout are unchanged."""
        new_cfgs = list(new_cfgs)
        changed = set()
        for old, new in zip(self.inner.cfgs, new_cfgs):
            changed |= {f.name for f in dataclasses.fields(new)
                        if getattr(new, f.name) != getattr(old, f.name)}
        inner, cst = self.inner.reconfigure(state.cascade, new_cfgs,
                                            generator)
        if changed <= OceanSolver.INIT_ONLY_FIELDS:
            solver = copy.copy(self)
            solver.inner = inner
            return solver, LODState(cascade=cst,
                                    planes=solver._planes_at(cst,
                                                             inner._coeffs),
                                    frame=state.frame)
        solver = LODCascadeSolver(new_cfgs, periods=self.periods,
                                  fft_backend=inner.fft_backend,
                                  display_length=inner._display_length_arg,
                                  dt=self.dt,
                                  pack_channels=inner.pack_channels,
                                  real_state=inner.real_state,
                                  pallas_fields=inner.pallas_fields,
                                  half_spectrum=inner.half_spectrum,
                                  mesh=inner.mesh, device=inner.device)
        if (new_cfgs[0].resolution == self.inner.cfgs[0].resolution
                and new_cfgs[0].spectrum_layout
                == self.inner.cfgs[0].spectrum_layout):
            # cst carries the kept phase, t and step; re-prime the cache at
            # the held phases under the new solver's tables
            return solver, LODState(
                cascade=cst,
                planes=solver._planes_at(cst, solver.inner._coeffs),
                frame=state.frame)
        return solver, solver.init(generator)

    def velocity(self, state: LODState) -> torch.Tensor:
        """∂h/∂t of the displayed surface: each band's cached planes were
        rendered at its last-refresh phase, which state.cascade.phase holds
        in both evolution modes, so the rate is the held surface's."""
        return self.inner.velocity_at_held_phase(state.cascade)

    # ---------------------------------------------------------------- step

    def step(self, state: LODState, dt: Optional[float] = None):
        """Advance one frame; returns (new_state, OceanFields). ``dt``, if
        given, must equal the schedule's dt."""
        if dt is not None and abs(float(dt) - self.dt) > 1e-9:
            raise ValueError("LOD schedule is built for a fixed dt; "
                             "reconstruct the solver to change it")
        frame = state.frame + 1                # 1-based frame being computed
        subset = self._slots[frame % self.schedule_len]
        cascade, planes, fields = self._substep_impl(subset, state.cascade,
                                                     state.planes)
        return LODState(cascade=cascade, planes=planes, frame=frame), fields

    def _substep_impl(self, subset: Tuple[int, ...], cst, planes_in):
        """Refresh the ``subset`` bands, combine all cached planes. The
        phase and plane scatters write new tensors; a frame that refreshes
        no band (every period above 1) transforms nothing."""
        inner = self.inner
        idx, steps = self._substeps[subset]
        cfg0 = inner.cfgs[0]
        dt32 = np.float32(self.dt)
        absolute = cfg0.evolution_mode == "absolute"
        t_new = cst.t + float(dt32 / np.float32(cfg0.t_division)
                              if absolute else dt32)
        if not subset:
            return (cst._replace(t=t_new, step=cst.step + 1), planes_in,
                    inner._combine_fields(planes_in))
        om = inner._omega[idx]
        if absolute:
            # the phase is ω·t from the clock; the state's phase keeps each
            # band's last-refresh phase, so velocity() rates the held
            # surface
            ph_new = evolve_phase_absolute(om, t_new)
        else:
            ph_new = evolve_phase_accumulate(cst.phase[idx], om, steps)
        phase_out = cst.phase.index_copy(0, idx, ph_new)
        fresh = self._transform_planes(cst, idx, ph_new,
                                       inner._coeffs[idx])      # [S, C, N, N]
        planes = planes_in.index_copy(0, idx, fresh)
        out = inner._combine_fields(planes)
        return (cst._replace(phase=phase_out, t=t_new, step=cst.step + 1),
                planes, out)

    def _transform_planes(self, cst, bands, phase, coeffs) -> torch.Tensor:
        """The refresh transform of the bands ``bands`` selects (an index
        tensor, or slice(None) for all) → [S, C, N, N] live planes, either
        state representation."""
        inner = self.inner
        if inner.real_state:
            pair = (cst.h0_re[bands], cst.h0_im[bands], cst.h0c_re[bands],
                    cst.h0c_im[bands])
            return inner._real_planes(pair, phase, coeffs)
        return inner._complex_planes(cst.h0[bands], cst.h0_conj[bands], phase,
                                     coeffs)

    def _planes_at(self, cst, coeffs) -> torch.Tensor:
        return self._transform_planes(cst, slice(None), cst.phase, coeffs)
