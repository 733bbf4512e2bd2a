"""The domain-decomposed ocean solver over a ('batch', 'shard') mesh.

JAX counterpart: ``tpu_ocean/solver_dist.py`` ``DistributedOceanSolver``,
whose shard_map'ped step runs here as one process a rank of the mesh's
shard group. Each rank holds:

    the state's h0 pair and phase : its N/D rows (X split), as P('shard', None)
    the fields and foam_accum     : its N/D columns (Z split), as P(None, 'shard')
    t and step                    : the whole value (replicated)

One step on a rank: the phase update on its rows; the spectra assembled on
its rows (in torch, or inside the fused kernels #5/#6 at ``row_offset`` =
rank·N/D); the sharded 2-D transform of fft/distributed.py (the row-DFT
kernels #1/#2 at the shard's shapes around one all_to_all, or the
mirror-balanced half route for the last packed channel); then the fields on
its columns, their stencils' periodic wrap across ranks by the halo ring
(parallel/halo.py), or the fields kernel #3 on the local columns with its
two boundary columns recomputed from ring-exchanged strips. Every rank of
the group calls every method together (the collectives pair them up).

``gather`` all-gathers a sharded state, fields or a column-split plane to
global tensors on every rank: the counterpart of reading a JAX global
array. ``shard_state`` takes a global state (a checkpoint's) to this
rank's shards.

Not ported: the JAX constructor's TPU-only Mosaic checks (128-lane rules
for the sharded Pallas routes, the half route's 256 | N), which fire only
off the CPU there; on the card every kernel takes every even N in [16,
8192] (fft.planes.check_card_sizes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_ocean_torch import fields as field_ops
from tpu_ocean_torch.config import EPSILON, OceanConfig
from tpu_ocean_torch.evolve import (
    assemble_spectra, assemble_spectra_packed, assemble_spectra_packed_real,
    assemble_spectra_real, hermitize_pair, hermitize_planes, omega_grid,
    packed_coefficients, spectrum_coefficients)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.fft.distributed import (
    ifft2_x_sharded, ifft2_x_sharded_half, ifft2_x_sharded_planes)
from tpu_ocean_torch.fft.reference import centered_modulation
from tpu_ocean_torch.grids import coordinate_1d
from tpu_ocean_torch.ops.fields_stencil import fields_stencil
from tpu_ocean_torch.ops.fused_spectrum import (
    assemble_rowfft, assemble_rowfft_natural)
from tpu_ocean_torch.parallel.collectives import all_gather, all_to_all, ppermute
from tpu_ocean_torch.parallel.halo import make_roll_fn
from tpu_ocean_torch.solver import (
    OceanFields, OceanState, OceanStateReal, advance, channel_fields,
    finish_step, h0_pair, reconfigured, velocity_phase, velocity_planes)

_BACKENDS = ("reference", "stockham", "matmul", "pallas", "pallas_fused")
_PLANE_BACKENDS = ("pallas", "pallas_fused")


class DistributedOceanSolver:
    """The sharded twin of OceanSolver on the shard group of ``mesh``
    (parallel.make_mesh). The switches take the JAX
    ``DistributedOceanSolver``'s defaults and values and raise ValueError
    where it raises on the CPU, in its order. ``device`` "cuda" puts rank r
    on ``cuda:{r % torch.cuda.device_count()}`` (a device with an index is
    taken as given); pass ``device="cpu"`` for the plain versions. Without
    a card "cuda" raises: nothing moves to the CPU by itself."""

    def __init__(self, cfg: OceanConfig, mesh, *, device="cuda",
                 fft_backend: str = "reference", overlap_chunks: int = 1,
                 pallas_fields: bool = False, real_state: bool = False,
                 pack_channels: Optional[bool] = None,
                 half_spectrum: bool = False):
        # tpu_ocean/solver_dist.py:48-198, the checks it makes on the CPU
        if "shard" not in (mesh.mesh_dim_names or ()):
            raise ValueError("mesh needs a 'shard' axis (parallel.make_mesh)")
        if fft_backend not in _BACKENDS:
            raise ValueError(f"unknown distributed fft backend "
                             f"{fft_backend!r}")
        if real_state:
            if fft_backend not in _PLANE_BACKENDS:
                raise ValueError("real_state supports the plane-based "
                                 "backends 'pallas'/'pallas_fused' only")
            if cfg.spectrum_layout != "fft":
                raise ValueError("real_state requires spectrum_layout='fft'")
        if fft_backend == "pallas_fused" and cfg.spectrum_layout != "fft":
            raise ValueError("pallas_fused requires spectrum_layout='fft'")
        if pallas_fields and (cfg.normals_mode != "stencil"
                              or cfg.spectrum_layout != "fft"
                              or cfg.resolution % 8 != 0):
            raise ValueError("pallas_fields requires normals_mode='stencil', "
                             "spectrum_layout='fft', and a resolution "
                             "divisible by 8")
        n = cfg.resolution
        n_dev = mesh.shape[mesh.mesh_dim_names.index("shard")]
        if n % n_dev != 0:
            raise ValueError(f"resolution {n} not divisible by shard={n_dev}")
        if pallas_fields and n // n_dev < 2:
            raise ValueError("pallas_fields needs ≥2 local columns per shard")
        if pack_channels is None:
            pack_channels = False
        elif pack_channels and cfg.spectrum_layout != "fft":
            raise ValueError("pack_channels requires spectrum_layout='fft'")
        nch = 3 if cfg.normals_mode == "stencil" else 5
        pch = (2 if nch == 3 else 3) if pack_channels else nch
        if half_spectrum:
            if not pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if not real_state or fft_backend != "pallas":
                raise ValueError("half_spectrum supports the plane-based "
                                 "real_state 'pallas' pipeline only")
            if n % 16 != 0 or n < 64:
                raise ValueError("half_spectrum needs resolution % 16 == 0 "
                                 "and >= 64 (the N/2-length column kernels)")
            if n_dev > 1 and (n_dev % 2 != 0 or (n // (2 * n_dev)) % 8 != 0):
                raise ValueError(
                    f"half_spectrum's mirror-balanced sharding needs an "
                    f"EVEN shard count with N/(2D) divisible by 8 (got "
                    f"D={n_dev}, N={n}) — see ifft2_x_sharded_half")
        if overlap_chunks > 1 and pch % overlap_chunks != 0:
            raise ValueError(f"overlap_chunks must divide the {pch}-channel "
                             f"transform batch (got {overlap_chunks}); use 1 "
                             f"or {pch}")
        self.mesh = mesh
        self.group = mesh.get_group("shard")
        self.n_dev = n_dev
        self.rank = dist.get_rank(self.group)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            if not torch.cuda.is_available():
                raise RuntimeError("DistributedOceanSolver(device='cuda') "
                                   "found no CUDA device; pass device='cpu' "
                                   "for the plain versions")
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        if dev.type == "cuda" and fft_backend in _PLANE_BACKENDS:
            # the shards' passes are the single card's lengths: rows and
            # columns of N, the half channel's columns of N/2
            planes.check_card_sizes(n, cfg.precision,
                                    fused=fft_backend == "pallas_fused",
                                    half=half_spectrum)
        self.cfg = cfg
        self.fft_backend = fft_backend
        self.overlap_chunks = overlap_chunks
        self.pallas_fields = bool(pallas_fields)
        self.real_state = bool(real_state)
        self.pack_channels = bool(pack_channels)
        self.half_spectrum = bool(half_spectrum)
        self.precision = cfg.precision
        self.dz_sign = -1.0 if cfg.oracle_sign_quirk else 1.0
        self._nch, self._pch = nch, pch
        self.n_local = n // n_dev
        rows = slice(self.rank * self.n_local, (self.rank + 1) * self.n_local)

        def table(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, dtype=np.float32))).to(dev)

        # the full-size f32 tables of tpu_ocean/solver_dist.py:205-228, each
        # rank keeping its rows (X split) or its columns (Z split)
        self.omega = table(omega_grid(cfg)[rows])
        self.coeffs = None
        if fft_backend != "pallas_fused":
            if self.pack_channels:
                self.coeffs = table(packed_coefficients(cfg, nch)[:, rows])
            else:
                self.coeffs = table(
                    spectrum_coefficients(cfg).real[:nch, rows])
        self.pre = self.post = None
        if cfg.spectrum_layout == "centered":
            pre, post = centered_modulation(n, cfg.length, cfg.unit_width)
            self.pre = torch.complex(table(pre.real[rows]),
                                     table(pre.imag[rows]))
            self.post = torch.complex(table(post.real[:, rows]),
                                      table(post.imag[:, rows]))
            x1d = coordinate_1d(n, cfg.unit_width)
        else:
            x1d = np.arange(n, dtype=np.float64) * (cfg.length / n)
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self.x0 = table(x0[:, rows])
        self.z0 = table(z0[:, rows])

    # ------------------------------------------------------------- sharding

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [N, ...] tensor, on its device."""
        nl = self.n_local
        return x[self.rank * nl:(self.rank + 1) * nl].to(self.device).clone()

    def _cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a global [N, N, ...] tensor."""
        nl = self.n_local
        return x[:, self.rank * nl:(self.rank + 1) * nl].to(
            self.device).contiguous()

    def _gather_along(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` in rank order."""
        if self.n_dev == 1:
            return x
        return torch.cat(list(all_gather(x, self.group).unbind(0)), axis)

    def gather(self, x):
        """Global tensors on every rank from this rank's shards: a state
        (the h0 planes and phase along rows, foam_accum along columns, t
        and step as they are), OceanFields, or one column-split plane (a
        field, ``velocity``'s output)."""
        if isinstance(x, (OceanState, OceanStateReal)):
            return type(x)(**{
                name: (v if v.dim() == 0 else
                       self._gather_along(v, 1 if name == "foam_accum" else 0))
                for name, v in x._asdict().items()})
        if isinstance(x, OceanFields):
            return OceanFields(*(self._gather_along(f, 1) for f in x))
        return self._gather_along(x, 1)

    def shard_state(self, state):
        """This rank's shards, on its device, of a global state (torch
        tensors or numpy arrays; a checkpoint's, load_checkpoint with the
        solver's ``real_state``): rows of the h0 planes and phase, columns
        of foam_accum, t and step whole."""
        if isinstance(state, OceanStateReal) != self.real_state:
            raise ValueError("state representation does not match the "
                             "solver's real_state setting (load_checkpoint"
                             "(real_state=...) selects the view)")
        out = {}
        for name, v in state._asdict().items():
            v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            out[name] = (v.to(self.device) if v.dim() == 0 else
                         self._cols(v) if name == "foam_accum" else
                         self._rows(v))
        return type(state)(**out)

    # ------------------------------------------------------------------ init

    def symmetrize(self, state):
        """Packed solvers: the Hermitian projection of the h0 pair
        (OceanSolver.symmetrize). Its negflip pairs row r with row N − r,
        which another rank holds, so the pair is gathered, projected and
        sharded again. Per-channel solvers return the state unchanged."""
        if not self.pack_channels:
            return state
        if self.real_state:
            full = hermitize_planes(*(self._gather_along(p, 0) for p in (
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)))
            return state._replace(**dict(zip(
                ("h0_re", "h0_im", "h0c_re", "h0c_im"),
                (self._rows(p) for p in full))))
        a, ac = hermitize_pair(self._gather_along(state.h0, 0),
                               self._gather_along(state.h0_conj, 0))
        return state._replace(h0=self._rows(a), h0_conj=self._rows(ac))

    def init(self, generator: Optional[torch.Generator] = None, h0=None,
             h0_conj=None):
        """This rank's shards of the initial state: the global h0 pair drawn
        from ``generator`` (default seeded with cfg.seed, as
        OceanSolver.init, so one seed gives the single-device solver's h0)
        or an injected global (h0, h0_conj) pair (numpy or anything
        np.asarray takes), projected onto its Hermitian part when packed,
        then this rank's rows. Phase, clock and foam start at 0. Every rank
        passes the same generator state or pair."""
        n = self.cfg.resolution
        # projected on the device, as OceanSolver.symmetrize projects
        pair = [p.to(self.device) for p in h0_pair(
            self.cfg, self.real_state, generator, h0, h0_conj)]
        if self.pack_channels:
            pair = (hermitize_planes(*pair) if self.real_state
                    else hermitize_pair(*pair))
        pair = [self._rows(p) for p in pair]
        nl = self.n_local
        zeros = dict(
            phase=torch.zeros((nl, n), dtype=torch.float32, device=self.device),
            t=torch.zeros((), dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            foam_accum=torch.zeros((n, nl), dtype=torch.float32,
                                   device=self.device))
        kind = OceanStateReal if self.real_state else OceanState
        return kind(*pair, **zeros)

    def reconfigure(self, state, new_cfg: OceanConfig,
                    generator: Optional[torch.Generator] = None):
        """Live parameter change (OceanSolver.reconfigure on the mesh):
        returns (new solver, new state), h0 drawn afresh from ``generator``
        (default seeded with new_cfg.seed). A change of init-only fields
        shares every table of this solver (a shallow copy) and keeps the
        phase, clock, step and foam; any other change builds a new solver on
        the same mesh with the same switches (packing and half spectrum kept
        only in the same layout), which keeps them only at the same N and
        layout."""
        return reconfigured(
            self, state, new_cfg, generator,
            lambda pack, half: DistributedOceanSolver(
                new_cfg, self.mesh, device=self.device,
                fft_backend=self.fft_backend,
                overlap_chunks=self.overlap_chunks,
                pallas_fields=self.pallas_fields, real_state=self.real_state,
                pack_channels=pack, half_spectrum=half))

    # ------------------------------------------------------------------ step

    def step(self, state, dt: float = 1.0 / 60.0):
        """Advance one step on every rank; returns (new_state, OceanFields),
        this rank's shards of each."""
        phase, phase_state, t_new = advance(self.cfg, self.omega, state, dt)
        out = self._extract_fields(*self._planes(state, phase))
        return finish_step(self.cfg, state, out, phase_state, t_new, dt)

    def velocity(self, state, t: Optional[float] = None) -> torch.Tensor:
        """∂h/∂t on this rank's columns [N, N/D] (OceanSolver.velocity,
        sharded): the iρω-weighted spectrum expanded into f32 planes on the
        rows, then the sharded transform: the plane route on the pallas
        backends (the half route with half_spectrum: the spectrum is
        Hermitian under the packed projection), the complex route with the
        modulation on the others."""
        phase = velocity_phase(self.cfg, self.omega, state, t)
        pair = ((state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
                if self.real_state else
                (state.h0.real, state.h0.imag, state.h0_conj.real,
                 state.h0_conj.imag))
        vr, vi = velocity_planes(self.cfg, self.omega, phase, *pair)
        if self.fft_backend in _PLANE_BACKENDS:
            if self.half_spectrum:
                return ifft2_x_sharded_half(vr[None], vi[None], self.group,
                                            self.precision)[0]
            re, _ = ifft2_x_sharded_planes(vr[None], vi[None], self.group,
                                           precision=self.precision)
            return re[0]
        vspec = torch.complex(vr, vi)[None]
        if self.pre is not None:
            vspec = vspec * self.pre[None]
        out = ifft2_x_sharded(vspec, self.group, self.fft_backend,
                              precision=self.precision)
        if self.post is not None:
            out = out * self.post[None]
        return out[0].real.contiguous()

    # ------------------------------------------------------------- internals

    def _planes(self, state, phase):
        """Assembly and the sharded transform at ``phase``: this rank's
        columns of (height, disp_x, disp_z[, slope_x, slope_z])."""
        if self.real_state:
            pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            half = None
            if self.fft_backend == "pallas_fused":
                re, im = self._fused_transform_planes(pair, phase)
            else:
                assemble = (assemble_spectra_packed_real if self.pack_channels
                            else assemble_spectra_real)
                re, im = assemble(pair, phase, self.coeffs)
                if self.half_spectrum:
                    half = ifft2_x_sharded_half(re[-1:], im[-1:], self.group,
                                                self.precision)[0]
                    # the half channel is its own launch group: chunking
                    # applies to the remaining full channels only
                    oc = (self.overlap_chunks
                          if (self._pch - 1) % self.overlap_chunks == 0 else 1)
                    re, im = ifft2_x_sharded_planes(
                        re[:-1], im[:-1], self.group, overlap_chunks=oc,
                        precision=self.precision)
                else:
                    re, im = ifft2_x_sharded_planes(
                        re, im, self.group,
                        overlap_chunks=self.overlap_chunks,
                        precision=self.precision)
            return channel_fields(re, im, self._nch, self.pack_channels, half)
        if self.fft_backend == "pallas_fused":
            pair = tuple(p.contiguous() for p in (
                state.h0.real, state.h0.imag,
                state.h0_conj.real, state.h0_conj.imag))
            f = torch.complex(*self._fused_transform_planes(pair, phase))
        else:
            if self.pack_channels:
                spectra = assemble_spectra_packed(state.h0, state.h0_conj,
                                                  phase, self.coeffs)
            else:
                spectra = assemble_spectra(state.h0, state.h0_conj, phase,
                                           self.coeffs)
            if self.pre is not None:
                spectra = spectra * self.pre[None]
            f = ifft2_x_sharded(spectra, self.group, self.fft_backend,
                                overlap_chunks=self.overlap_chunks,
                                precision=self.precision)
            if self.post is not None:
                f = f * self.post[None]
        return tuple(p.contiguous() for p in channel_fields(
            f.real, f.imag, self._nch, self.pack_channels))

    def _fused_transform_planes(self, pair, phase):
        """``pallas_fused`` on the shard: the fused assembly + row DFT of
        this rank's rows, the global row index from ``row_offset`` =
        rank·N/D (#5 transposed store, or #6 natural store beyond
        MAX_TRANSPOSED_N), one launch a channel range of
        ``overlap_chunks``, each followed by its all_to_all (split −2 and
        concat −1, or split −1 and concat −2); then the column pass of every
        channel at once (#1, or the axis −2 column pass)."""
        cfg = self.cfg
        large = cfg.resolution > planes.MAX_TRANSPOSED_N
        row_fn = assemble_rowfft_natural if large else assemble_rowfft
        split_ax, concat_ax = (3, 2) if large else (2, 3)

        def chunk(ch_start, ch_count):
            re, im = row_fn(pair, phase, cfg.length, self.dz_sign,
                            epsilon=EPSILON, ch_count=ch_count,
                            row_offset=self.rank * self.n_local,
                            ch_start=ch_start, packed=self.pack_channels,
                            nch_live=self._nch, precision=self.precision)
            if self.n_dev > 1:
                both = all_to_all(torch.stack([re, im]), self.group,
                                  split_ax, concat_ax)
                re, im = both[0], both[1]
            return re, im

        chunks = max(self.overlap_chunks, 1)
        per = self._pch // chunks
        parts = [chunk(i * per, per) for i in range(chunks)]
        re = torch.cat([p[0] for p in parts]) if len(parts) > 1 else parts[0][0]
        im = torch.cat([p[1] for p in parts]) if len(parts) > 1 else parts[0][1]
        if large:
            return planes.ifft1d_planes_axis2(re, im, True, self.precision)
        return planes.fft1d_transposed(re, im, True, self.precision)

    def _fields_pallas_sharded(self, cdx, h, cdz, texel: float):
        """The fields kernel (#3) on this rank's columns [N, N/D], whose
        z-neighbours wrap around the shard: only columns 0 and N/D − 1 read
        a wrong neighbour. Those two are recomputed from 3-column strips
        whose outer column comes round the ring (two exchanges, the three
        planes stacked), with the torch twins (fields.normals_stencil,
        whitecap_gpu), and spliced in."""
        normal, foam, jac = fields_stencil(cdx, h, cdz, texel)
        d = self.n_dev
        if d == 1:
            return normal, foam, jac
        p = torch.stack([cdx, h, cdz])                         # [3, N, N/D]
        halo_l = ppermute(p[:, :, -1:], self.group,
                          [(i, (i + 1) % d) for i in range(d)])  # left's last
        halo_r = ppermute(p[:, :, :1], self.group,
                          [(i, (i - 1) % d) for i in range(d)])  # right's first
        for col, strip in ((0, torch.cat([halo_l, p[:, :, :2]], 2)),
                           (-1, torch.cat([p[:, :, -2:], halo_r], 2))):
            # torch.roll is periodic over the 3-column strip: the halo and
            # the interior neighbour sit on either side of the middle column
            sx, sh, sz = strip
            nrm = field_ops.normals_stencil(sx, sh, sz, texel)
            fm, jc = field_ops.whitecap_gpu(sx, sz, nrm)
            normal[:, col] = nrm[:, 1]
            foam[:, col] = fm[:, 1]
            jac[:, col] = jc[:, 1]
        return normal, foam, jac

    def _extract_fields(self, height, disp_x, disp_z, slope_x=None,
                        slope_z=None) -> OceanFields:
        """This rank's columns of the fields: the fields kernel with the
        halo splice, or the normals and foam in torch with the ring as
        their periodic wrap along the split axis (the oracle's foam zeroed
        on the global last row and column)."""
        cfg = self.cfg
        n = cfg.resolution
        chop_dx = cfg.choppiness * disp_x
        chop_dz = cfg.choppiness * disp_z
        texel = cfg.length / n
        if self.pallas_fields:
            normal, foam, jac = self._fields_pallas_sharded(chop_dx, height,
                                                            chop_dz, texel)
        else:
            roll = make_roll_fn(self.group, sharded_axes=(1,))
            if cfg.normals_mode == "spectral":
                normal = field_ops.normals_spectral(slope_x, slope_z)
            else:
                normal = field_ops.normals_stencil(chop_dx, height, chop_dz,
                                                   texel, roll_fn=roll)
            if cfg.spectrum_layout == "centered":
                foam, jac = field_ops.whitecap_oracle(
                    disp_x, disp_z, normal, roll_fn=roll,
                    axis_offsets=(0, self.rank * self.n_local),
                    global_sizes=(n, n))
            else:
                foam, jac = field_ops.whitecap_gpu(chop_dx, chop_dz, normal,
                                                   roll_fn=roll)
        return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                           pos_x=self.x0 - chop_dx, pos_z=self.z0 - chop_dz,
                           normal=normal, foam=foam, jacobian=jac)
