"""Field probing — the texture-sampler analogue.

JAX counterpart: ``tpu_ocean/sample.py``. Every consumer in the reference
reads the solver's output textures with bilinear repeat-mode sampling
(tex2Dlod in the pond vertex stage, MistralWaterCommon.cginc:21-23; the
ocean material's height/displacement fetches, TestOcean.shader:65-66).
Here the fields are tensors; this module is that sampler: periodic
bilinear interpolation at arbitrary world positions, in f32 on the field's
device, differentiable in the query position through torch's autograd —
the API a physics or gameplay consumer uses to put buoys, boats or probes
on the surface.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ocean_torch.grids import coordinate_1d


def grid_origin(cfg) -> float:
    """World coordinate of grid index 0 for a solver config: 0 for the
    fft layout (GPU convention), the centered mesh's first vertex for the
    centered layout (grids.coordinate_1d)."""
    if cfg.spectrum_layout == "fft":
        return 0.0
    return float(coordinate_1d(cfg.resolution, cfg.unit_width)[0])


def grid_period(cfg) -> float:
    """The sampler's tiling period = N · (grid spacing). For the fft layout
    the spacing is length/N so the period IS cfg.length; for the centered
    layout the mesh spacing is unit_width (FFTMesh.cs:107), so the period is
    N·unit_width — which differs from cfg.length on incommensurate configs
    like FFT_MESH_DEMO (L=12.39, N·w=12)."""
    if cfg.spectrum_layout == "fft":
        return float(cfg.length)
    return float(cfg.resolution * cfg.unit_width)


def _f32(v, device) -> torch.Tensor:
    """``v`` (a number, array or tensor) as an f32 tensor on ``device``;
    a tensor keeps its autograd graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)


def sample_bilinear(field: torch.Tensor, x, z, length: float,
                    origin: float = 0.0) -> torch.Tensor:
    """Periodic bilinear sample of ``field`` [N, N] at world (x, z).

    Axis 0 = x, axis 1 = z (the package-wide convention); the patch tiles
    with period ``length`` exactly like the reference's repeat-mode textures.
    ``length`` is the tiling PERIOD = N·spacing — use ``grid_period(cfg)``,
    which is cfg.length for the fft layout but N·unit_width for centered
    grids (those can be incommensurate with cfg.length). ``origin`` is the
    world coordinate of index 0 — ``grid_origin(cfg)`` (0 for fft; the
    centered mesh starts at −N·w/2 + w/2). ``x``/``z`` may be scalars,
    arrays or tensors of any matching shape; the result is f32 on the
    field's device.
    """
    n = field.shape[0]
    o = float(np.float32(origin))
    # the period as a tensor on the field's device: CUDA divides by a host
    # scalar through its reciprocal, which puts fx an ulp from JAX's and
    # the CPU's quotient, and tx inherits that ulp of fx (1e-4 at 2 periods
    # of N = 1024)
    period = _f32(length, field.device)
    fx = (_f32(x, field.device) - o) / period * n
    fz = (_f32(z, field.device) - o) / period * n
    # floor before the cast, and the wrap a floor-mod (as jnp.mod): a
    # truncating cast or torch.fmod would mirror negative coordinates
    fx0 = torch.floor(fx)
    fz0 = torch.floor(fz)
    tx = fx - fx0
    tz = fz - fz0
    i0 = torch.remainder(fx0.to(torch.int64), n)
    j0 = torch.remainder(fz0.to(torch.int64), n)
    i1 = torch.remainder(i0 + 1, n)
    j1 = torch.remainder(j0 + 1, n)
    f00 = field[i0, j0]
    f10 = field[i1, j0]
    f01 = field[i0, j1]
    f11 = field[i1, j1]
    return ((1 - tx) * (1 - tz) * f00 + tx * (1 - tz) * f10
            + (1 - tx) * tz * f01 + tx * tz * f11)


def surface_at(fields, x, z, length: float, choppiness: float = 1.0,
               origin: float = 0.0):
    """Displaced surface point(s) for probes at rest position (x, z):
    returns (world_x, height, world_z) after the choppy horizontal
    displacement — the vertex-stage math (TestOcean.shader:65-66,
    FFTMesh.cs:243-245) for arbitrary query points."""
    h = sample_bilinear(fields.height, x, z, length, origin)
    dx = sample_bilinear(fields.disp_x, x, z, length, origin)
    dz = sample_bilinear(fields.disp_z, x, z, length, origin)
    dev = fields.height.device
    return (_f32(x, dev) - choppiness * dx, h,
            _f32(z, dev) - choppiness * dz)


def buoy_heights(fields, positions, length: float,
                 origin: float = 0.0) -> torch.Tensor:
    """Heights under a [K, 2] array of (x, z) probe positions."""
    p = _f32(positions, fields.height.device)
    return sample_bilinear(fields.height, p[:, 0], p[:, 1], length, origin)
