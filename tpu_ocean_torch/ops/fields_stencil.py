"""Fused surface-fields stencil: normals, Jacobian and whitecap foam.

JAX counterpart: ``tpu_ocean/ops/fields_pallas.py`` (``fields_pallas_v2``).
By bilinearity the shader's four edge cross products equal one cross
product of the central differences, u = right − left and v = top − bottom,
so normals and the Jacobian both come from six difference planes.

On a CUDA tensor ``fields_stencil`` launches the hand-written kernel
(``csrc/fields_stencil.cu``) and nothing else; on a CPU tensor it runs its
plain version below. The TPU kernel's boundary-row gather and its
``M % 8`` rule came from its VMEM blocking and are not carried over: any
[M, N] grid works.
"""

from __future__ import annotations

import torch

from tpu_ocean_torch import _build


def fields_stencil_plain(disp_x, height, disp_z, texel: float):
    """Plain version of fields_stencil, the kernel's arithmetic in torch."""
    def xdiff(a):                  # a[i+1] − a[i−1]
        return torch.roll(a, -1, 0) - torch.roll(a, 1, 0)

    def zdiff(a):                  # a[j−1] − a[j+1]
        return torch.roll(a, 1, 1) - torch.roll(a, -1, 1)

    ddx, ddh, ddz = xdiff(disp_x), xdiff(height), xdiff(disp_z)
    dzx, dzh, dzz = zdiff(disp_x), zdiff(height), zdiff(disp_z)
    ux, uy, uz = ddx + 2.0 * texel, ddh, ddz
    vx, vy, vz = dzx, dzh, dzz - 2.0 * texel
    nx = uy * vz - uz * vy
    ny = uz * vx - ux * vz
    nz = ux * vy - uy * vx
    inv = torch.reciprocal(torch.sqrt(nx * nx + ny * ny + nz * nz))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    # the whitecap central differences are the same differences ÷16
    # (WhiteCap.shader:36-37: −0.5·(bwd − fwd)/8)
    jac = ((1.0 + ddx * (1.0 / 16.0)) * (1.0 + dzz * (-1.0 / 16.0))
           - (ddz * (1.0 / 16.0)) * (dzx * (-1.0 / 16.0)))
    t = torch.clamp(1.0 - jac + 0.3 * torch.sqrt(nx * nx + nz * nz), 0.0, 1.0)
    return torch.stack([nx, ny, nz], dim=-1), t * t * (3.0 - 2.0 * t), jac


def _check_planes(*planes: torch.Tensor) -> None:
    shape, device = planes[0].shape, planes[0].device
    for p in planes:
        if p.dtype != torch.float32:
            raise TypeError(f"fields_stencil takes float32 planes, got {p.dtype}")
        if p.dim() != 2 or p.shape != shape or p.numel() == 0:
            raise ValueError(f"fields_stencil takes three non-empty [M, N] "
                             f"planes of one shape, got {[tuple(q.shape) for q in planes]}")
        if p.device != device:
            raise ValueError(f"planes on two devices: {device}, {p.device}")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")


def fields_stencil(disp_x: torch.Tensor, height: torch.Tensor,
                   disp_z: torch.Tensor, texel: float):
    """(normal [M, N, 3], foam [M, N], jacobian [M, N]) from the chop-scaled
    displacements and the height, periodic on both axes; ``texel`` = L/N."""
    _check_planes(disp_x, height, disp_z)
    if disp_x.device.type == "cpu":
        return fields_stencil_plain(disp_x, height, disp_z, texel)
    if disp_x.device.type != "cuda":
        raise ValueError(f"fields_stencil runs on cpu or cuda, not "
                         f"{disp_x.device}")
    kernels = _build.load()
    m, n = height.shape
    normal = torch.empty((m, n, 3), dtype=torch.float32, device=height.device)
    foam = torch.empty((m, n), dtype=torch.float32, device=height.device)
    jac = torch.empty_like(foam)
    with torch.cuda.device(height.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernels.lib.tpu_fields_stencil(
            disp_x.data_ptr(), height.data_ptr(), disp_z.data_ptr(),
            normal.data_ptr(), foam.data_ptr(), jac.data_ptr(), m, n,
            float(texel), stream)
    kernels.check(err, "fields_stencil")
    fields_stencil.launches += 1
    return normal, foam, jac


#: kernel launches since the last reset (CPU calls do not count)
fields_stencil.launches = 0
