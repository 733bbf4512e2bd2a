"""Fused surface-fields stencil: normals, Jacobian and whitecap foam.

JAX counterpart: ``tpu_ocean/ops/fields_pallas.py``, two kernels behind
one module switch, ``FIELDS_KERNEL_V2`` (fields_pallas.py:149, 193-195):

* v2 (``fields_pallas_v2``, the default): by bilinearity the shader's four
  edge cross products equal one cross product of the central differences,
  u = right − left and v = top − bottom, so normals and the Jacobian both
  come from six difference planes. Kernel ``csrc/fields_stencil.cu``.
* v1 (``_fields_kernel``, kept for A/B and regression hunts): the same
  fields from the four edge vectors and four cross products, summed per
  component as c1 + c2 + c3 + c4. Kernel ``csrc/fields_stencil_v1.cu``.

On a CUDA tensor each wrapper launches its hand-written kernel and nothing
else; on a CPU tensor it runs its plain version below. The TPU kernels'
boundary-row gather, halo bands and ``M % 8`` rule came from VMEM
blocking and DMA alignment and are not carried over: any [M, N] grid works.

Gradients follow the JAX package (fields_pallas.py:172-190): the forward
is the kernel (or its plain version), the backward differentiates the jnp
twins (``fields_twin``: ``fields.normals_stencil`` + ``whitecap_gpu``) in
plain torch, for v1 and v2 alike.
"""

from __future__ import annotations

import torch

from tpu_ocean_torch import _build
from tpu_ocean_torch import fields as field_ops
from tpu_ocean_torch.fft.planes import needs_grad, on_cpu

#: False routes fields_stencil to the v1 kernel (fields_stencil_v1), as the
#: JAX package's switch of the same name does
FIELDS_KERNEL_V2 = True


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


def fields_stencil_v1_plain(disp_x, height, disp_z, texel: float):
    """Plain version of fields_stencil_v1, the kernel's arithmetic in torch
    (fields_pallas.py:100-140)."""
    p = (disp_x, height, disp_z)

    def xm(a):                     # row i−1
        return torch.roll(a, 1, 0)

    def xp(a):                     # row i+1
        return torch.roll(a, -1, 0)

    def zm(a):                     # column j−1
        return torch.roll(a, 1, 1)

    def zp(a):                     # column j+1
        return torch.roll(a, -1, 1)

    def edge(nb, ox, oz):
        return (nb(p[0]) - p[0] + ox, nb(p[1]) - p[1], nb(p[2]) - p[2] + oz)

    # "right" = +x neighbour, "top" = −z neighbour (OceanNormal.shader:39-56)
    right = edge(xp, texel, 0.0)
    left = edge(xm, -texel, 0.0)
    top = edge(zm, 0.0, -texel)
    bottom = edge(zp, 0.0, texel)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    c1 = cross(right, top)
    c2 = cross(top, left)
    c3 = cross(left, bottom)
    c4 = cross(bottom, right)
    nx = c1[0] + c2[0] + c3[0] + c4[0]
    ny = c1[1] + c2[1] + c3[1] + c4[1]
    nz = c1[2] + c2[2] + c3[2] + c4[2]
    inv = torch.reciprocal(torch.sqrt(nx * nx + ny * ny + nz * nz))
    nx, ny, nz = nx * inv, ny * inv, nz * inv

    # whitecap (WhiteCap.shader:33-45): central differences ÷8
    dx, dz = disp_x, disp_z
    ddx_x = -0.5 * (xm(dx) - xp(dx)) / 8.0
    ddx_z = -0.5 * (xm(dz) - xp(dz)) / 8.0
    ddy_x = -0.5 * (zm(dx) - zp(dx)) / 8.0
    ddy_z = -0.5 * (zm(dz) - zp(dz)) / 8.0
    jac = (1.0 + ddx_x) * (1.0 + ddy_z) - ddx_z * ddy_x
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


def _launch(entry: str, disp_x, height, disp_z, texel: float):
    kernels = _build.load()
    m, n = height.shape
    normal = torch.empty((m, n, 3), dtype=torch.float32, device=height.device)
    foam = torch.empty((m, n), dtype=torch.float32, device=height.device)
    jac = torch.empty_like(foam)
    with torch.cuda.device(height.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(kernels.lib, entry)(
            disp_x.data_ptr(), height.data_ptr(), disp_z.data_ptr(),
            normal.data_ptr(), foam.data_ptr(), jac.data_ptr(), m, n,
            float(texel), stream)
    kernels.check(err, entry)
    return normal, foam, jac


def _fields_v2_impl(disp_x, height, disp_z, texel):
    _check_planes(disp_x, height, disp_z)
    if on_cpu("fields_stencil", disp_x):
        return fields_stencil_plain(disp_x, height, disp_z, texel)
    out = _launch("tpu_fields_stencil", disp_x, height, disp_z, texel)
    fields_stencil.launches += 1
    return out


def _fields_v1_impl(disp_x, height, disp_z, texel):
    _check_planes(disp_x, height, disp_z)
    if on_cpu("fields_stencil_v1", disp_x):
        return fields_stencil_v1_plain(disp_x, height, disp_z, texel)
    out = _launch("tpu_fields_stencil_v1", disp_x, height, disp_z, texel)
    fields_stencil_v1.launches += 1
    return out


def fields_twin(disp_x, height, disp_z, texel: float):
    """The JAX package's jnp twins of the kernels
    (fields_pallas._fields_twin): fields.normals_stencil, then
    fields.whitecap_gpu on its normals. The fields' backward reverses
    through these, not through the kernels' plain versions."""
    normal = field_ops.normals_stencil(disp_x, height, disp_z, texel)
    foam, jac = field_ops.whitecap_gpu(disp_x, disp_z, normal)
    return normal, foam, jac


class _FieldsStencilDiff(torch.autograd.Function):
    """A fields kernel (``impl``: the v2 or v1 dispatch) with the rule of
    fields_pallas._fields_pallas_diff: the forward is the dispatch, the
    backward torch.autograd.grad of fields_twin at the saved inputs, in
    plain torch on either device. The texel size is not differentiated."""

    @staticmethod
    def forward(ctx, disp_x, height, disp_z, texel, impl):
        ctx.save_for_backward(disp_x, height, disp_z)
        ctx.texel = texel
        return impl(disp_x, height, disp_z, texel)

    @staticmethod
    def backward(ctx, g_normal, g_foam, g_jac):
        inputs = [p.detach().requires_grad_() for p in ctx.saved_tensors]
        with torch.enable_grad():
            outs = fields_twin(*inputs, ctx.texel)
        grads = torch.autograd.grad(outs, inputs, (g_normal, g_foam, g_jac))
        return (*grads, None, None)


def _dispatch(impl, disp_x, height, disp_z, texel):
    if needs_grad(disp_x, height, disp_z):
        return _FieldsStencilDiff.apply(disp_x, height, disp_z, float(texel),
                                        impl)
    return impl(disp_x, height, disp_z, texel)


def fields_stencil(disp_x: torch.Tensor, height: torch.Tensor,
                   disp_z: torch.Tensor, texel: float):
    """(normal [M, N, 3], foam [M, N], jacobian [M, N]) from the chop-scaled
    displacements and the height, periodic on both axes; ``texel`` = L/N.
    The v2 kernel, or v1 when FIELDS_KERNEL_V2 is False. Differentiable
    (_FieldsStencilDiff) where needs_grad."""
    if not FIELDS_KERNEL_V2:
        return fields_stencil_v1(disp_x, height, disp_z, texel)
    return _dispatch(_fields_v2_impl, disp_x, height, disp_z, texel)


def fields_stencil_v1(disp_x: torch.Tensor, height: torch.Tensor,
                      disp_z: torch.Tensor, texel: float):
    """fields_stencil by the v1 kernel: the same outputs from four edge
    cross products (agreeing with v2 up to f32 reassociation), and the same
    backward."""
    return _dispatch(_fields_v1_impl, disp_x, height, disp_z, texel)


#: kernel launches since the last reset (CPU calls do not count)
fields_stencil.launches = 0
fields_stencil_v1.launches = 0
