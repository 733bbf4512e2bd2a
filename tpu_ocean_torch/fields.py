"""Spectral and stencil normals and whitecap foam in both conventions,
plain torch.

JAX counterpart: ``tpu_ocean/fields.py`` (``normals_spectral``,
``normals_stencil``, ``whitecap_gpu``, ``whitecap_oracle``). Spectral
normals normalize the exact slopes the slope channels carry
(FFTMesh.cs:218). The stencil and the GPU foam are the literal shader
forms: four cross products of edge vectors to the ±x/±z neighbours
(OceanNormal.shader:39-56) and the ÷8 central differences of
WhiteCap.shader:33-45, periodic via torch.roll; the oracle's foam takes
one-sided differences that stop at the last row (FFTMesh.cs:253-276).
The fields kernel (``ops/fields_stencil.py``) computes the same fields
from six difference planes; these twins are its independent reference.
Axis 0 = x, axis 1 = z.

The clips take JAX's tie rule for gradients: ``jnp.clip`` and
``jnp.maximum(x, 0.0)`` pass half the gradient at a bound, where
``torch.clamp`` passes all of it, so they are torch.maximum and
torch.minimum against 0-d tensors (``_at_least_zero``), with the same
forward values.
"""

from __future__ import annotations

import torch


def _at_least_zero(t):
    """jnp.maximum(t, 0.0): a tie splits its gradient 0.5/0.5."""
    return torch.maximum(t, t.new_zeros(()))


def _smoothstep01(t):
    # jnp.clip(t, 0, 1), tie rule included
    t = torch.minimum(_at_least_zero(t), t.new_ones(()))
    return t * t * (3.0 - 2.0 * t)


def normals_spectral(slope_x, slope_z):
    """normalize((−sx, 1, −sz)) from the exact spectral slopes: [M, N, 3]."""
    n = torch.stack([-slope_x, torch.ones_like(slope_x), -slope_z], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def normals_stencil(disp_x, height, disp_z, texel_size: float):
    """Finite-difference normals of the displaced positions p = (dx, h, dz)
    with the rest-position offset ±texel_size on the stepped axis: [M, N, 3]."""
    p = torch.stack([disp_x, height, disp_z], dim=-1)

    def nb(axis, shift):
        return torch.roll(p, -shift, axis)

    zero = torch.zeros_like(height)
    ts = torch.full_like(height, texel_size)
    right = torch.stack([ts, zero, zero], -1) + nb(0, 1) - p
    left = torch.stack([-ts, zero, zero], -1) + nb(0, -1) - p
    # the shader's "top" samples uv − texel on the second axis and offsets
    # −texelSize in world z (OceanNormal.shader:47-48)
    top = torch.stack([zero, zero, -ts], -1) + nb(1, -1) - p
    bottom = torch.stack([zero, zero, ts], -1) + nb(1, 1) - p

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    n = (cross(right, top) + cross(top, left)
         + cross(left, bottom) + cross(bottom, right))
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def whitecap_gpu(disp_x, disp_z, normal):
    """Jacobian foam, GPU convention: central differences with periodic
    wrap and the reference's ÷8 display scaling. Returns (foam, jacobian)."""
    def central(d, axis):
        fwd = torch.roll(d, -1, axis)
        bwd = torch.roll(d, 1, axis)
        return -0.5 * (bwd - fwd) / 8.0

    ddx_x = central(disp_x, 0)
    ddx_z = central(disp_z, 0)
    ddy_x = central(disp_x, 1)
    ddy_z = central(disp_z, 1)
    jacobian = (1.0 + ddx_x) * (1.0 + ddy_z) - ddx_z * ddy_x
    noise = 0.3 * torch.sqrt(normal[..., 0] ** 2 + normal[..., 2] ** 2)
    turb = _at_least_zero(1.0 - jacobian + noise)
    return _smoothstep01(turb), jacobian


def whitecap_oracle(disp_x, disp_z, normal):
    """Jacobian foam, oracle convention (FFTMesh.cs:253-276), on the raw
    (unscaled) displacements: one-sided differences dD/dx = 0.5·(D[i] −
    D[i+1]), zero on the last row and column (the reference's
    ``if (i != resolution-1)``). Returns (foam, jacobian)."""
    def one_sided(d, axis):
        g = 0.5 * (d - torch.roll(d, -1, axis))
        last = [slice(None)] * d.dim()
        last[axis] = slice(-1, None)
        g[tuple(last)] = 0.0
        return g

    ddx_x = one_sided(disp_x, 0)
    ddx_z = one_sided(disp_z, 0)
    ddy_x = one_sided(disp_x, 1)
    ddy_z = one_sided(disp_z, 1)
    jacobian = (1.0 + ddx_x) * (1.0 + ddy_z) - ddx_z * ddy_x
    noise = 0.3 * torch.sqrt(normal[..., 0] ** 2 + normal[..., 2] ** 2)
    turb = _at_least_zero(1.0 - jacobian + noise)
    return _smoothstep01(turb), jacobian
