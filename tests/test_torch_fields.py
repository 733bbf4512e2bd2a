"""tpu_ocean_torch fields stencil against the JAX package: the port's
fields_stencil (plain version on the CPU) vs the v2 Pallas kernel in
interpret mode, and vs the literal four-cross-product shader twins
(tpu_ocean.fields, and the port's own copy of them); the v1 form
(fields_stencil_v1, FIELDS_KERNEL_V2 off) vs the JAX v1 kernel and inside
the solver. Square and non-square grids, so that an x/z axis swap cannot
hide."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean import fields as jfields
from tpu_ocean.ops import fields_pallas
from tpu_ocean.ops.fields_pallas import fields_pallas_v2
from tpu_ocean_torch import fields as tfields, fields_to_numpy
from tpu_ocean_torch.ops import fields_stencil as fs
from tests.test_packing import _assert_fields_close

TEXEL = 434.48 / 64


def _inputs(shape, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=shape)).astype(np.float32)
            for _ in range(3)]


def _check(got, want, normal_tol, jac_tol, foam_tol):
    for g, w, tol in zip(got, want, (normal_tol, foam_tol, jac_tol)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("shape", [(64, 64), (32, 64)])
def test_fields_stencil_matches_pallas_v2(shape):
    dx, h, dz = _inputs(shape)
    want = fields_pallas_v2(jnp.asarray(dx), jnp.asarray(h), jnp.asarray(dz),
                            TEXEL)
    got = fs.fields_stencil(*map(torch.from_numpy, (dx, h, dz)), TEXEL)
    assert got[0].shape == shape + (3,)
    # each side against the same stencil in float64 first (both within
    # ~2e-7 of it), so that a mismatch below names the side that moved
    ref = fs.fields_stencil_plain(
        *(torch.from_numpy(a).double() for a in (dx, h, dz)), TEXEL)
    for side, normal in (("port", got[0].numpy()),
                         ("jax v2", np.asarray(want[0]))):
        np.testing.assert_allclose(normal, ref[0].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"{side} normal vs float64")
    _check([t.numpy() for t in got], want, 1e-5, 1e-5, 1e-4)


@pytest.mark.parametrize("shape", [(64, 64), (32, 64)])
def test_fields_stencil_matches_shader_twins(shape):
    """Normals 2e-4: the difference form reassociates the four cross
    products, which the renormalization amplifies where |n| is small
    (tests/test_packing.py's band)."""
    dx, h, dz = _inputs(shape, seed=1)
    jn = jfields.normals_stencil(jnp.asarray(dx), jnp.asarray(h),
                                 jnp.asarray(dz), TEXEL)
    jf, jj = jfields.whitecap_gpu(jnp.asarray(dx), jnp.asarray(dz), jn)
    t = list(map(torch.from_numpy, (dx, h, dz)))
    tn = tfields.normals_stencil(*t, TEXEL)
    tf, tj = tfields.whitecap_gpu(t[0], t[2], tn)
    # the port's twins are the JAX twins
    _check([tn.numpy(), tf.numpy(), tj.numpy()], [jn, jf, jj], 1e-5, 1e-5, 1e-4)
    # and the kernel's plain version agrees with both
    got = fs.fields_stencil(*t, TEXEL)
    _check([g.numpy() for g in got], [jn, jf, jj], 2e-4, 1e-5, 1e-4)


def test_normals_are_unit_and_foam_in_range():
    dx, h, dz = _inputs((32, 64), seed=2)
    normal, foam, _ = fs.fields_stencil(*map(torch.from_numpy, (dx, h, dz)),
                                        TEXEL)
    np.testing.assert_allclose(torch.linalg.norm(normal, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert float(foam.min()) >= 0.0 and float(foam.max()) <= 1.0


def test_cpu_calls_do_not_count_launches():
    before = fs.fields_stencil.launches
    fs.fields_stencil(*map(torch.from_numpy, _inputs((8, 16))), 1.0)
    assert fs.fields_stencil.launches == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "shape", "contiguous",
                                 "empty"])
def test_fields_stencil_rejects_bad_input(bad):
    planes = [torch.zeros((16, 32)) for _ in range(3)]
    if bad == "dtype":
        planes[1] = planes[1].double()
    elif bad == "ndim":
        planes = [p[None] for p in planes]
    elif bad == "shape":
        planes[2] = torch.zeros((16, 16))
    elif bad == "contiguous":
        planes[0] = torch.zeros((32, 16)).t()
    elif bad == "empty":
        planes = [torch.zeros((0, 32)) for _ in range(3)]
    with pytest.raises((TypeError, ValueError)):
        fs.fields_stencil(*planes, 1.0)


# ---- v1: the halo form with four edge cross products (FIELDS_KERNEL_V2 off)

@pytest.mark.parametrize("shape", [(64, 64), (32, 64)])
def test_fields_stencil_v1_matches_jax_v1(shape, monkeypatch):
    """The port's v1 plain version against the JAX v1 kernel in interpret
    mode, reached through _fields_pallas_impl with the JAX switch off. Both
    sum the same four cross products in the same order: normal and foam
    within 1e-6, J within 1e-6 (measured ≤ 1.8e-7 at these shapes)."""
    monkeypatch.setattr(fields_pallas, "FIELDS_KERNEL_V2", False)
    dx, h, dz = _inputs(shape, seed=3)
    want = fields_pallas._fields_pallas_impl(
        jnp.asarray(dx), jnp.asarray(h), jnp.asarray(dz), TEXEL)
    got = fs.fields_stencil_v1(*map(torch.from_numpy, (dx, h, dz)), TEXEL)
    assert got[0].shape == shape + (3,)
    _check([t.numpy() for t in got], want, 1e-6, 1e-6, 1e-6)


@pytest.mark.parametrize("shape", [(64, 64), (7, 100), (1, 16), (16, 1)])
def test_fields_stencil_v1_plain_matches_v2_plain(shape):
    """v1 and v2 compute the same fields up to f32 reassociation (the
    normal 2e-4 where the renormalization amplifies it, as above); shapes
    with one row or one column wrap onto themselves."""
    dx, h, dz = map(torch.from_numpy, _inputs(shape, seed=4))
    got = fs.fields_stencil_v1_plain(dx, h, dz, TEXEL)
    want = fs.fields_stencil_plain(dx, h, dz, TEXEL)
    _check([g.numpy() for g in got], [w.numpy() for w in want], 2e-4, 1e-5, 1e-4)


def test_switch_routes_fields_stencil_to_v1(monkeypatch):
    dx, h, dz = map(torch.from_numpy, _inputs((32, 64), seed=5))
    v1 = fs.fields_stencil_v1_plain(dx, h, dz, TEXEL)
    v2 = fs.fields_stencil_plain(dx, h, dz, TEXEL)
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", False)
    got = fs.fields_stencil(dx, h, dz, TEXEL)
    assert all(torch.equal(g, w) for g, w in zip(got, v1))
    assert not torch.equal(got[0], v2[0])     # v1 reassociates the normal
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", True)
    assert all(torch.equal(g, w)
               for g, w in zip(fs.fields_stencil(dx, h, dz, TEXEL), v2))


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_solver_with_v1_matches_jax_solver_with_v1(backend, monkeypatch):
    """OCEAN_DEMO at N = 64 with both packages' switch off: the port's CPU
    solver against the JAX solver (v1 Pallas kernel in interpret mode),
    10 steps from one injected h0, tests/test_packing.py's bands."""
    from tests.test_torch_solver import _ten_steps_against_jax
    monkeypatch.setattr(fields_pallas, "FIELDS_KERNEL_V2", False)
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", False)
    _, jf, _, tf = _ten_steps_against_jax(64, backend=backend)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_v1_cpu_calls_do_not_count_launches():
    before = (fs.fields_stencil.launches, fs.fields_stencil_v1.launches)
    fs.fields_stencil_v1(*map(torch.from_numpy, _inputs((8, 16))), 1.0)
    assert (fs.fields_stencil.launches, fs.fields_stencil_v1.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_fields_stencil_v1_rejects_bad_input(bad):
    planes = [torch.zeros((16, 32)) for _ in range(3)]
    if bad == "dtype":
        planes[1] = planes[1].double()
    elif bad == "shape":
        planes[2] = torch.zeros((16, 16))
    elif bad == "contiguous":
        planes[0] = torch.zeros((32, 16)).t()
    with pytest.raises((TypeError, ValueError)):
        fs.fields_stencil_v1(*planes, 1.0)
