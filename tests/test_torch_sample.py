"""tpu_ocean_torch.sample against tpu_ocean/sample.py on the same fields:
each function within 1e-6 (of the field's largest value) of the JAX one,
at both layouts' origin and period, at scalar and array queries,
negative coordinates and coordinates beyond one period (the wrap is a
floor-mod, as jnp.mod); the gradient with respect to x and z through
torch's autograd against jax.grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, sample as jsample
from tpu_ocean_torch import FFT_MESH_DEMO, OCEAN_DEMO, OceanConfig, sample
from tpu_ocean_torch.solver import OceanFields

CONFIGS = {
    "fft": OCEAN_DEMO.replace(resolution=32, length=40.0),
    # N = 1024: fx reaches 2.5 N, where one ulp of the quotient moves a
    # sample by ~1e-4 (CUDA's reciprocal for a host-scalar divisor did)
    "ocean_demo": OCEAN_DEMO,
    "centered": OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                            amplitude=0.1),
    "incommensurate": FFT_MESH_DEMO,
}


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    planes = {name: rng.standard_normal((n, n)).astype(np.float32)
              for name in OceanFields._fields if name != "normal"}
    planes["normal"] = rng.standard_normal((n, n, 3)).astype(np.float32)
    return (OceanFields(**{k: torch.from_numpy(v) for k, v in planes.items()}),
            jsample_fields(planes))


def jsample_fields(planes):
    from tpu_ocean.solver import OceanFields as JaxFields
    return JaxFields(**{k: jnp.asarray(v) for k, v in planes.items()})


def _queries(cfg, seed):
    """Points across [-2.5, 2.5] periods around the origin, with the grid
    points themselves and their neighbours at ±1 ulp-ish offsets."""
    rng = np.random.default_rng(seed)
    period, o = sample.grid_period(cfg), sample.grid_origin(cfg)
    x = o + period * rng.uniform(-2.5, 2.5, 64)
    z = o + period * rng.uniform(-2.5, 2.5, 64)
    grid = o + np.arange(cfg.resolution) * period / cfg.resolution
    x = np.concatenate([x, grid, grid - period, -grid - 1e-3])
    z = np.concatenate([z, grid[::-1], grid + 3 * period, grid + 1e-3])
    return x.astype(np.float32), z.astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_origin_and_period_equal_jax(name):
    cfg = CONFIGS[name]
    jc = jcfg.OceanConfig(**dataclasses.asdict(cfg))
    assert sample.grid_origin(cfg) == jsample.grid_origin(jc)
    assert sample.grid_period(cfg) == jsample.grid_period(jc)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sample_bilinear_arrays_match_jax(name):
    cfg = CONFIGS[name]
    tf, jf = _fields(cfg.resolution, 1)
    x, z = _queries(cfg, 2)
    period, o = sample.grid_period(cfg), sample.grid_origin(cfg)
    scale = float(tf.height.abs().max())
    got = sample.sample_bilinear(tf.height, x, z, period, o)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, jsample.sample_bilinear(jf.height, x, z, period, o), scale)
    # 2-D query arrays keep their shape; tensors are taken as they are
    x2, z2 = x[:64].reshape(8, 8), z[:64].reshape(8, 8)
    got2 = sample.sample_bilinear(tf.height, torch.from_numpy(x2), z2,
                                  period, o)
    assert got2.shape == (8, 8)
    _close(got2, jsample.sample_bilinear(jf.height, x2, z2, period, o), scale)


@pytest.mark.parametrize("x,z", [(-0.3, 5.7), (-41.0, -80.25), (123.4, -0.0),
                                 (0.0, 0.0), (39.999, 40.0)])
def test_sample_scalar_queries_and_wrap(x, z):
    cfg = CONFIGS["fft"]
    tf, jf = _fields(cfg.resolution, 3)
    got = sample.sample_bilinear(tf.height, x, z, cfg.length)
    assert got.shape == ()
    _close(got, jsample.sample_bilinear(jf.height, x, z, cfg.length),
           float(tf.height.abs().max()))
    # one period away samples the same value (floor-mod wrap)
    shifted = sample.sample_bilinear(tf.height, x - cfg.length,
                                     z + 2 * cfg.length, cfg.length)
    np.testing.assert_allclose(shifted.numpy(), got.numpy(), atol=1e-5)


def test_negative_coordinates_wrap_with_floor_not_truncation():
    """f = i along x: halfway between the last row and row 0 is reached at
    x = -0.5 (one period below 7.5), which truncation toward zero would
    place between rows 0 and 1."""
    n = 8
    f = torch.arange(n, dtype=torch.float32)[:, None] * torch.ones(1, n)
    np.testing.assert_allclose(float(sample.sample_bilinear(f, -0.5, 1.0, 8.0)),
                               3.5, atol=1e-6)
    np.testing.assert_allclose(float(sample.sample_bilinear(f, -5.5, 1.0, 8.0)),
                               2.5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_surface_at_and_buoys_match_jax(name):
    cfg = CONFIGS[name]
    tf, jf = _fields(cfg.resolution, 4)
    x, z = _queries(cfg, 5)
    period, o = sample.grid_period(cfg), sample.grid_origin(cfg)
    scale = max(float(getattr(tf, k).abs().max())
                for k in ("height", "disp_x", "disp_z"))
    got = sample.surface_at(tf, x, z, period, cfg.choppiness, o)
    want = jsample.surface_at(jf, x, z, period, cfg.choppiness, o)
    for g, w in zip(got, want):
        _close(g, w, scale + float(np.abs(x).max() + np.abs(z).max()))
    scalar = sample.surface_at(tf, 1.25, -3.5, period, cfg.choppiness, o)
    for g, w in zip(scalar, jsample.surface_at(jf, 1.25, -3.5, period,
                                               cfg.choppiness, o)):
        assert g.shape == ()
        _close(g, w, scale + 3.5)
    pos = np.stack([x, z], axis=1)
    _close(sample.buoy_heights(tf, pos, period, o),
           jsample.buoy_heights(jf, pos, period, o), scale)


@pytest.mark.parametrize("x0,z0", [(5.25, 3.0), (-7.6, 44.1), (0.0, -0.01)])
def test_gradient_matches_jax_grad(x0, z0):
    cfg = CONFIGS["fft"]
    tf, jf = _fields(cfg.resolution, 6)
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    z = torch.tensor(z0, dtype=torch.float32, requires_grad=True)
    sample.sample_bilinear(tf.height, x, z, cfg.length).sum().backward()
    gx, gz = jax.grad(lambda a, b: jnp.sum(jsample.sample_bilinear(
        jf.height, a, b, cfg.length)), argnums=(0, 1))(x0, z0)
    scale = float(tf.height.abs().max()) * cfg.resolution / cfg.length
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=1e-6 * scale)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(gz), atol=1e-6 * scale)
    assert np.isfinite(x.grad.numpy())
