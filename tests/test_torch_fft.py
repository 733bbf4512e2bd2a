"""tpu_ocean_torch.fft.planes against tpu_ocean.fft.pallas_fft (the Pallas
kernels in interpret mode): the transposed row DFT, the full 2-D inverse
and the half-spectrum (C2R) route, on random non-Hermitian data and M ≠ N
batches so that a transposed-axis bug cannot hide. Tolerance 1e-5·max|ref|
(f32 transforms of O(N) accumulated terms)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean.fft import pallas_fft
from tpu_ocean_torch.fft import planes


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _hermitian(n, c, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(c, n, n)) + 1j * rng.normal(size=(c, n, n))
    neg = (-np.arange(n)) % n
    s = 0.5 * (s + np.conj(s[:, neg][:, :, neg]))
    return s.real.astype(np.float32), s.imag.astype(np.float32)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 32, 64), (1, 64, 32),
                                   (1, 1, 64), (1, 128, 128)])
def test_fft1d_transposed_matches_jax(shape, inverse):
    re, im = _planes(shape, 0)
    wr, wi = pallas_fft._fft1d_transposed(jnp.asarray(re), jnp.asarray(im),
                                          inverse)
    gr, gi = planes.fft1d_transposed(torch.from_numpy(re),
                                     torch.from_numpy(im), inverse)
    assert gr.shape == (shape[0], shape[2], shape[1])
    _close(gr, wr)
    _close(gi, wi)


@pytest.mark.parametrize("n", [64, 128, 256])
def test_ifft2_planes_auto_matches_jax(n):
    re, im = _planes((1, n, n), 1)
    wr, wi = pallas_fft.ifft2_planes_auto(jnp.asarray(re), jnp.asarray(im))
    gr, gi = planes.ifft2_planes_auto(torch.from_numpy(re), torch.from_numpy(im))
    _close(gr, wr)
    _close(gi, wi)


@pytest.mark.parametrize("n", [64, 128, 256])
def test_ifft2_planes_half_matches_jax(n):
    """Random, NOT Hermitian input: both implementations must make the
    same (meaningless but deterministic) use of every input element."""
    m = n // 2
    re, im = _planes((1, m + 1, n), 2)
    want = pallas_fft.ifft2_planes_half(jnp.asarray(re), jnp.asarray(im))
    got = planes.ifft2_planes_half(torch.from_numpy(re), torch.from_numpy(im))
    assert got.shape == (1, n, n)
    _close(got, want)


@pytest.mark.parametrize("n", [64, 256])
def test_half_transform_matches_full_re(n):
    """On a Hermitian spectrum the half route equals the Re part of the
    full transform, whose Im part vanishes (mirrors
    tests/test_half_spectrum.py::test_half_transform_matches_full_re)."""
    re, im = map(torch.from_numpy, _hermitian(n, 2, 3))
    fr, fi = planes.ifft2_planes_auto(re, im)
    m = n // 2
    half = planes.ifft2_planes_half(re[:, :m + 1].contiguous(),
                                    im[:, :m + 1].contiguous())
    scale = fr.abs().max().item()
    assert fi.abs().max().item() < 1e-4 * scale
    np.testing.assert_allclose(half.numpy(), fr.numpy(), rtol=0,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("shape,rows", [
    ((1, 1024, 1024), 8), ((1, 512, 1024), 4), ((1, 1024, 512), 8),
    ((1, 1, 1024), 1), ((2, 2048, 2048), 4), ((1, 64, 8192), 1),
    ((4, 4096, 16), 8)])
def test_rows_per_block_fills_the_card(shape, rows):
    """About one block per SM of a 132-SM card, within the 8-row and
    shared-memory caps."""
    assert planes.rows_per_block(*shape, sms=132) == rows


def test_cpu_calls_do_not_count_launches():
    before = planes.fft1d_transposed.launches
    re, im = map(torch.from_numpy, _planes((1, 8, 16), 4))
    planes.fft1d_transposed(re, im)
    assert planes.fft1d_transposed.launches == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "shape", "contiguous",
                                 "length", "power_of_two", "empty"])
def test_fft1d_transposed_rejects_bad_input(bad):
    re = torch.zeros((1, 8, 64))
    im = torch.zeros((1, 8, 64))
    if bad == "dtype":
        re = re.double()
    elif bad == "ndim":
        re, im = re[0], im[0]
    elif bad == "shape":
        im = torch.zeros((1, 8, 32))
    elif bad == "contiguous":
        re = torch.zeros((1, 64, 8)).transpose(1, 2)
    elif bad == "length":
        re, im = torch.zeros((1, 8, 8)), torch.zeros((1, 8, 8))
    elif bad == "power_of_two":
        re, im = torch.zeros((1, 8, 48)), torch.zeros((1, 8, 48))
    elif bad == "empty":
        re, im = torch.zeros((1, 0, 64)), torch.zeros((1, 0, 64))
    with pytest.raises((TypeError, ValueError)):
        planes.fft1d_transposed(re, im)


def test_half_transform_validates_input():
    x = torch.zeros((1, 30, 64))
    with pytest.raises(ValueError, match="N/2"):
        planes.ifft2_planes_half(x, x)
    y = torch.zeros((1, 33, 64))
    with pytest.raises(NotImplementedError):
        planes.ifft2_planes_half(y, y, inverse=False)
