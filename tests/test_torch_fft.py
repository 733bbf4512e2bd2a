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
    precision = "float32"
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
        # odd: no kernel at any tier (48, once refused at bf16, runs the
        # matrix engine behind the mixed-radix kernel's loads and stores)
        re, im = torch.zeros((1, 8, 47)), torch.zeros((1, 8, 47))
        precision = "bfloat16"
    elif bad == "empty":
        re, im = torch.zeros((1, 0, 64)), torch.zeros((1, 0, 64))
    if bad in ("length", "power_of_two"):
        # a length the card has no kernel for is refused by the size rule
        # a CUDA tensor meets; a CPU tensor runs the plain version at any
        # length, as the JAX package's kernels take any length
        n = re.shape[-1]
        with pytest.raises(ValueError, match="even lengths"):
            planes.require_card_kernel(n, *planes.engine(n, precision, True))
        out = planes.fft1d_transposed(re, im, True, precision)
        assert out[0].shape == (1, n, 8)
        return
    with pytest.raises((TypeError, ValueError)):
        planes.fft1d_transposed(re, im)


def test_half_transform_validates_input():
    x = torch.zeros((1, 30, 64))
    with pytest.raises(ValueError, match="N/2"):
        planes.ifft2_planes_half(x, x)
    y = torch.zeros((1, 33, 64))
    with pytest.raises(NotImplementedError):
        planes.ifft2_planes_half(y, y, inverse=False)


# ---- the natural regime (N > MAX_TRANSPOSED_N; forced at small N)

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 8, 128)])
def test_fft1d_natural_large_matches_jax(shape, inverse):
    re, im = _planes(shape, 5)
    wr, wi = pallas_fft.fft1d_natural_large(jnp.asarray(re), jnp.asarray(im),
                                            inverse)
    gr, gi = planes.fft1d_natural_large(torch.from_numpy(re),
                                        torch.from_numpy(im), inverse)
    assert gr.shape == shape
    _close(gr, wr)
    _close(gi, wi)


def test_ifft1d_planes_axis2_matches_jax():
    """The JAX column pass is an einsum at Precision.HIGH (bf16×3, about
    f32 accuracy on the TPU; full f32 on the CPU), so 1e-5·max holds."""
    from tpu_ocean.fft import matmul
    re, im = _planes((1, 64, 32), 6)
    wr, wi = matmul.ifft1d_planes_axis2(jnp.asarray(re), jnp.asarray(im), True)
    gr, gi = planes.ifft1d_planes_axis2(torch.from_numpy(re),
                                        torch.from_numpy(im), True)
    assert gr.shape == (1, 64, 32)
    _close(gr, wr)
    _close(gi, wi)


@pytest.mark.parametrize("route", ["half", "auto"])
def test_natural_regime_matches_jax(route, monkeypatch):
    """N = 128 with both packages' transposed-store cap at 32: the natural-
    store row pass, the axis −2 column pass and (half) the fold on axis −2."""
    n = 128
    monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    rows = n // 2 + 1 if route == "half" else n
    re, im = _planes((1, rows, n), 7)
    jfn = getattr(pallas_fft, f"ifft2_planes_{route}")
    tfn = getattr(planes, f"ifft2_planes_{route}")
    with pallas_fft.transposed_store_cap(32):
        want = jfn(jnp.asarray(re), jnp.asarray(im))
    got = tfn(torch.from_numpy(re), torch.from_numpy(im))
    if route == "half":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert g.shape == (1, n, n)
        _close(g, w)


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("c", [3, 5])
def test_ifft2_planes_auto_takes_every_channel_count(c, natural,
                                                     monkeypatch):
    """C = 3 (per-channel, stencil normals) and C = 5 (spectral) channels in
    one call, both regimes (the natural one's transposing copies take all
    C planes), each channel held on its own scale (channel k's real part
    scaled by (k + 1)²)."""
    n = 64
    cap = 32 if natural else pallas_fft.MAX_PALLAS_N
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", cap)
    re, im = _planes((c, n, n), 8)
    re *= np.arange(1, c + 1, dtype=np.float32)[:, None, None] ** 2
    with pallas_fft.transposed_store_cap(cap):
        wr, wi = pallas_fft.ifft2_planes_auto(jnp.asarray(re), jnp.asarray(im))
    gr, gi = planes.ifft2_planes_auto(torch.from_numpy(re),
                                      torch.from_numpy(im))
    assert gr.shape == (c, n, n)
    for k in range(c):
        _close(gr[k], wr[k])
        _close(gi[k], wi[k])


@pytest.mark.parametrize("axis", [-1, -2])
def test_c2r_combine_matches_jax_on_either_axis(axis):
    y = _planes((2, 16, 24) if axis == -2 else (2, 24, 16), 8)
    shape = (2, 1, 24) if axis == -2 else (2, 24, 1)
    nyq = _planes(shape, 9)
    want = pallas_fft._c2r_combine(*map(jnp.asarray, y + nyq), True, axis=axis)
    got = planes._c2r_combine(*map(torch.from_numpy, y + nyq), True, axis=axis)
    for g, w in zip(got, want):
        _close(g, w)


def test_half_column_pass_checks_its_length():
    v = torch.zeros((1, 32, 64))
    with pytest.raises(ValueError, match="m=16"):
        planes.half_column_pass(v, v, 16)


@pytest.mark.parametrize("n,fits", [(1024, True), (4096, True),
                                    (8192, True), (16384, False)])
def test_one_row_block_fits_shared_memory(n, fits):
    """One row at N = 8192 (the largest the kernels take) needs 192 KB of
    the card's 227 KB, the row kernels and the fused kernels alike."""
    assert (planes.shared_bytes(1, n) <= planes.SMEM_LIMIT) == fits


@pytest.mark.parametrize("shape,rows", [
    ((1, 1024, 1024), 4), ((1, 4096, 4096), 1), ((1, 2048, 4096), 1),
    ((1, 4096, 2048), 2), ((1, 1, 4096), 1), ((1, 512, 1024), 4)])
def test_natural_rows_per_block_keeps_about_4096_points(shape, rows):
    """The natural store's blocks hold at most NATURAL_BLOCK_POINTS points
    (the fastest in the H100 sweep of chip_smoke.py --sweep-rows)."""
    c, m, n = shape
    cap = planes.max_rows(n, natural=True)
    assert planes.rows_per_block(c, m, n, sms=132, cap=cap) == rows
