"""tpu_ocean_torch.ops.fused_spectrum against tpu_ocean.ops.fused_spectrum_fft
(the Pallas kernels in interpret mode): the fused assembly + row DFT with
its transposed and its natural store, in the three channel sets (packed
with 3 or 5 live fields, per-channel), the fused full 2-D route and the
fused half-spectrum 2-D route, in both regimes. Inputs are made once with
numpy and handed to both.

Tolerances: the row passes 1e-5·max|jax| of each channel (f32 sin/cos and
rsqrt of two libraries, then f32 transforms of O(N) terms); the 2-D routes
2e-5·max, the band of tests/test_half_spectrum.py:46."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean.evolve import packed_coefficients as jax_packed_coefficients
from tpu_ocean.fft import pallas_fft
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean_torch import OCEAN_DEMO
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused

EPS = 1e-4


def _inputs(m, n, seed):
    """h0 pair planes and a phase in [0, 2π), [M, N] f32 each."""
    rng = np.random.default_rng(seed)
    h0 = [rng.normal(size=(m, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0.0, 2 * np.pi, size=(m, n)).astype(np.float32)
    return h0, phase


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("length", [434.48, "n"])
@pytest.mark.parametrize("rows", ["n", "n/2"])
@pytest.mark.parametrize("ch_start", [0, 1])
@pytest.mark.parametrize("n", [64, 128])
def test_assemble_rowfft_matches_jax(n, ch_start, rows, length, natural):
    m = n if rows == "n" else n // 2
    length = float(n) if length == "n" else length
    h0, phase = _inputs(m, n, seed=n + ch_start)
    jfn = jfused.assemble_rowfft_natural if natural else jfused.assemble_rowfft
    tfn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    wr, wi = jfn(tuple(map(jnp.asarray, h0)), jnp.asarray(phase), length,
                 -1.0, epsilon=EPS, ch_start=ch_start, ch_count=1,
                 packed=True, nch_live=3)
    gr, gi = tfn(tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
                 length, -1.0, epsilon=EPS, ch_start=ch_start, ch_count=1)
    assert gr.shape == ((1, m, n) if natural else (1, n, m))
    _close(gr, wr, 1e-5)
    _close(gi, wi, 1e-5)


#: (packed, nch_live) of the two channel sets besides packed with 3 fields
NEW_SETS = {"per_channel": (False, 3), "packed5": (True, 5)}


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("channel_set", list(NEW_SETS))
@pytest.mark.parametrize("n", [64, 128])
def test_assemble_rowfft_channel_sets_match_jax(n, channel_set, natural):
    """Every channel of the per-channel set (0..4) and of the packed set
    with 5 live fields (0..2) in one call, over rows n/4 .. 3n/4 − 1 (a row
    offset), each channel within 1e-5 of its own max."""
    packed, nch_live = NEW_SETS[channel_set]
    m, count = n // 2, 5 if channel_set == "per_channel" else 3
    h0, phase = _inputs(m, n, seed=n + count)
    kw = dict(epsilon=EPS, ch_start=0, ch_count=count, row_offset=n // 4,
              packed=packed, nch_live=nch_live)
    jfn = jfused.assemble_rowfft_natural if natural else jfused.assemble_rowfft
    tfn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    wr, wi = jfn(tuple(map(jnp.asarray, h0)), jnp.asarray(phase), 434.48,
                 -1.0, **kw)
    gr, gi = tfn(tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
                 434.48, -1.0, **kw)
    assert gr.shape == ((count, m, n) if natural else (count, n, m))
    for c in range(count):
        _close(gr[c], wr[c], 1e-5)
        _close(gi[c], wi[c], 1e-5)


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("channel_set,ch_count", [("per_channel", 3),
                                                  ("per_channel", 5),
                                                  ("packed5", 3)])
def test_ifft2_fused_planes_matches_jax(channel_set, ch_count, natural,
                                        monkeypatch):
    """The full fused 2-D route: the per-channel set with 3 channels
    (stencil normals) and 5 (spectral), the packed set with 5 live fields,
    both regimes."""
    n = 64
    packed, nch_live = NEW_SETS[channel_set]
    h0, phase = _inputs(n, n, seed=11)
    cap = 32 if natural else pallas_fft.MAX_PALLAS_N
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", cap)
    kw = dict(epsilon=EPS, ch_count=ch_count, packed=packed,
              nch_live=nch_live)
    with pallas_fft.transposed_store_cap(cap):
        wr, wi = jfused.ifft2_fused_planes(tuple(map(jnp.asarray, h0)),
                                           jnp.asarray(phase), 434.48, 1.0,
                                           **kw)
    gr, gi = fused.ifft2_fused_planes(tuple(map(torch.from_numpy, h0)),
                                      torch.from_numpy(phase), 434.48, 1.0,
                                      **kw)
    assert gr.shape == (ch_count, n, n)
    for c in range(ch_count):
        _close(gr[c], wr[c], 2e-5)
        _close(gi[c], wi[c], 2e-5)


@pytest.mark.parametrize("natural", [False, True])
def test_ifft2_fused_planes_half_spectral_matches_jax(natural, monkeypatch):
    """The fused half route with 5 live fields (spectral normals): 2 full
    packed channels and the half channel, the Nyquist row from the 5-field
    pack_nyq."""
    n = 64
    cfg = OCEAN_DEMO.replace(resolution=n, normals_mode="spectral")
    h0, phase = _inputs(n, n, seed=12)
    pack_nyq = np.asarray(jax_packed_coefficients(cfg, 5),
                          np.float32)[:, n // 2:n // 2 + 1, :]
    cap = 32 if natural else pallas_fft.MAX_PALLAS_N
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", cap)
    with pallas_fft.transposed_store_cap(cap):
        wr, wi, wl = jfused.ifft2_fused_planes_half(
            tuple(map(jnp.asarray, h0)), jnp.asarray(phase), cfg.length,
            -1.0, pack_nyq, epsilon=EPS, ch_count=3, nch_live=5)
    gr, gi, gl = fused.ifft2_fused_planes_half(
        tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
        cfg.length, -1.0, torch.from_numpy(pack_nyq), epsilon=EPS,
        nch_live=5)
    assert gr.shape == (2, n, n) and gl.shape == (n, n)
    for g, w in ((gr[0], wr[0]), (gr[1], wr[1]), (gi[0], wi[0]),
                 (gi[1], wi[1]), (gl, wl)):
        _close(g, w, 2e-5)


def test_plain_versions_are_what_cpu_calls_run():
    h0, phase = _inputs(32, 64, seed=2)
    args = (tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
            434.48, -1.0)
    kw = dict(epsilon=EPS, ch_count=2, row_offset=16)
    before = (fused.assemble_rowfft.launches,
              fused.assemble_rowfft_natural.launches,
              dict(planes.named_launches))
    for fn, plain in ((fused.assemble_rowfft, fused.assemble_rowfft_plain),
                      (fused.assemble_rowfft_natural,
                       fused.assemble_rowfft_natural_plain)):
        for g, w in zip(fn(*args, **kw), plain(*args, **kw)):
            assert torch.equal(g, w)
    assert before == (fused.assemble_rowfft.launches,
                      fused.assemble_rowfft_natural.launches,
                      dict(planes.named_launches))


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("n", [64, 128])
def test_ifft2_fused_planes_half_matches_jax(n, natural, monkeypatch):
    """Both regimes: the natural one forced at small N with the JAX cap
    override and the port's MAX_TRANSPOSED_N set to the same cap."""
    cfg = OCEAN_DEMO.replace(resolution=n)
    h0, phase = _inputs(n, n, seed=7)
    pack_nyq = np.asarray(jax_packed_coefficients(cfg, 3),
                          np.float32)[:, n // 2:n // 2 + 1, :]
    args = (cfg.length, -1.0)
    cap = 32 if natural else pallas_fft.MAX_PALLAS_N
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", cap)
    with pallas_fft.transposed_store_cap(cap):
        wr, wi, wl = jfused.ifft2_fused_planes_half(
            tuple(map(jnp.asarray, h0)), jnp.asarray(phase), *args,
            pack_nyq, epsilon=EPS)
    gr, gi, gl = fused.ifft2_fused_planes_half(
        tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase), *args,
        torch.from_numpy(pack_nyq), epsilon=EPS)
    assert gr.shape == (1, n, n) and gl.shape == (n, n)
    for g, w in ((gr, wr), (gi, wi), (gl, wl)):
        _close(g, w, 2e-5)


@pytest.mark.parametrize("bad", ["nch_live", "unpacked", "channels",
                                 "shape", "dtype", "odd_n"])
def test_fused_wrappers_reject_what_they_do_not_take(bad):
    h0, phase = _inputs(8, 16, seed=3)
    h0 = tuple(map(torch.from_numpy, h0))
    phase = torch.from_numpy(phase)
    kw = dict(epsilon=EPS, ch_count=1)
    want = ValueError
    if bad == "nch_live":
        kw["nch_live"] = 4
    elif bad == "unpacked":       # the per-channel set has channels 0..4
        kw.update(packed=False, ch_start=4, ch_count=2)
    elif bad == "channels":       # packed with 3 live fields: 0..1
        kw.update(ch_start=1, ch_count=2)
    elif bad == "shape":
        phase = phase[:4].contiguous()
    elif bad == "dtype":
        phase, want = phase.double(), TypeError
    elif bad == "odd_n":
        h0 = tuple(p[:, :15].contiguous() for p in h0)
        phase = phase[:, :15].contiguous()
    for fn in (fused.assemble_rowfft, fused.assemble_rowfft_natural,
               fused.assemble_rowfft_plain):
        with pytest.raises(want):
            fn(h0, phase, 16.0, 1.0, **kw)
