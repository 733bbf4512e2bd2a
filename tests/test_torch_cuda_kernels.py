"""tpu_ocean_torch's CUDA kernels against their plain torch versions, on
the card. Every test here needs an NVIDIA GPU with nvcc: each decides
inside the ``cuda`` fixture whether one exists and skips with a reason
when not. This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

(``--noconftest`` because tests/conftest.py configures jax, which a
machine with a GPU need not have).

Tolerances: the row DFTs (transposed, natural and fused stores) differ from
torch.fft (cuFFT) in summation order, 1e-5·max|plain| covers f32 rounding
over log2(N) stages (the fused kernels' assembly rounds each product as
the plain version does; sin/cos differ by an ulp at most). The two f32
direct row kernels, the transposed one (the cluster store, radix-2
stages) and the natural one (radix-16 passes), round in other orders: on
the same inputs they agree within 1e-6·max (each is within ~2e-7·max of
float64), and each one's RMS error against float64 is within 1.1 × the
other's (the max error over one seed's rows is a sample: the two
kernels' max errors differ by up to 16% either way on the H100). The
fields
kernel rounds the normal's cross product as the plain version does, so
its normal agrees to 1e-5; foam 1e-4. The v1 fields kernel rounds every
operation as its plain version does: 1e-5 on all three outputs. The
wave-bank kernel rounds the phase and the sums as its plain version does;
only sincosf against torch's sin and cos (an ulp or two) differs, summed
over W waves: 1e-5·max|plain| per output. The matrix-form DFT engine
(csrc/dft_matrix.cuh) rounds the same operands to bf16 as its plain
version (fft/matrix.py) but accumulates in another order, so an
intermediate's bf16 rounding can flip by one ulp: 2e-3·max|plain| at
bf16; 1e-5 at bf16x3 and for the three-factor form at f32. The bf16 row
kernel (csrc/dft_bf16_rows.cuh, both stores) rounds the same operands and
is held to the same 2e-3; the f32 three-factor row kernel
(csrc/dft_split3_f32.cuh) rounds each twiddle as its plain version does and
accumulates in another order: 1e-5. So does the bf16x3 three-factor row
kernel (csrc/dft_split3_bf16x3.cuh), whose stage-2 operands are split as
its plain version splits them: 1e-5, the bf16x3 band. The two f32 fused
kernels (natural and transposed store) run one load, assembly and set of
radix-16 passes: on the same inputs bit-equal, one the other transposed.
The bf16 fused
natural kernel (csrc/fused_rows_natural_bf16.cuh) rounds its f32 assembly
to bf16 where the plain version does and then runs the bf16 row kernel's
stages: 2e-3, the bf16 band."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ocean_torch import (OCEAN_DEMO, POND_DEMO, OceanSolver, PondSimulation,
                             WaveBank, fields_to_numpy, pond_fields_to_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs
from tpu_ocean_torch.ops import fused_spectrum as fused
from tpu_ocean_torch.ops import gerstner_bank as gb

#: the real-state switches of the OCEAN_DEMO slice (packed + half with the
#: fields kernel); the solver's defaults are the JAX package's complex state
SLICE = dict(real_state=True, pack_channels=True, half_spectrum=True,
             pallas_fields=True)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _planes(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
                 for _ in range(2))


def _assert_close(got, want):
    """Each of the (re, im) pairs within 1e-5·max|plain| of the other."""
    torch.cuda.synchronize()
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * scale


def _fused_inputs(m, n, device, seed=0):
    rng = np.random.default_rng(seed)
    h0 = tuple(torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(device)
               for _ in range(4))
    phase = rng.uniform(0, 2 * np.pi, size=(m, n)).astype(np.float32)
    return h0, torch.from_numpy(phase).to(device)


# the f32 transposed pass at the paths' shapes (C = 1, 2, 3, 5) and at
# ragged M
TRANSPOSED_SHAPES = [(1, 1024, 1024), (1, 512, 1024), (1, 1024, 512),
                     (1, 1, 1024), (2, 1024, 1024), (3, 1024, 1024),
                     (1, 4096, 4096), (1, 4096, 2048), (3, 4096, 4096),
                     (5, 4096, 4096), (3, 5, 16), (2, 13, 64), (1, 9, 2048),
                     (1, 3, 8192)]


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", TRANSPOSED_SHAPES)
def test_fft_rows_kernel_matches_plain(cuda, monkeypatch, shape, inverse,
                                       cluster):
    """The cluster-store kernel at the wrapper's cluster size (None) and
    at every size it takes."""
    if cluster is not None:
        monkeypatch.setattr(planes, "transposed_cluster",
                            lambda *_: cluster)
    re, im = _planes(shape, cuda)
    kr, ki = planes.fft1d_transposed(re, im, inverse)
    pr, pi = planes.fft1d_transposed_plain(re, im, inverse)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert kr.shape == (shape[0], shape[2], shape[1])
    assert (kr - pr).abs().max().item() <= 1e-5 * scale
    assert (ki - pi).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("shape", TRANSPOSED_SHAPES)
def test_fft_rows_transposed_is_the_natural_store_transposed(cuda, shape):
    """The cluster-store kernel (radix-2 stages) and the natural store
    (radix-16 passes) on the same inputs: within 1e-6·max of each other,
    and each one's RMS error against float64 within 1.1 × the other's."""
    re, im = _planes(shape, cuda)
    got = tuple(g.transpose(-1, -2) for g in planes.fft1d_transposed(re, im))
    nat = planes.fft1d_natural_large(re, im)
    z = torch.fft.ifft(torch.complex(re.double(), im.double()), dim=-1,
                       norm="forward")
    torch.cuda.synchronize()
    scale = max(z.real.abs().max().item(), z.imag.abs().max().item())
    for g, w in zip(got, nat):
        assert (g - w).abs().max().item() <= 1e-6 * scale
    rms = z.abs().pow(2).mean().sqrt().item()
    e_tr, e_nat = (((o[0].double() - z.real) ** 2 + (o[1].double() - z.imag)
                    ** 2).mean().sqrt().item() / rms for o in (got, nat))
    assert e_nat <= 1.1 * e_tr and e_tr <= 1.1 * e_nat, (e_tr, e_nat)


@pytest.mark.parametrize("cluster", [3, 16])
def test_cluster_size_the_kernel_does_not_take_raises(cuda, monkeypatch,
                                                      cluster):
    """No fallback: a cluster size outside 1, 2, 4, 8 is refused and the
    wrapper raises."""
    monkeypatch.setattr(planes, "transposed_cluster", lambda *_: cluster)
    re, im = _planes((1, 64, 1024), cuda)
    before = planes.fft1d_transposed.launches
    with pytest.raises(RuntimeError, match="tpu_fft_rows_transposed"):
        planes.fft1d_transposed(re, im)
    assert planes.fft1d_transposed.launches == before


@pytest.mark.parametrize("shape", [(1024, 1024), (33, 64), (7, 100)])
def test_fields_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(1)
    dx, h, dz = (torch.from_numpy((2 * rng.normal(size=shape)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    got = fs.fields_stencil(dx, h, dz, 0.4243)
    want = fs.fields_stencil_plain(dx, h, dz, 0.4243)
    torch.cuda.synchronize()
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-5)):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= tol


# every power of two N in [16, 8192] at M = 1 and at a ragged M (333 rows of
# 2 channels: 8 rows a block up to N = 512, 4 at 1024, 2 at 2048, so that
# the last block holds rows past M), small batches, and the main path's
# batches
NATURAL_SHAPES = ([(1, 1, 1 << i) for i in range(4, 14)]
                  + [(2, 333, 1 << i) for i in range(4, 14)]
                  + [(3, 5, 16), (2, 13, 64), (1, 1024, 1024), (1, 37, 4096),
                     (1, 2048, 4096), (1, 4096, 4096), (1, 3, 8192)])


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", NATURAL_SHAPES)
def test_fft_rows_natural_kernel_matches_plain(cuda, shape, inverse):
    re, im = _planes(shape, cuda)
    before = planes.fft1d_natural_large.launches
    got = planes.fft1d_natural_large(re, im, inverse)
    assert got[0].shape == shape
    assert planes.fft1d_natural_large.launches == before + 1
    _assert_close(got, planes.fft1d_natural_large_plain(re, im, inverse))


@pytest.mark.parametrize("rows", [0, 3, 64])
def test_natural_rows_the_kernel_does_not_take_raise(cuda, monkeypatch,
                                                     rows):
    """No fallback: a block the f32 natural kernel refuses (no rows, or
    more than 512 threads: 64 rows of N = 1024) raises; rows that are not
    a power of two (3, the last block one row) still transform every
    row."""
    monkeypatch.setattr(planes, "rows_per_block", lambda *_, **__: rows)
    re, im = _planes((1, 7, 1024), cuda)
    before = planes.fft1d_natural_large.launches
    if rows == 3:
        _assert_close(planes.fft1d_natural_large(re, im),
                      planes.fft1d_natural_large_plain(re, im))
        return
    with pytest.raises(RuntimeError, match="tpu_fft_rows_natural"):
        planes.fft1d_natural_large(re, im)
    assert planes.fft1d_natural_large.launches == before


# (M, N, ch_start, ch_count, row_offset)
FUSED_CASES = [(16, 16, 0, 2, 0), (7, 16, 1, 1, 5), (1, 64, 0, 1, 32),
               (13, 64, 1, 1, 20), (1024, 1024, 0, 1, 0),
               (512, 1024, 1, 1, 0), (37, 1024, 0, 2, 500),
               (2048, 4096, 1, 1, 0), (4096, 4096, 0, 1, 0),
               (5, 4096, 1, 1, 2046), (1, 8192, 0, 1, 4096),
               (3, 8192, 1, 1, 4095)]


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_rows_kernels_match_plain(cuda, case, natural):
    m, n, ch_start, ch_count, row_offset = case
    h0, phase = _fused_inputs(m, n, cuda)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=row_offset)
    if natural:
        got = fused.assemble_rowfft_natural(h0, phase, 434.48, -1.0, **kw)
        want = fused.assemble_rowfft_natural_plain(h0, phase, 434.48, -1.0, **kw)
    else:
        got = fused.assemble_rowfft(h0, phase, 434.48, -1.0, **kw)
        want = fused.assemble_rowfft_plain(h0, phase, 434.48, -1.0, **kw)
    _assert_close(got, want)


# (M, N, packed, nch_live, ch_start, ch_count, row_offset): the per-channel
# set (channels 0..4) and the packed set with 5 live fields (0..2), at the
# paths' shapes and at ragged M
FUSED_SET_CASES = [(16, 16, False, 3, 0, 5, 0), (7, 16, True, 5, 1, 2, 5),
                   (13, 64, False, 3, 2, 3, 20), (13, 64, True, 5, 0, 3, 20),
                   (1024, 1024, False, 3, 0, 3, 0),
                   (512, 1024, True, 5, 2, 1, 0),
                   (1024, 1024, True, 5, 0, 2, 0),
                   (37, 1024, False, 3, 3, 2, 500),
                   (4096, 4096, False, 3, 0, 5, 0),
                   (2048, 4096, True, 5, 2, 1, 0),
                   (5, 4096, True, 5, 0, 3, 2046),
                   (3, 8192, False, 3, 0, 5, 4095)]


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("case", FUSED_SET_CASES)
def test_fused_channel_sets_match_plain(cuda, case, natural):
    m, n, packed, nch_live, ch_start, ch_count, row_offset = case
    h0, phase = _fused_inputs(m, n, cuda)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=row_offset, packed=packed, nch_live=nch_live)
    fn, plain, store = ((fused.assemble_rowfft_natural,
                         fused.assemble_rowfft_natural_plain, "natural")
                        if natural else
                        (fused.assemble_rowfft, fused.assemble_rowfft_plain,
                         "transposed"))
    before = fn.launches
    planes.named_launches.clear()
    got = fn(h0, phase, 434.48, -1.0, **kw)
    assert fn.launches == before          # counted once, under its set
    assert planes.named_launches == {
        f"fused_{store}[{fused.channel_set(packed, nch_live)}]": 1}
    want = plain(h0, phase, 434.48, -1.0, **kw)
    for c in range(ch_count):      # each channel on its own scale
        _assert_close((got[0][c], got[1][c]), (want[0][c], want[1][c]))


# the f32 fused natural kernel (csrc/fused_rows_natural_f32.cuh): every
# (set, ch_start, ch_count) a launch may take
FUSED_SPANS = [(packed, live, start, count)
               for packed, live in ((True, 3), (True, 5), (False, 3))
               for start in range(fused.channel_count(packed, live))
               for count in range(1, fused.channel_count(packed, live) - start
                                  + 1)]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("span", FUSED_SPANS, ids=str)
@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_fused_natural_f32_kernel_matches_plain(cuda, monkeypatch, n, span,
                                                inverse):
    """At every N, R the wrapper's cap (at most 8, forced) and a ragged M
    (a block and a half) across the Nyquist row: every channel within
    1e-5·max of its own plain channel, counted once under its set."""
    packed, nch_live, ch_start, ch_count = span
    rows = min(planes.fused_natural_max_rows(n), 8)
    m = rows + rows // 2 + 1
    monkeypatch.setattr(planes, "rows_per_block", lambda *_, **__: rows)
    h0, phase = _fused_inputs(m, n, cuda, seed=n + ch_start)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=n // 2 - m // 2, packed=packed, nch_live=nch_live,
              inverse=inverse)
    before = fused.assemble_rowfft_natural.launches
    planes.named_launches.clear()
    got = fused.assemble_rowfft_natural(h0, phase, 434.48, -1.0, **kw)
    tag = fused.channel_set(packed, nch_live)
    if tag:
        assert planes.named_launches == {f"fused_natural[{tag}]": 1}
    else:
        assert fused.assemble_rowfft_natural.launches == before + 1
    want = fused.assemble_rowfft_natural_plain(h0, phase, 434.48, -1.0, **kw)
    for c in range(ch_count):
        _assert_close((got[0][c], got[1][c]), (want[0][c], want[1][c]))


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("span", FUSED_SPANS, ids=str)
@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_fused_transposed_f32_kernel_matches_plain(cuda, monkeypatch, n,
                                                   span, inverse):
    """The f32 fused transposed kernel (csrc/fused_rows_transposed_f32.cuh)
    at every N, R the wrapper's cap (forced) and a ragged M (a block and a
    half) across the Nyquist row: every channel within 1e-5·max of its own
    plain channel, counted once under its set; and bit-equal to the f32
    fused natural kernel transposed on the same inputs, which runs the same
    load, assembly and passes (so the factoring of those into load_terms
    and channel_passes left the natural kernel's arithmetic as the
    transposed kernel's)."""
    packed, nch_live, ch_start, ch_count = span
    rows = planes.fused_transposed_max_rows(n)
    m = rows + rows // 2 + 1
    monkeypatch.setattr(planes, "rows_per_block", lambda *_, **__: rows)
    h0, phase = _fused_inputs(m, n, cuda, seed=n + ch_start)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=n // 2 - m // 2, packed=packed, nch_live=nch_live,
              inverse=inverse)
    before = fused.assemble_rowfft.launches
    planes.named_launches.clear()
    got = fused.assemble_rowfft(h0, phase, 434.48, -1.0, **kw)
    tag = fused.channel_set(packed, nch_live)
    if tag:
        assert planes.named_launches == {f"fused_transposed[{tag}]": 1}
    else:
        assert fused.assemble_rowfft.launches == before + 1
    want = fused.assemble_rowfft_plain(h0, phase, 434.48, -1.0, **kw)
    for c in range(ch_count):
        _assert_close((got[0][c], got[1][c]), (want[0][c], want[1][c]))
    nat = fused.assemble_rowfft_natural(h0, phase, 434.48, -1.0, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, nat):
        assert torch.equal(g, w.transpose(1, 2))


@pytest.mark.parametrize("n,rows", [(16384, 1), (8, 1), (96, 1), (1024, 64),
                                    (1024, 0), (1024, 3)])
def test_fused_transposed_f32_kernel_refuses_other_lengths_and_blocks(
        cuda, n, rows):
    """The C entry at tier f32, direct form, transposed store: N outside
    the powers of two in [16, 8192], no rows, rows not a power of two or
    more than 512 threads a block are refused (cudaErrorInvalidValue),
    never run on another kernel."""
    from tpu_ocean_torch import _build
    h0, phase = _fused_inputs(2, n, cuda)
    out = torch.empty((1, n, 2), device=cuda)
    kz = torch.zeros(n, device=cuda)
    tables = planes.radix16_twiddles(1024, True, cuda)
    err = _build.load().lib.tpu_fused_rows_transposed(
        *(p.data_ptr() for p in (*h0, phase, kz, out, out, tables)),
        1, 0, 2, n, rows, 0, 1, 3, planes.TIERS["f32"], 0, 0.0145, -1.0,
        1e-4, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fused_rows_transposed")


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("span", FUSED_SPANS, ids=str)
@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_fused_natural_bf16_kernel_matches_plain(cuda, monkeypatch, n, span,
                                                 inverse):
    """The bf16 fused natural kernel (csrc/fused_rows_natural_bf16.cuh) at
    every N, R the wrapper's cap (at most 8, forced) and a ragged M (a
    block and a half) across the Nyquist row: every channel within
    2e-3·max of its own plain channel at bfloat16, counted once under its
    name."""
    packed, nch_live, ch_start, ch_count = span
    rows = min(planes.max_rows(n, True, "bf16"), 8)
    m = rows + rows // 2 + 1
    monkeypatch.setattr(planes, "rows_per_block", lambda *_, **__: rows)
    h0, phase = _fused_inputs(m, n, cuda, seed=n + ch_start)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=n // 2 - m // 2, packed=packed, nch_live=nch_live,
              inverse=inverse, precision="bfloat16")
    planes.named_launches.clear()
    got = fused.assemble_rowfft_natural(h0, phase, 434.48, -1.0, **kw)
    tag = fused.channel_set(packed, nch_live)
    assert planes.named_launches == {
        planes.kernel_name("fused_natural", "bf16", False, tag): 1}
    want = fused.assemble_rowfft_natural_plain(h0, phase, 434.48, -1.0, **kw)
    for c in range(ch_count):
        _assert_band((got[0][c], got[1][c]), (want[0][c], want[1][c]),
                     BANDS["bf16"])


@pytest.mark.parametrize("n,rows,offset", [(16384, 1, 0), (8, 1, 0),
                                           (96, 1, 0), (1024, 0, 0),
                                           (1024, 64, 0), (1024, 1, 4)])
def test_fused_natural_bf16_kernel_refuses_other_lengths_and_blocks(
        cuda, n, rows, offset):
    """The C entry at tier bf16, direct form, natural store: N outside the
    powers of two in [16, 8192], no rows, a block beyond the card's shared
    memory or an input that is not 16-byte aligned (``offset`` bytes
    past the plane) is refused, never run on another kernel."""
    from tpu_ocean_torch import _build
    h0, phase = _fused_inputs(2, n + 4, cuda)
    out = torch.empty((1, 2, n), device=cuda)
    kz = torch.zeros(n, device=cuda)
    tables = planes.bf16_rows_tables(1024, True, cuda)
    err = _build.load().lib.tpu_fused_rows_natural(
        h0[0].data_ptr() + offset,
        *(p.data_ptr() for p in (*h0[1:], phase, kz, out, out, tables)),
        1, 0, 2, n, rows, 0, 1, 3, planes.TIERS["bf16"], 0, 0.0145, -1.0,
        1e-4, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fused_rows_natural")


@pytest.mark.parametrize("n,rows", [(16384, 1), (8, 1), (96, 1), (1024, 64),
                                    (1024, 0)])
def test_fused_natural_f32_kernel_refuses_other_lengths_and_blocks(cuda, n,
                                                                   rows):
    """The C entry at tier f32, direct form, natural store: N outside the
    powers of two in [16, 8192], no rows or more than 512 threads a block
    are refused (cudaErrorInvalidValue), never run on another kernel."""
    from tpu_ocean_torch import _build
    h0, phase = _fused_inputs(2, n, cuda)
    out = torch.empty((1, 2, n), device=cuda)
    kz = torch.zeros(n, device=cuda)
    tables = planes.radix16_twiddles(1024, True, cuda)
    err = _build.load().lib.tpu_fused_rows_natural(
        *(p.data_ptr() for p in (*h0, phase, kz, out, out, tables)),
        1, 0, 2, n, rows, 0, 1, 3, planes.TIERS["f32"], 0, 0.0145, -1.0,
        1e-4, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fused_rows_natural")


def test_launch_counters_count_kernel_launches(cuda):
    re, im = _planes((1, 16, 64), cuda)
    f0, s0 = planes.fft1d_transposed.launches, fs.fields_stencil.launches
    planes.ifft2_planes_auto(re, im)
    fs.fields_stencil(re[0], im[0], re[0], 1.0)
    assert planes.fft1d_transposed.launches == f0 + 2
    assert fs.fields_stencil.launches == s0 + 1


def test_solver_step_matches_cpu_and_launches_six_kernels(cuda):
    cfg = OCEAN_DEMO.replace(resolution=128)
    gpu = OceanSolver(cfg, device=cuda, fft_backend="pallas", **SLICE)
    cpu = OceanSolver(cfg, device="cpu", fft_backend="pallas", **SLICE)
    sg = gpu.init(torch.Generator().manual_seed(5))
    sc = cpu.init(torch.Generator().manual_seed(5))
    f0, s0 = planes.fft1d_transposed.launches, fs.fields_stencil.launches
    for _ in range(3):
        sg, fg = gpu.step(sg, 1 / 60)
        sc, fc = cpu.step(sc, 1 / 60)
    assert planes.fft1d_transposed.launches - f0 == 15
    assert fs.fields_stencil.launches - s0 == 3
    assert torch.equal(sg.phase.cpu(), sc.phase)
    fg, fc = fields_to_numpy(fg), fields_to_numpy(fc)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        want = getattr(fc, name)
        np.testing.assert_allclose(getattr(fg, name), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("backend,n,per_step", [
    ("pallas_fused", 128, {"fused_t": 2, "rows_t": 3, "rows_n": 0,
                           "fused_n": 0}),
    ("pallas", 4096, {"fused_t": 0, "rows_t": 2, "rows_n": 3, "fused_n": 0}),
    ("pallas_fused", 4096, {"fused_t": 0, "rows_t": 2, "rows_n": 1,
                            "fused_n": 2})])
def test_solver_paths_match_cpu_and_launch_their_kernels(cuda, backend, n,
                                                         per_step):
    cfg = OCEAN_DEMO.replace(resolution=n)
    gpu = OceanSolver(cfg, device=cuda, fft_backend=backend, **SLICE)
    cpu = OceanSolver(cfg, device="cpu", fft_backend=backend, **SLICE)
    sg = gpu.init(torch.Generator().manual_seed(5))
    sc = cpu.init(torch.Generator().manual_seed(5))
    counters = {"fused_t": fused.assemble_rowfft,
                "fused_n": fused.assemble_rowfft_natural,
                "rows_t": planes.fft1d_transposed,
                "rows_n": planes.fft1d_natural_large,
                "fields": fs.fields_stencil}
    before = {k: f.launches for k, f in counters.items()}
    for _ in range(2):
        sg, fg = gpu.step(sg, 1 / 60)
        sc, fc = cpu.step(sc, 1 / 60)
    torch.cuda.synchronize()
    for key, per in {**per_step, "fields": 1}.items():
        assert counters[key].launches - before[key] == 2 * per, key
    fg, fc = fields_to_numpy(fg), fields_to_numpy(fc)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        want = getattr(fc, name)
        np.testing.assert_allclose(getattr(fg, name), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bad", ["cpu_and_cuda", "contiguous", "length"])
def test_kernel_wrappers_reject_bad_input(cuda, bad):
    re, im = _planes((1, 8, 64), cuda)
    if bad == "cpu_and_cuda":
        im = im.cpu()
    elif bad == "contiguous":
        re = re.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "length":
        # odd: no kernel at any tier (48, once refused, now runs the
        # mixed-radix kernel)
        re, im = _planes((1, 8, 47), cuda)
    with pytest.raises(ValueError):
        planes.fft1d_transposed(re, im)
    with pytest.raises(ValueError):
        planes.fft1d_natural_large(re, im)
    with pytest.raises(ValueError):
        fused.assemble_rowfft((re[0], im[0], re[0], im[0]), im[0], 1.0, 1.0,
                              epsilon=1e-4, ch_count=1)
    if bad != "length":            # the stencils take any [M, N]
        with pytest.raises(ValueError):
            fs.fields_stencil(re[0], im[0], re[0], 1.0)
        with pytest.raises(ValueError):
            fs.fields_stencil_v1(re[0], im[0], re[0], 1.0)
        with pytest.raises(ValueError):
            gb.gerstner_bank(gb.pack_bank(WaveBank.random(0, 4), cuda),
                             re[0], im[0], 1.0)


@pytest.mark.parametrize("shape", [(1024, 1024), (33, 64), (7, 100), (1, 16),
                                   (17, 1)])
def test_fields_v1_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(2)
    dx, h, dz = (torch.from_numpy((2 * rng.normal(size=shape)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    got = fs.fields_stencil_v1(dx, h, dz, 0.4243)
    want = fs.fields_stencil_v1_plain(dx, h, dz, 0.4243)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5


def test_fields_switch_launches_v1_in_the_solver(cuda, monkeypatch):
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", False)
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=128), device=cuda,
                         fft_backend="pallas", **SLICE)
    state = solver.init(torch.Generator().manual_seed(5))
    before = (fs.fields_stencil.launches, fs.fields_stencil_v1.launches)
    for _ in range(2):
        state, _ = solver.step(state, 1 / 60)
    assert fs.fields_stencil.launches == before[0]
    assert fs.fields_stencil_v1.launches == before[1] + 2


@pytest.mark.parametrize("mode", ["analytic", "flat"])
@pytest.mark.parametrize("waves", [1, 4, 16, 300])
@pytest.mark.parametrize("shape", [(512, 512), (33, 64), (7, 100)])
def test_gerstner_bank_kernel_matches_plain(cuda, shape, waves, mode):
    """Coordinates up to ±300 (phases of several hundred radians, as at
    512²); W = 300 needs more than one pass of the block's staging loop."""
    rng = np.random.default_rng(waves)
    x, z = (torch.from_numpy(rng.uniform(-300, 300, size=shape).astype(np.float32)).to(cuda)
            for _ in range(2))
    bank = gb.pack_bank(WaveBank.random(waves, waves), cuda)
    got = gb.gerstner_bank(bank, x, z, 12.5, mode)
    want = gb.gerstner_bank_plain(bank, x, z, 12.5, mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_pond_simulation_launches_one_kernel_a_step_and_matches_cpu(cuda):
    cfg = dataclasses.replace(POND_DEMO, resolution=128)
    sim = PondSimulation(cfg, use_pallas=True, device=cuda)
    cpu = PondSimulation(cfg, use_pallas=True, device="cpu")
    before = gb.gerstner_bank.launches
    sim.run(5)
    cpu.run(5)
    assert gb.gerstner_bank.launches == before + 5
    for g, w in zip(pond_fields_to_numpy(sim.fields), pond_fields_to_numpy(cpu.fields)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-5)


# ---- the matrix-form engine: each entry × tier × form against its plain
# version. (tier, split3): the three-factor form needs n1 = 128 (N ≥ 128)
# and exists for the transposed store only.
ENGINES = [("bf16", False), ("bf16", True), ("bf16x3", False),
           ("bf16x3", True), ("f32", True)]
BANDS = {"bf16": 2e-3, "bf16x3": 1e-5, "f32": 1e-5}


@pytest.fixture
def select_engine(monkeypatch):
    """Set the module switches for (tier, split3); returns the precision
    argument that selects the tier."""
    def select(tier, split3):
        monkeypatch.setattr(planes, "KERNEL_B3_THRESHOLD",
                            0 if tier == "bf16x3" else 1 << 30)
        monkeypatch.setattr(planes, "THREE_FACTOR_THRESHOLD",
                            0 if split3 else 1 << 30)
        planes.named_launches.clear()
        return "bfloat16" if tier == "bf16" else "float32"
    return select


def _assert_band(got, want, band):
    torch.cuda.synchronize()
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w).abs().max().item()
        assert err <= band * scale, f"{err / scale:.3e} x max|plain|"


MATRIX_ROW_SHAPES = [(1, 1024, 1024), (1, 512, 1024), (1, 1024, 512),
                     (1, 1, 1024), (1, 4096, 2048), (3, 5, 16), (2, 13, 64),
                     (1, 9, 128), (1, 7, 256), (1, 3, 8192), (1, 4096, 4096),
                     (2, 1024, 1024), (3, 1024, 1024)]


@pytest.mark.parametrize("shape,engine", [
    (shape, engine) for shape in MATRIX_ROW_SHAPES for engine in ENGINES
    if shape[2] >= 128 or not engine[1]])
def test_matrix_rows_transposed_match_plain(cuda, select_engine, shape,
                                            engine):
    tier, split3 = engine
    precision = select_engine(tier, split3)
    re, im = _planes(shape, cuda)
    before = planes.fft1d_transposed.launches
    got = planes.fft1d_transposed(re, im, True, precision)
    assert planes.fft1d_transposed.launches == before
    name = planes.kernel_name("rows_transposed", tier, split3)
    assert planes.named_launches == {name: 1}
    _assert_band(got, planes.fft1d_transposed_plain(re, im, True, precision),
                 BANDS[tier])


# (tier, split3, natural) → the kernel the routing names (csrc/fft_rows.cu):
# bf16 direct, either store → dft_bf16_rows.cuh; f32 three-factor →
# dft_split3_f32.cuh; bf16x3 three-factor → dft_split3_bf16x3.cuh; bf16
# three-factor and bf16x3 direct → the matrix engine
ROUTED_KERNELS = [("bf16", False, False, "bf16_rows_kernel"),
                  ("bf16", True, False, "MatrixEngine"),
                  ("bf16", False, True, "bf16_rows_kernel"),
                  ("bf16x3", False, False, "MatrixEngine"),
                  ("bf16x3", True, False, "split3_bf16x3_rows_kernel"),
                  ("f32", True, False, "split3_f32_rows_kernel"),
                  ("bf16x3", False, True, "MatrixEngine")]


@pytest.mark.parametrize("tier,split3,natural,kernel", ROUTED_KERNELS)
def test_only_the_bf16_direct_transposed_pass_runs_its_own_kernel(
        cuda, select_engine, tier, split3, natural, kernel):
    """Each (tier, form, store) launches the one kernel its routing names,
    read from the profiler's kernel names: the bf16 direct passes (both
    stores) csrc/dft_bf16_rows.cuh's kernel, the f32 and bf16x3
    three-factor passes csrc/dft_split3_f32.cuh's and
    csrc/dft_split3_bf16x3.cuh's, the rest the matrix engine
    (fft_rows_kernel with MatrixEngine); each counts under its old name,
    and the profiler key groups under that name as chip_smoke.py reads
    it."""
    import chip_smoke
    precision = select_engine(tier, split3)
    re, im = _planes((1, 64, 256), cuda)
    fn = planes.fft1d_natural_large if natural else planes.fft1d_transposed
    fn(re, im, True, precision)        # built and warm outside the trace
    # the profiler now and then records no kernel in a window (seen on the
    # H100 for the first window of a process): up to three windows
    for _ in range(3):
        planes.named_launches.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(re, im, True, precision)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    row_kernels = [k for k in names if chip_smoke.kernel_group(k) != "torch ops"]
    assert len(row_kernels) == 1 and kernel in row_kernels[0], names
    if kernel == "MatrixEngine":
        assert "fft_rows_kernel" in row_kernels[0], names
    store = "natural" if natural else "transposed"
    name = planes.kernel_name(f"rows_{store}", tier, split3)
    assert planes.named_launches == {name: 1}
    assert chip_smoke.kernel_group(row_kernels[0]) == name


# (tier, split3, natural) of a fused pass → the kernel it runs: the f32
# direct stores and the bf16 direct natural store their own
# (radix16_fused_rows_natural_kernel, radix16_fused_rows_transposed_kernel,
# bf16_fused_natural_kernel), the rest fused_rows_kernel on the matrix
# engine
OWN_FUSED_KERNELS = {"radix16_fused_rows_natural_kernel": ("f32", False, True),
                     "radix16_fused_rows_transposed_kernel":
                         ("f32", False, False),
                     "bf16_fused_natural_kernel": ("bf16", False, True)}
FUSED_ROUTED = [("f32", False, True, "radix16_fused_rows_natural_kernel"),
                ("f32", False, False, "radix16_fused_rows_transposed_kernel"),
                ("bf16", False, True, "bf16_fused_natural_kernel"),
                ("bf16", False, False, "MatrixEngine"),
                ("bf16x3", False, True, "MatrixEngine"),
                ("bf16x3", True, False, "MatrixEngine"),
                ("f32", True, False, "MatrixEngine")]


@pytest.mark.parametrize("channel_set", [(True, 3), (True, 5), (False, 3)],
                         ids=str)
@pytest.mark.parametrize("tier,split3,natural,kernel", FUSED_ROUTED)
def test_only_the_f32_natural_fused_pass_runs_its_own_kernel(
        cuda, select_engine, tier, split3, natural, kernel, channel_set):
    """Each fused pass, in every channel set, launches the one kernel its
    routing names, read from the profiler's kernel names; the symbols of
    the fused kernels of their own (the f32 natural and transposed, the
    bf16 natural) each appear in their own pass alone, and every key
    groups under its launch name as chip_smoke.py reads it."""
    import chip_smoke
    packed, nch_live = channel_set
    precision = select_engine(tier, split3)
    h0, phase = _fused_inputs(64, 256, cuda)
    fn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    kw = dict(epsilon=1e-4, ch_start=0, ch_count=2, packed=packed,
              nch_live=nch_live, precision=precision)
    fn(h0, phase, 434.48, -1.0, **kw)        # built and warm outside the trace
    # the profiler now and then records no kernel in a window: up to three
    # windows of five launches each
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(h0, phase, 434.48, -1.0, **kw)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    fused_kernels = [k for k in names
                     if chip_smoke.kernel_group(k) != "torch ops"]
    assert len(fused_kernels) == 1 and kernel in fused_kernels[0], names
    for symbol, route in OWN_FUSED_KERNELS.items():
        assert (symbol in fused_kernels[0]) == (
            (tier, split3, natural) == route), names
    if kernel not in OWN_FUSED_KERNELS:
        assert "fused_rows_kernel" in fused_kernels[0], names
    store = "natural" if natural else "transposed"
    group = (f"fused_rows_{store}" if tier == "f32" and not split3 else
             planes.kernel_name(f"fused_{store}", tier, split3))
    assert chip_smoke.kernel_group(fused_kernels[0]) == group


# the f32 three-factor row kernel: every N it takes from 256, M = 1, ragged
# and the path's batch, up to 3 channels
SPLIT3_F32_SHAPES = [(c, m, n) for n in (256, 512, 1024, 2048, 4096, 8192)
                     for c, m in ((1, 1), (2, 7), (3, 13), (1, 1024))]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", SPLIT3_F32_SHAPES)
def test_split3_f32_rows_kernel_matches_plain(cuda, select_engine, shape,
                                              inverse):
    precision = select_engine("f32", True)
    re, im = _planes(shape, cuda, seed=shape[2] + shape[1])
    got = planes.fft1d_transposed(re, im, inverse, precision)
    assert planes.named_launches == {"matrix_rows_transposed[f32,split3]": 1}
    want = planes.fft1d_transposed_plain(re, im, inverse, precision)
    for c in range(shape[0]):
        _assert_band((got[0][c], got[1][c]), (want[0][c], want[1][c]),
                     BANDS["f32"])


# the bf16x3 three-factor row kernel: every N it takes, one row, ragged M
# (odd and even, against R), the path's batch, up to 5 channels
SPLIT3_BF16X3_SHAPES = [(c, m, n) for n in (128, 256, 512, 1024, 2048, 4096,
                                            8192)
                        for c, m in ((1, 1), (2, 7), (5, 13), (3, 6),
                                     (1, 1024))]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", SPLIT3_BF16X3_SHAPES)
def test_split3_bf16x3_rows_kernel_matches_plain(cuda, select_engine, shape,
                                                 inverse):
    precision = select_engine("bf16x3", True)
    re, im = _planes(shape, cuda, seed=shape[2] + shape[1])
    got = planes.fft1d_transposed(re, im, inverse, precision)
    assert planes.named_launches == {
        "matrix_rows_transposed[bf16x3,split3]": 1}
    want = planes.fft1d_transposed_plain(re, im, inverse, precision)
    for c in range(shape[0]):
        _assert_band((got[0][c], got[1][c]), (want[0][c], want[1][c]),
                     BANDS["bf16x3"])


@pytest.mark.parametrize("n", [64, 16384, 96])
def test_split3_bf16x3_rows_kernel_refuses_other_lengths(cuda, n):
    """The C entry at tier bf16x3, three-factor form: N outside the powers
    of two in [128, 8192] is refused (cudaErrorInvalidValue), never run on
    another kernel."""
    from tpu_ocean_torch import _build
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty_like(re)
    tables = planes.split3_bf16x3_tables(1024, True, re.device)
    err = _build.load().lib.tpu_fft_rows_transposed(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), 1, 2, n, 1, planes.TIERS["bf16x3"], 1, 1,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fft_rows_transposed")


# the bf16 natural pass at R > 1 rows a block with a ragged last block
@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("shape", [(1, 1023, 1024), (3, 301, 2048),
                                   (2, 131, 2048), (1, 2047, 4096)])
def test_bf16_natural_kernel_ragged_blocks_match_plain(cuda, select_engine,
                                                       shape, inverse):
    c, m, n = shape
    rows = planes.rows_per_block(
        c, m, n, planes.sm_count(cuda), planes.max_rows(n, True, "bf16", False),
        planes.block_shared_bytes("bf16", False, True))
    assert rows > 1 and m % rows
    precision = select_engine("bf16", False)
    re, im = _planes(shape, cuda, seed=m)
    got = planes.fft1d_natural_large(re, im, inverse, precision)
    assert planes.named_launches == {"matrix_rows_natural[bf16]": 1}
    want = planes.fft1d_natural_large_plain(re, im, inverse, precision)
    for ch in range(c):
        _assert_band((got[0][ch], got[1][ch]), (want[0][ch], want[1][ch]),
                     BANDS["bf16"])


@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
@pytest.mark.parametrize("shape", [(1, 1, 16), (2, 13, 64), (1, 1024, 1024),
                                   (1, 1, 4096), (1, 37, 4096),
                                   (1, 2048, 4096), (1, 3, 8192)])
def test_matrix_rows_natural_match_plain(cuda, select_engine, shape, tier):
    precision = select_engine(tier, True)     # no three-factor natural store
    re, im = _planes(shape, cuda)
    got = planes.fft1d_natural_large(re, im, False, precision)
    assert planes.named_launches == {
        planes.kernel_name("rows_natural", tier, False): 1}
    _assert_band(got, planes.fft1d_natural_large_plain(re, im, False,
                                                       precision),
                 BANDS[tier])


FUSED_MATRIX_CASES = [(16, 16, 0, 2, 0), (13, 64, 1, 1, 20),
                      (1024, 1024, 0, 1, 0), (512, 1024, 1, 1, 0),
                      (2048, 4096, 1, 1, 0), (3, 8192, 1, 1, 4095)]


@pytest.mark.parametrize("case,natural,engine", [
    (case, natural, engine) for case in FUSED_MATRIX_CASES
    for natural in (False, True) for engine in ENGINES
    if not (engine[1] and (natural or case[1] < 128))])
def test_matrix_fused_match_plain(cuda, select_engine, case, natural, engine):
    """The three-factor form: transposed store, N >= 128 only."""
    m, n, ch_start, ch_count, row_offset = case
    tier, split3 = engine
    precision = select_engine(tier, split3)
    h0, phase = _fused_inputs(m, n, cuda)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=row_offset, precision=precision)
    fn, plain, kind = ((fused.assemble_rowfft_natural,
                        fused.assemble_rowfft_natural_plain, "fused_natural")
                       if natural else
                       (fused.assemble_rowfft, fused.assemble_rowfft_plain,
                        "fused_transposed"))
    got = fn(h0, phase, 434.48, -1.0, **kw)
    assert planes.named_launches == {planes.kernel_name(kind, tier, split3): 1}
    _assert_band(got, plain(h0, phase, 434.48, -1.0, **kw), BANDS[tier])


@pytest.mark.parametrize("case,natural,engine", [
    (case, natural, engine)
    for case in [(13, 64, False, 3, 0, 5, 20), (512, 1024, True, 5, 2, 1, 0),
                 (37, 1024, False, 3, 3, 2, 500),
                 (2048, 4096, True, 5, 2, 1, 0)]
    for natural in (False, True) for engine in ENGINES
    if not (engine[1] and (natural or case[1] < 128))])
def test_matrix_fused_channel_sets_match_plain(cuda, select_engine, case,
                                               natural, engine):
    """The slope and per-channel assembly ahead of every tier and form."""
    m, n, packed, nch_live, ch_start, ch_count, row_offset = case
    tier, split3 = engine
    precision = select_engine(tier, split3)
    h0, phase = _fused_inputs(m, n, cuda)
    kw = dict(epsilon=1e-4, ch_start=ch_start, ch_count=ch_count,
              row_offset=row_offset, packed=packed, nch_live=nch_live,
              precision=precision)
    fn, plain, kind = ((fused.assemble_rowfft_natural,
                        fused.assemble_rowfft_natural_plain, "fused_natural")
                       if natural else
                       (fused.assemble_rowfft, fused.assemble_rowfft_plain,
                        "fused_transposed"))
    got = fn(h0, phase, 434.48, -1.0, **kw)
    assert planes.named_launches == {planes.kernel_name(
        kind, tier, split3, fused.channel_set(packed, nch_live)): 1}
    want = plain(h0, phase, 434.48, -1.0, **kw)
    for c in range(ch_count):
        _assert_band((got[0][c], got[1][c]), (want[0][c], want[1][c]),
                     BANDS[tier])


# (fft_backend, N, normals, pack_channels, half_spectrum, pallas_fields,
# evolution_mode, launches a step by counter or by planes.named_launches
# name)
SOLVER_CONFIGS = [
    ("pallas_fused", 128, "stencil", False, False, True, "phase",
     {"fused_transposed[per_channel]": 1, "rows_t": 1, "fields": 1}),
    ("pallas_fused", 128, "spectral", True, True, False, "phase",
     {"fused_transposed[packed5]": 2, "rows_t": 3}),
    ("pallas", 128, "stencil", False, False, False, "phase", {"rows_t": 2}),
    ("pallas_fused", 4096, "spectral", False, False, False, "phase",
     {"fused_natural[per_channel]": 1, "rows_t": 1}),
    ("pallas_fused", 4096, "spectral", True, False, False, "absolute",
     {"fused_natural[packed5]": 1, "rows_t": 1}),
    ("pallas", 4096, "spectral", True, True, False, "phase",
     {"rows_n": 3, "rows_t": 2})]


@pytest.mark.parametrize("config", SOLVER_CONFIGS)
def test_solver_configurations_match_cpu_and_launch_their_kernels(cuda,
                                                                  config):
    backend, n, normals, pack, half, fields_kernel, mode, per_step = config
    cfg = OCEAN_DEMO.replace(resolution=n, normals_mode=normals,
                             evolution_mode=mode)
    kw = dict(fft_backend=backend, real_state=True, pack_channels=pack,
              half_spectrum=half, pallas_fields=fields_kernel)
    gpu = OceanSolver(cfg, device=cuda, **kw)
    cpu = OceanSolver(cfg, device="cpu", **kw)
    sg = gpu.init(torch.Generator().manual_seed(5))
    sc = cpu.init(torch.Generator().manual_seed(5))
    counters = {"fused_t": fused.assemble_rowfft,
                "fused_n": fused.assemble_rowfft_natural,
                "rows_t": planes.fft1d_transposed,
                "rows_n": planes.fft1d_natural_large,
                "fields": fs.fields_stencil}
    before = {k: f.launches for k, f in counters.items()}
    planes.named_launches.clear()
    sg, fg = gpu.step(sg, 1 / 60)
    sc, fc = cpu.step(sc, 1 / 60)
    torch.cuda.synchronize()
    for key, counter in counters.items():
        assert counter.launches - before[key] == per_step.get(key, 0), key
    assert planes.named_launches == {k: v for k, v in per_step.items()
                                     if k not in counters}
    fg, fc = fields_to_numpy(fg), fields_to_numpy(fc)
    names = ["height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"]
    for name in names:
        want = getattr(fc, name)
        np.testing.assert_allclose(getattr(fg, name), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    if normals == "spectral":
        np.testing.assert_allclose(fg.normal, fc.normal, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_bf16_solver_runs_the_matrix_engine_and_matches_cpu(cuda, backend):
    """precision="bfloat16" at 128²: every pass on the bf16 engine, none on
    the Stockham kernels; card vs CPU within 2e-3·max (one bf16 ulp flips
    where the two accumulate in other orders)."""
    cfg = OCEAN_DEMO.replace(resolution=128, precision="bfloat16")
    gpu = OceanSolver(cfg, device=cuda, fft_backend=backend, **SLICE)
    cpu = OceanSolver(cfg, device="cpu", fft_backend=backend, **SLICE)
    sg = gpu.init(torch.Generator().manual_seed(5))
    sc = cpu.init(torch.Generator().manual_seed(5))
    before = (planes.fft1d_transposed.launches, fused.assemble_rowfft.launches)
    planes.named_launches.clear()
    for _ in range(2):
        sg, fg = gpu.step(sg, 1 / 60)
        sc, fc = cpu.step(sc, 1 / 60)
    torch.cuda.synchronize()
    assert before == (planes.fft1d_transposed.launches,
                      fused.assemble_rowfft.launches)
    want = ({"matrix_rows_transposed[bf16]": 10} if backend == "pallas" else
            {"matrix_rows_transposed[bf16]": 6,
             "matrix_fused_transposed[bf16]": 4})
    assert planes.named_launches == want
    fg, fc = fields_to_numpy(fg), fields_to_numpy(fc)
    for name in ("height", "disp_x", "disp_z"):
        want = getattr(fc, name)
        np.testing.assert_allclose(getattr(fg, name), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())


def test_matrix_engine_refuses_a_natural_three_factor_launch(cuda):
    from tpu_ocean_torch import _build
    re, im = _planes((1, 4, 256), cuda)
    out = torch.empty_like(re)
    tables = planes.matrix_tables(256, True, True, re.device)
    err = _build.load().lib.tpu_fft_rows_natural(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), 1, 4, 256, 1, planes.TIERS["bf16"], 1,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
