"""The f32 mixed-radix row kernel (csrc/rows_mixed_passes_f32.cuh) on the
card: the row DFTs #1 and #2 at even lengths that are not powers of two. Every test
here needs an NVIDIA GPU with nvcc: each decides inside the ``cuda``
fixture whether one exists and skips with a reason when not. This file
imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_sizes_cuda.py -m cuda -q

- Both stores in both directions at chip_smoke.py's phase-3 shapes, and
  at M = 301 (ragged at R = 2 and 4, in clusters of 2) at lengths whose
  passes take every register radix but 12 and 16 (40 = 10·4, 120 = 15·8,
  250 = 10·5·5, 686 = 14·7·7, 980 = 14·14·5, 1458 = 9·9·9·2, 2058 =
  14·7·7·3) and a generic pass after them (1020 = 15·4·17): one launch
  counted under fft.planes.MIXED_NAMES and nothing else, within 1e-6·max
  of float64 (torch.fft in complex128) and 2e-6·max of the plain version
  (torch.fft in complex64); a ragged batch (rows not a multiple of a
  block's) too.
- The autograd backward through the kernel: the kernel in the opposite
  direction, against the plain version.
- A step of path (i)'s switches at N = 192 in both regimes against the CPU
  from one state, with exact launch counts.
- What has no kernel raises ValueError on a CUDA tensor (odd N and N
  above 8192, row or fused, at every precision), and the C entry refuses
  lengths, plans and blocks it does not take.
- The f32 fused mixed-radix kernel (csrc/fused_rows_mixed_f32.cuh, #5 and
  #6 at those lengths), every channel of the three sets, both stores, at
  ragged M and at a row offset: one launch counted under
  fft.planes.MIXED_FUSED_NAME, each channel within 2e-6·max of the plain
  version (the assembly in torch, then torch.fft) and 1e-6·max of the
  float64 DFT of the float64 assembly; its C entry's refusals; path (i)'s
  switches on ``pallas_fused`` at N = 96 and 1536, card against CPU; a
  gradient refused at 1536, where bf16 steps.
- The matrix engine behind those kernels' loads and stores (the other
  tiers and forms at those lengths; entries tpu_matrix_rows_any and
  tpu_matrix_fused_rows_any) and the bf16 and bf16x3 row kernels (bf16 and
  bf16x3 direct rows, entry tpu_bf16_rows_mixed): bf16 and bf16x3 direct,
  either store, and the three-factor form at f32, bf16 and bf16x3 (where
  128 | N), row and fused, both directions, at n1 = N/2 (96, 106, 160,
  2042, 8186) and n1 = 128 (384, 768, 1536), ragged M and C = 3: its
  launches under their names (fft.planes.mixed_kernel_name, the direct
  rows fft.planes.direct_rows_launches), within the tier's band of the
  plain version and of float64; the backward at bf16; the entries'
  refusals;
  path (i)'s switches at bf16 at N = 96 on ``pallas`` and
  ``pallas_fused``, card against CPU.
"""

import numpy as np
import pytest
import torch

from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, fields_to_numpy,
                             state_from_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs
from tpu_ocean_torch.ops import fused_spectrum as fused

pytestmark = pytest.mark.cuda

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)
#: chip_smoke.py's phase-3 shapes: the transposed store at N = 48 … 2042,
#: the natural one at 3072, 6144, 8190, each at M = N, N/2 and 1, the
#: natural store at C = 3, and at 8186 = 2·4093 (the largest prime radix)
#: at M = N and 1
SHAPES = ([("transposed", (1, m, n))
           for n in (48, 96, 106, 160, 224, 384, 768, 1536, 2042)
           for m in (n, n // 2, 1)]
          + [("natural", (1, m, n)) for n in (3072, 6144, 8190)
             for m in (n, n // 2, 1)]
          + [("natural", (3, 3072, 3072)), ("natural", (1, 8186, 8186)),
             ("natural", (1, 1, 8186))]
          + [(store, (1, 301, n)) for n in (40, 120, 250, 686, 980, 1458,
                                            2058, 1020)
             for store in ("transposed", "natural")])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    planes.fft1d_transposed.launches = 0
    planes.fft1d_natural_large.launches = 0
    fs.fields_stencil.launches = 0
    planes.named_launches.clear()
    return torch.device("cuda")


def _planes(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for _ in range(2)]


def _counts():
    torch.cuda.synchronize()
    counts = {"fft_rows_transposed": planes.fft1d_transposed.launches,
              "fft_rows_natural": planes.fft1d_natural_large.launches,
              "fields_stencil": fs.fields_stencil.launches,
              **planes.named_launches}
    return {k: v for k, v in counts.items() if v}


def _rel(got, want):
    scale = max(w.abs().max().item() for w in want)
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want)) / scale


def _wrappers(store):
    if store == "transposed":
        return planes.fft1d_transposed, planes.fft1d_transposed_plain
    return planes.fft1d_natural_large, planes.fft1d_natural_large_plain


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("store,shape", SHAPES,
                         ids=[f"{s}-{'x'.join(map(str, sh))}"
                              for s, sh in SHAPES])
def test_mixed_kernel_matches_float64_and_plain(cuda, store, shape, inverse):
    fn, plain = _wrappers(store)
    re, im = _planes(shape, cuda, seed=shape[-1] + shape[-2])
    got = fn(re, im, inverse)
    assert _counts() == {planes.MIXED_NAMES[f"rows_{store}"]: 1}
    z = torch.complex(re.double(), im.double())
    ref = (torch.fft.ifft(z, dim=-1, norm="forward") if inverse
           else torch.fft.fft(z, dim=-1))
    if store == "transposed":
        ref = ref.transpose(-1, -2)
    assert _rel(got, (ref.real, ref.imag)) <= 1e-6
    assert _rel(got, plain(re, im, inverse)) <= 2e-6


@pytest.mark.parametrize("store", ["transposed", "natural"])
@pytest.mark.parametrize("shape", [(2, 13, 96), (3, 37, 106), (1, 5, 8190)])
def test_ragged_batches(cuda, store, shape):
    """M not a multiple of a block's rows: every row transformed, none
    stored twice or past M."""
    fn, plain = _wrappers(store)
    re, im = _planes(shape, cuda, seed=1)
    assert _rel(fn(re, im), plain(re, im)) <= 2e-6


@pytest.mark.parametrize("store", ["transposed", "natural"])
def test_backward_runs_the_kernel_in_the_opposite_direction(cuda, store):
    fn, plain = _wrappers(store)
    x = [p.requires_grad_() for p in _planes((1, 96, 96), cuda, seed=2)]
    yr, yi = fn(*x)
    cts = _planes(tuple(yr.shape), cuda, seed=3)
    grads = torch.autograd.grad((yr, yi), x, cts)
    assert _counts() == {planes.MIXED_NAMES[f"rows_{store}"]: 2}
    if store == "transposed":
        want = [w.transpose(-1, -2) for w in plain(
            *(c.transpose(-1, -2).contiguous() for c in cts), False)]
    else:
        want = plain(*cts, False)
    assert _rel(grads, want) <= 2e-6


@pytest.mark.parametrize("natural", [False, True])
def test_slice_step_against_the_cpu(cuda, natural, monkeypatch):
    """Path (i)'s switches at N = 192, 3 steps on the card and on the CPU
    from one state: the fields within 1e-5·max (normals 2e-4, foam 25×);
    every row pass on the mixed-radix kernel (transposed regime: 5
    transposed launches a step; natural, the cap at 64: 3 natural and 2
    transposed)."""
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 64)
    cfg = OCEAN_DEMO.replace(resolution=192)
    card = OceanSolver(cfg, **SLICE)
    cpu = OceanSolver(cfg, device="cpu", **SLICE)
    state = card.init(torch.Generator().manual_seed(0))
    cpu_state = state_from_numpy(state, "cpu")
    planes.named_launches.clear()
    for _ in range(3):
        state, got = card.step(state, 1 / 60)
        cpu_state, want = cpu.step(cpu_state, 1 / 60)
    per_step = ({"fft_rows_mixed_natural": 3, "fft_rows_mixed_transposed": 2}
                if natural else {"fft_rows_mixed_transposed": 5})
    assert _counts() == {**{k: 3 * v for k, v in per_step.items()},
                         "fields_stencil": 3}
    got, want = fields_to_numpy(got), fields_to_numpy(want)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        w = getattr(want, name)
        np.testing.assert_allclose(getattr(got, name), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(got.normal, want.normal, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.foam, want.foam, rtol=0,
                               atol=25e-5 * max(np.abs(want.foam).max(), 1e-9))


def test_what_has_no_kernel_raises_on_a_cuda_tensor(cuda):
    """Odd N and N above 8192 have no kernel at any tier, row or fused:
    ValueError before any launch. (bf16 at N = 96, once refused here, runs
    the matrix engine behind the mixed-radix kernel's loads and stores.)"""
    for n in (95, 8194):
        re, im = _planes((1, 2, n), cuda)
        for precision in ("float32", "bfloat16"):
            for fn in (planes.fft1d_transposed, planes.fft1d_natural_large):
                with pytest.raises(ValueError, match="even lengths"):
                    fn(re, im, True, precision)
            with pytest.raises(ValueError, match="even"):
                fused.assemble_rowfft((re[0], im[0], re[0], im[0]), im[0],
                                      1.0, 1.0, epsilon=1e-4, ch_count=1,
                                      precision=precision)
    assert _counts() == {}


@pytest.mark.parametrize("n,rows,plan_n,table", [
    (95, 1, 96, 0), (8194, 1, 96, 0), (14, 1, 96, 0), (96, 3, 96, 0),
    (96, 0, 96, 0), (8190, 2, 8190, 0), (106, 1, 96, 0), (106, 1, 106, 120)])
def test_the_c_entry_refuses_other_lengths_and_blocks(cuda, n, rows, plan_n,
                                                      table):
    """Odd N, N outside [16, 8192], rows not a power of two, no rows, a
    block beyond the card's limits (two rows of 8190, 1184 threads), a plan
    that is not a length-N transform (96's passes at 106), or a table too
    short for the plan's roots (106 with 120 entries, not 158): refused (a
    CUDA error), never run."""
    _refused(cuda, n, rows, plan_n, table, 1, 1)


def _refused(cuda, n, rows, plan_n, table, natural, cluster):
    from tpu_ocean_torch import _build
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty_like(re)
    tables = planes.passes_twiddles(plan_n, True, cuda)
    plan = planes.passes_plan_rows(plan_n)
    err = _build.load().lib.tpu_fft_rows_mixed(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), 1, 2, n, rows, natural, len(plan) - 1,
        table or tables.shape[0], cluster, plan.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fft_rows_mixed")
    # a refused launch leaves no error behind for the next one
    assert _rel(planes.fft1d_transposed(*_planes((1, 4, 96), cuda)),
                planes.fft1d_transposed_plain(*_planes((1, 4, 96), cuda))) \
        <= 2e-6


@pytest.mark.parametrize("natural,cluster,n", [
    (1, 2, 1536), (0, 3, 1536), (0, 16, 1536), (0, 0, 1536), (0, 4, 106)])
def test_the_c_entry_refuses_clusters_it_does_not_take(cuda, natural,
                                                       cluster, n):
    """A cluster with the natural store, of 3, 16 or no blocks, or of more
    blocks than N has columns to share (4 at 106 = 2·53): refused (a CUDA
    error), never run."""
    _refused(cuda, n, 1, n, 0, natural, cluster)


# ------------------------------------------ the f32 fused mixed-radix kernel

#: (packed, nch_live) of each channel set
SETS = {"packed3": (True, 3), "packed5": (True, 5),
        "per_channel": (False, 3)}
#: (M, N, row offset, first channel, channels): every channel over all
#: rows, the half channel (rows 0..N/2−1, the last channel), and a ragged
#: batch at a row offset across the Nyquist row from channel 1 on (None:
#: the set's last channel / the rest of the set)
FUSED_SHAPES = [(96, 96, 0, 0, None), (48, 96, 0, -1, 1),
                (106, 106, 0, 0, None), (53, 106, 0, -1, 1),
                (37, 106, 40, 1, None), (160, 160, 0, 0, None),
                (13, 1536, 760, 1, None), (5, 3072, 1534, 0, None)]


def _fused_inputs(m, n, dev, seed):
    g = torch.Generator().manual_seed(seed)
    h0 = tuple(torch.randn(m, n, generator=g).to(dev) for _ in range(4))
    phase = (2 * np.pi * torch.rand(m, n, generator=g)).to(dev)
    return h0, phase


def _assembly_f64(h0, phase, length, dz_sign, *, epsilon, ch, packed,
                  nch_live, row_offset):
    """Channel ``ch`` of the set in float64 from the f32 inputs, kx and kz
    from 2π/L in float64 (chip_smoke.assembly_f64): complex128 [M, N]."""
    h0r, h0i, h0cr, h0ci = (q.double() for q in h0)
    c, s = torch.cos(phase.double()), torch.sin(phase.double())
    htr = (h0r + h0cr) * c + (h0ci - h0i) * s
    hti = (h0i + h0ci) * c + (h0r - h0cr) * s
    m, n = phase.shape
    kw = dict(device=phase.device, dtype=torch.float64)
    row = torch.arange(m, **kw)[:, None] + row_offset
    col = torch.arange(n, **kw)[None, :]
    kx = 2 * np.pi / length * torch.where(row < n // 2, row, row - n)
    kz = 2 * np.pi / length * torch.where(col < n // 2, col, col - n)
    kmag2 = kx * kx + kz * kz
    invk = torch.where(kmag2 < epsilon ** 2, 0.0, 1.0 / kmag2.sqrt())
    w = [float(ch == i) for i in range(5)]
    if not packed:
        k = (w[0] + w[1] * kx * invk + w[2] * dz_sign * kz * invk
             - w[3] * kx - w[4] * kz)
        return torch.complex(k * htr, k * hti)
    rowmask, colmask = (row != n // 2).double(), (col != n // 2).double()
    a = w[0] * (1 + kx * invk * rowmask)
    b = w[1] * dz_sign * kz * invk * colmask
    if nch_live == 5:
        a = a - w[1] * kx * rowmask
        b = b - w[2] * kz * colmask
    return torch.complex(a * htr + b * hti, a * hti - b * htr)


@pytest.mark.parametrize("store", ["transposed", "natural"])
@pytest.mark.parametrize("channel_set", list(SETS))
@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=["x".join(map(str, sh[:3])) + f"-ch{sh[3]}"
                              for sh in FUSED_SHAPES])
def test_fused_mixed_kernel_matches_plain_and_float64(cuda, shape,
                                                      channel_set, store):
    m, n, offset, ch, count = shape
    packed, nch_live = SETS[channel_set]
    total = fused.channel_count(packed, nch_live)
    ch = ch % total
    count = count or total - ch
    natural = store == "natural"
    h0, phase = _fused_inputs(m, n, cuda, seed=m + n + ch)
    length = OCEAN_DEMO.length
    kw = dict(epsilon=1e-4, ch_start=ch, ch_count=count, row_offset=offset,
              packed=packed, nch_live=nch_live)
    fn, plain = ((fused.assemble_rowfft_natural,
                  fused.assemble_rowfft_natural_plain) if natural else
                 (fused.assemble_rowfft, fused.assemble_rowfft_plain))
    got = fn(h0, phase, length, -1.0, **kw)
    assert _counts() == {planes.MIXED_FUSED_NAME.format(
        store=store, channel_set=channel_set): 1}
    want = plain(h0, phase, length, -1.0, **kw)
    for c in range(count):
        gc = tuple(g[c] for g in got)
        assert _rel(gc, tuple(w[c] for w in want)) <= 2e-6
        ref = torch.fft.ifft(_assembly_f64(
            h0, phase, length, -1.0, epsilon=1e-4, ch=ch + c, packed=packed,
            nch_live=nch_live, row_offset=offset), dim=-1, norm="forward")
        if not natural:
            ref = ref.transpose(0, 1)
        assert _rel(gc, (ref.real, ref.imag)) <= 1e-6


@pytest.mark.parametrize("what", ["channels", "ch_start", "row_offset",
                                  "rows", "plan", "nch_live"])
def test_the_fused_c_entry_refuses_what_it_does_not_take(cuda, what):
    """Channels past the set (3 of the packed set with 3 live fields), a
    negative first channel or row offset, rows not a power of two, a plan
    that is not a length-N transform (96's stages at 106), a packed set
    with 4 live fields: refused (a CUDA error), never run."""
    from tpu_ocean_torch import _build
    n = 106
    h0, phase = _fused_inputs(8, n, cuda, seed=0)
    kz = torch.zeros(n, device=cuda)
    out = torch.empty(3, n, 8, device=cuda)
    args = dict(channels=1, ch_start=0, rows=4, row_offset=0, nch_live=3,
                plan_n=n)
    args.update({"channels": dict(channels=3), "ch_start": dict(ch_start=-1),
                 "row_offset": dict(row_offset=-1), "rows": dict(rows=3),
                 "plan": dict(plan_n=96), "nch_live": dict(nch_live=4)}[what])
    tables = planes.mixed_twiddles(args["plan_n"], True, cuda)
    plan = planes.mixed_plan_rows(args["plan_n"])
    err = _build.load().lib.tpu_fused_rows_mixed(
        *(p.data_ptr() for p in (*h0, phase)), kz.data_ptr(), out.data_ptr(),
        out.data_ptr(), tables.data_ptr(), args["channels"],
        args["ch_start"], 8, n, args["rows"], args["row_offset"], 1,
        args["nch_live"], 0, len(plan), tables.shape[0], 1.0, -1.0, 1e-4,
        plan.ctypes.data, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fused_rows_mixed")
    assert _counts() == {}


@pytest.mark.parametrize("n", [96, 1536])
def test_fused_slice_step_against_the_cpu(cuda, n):
    """Path (i)'s switches on ``pallas_fused`` at N = 96 and 1536, 3 steps
    on the card and on the CPU from one state, held as chip_smoke.py holds
    its paths (compare_fields: the fields within 1e-5·max, normals within
    2e-4 plus their first-order sensitivity to the measured input error,
    which at 1536² reaches ~6e-3 on a few hundred folded texels, foam
    25× plus its own); each step 2 fused launches (the full channel, the
    half channel's rows) and 3 of the row kernel, all mixed-radix, and
    none of the power-of-two kernels."""
    from chip_smoke import compare_fields
    cfg = OCEAN_DEMO.replace(resolution=n)
    kw = dict(SLICE, fft_backend="pallas_fused")
    card = OceanSolver(cfg, **kw)
    cpu = OceanSolver(cfg, device="cpu", **kw)
    state = card.init(torch.Generator().manual_seed(0))
    cpu_state = state_from_numpy(state, "cpu")
    planes.named_launches.clear()
    fused.assemble_rowfft.launches = 0
    for _ in range(3):
        state, got = card.step(state, 1 / 60)
        cpu_state, want = cpu.step(cpu_state, 1 / 60)
    assert fused.assemble_rowfft.launches == 0
    assert _counts() == {"fused_mixed_transposed[packed3]": 6,
                         "fft_rows_mixed_transposed": 9, "fields_stencil": 3}
    compare_fields(fields_to_numpy(got), fields_to_numpy(want), cfg,
                   f"fused {n}")


def test_fused_at_1536_refuses_a_gradient_and_bf16(cuda):
    """A gradient through ``pallas_fused`` raises NotImplementedError
    before any launch (JAX gives the fused kernels no VJP), at f32 and at
    bf16; bf16 on ``pallas_fused`` at 1536, once refused, constructs and
    steps: 2 fused launches a step on the matrix engine, 3 row launches on
    the bf16 row kernel (csrc/dft_bf16_rows_mixed.cuh)."""
    cfg = OCEAN_DEMO.replace(resolution=1536)
    kw = dict(SLICE, fft_backend="pallas_fused")
    for precision in ("float32", "bfloat16"):
        solver = OceanSolver(cfg.replace(precision=precision), **kw)
        st = solver.init(torch.Generator().manual_seed(0))
        planes.named_launches.clear()
        leaf = st.h0_re.clone().requires_grad_()
        with pytest.raises(NotImplementedError, match='fft_backend="pallas"'):
            solver.step(st._replace(h0_re=leaf), 1 / 60)
        assert _counts() == {}
    _, f = solver.step(st, 1 / 60)
    assert bool(torch.isfinite(f.height).all())
    assert _counts() == {"matrix_fused_mixed_transposed[bf16,packed3]": 2,
                         "bf16_rows_mixed_transposed": 3,
                         "fields_stencil": 1}


# ------------------------------- the matrix engine at those lengths

#: (store, precision, B3 threshold, three-factor threshold) of each mode
#: the matrix engine runs behind the mixed-radix kernels' loads and stores,
#: by its named_launches tags: bf16 and bf16x3 direct, either store; the
#: three-factor form (transposed only, where 128 | N) at f32, bf16, bf16x3
OFF = 1 << 30
MODES = {"bf16": ("bfloat16", OFF, OFF), "bf16x3": ("float32", 0, OFF),
         "f32,split3": ("float32", OFF, 0),
         "bf16,split3": ("bfloat16", OFF, 0),
         "bf16x3,split3": ("float32", 0, 0)}
#: each mode's band against the plain version (chip_smoke.TIER_BAND) and
#: against float64 (tests/test_torch_precision.py TO_F64)
TO_PLAIN = {"bf16": 2e-3, "bf16x3": 1e-5, "f32": 1e-5}
TO_F64 = {"bf16": 1e-2, "bf16x3": 5e-5, "f32": 1e-5}

#: [C, M, N] of the direct modes: n1 = N/2 at 96, 106 (odd, 53, padded to
#: 56), 160 and 2042 (1021), n1 = 128 at 768 and 1536 (n2 = 6, 12), at
#: M = N, ragged M and C = 3; 8186 (n1 = 4093) at M = 1 and 8
MATRIX_SHAPES = [(1, 96, 96), (2, 13, 96), (3, 106, 106), (1, 37, 106),
                 (1, 160, 160), (1, 768, 768), (1, 1536, 1536),
                 (1, 1, 1536), (1, 64, 2042), (1, 1, 8186), (1, 8, 8186)]
#: the three-factor form: 128 | N
SPLIT3_SHAPES = [(1, 384, 384), (2, 13, 768), (1, 1536, 1536),
                 (1, 1, 1536)]
MATRIX_CASES = ([(store, mode, shape) for mode in ("bf16", "bf16x3")
                 for store in ("transposed", "natural")
                 for shape in MATRIX_SHAPES]
                + [("transposed", mode, shape)
                   for mode in ("f32,split3", "bf16,split3", "bf16x3,split3")
                   for shape in SPLIT3_SHAPES])


def _mode(monkeypatch, mode):
    precision, b3, split3 = MODES[mode]
    monkeypatch.setattr(planes, "KERNEL_B3_THRESHOLD", b3)
    monkeypatch.setattr(planes, "THREE_FACTOR_THRESHOLD", split3)
    return precision


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("store,mode,shape", MATRIX_CASES,
                         ids=[f"{s}-{m}-{'x'.join(map(str, sh))}"
                              for s, m, sh in MATRIX_CASES])
def test_matrix_kernel_matches_plain_and_float64(cuda, monkeypatch, store,
                                                 mode, shape, inverse):
    """One launch of tpu_matrix_rows_any under its name (bf16 and bf16x3
    direct: the bf16 and bf16x3 row kernels' tpu_bf16_rows_mixed, one
    launch where n1 ≤ 128, two where n1 = N/2 > 128,
    fft.planes.direct_rows_launches), within the tier's band of the plain
    version (fft/matrix.py, the same rounded operands) and of float64."""
    precision = _mode(monkeypatch, mode)
    fn, plain = _wrappers(store)
    tier, split3 = planes.engine(shape[-1], precision, store == "transposed")
    assert f"{tier}{',split3' if split3 else ''}" == mode
    re, im = _planes(shape, cuda, seed=shape[-1] + shape[-2])
    got = fn(re, im, inverse, precision)
    assert _counts() == (
        dict.fromkeys(planes.direct_rows_launches(
            shape[-1], store == "natural", mode), 1)
        if mode in ("bf16", "bf16x3")
        else {f"matrix_rows_mixed_{store}[{mode}]": 1})
    z = torch.complex(re.double(), im.double())
    ref = (torch.fft.ifft(z, dim=-1, norm="forward") if inverse
           else torch.fft.fft(z, dim=-1))
    if store == "transposed":
        ref = ref.transpose(-1, -2)
    assert (_rel(got, plain(re, im, inverse, precision))
            <= TO_PLAIN[tier])
    assert _rel(got, (ref.real, ref.imag)) <= TO_F64[tier]


@pytest.mark.parametrize("store", ["transposed", "natural"])
def test_matrix_backward_runs_the_kernel_in_the_opposite_direction(cuda,
                                                                   store):
    """bf16 at [1, 96, 96]: the backward's launch is the bf16 row kernel's
    in the forward direction, against the plain version there."""
    fn, plain = _wrappers(store)
    x = [p.requires_grad_() for p in _planes((1, 96, 96), cuda, seed=2)]
    yr, yi = fn(*x, True, "bfloat16")
    cts = _planes(tuple(yr.shape), cuda, seed=3)
    grads = torch.autograd.grad((yr, yi), x, cts)
    assert _counts() == {planes.BF16_MIXED_NAMES[f"rows_{store}"]: 2}
    if store == "transposed":
        want = [w.transpose(-1, -2) for w in plain(
            *(c.transpose(-1, -2).contiguous() for c in cts), False,
            "bfloat16")]
    else:
        want = plain(*cts, False, "bfloat16")
    assert _rel(grads, want) <= TO_PLAIN["bf16"]


#: (store, mode) of the fused modes: bf16 and bf16x3 direct, either
#: store; the three-factor form at f32 and bf16x3, transposed
FUSED_MODES = [("transposed", "bf16"), ("natural", "bf16"),
               ("transposed", "bf16x3"), ("natural", "bf16x3"),
               ("transposed", "f32,split3"), ("transposed", "bf16x3,split3")]
#: (M, N, row offset, first channel, channels), as FUSED_SHAPES: N = 96,
#: 106 and 1536 (three-factor: 768, 1536), the half channel, a ragged
#: batch at a row offset across the Nyquist row from channel 1 on
MATRIX_FUSED_SHAPES = [(96, 96, 0, 0, None), (53, 106, 0, -1, 1),
                       (37, 106, 40, 1, None), (13, 1536, 760, 1, None)]
SPLIT3_FUSED_SHAPES = [(768, 768, 0, 0, None), (384, 768, 0, -1, 1),
                       (13, 1536, 760, 1, None)]
MATRIX_FUSED_CASES = [(store, mode, shape) for store, mode in FUSED_MODES
                      for shape in (SPLIT3_FUSED_SHAPES if "split3" in mode
                                    else MATRIX_FUSED_SHAPES)]


@pytest.mark.parametrize("channel_set", list(SETS))
@pytest.mark.parametrize("store,mode,shape", MATRIX_FUSED_CASES,
                         ids=[f"{s}-{m}-" + "x".join(map(str, sh[:3]))
                              + f"-ch{sh[3]}"
                              for s, m, sh in MATRIX_FUSED_CASES])
def test_matrix_fused_kernel_matches_plain_and_float64(cuda, monkeypatch,
                                                       store, mode, shape,
                                                       channel_set):
    """One launch of tpu_matrix_fused_rows_any under its name, each channel
    within the tier's band of the plain version (the assembly in torch,
    then the matrix engine's plain row DFT) and of the float64 DFT of the
    float64 assembly."""
    precision = _mode(monkeypatch, mode)
    m, n, offset, ch, count = shape
    packed, nch_live = SETS[channel_set]
    total = fused.channel_count(packed, nch_live)
    ch = ch % total
    count = count or total - ch
    natural = store == "natural"
    tier, _ = planes.engine(n, precision, not natural)
    h0, phase = _fused_inputs(m, n, cuda, seed=m + n + ch)
    length = OCEAN_DEMO.length
    kw = dict(epsilon=1e-4, ch_start=ch, ch_count=count, row_offset=offset,
              packed=packed, nch_live=nch_live, precision=precision)
    fn, plain = ((fused.assemble_rowfft_natural,
                  fused.assemble_rowfft_natural_plain) if natural else
                 (fused.assemble_rowfft, fused.assemble_rowfft_plain))
    got = fn(h0, phase, length, -1.0, **kw)
    assert _counts() == {
        f"matrix_fused_mixed_{store}[{mode},{channel_set}]": 1}
    want = plain(h0, phase, length, -1.0, **kw)
    for c in range(count):
        gc = tuple(g[c] for g in got)
        assert _rel(gc, tuple(w[c] for w in want)) <= TO_PLAIN[tier]
        ref = torch.fft.ifft(_assembly_f64(
            h0, phase, length, -1.0, epsilon=1e-4, ch=ch + c, packed=packed,
            nch_live=nch_live, row_offset=offset), dim=-1, norm="forward")
        if not natural:
            ref = ref.transpose(0, 1)
        assert _rel(gc, (ref.real, ref.imag)) <= TO_F64[tier]


#: what the matrix entries refuse: (tier, split3, natural, n, rows)
#: (bf16x3 direct, which the fused entry takes at such N)
MATRIX_REFUSED = {"f32_direct": (0, 0, 0, 96, 1),
                  "power_of_two": (2, 0, 0, 128, 1),
                  "odd": (2, 0, 0, 95, 1), "long": (2, 0, 0, 8194, 1),
                  "short": (2, 0, 0, 14, 1),
                  "split3_n1": (1, 1, 0, 96, 1),
                  "split3_natural": (1, 1, 1, 384, 1),
                  "rows": (2, 0, 0, 96, 3), "no_rows": (2, 0, 0, 96, 0),
                  "smem": (2, 0, 0, 8190, 2), "tier": (3, 0, 0, 96, 1)}
#: the row entry refuses the direct form at every N
#: (tests/test_torch_bf16x3_rows_cuda.py), so its cases probe the one
#: form it takes, bf16x3 three-factor with the transposed store where
#: 128 | N: a power of two (256), 128·65, rows 3 or none at 384, two rows
#: of 8064 = 128·63 (258 KB); an odd N or one below 16 is no multiple of
#: 128 and is refused on that count too
ROW_ENTRY_REFUSED = {**MATRIX_REFUSED,
                     "power_of_two": (2, 1, 0, 256, 1),
                     "odd": (2, 1, 0, 95, 1), "long": (2, 1, 0, 8320, 1),
                     "short": (2, 1, 0, 14, 1),
                     "rows": (2, 1, 0, 384, 3), "no_rows": (2, 1, 0, 384, 0),
                     "smem": (2, 1, 0, 8064, 2)}


@pytest.mark.parametrize("fused_entry", [False, True], ids=["rows", "fused"])
@pytest.mark.parametrize("what", list(MATRIX_REFUSED))
def test_the_matrix_c_entries_refuse_what_they_do_not_take(cuda, what,
                                                           fused_entry):
    """f32 direct (the mixed-radix entries'), a power of two, an odd N or
    one outside [16, 8192], the three-factor form at n1 ≠ 128 or with the
    natural store, rows not a power of two or none, a block beyond the
    card's shared memory (two rows of 8190; of 8064 at the row entry),
    an unknown tier: refused (a CUDA error), never run; the next launch is
    not disturbed."""
    from tpu_ocean_torch import _build
    tier, split3, natural, n, rows = (MATRIX_REFUSED if fused_entry
                                      else ROW_ENTRY_REFUSED)[what]
    lib = _build.load().lib
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty(2, n, 2, device=cuda)
    tables = planes.matrix_tables(96, True, False, cuda)
    stream = torch.cuda.current_stream().cuda_stream
    if fused_entry:
        kz = torch.zeros(n, device=cuda)
        err = lib.tpu_matrix_fused_rows_any(
            re.data_ptr(), im.data_ptr(), re.data_ptr(), im.data_ptr(),
            im.data_ptr(), kz.data_ptr(), out.data_ptr(), out.data_ptr(),
            tables.data_ptr(), 1, 0, 2, n, rows, 0, 1, 3, natural, tier,
            split3, 1.0, -1.0, 1e-4, stream)
    else:
        err = lib.tpu_matrix_rows_any(
            re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
            tables.data_ptr(), 1, 2, n, rows, natural, tier, split3, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_matrix_rows_any")
    good = _planes((1, 4, 96), cuda)
    assert _rel(planes.fft1d_transposed(*good, True, "bfloat16"),
                planes.fft1d_transposed_plain(*good, True, "bfloat16")) \
        <= TO_PLAIN["bf16"]


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_bfloat16_slice_step_against_the_cpu(cuda, backend):
    """Path (i)'s switches at N = 96 and precision="bfloat16", 3 steps on
    the card and on the CPU from one state, held as chip_smoke.py holds
    its bf16 paths (compare_fields at BF16_REL); every row pass on the
    bf16 row kernel (csrc/dft_bf16_rows_mixed.cuh), every fused pass on the
    matrix engine behind the mixed-radix kernels' loads and stores."""
    from chip_smoke import BF16_REL, compare_fields
    cfg = OCEAN_DEMO.replace(resolution=96, precision="bfloat16")
    kw = dict(SLICE, fft_backend=backend)
    card = OceanSolver(cfg, **kw)
    cpu = OceanSolver(cfg, device="cpu", **kw)
    state = card.init(torch.Generator().manual_seed(0))
    cpu_state = state_from_numpy(state, "cpu")
    planes.named_launches.clear()
    for _ in range(3):
        state, got = card.step(state, 1 / 60)
        cpu_state, want = cpu.step(cpu_state, 1 / 60)
    per_step = ({"bf16_rows_mixed_transposed": 5}
                if backend == "pallas" else
                {"matrix_fused_mixed_transposed[bf16,packed3]": 2,
                 "bf16_rows_mixed_transposed": 3})
    assert _counts() == {**{k: 3 * v for k, v in per_step.items()},
                         "fields_stencil": 3}
    compare_fields(fields_to_numpy(got), fields_to_numpy(want), cfg,
                   f"bf16 {backend} 96", rel=BF16_REL)
