"""The f32 mixed-radix row kernel (csrc/rows_mixed_f32.cuh) on the card: the
row DFTs #1 and #2 at even lengths that are not powers of two. Every test
here needs an NVIDIA GPU with nvcc: each decides inside the ``cuda``
fixture whether one exists and skips with a reason when not. This file
imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_sizes_cuda.py -m cuda -q

- Both stores in both directions at chip_smoke.py's phase-3 shapes: one
  launch counted under fft.planes.MIXED_NAMES and nothing else, within
  1e-6·max of float64 (torch.fft in complex128) and 2e-6·max of the plain
  version (torch.fft in complex64); a ragged batch (rows not a multiple
  of a block's) too.
- The autograd backward through the kernel: the kernel in the opposite
  direction, against the plain version.
- A step of path (i)'s switches at N = 192 in both regimes against the CPU
  from one state, with exact launch counts.
- What has no kernel raises ValueError on a CUDA tensor (bf16, the fused
  kernels, odd N), and the C entry refuses lengths, plans and blocks it
  does not take.
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
             ("natural", (1, 1, 8186))])


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
    re, im = _planes((1, 8, 96), cuda)
    for fn in (planes.fft1d_transposed, planes.fft1d_natural_large):
        with pytest.raises(ValueError, match="sizes"):
            fn(re, im, True, "bfloat16")
    with pytest.raises(ValueError, match="sizes"):
        fused.assemble_rowfft((re[0], im[0], re[0], im[0]), im[0], 1.0, 1.0,
                              epsilon=1e-4, ch_count=1)
    odd = _planes((1, 8, 95), cuda)
    with pytest.raises(ValueError, match="even lengths"):
        planes.fft1d_transposed(*odd)
    assert _counts() == {}


@pytest.mark.parametrize("n,rows,plan_n,table", [
    (95, 1, 96, 0), (8194, 1, 96, 0), (14, 1, 96, 0), (96, 3, 96, 0),
    (96, 0, 96, 0), (8190, 2, 8190, 0), (106, 1, 96, 0), (106, 1, 106, 120)])
def test_the_c_entry_refuses_other_lengths_and_blocks(cuda, n, rows, plan_n,
                                                      table):
    """Odd N, N outside [16, 8192], rows not a power of two, no rows, a
    block beyond the card's shared memory (two rows of 8190), a plan that
    is not a length-N transform (96's stages at 106), or a table too short
    for the plan's roots (106 with 120 entries, not 159): refused (a CUDA
    error), never run."""
    from tpu_ocean_torch import _build
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty_like(re)
    tables = planes.mixed_twiddles(plan_n, True, cuda)
    plan = planes.mixed_plan_rows(plan_n)
    err = _build.load().lib.tpu_fft_rows_mixed(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), 1, 2, n, rows, 1, len(plan),
        table or tables.shape[0], plan.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_fft_rows_mixed")
    # a refused launch leaves no error behind for the next one
    assert _rel(planes.fft1d_transposed(*_planes((1, 4, 96), cuda)),
                planes.fft1d_transposed_plain(*_planes((1, 4, 96), cuda))) \
        <= 2e-6
