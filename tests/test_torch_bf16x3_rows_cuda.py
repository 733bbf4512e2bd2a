"""The bf16x3 row kernel in the direct form (csrc/dft_bf16_rows_mixed.cuh at
tier bf16x3, entry tpu_bf16_rows_mixed: #1 and #2 at the B3 tier) on the
card. Every test here needs an NVIDIA GPU with nvcc: each decides inside
the ``cuda`` fixture whether one exists and skips with a reason when not.
This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_bf16x3_rows_cuda.py -m cuda -q

- Both stores in both directions at every even N the kernel takes, its
  regime 1 (n1 ≤ 128: the powers of two from 16, n2 = 1 at 128, N = 96,
  106, 160, 384, 768, 1536, 3072, 6144; ragged M, C = 3) and its regime 2
  (n1 = N/2 > 128: 270, 1000, 2042, 8186 at ragged M, C = 2, a column
  tile across the channels): the launches fft.planes.bf16x3_rows_launches
  names and nothing else, within 1e-5·max of the plain version (fft/
  matrix.py rows_dft at bf16x3, the same split operands; chip_smoke.py's
  TIER_BAND) and 5e-5·max of float64, and the kernel's RMS error against
  float64 within 1.1 × the plain version's on the same rows
  (chip_smoke.py's B3_ROWS_RMS_SPREAD).
- The autograd backward runs the same kernel in the opposite direction.
- The matrix engine's row entries (tpu_fft_rows_transposed,
  tpu_fft_rows_natural, tpu_matrix_rows_any) refuse bf16x3 in the direct
  form, and tpu_bf16_rows_mixed refuses at tier bf16x3 what it does not
  take.
"""

import pytest
import torch

from tpu_ocean_torch.fft import planes

pytestmark = pytest.mark.cuda

#: [C, M, N] where n1 ≤ 128, then where n1 = N/2 > 128
NARROW = [(1, 16, 16), (3, 5, 16), (2, 13, 64), (1, 128, 128), (1, 9, 128),
          (1, 256, 256), (1, 1024, 1024), (1, 512, 1024), (1, 1, 1024),
          (3, 37, 1024), (1, 96, 96), (3, 106, 106), (1, 37, 106),
          (1, 160, 160), (1, 384, 384), (2, 301, 768), (1, 1536, 1536),
          (1, 13, 1536), (1, 3072, 3072), (1, 4096, 4096), (1, 7, 6144),
          (1, 5, 8192)]
WIDE = [(2, 37, 270), (1, 1000, 1000), (1, 64, 2042), (1, 1, 8186),
        (1, 8, 8186)]
CASES = [(store, shape) for shape in NARROW + WIDE
         for store in ("transposed", "natural")]
TO_PLAIN, TO_F64, RMS_SPREAD = 1e-5, 5e-5, 1.1


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(planes, "KERNEL_B3_THRESHOLD", 0)
    planes.named_launches.clear()
    return torch.device("cuda")


def _planes(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for _ in range(2)]


def _rel(got, want):
    scale = max(w.abs().max().item() for w in want)
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want)) / scale


def _rms(got, ref):
    err = sum(((g.double() - r) ** 2).mean() for g, r in zip(got, ref))
    return torch.sqrt(err / sum((r ** 2).mean() for r in ref)).item()


def _f64(re, im, inverse, natural):
    z = torch.complex(re.double(), im.double())
    ref = (torch.fft.ifft(z, dim=-1, norm="forward") if inverse
           else torch.fft.fft(z, dim=-1))
    if not natural:
        ref = ref.transpose(-1, -2)
    return ref.real, ref.imag


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("store,shape", CASES,
                         ids=[f"{s}-{'x'.join(map(str, sh))}"
                              for s, sh in CASES])
def test_bf16x3_kernel_matches_plain_and_float64(cuda, store, shape,
                                                 inverse):
    natural = store == "natural"
    assert planes.engine(shape[-1], "float32", not natural) == ("bf16x3",
                                                                False)
    fn, plain = ((planes.fft1d_natural_large,
                  planes.fft1d_natural_large_plain) if natural else
                 (planes.fft1d_transposed, planes.fft1d_transposed_plain))
    re, im = _planes(shape, cuda, seed=shape[-1] + shape[-2])
    got = fn(re, im, inverse, "float32")
    torch.cuda.synchronize()
    assert dict(planes.named_launches) == dict.fromkeys(
        planes.bf16x3_rows_launches(shape[-1], natural), 1)
    want = plain(re, im, inverse, "float32")
    assert _rel(got, want) <= TO_PLAIN
    ref = _f64(re, im, inverse, natural)
    assert _rel(got, ref) <= TO_F64
    assert _rms(got, ref) <= RMS_SPREAD * _rms(want, ref)


@pytest.mark.parametrize("store,shape", [("transposed", (1, 1024, 1024)),
                                         ("natural", (1, 64, 3072)),
                                         ("transposed", (1, 13, 2042))])
def test_the_backward_runs_the_kernel_in_the_opposite_direction(cuda, store,
                                                                shape):
    """_Fft1dTransposedDiff and _Fft1dNaturalLargeDiff at bf16x3: the
    backward's launch is the bf16x3 row kernel's in the forward direction,
    against the plain version there."""
    natural = store == "natural"
    fn, plain = ((planes.fft1d_natural_large,
                  planes.fft1d_natural_large_plain) if natural else
                 (planes.fft1d_transposed, planes.fft1d_transposed_plain))
    x = [p.requires_grad_() for p in _planes(shape, cuda, seed=2)]
    yr, yi = fn(*x, True, "float32")
    cts = _planes(tuple(yr.shape), cuda, seed=3)
    grads = torch.autograd.grad((yr, yi), x, cts)
    names = planes.bf16x3_rows_launches(shape[-1], natural)
    assert dict(planes.named_launches) == dict.fromkeys(names, 2)
    if natural:
        want = plain(*cts, False, "float32")
    else:
        want = [w.transpose(-1, -2) for w in plain(
            *(c.transpose(-1, -2).contiguous() for c in cts), False,
            "float32")]
    assert _rel(grads, want) <= TO_PLAIN


#: the engine's row entries at tier bf16x3 in the direct form: (entry, n,
#: natural)
ENGINE_ENTRIES = [("tpu_fft_rows_transposed", 1024, 0),
                  ("tpu_fft_rows_natural", 1024, 1),
                  ("tpu_fft_rows_transposed", 16, 0),
                  ("tpu_matrix_rows_any", 1536, 0),
                  ("tpu_matrix_rows_any", 1536, 1),
                  ("tpu_matrix_rows_any", 96, 0),
                  ("tpu_matrix_rows_any", 96, 1)]


@pytest.mark.parametrize("entry,n,natural", ENGINE_ENTRIES)
def test_the_engine_entries_refuse_bf16x3_direct(cuda, entry, n, natural):
    """The matrix engine no longer runs bf16x3 in the direct form: its row
    entries refuse it (a CUDA error, nothing run), either store."""
    from tpu_ocean_torch import _build
    lib = _build.load().lib
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty(2, n, 2, device=cuda)
    tables = planes.matrix_tables(n, True, False, cuda)
    stream = torch.cuda.current_stream().cuda_stream
    tier = planes.TIERS["bf16x3"]
    head = (re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
            tables.data_ptr(), 1, 2, n, 1)
    tail = {"tpu_fft_rows_transposed": (tier, 0, 1),
            "tpu_fft_rows_natural": (tier, 0),
            "tpu_matrix_rows_any": (natural, tier, 0)}[entry]
    err = getattr(lib, entry)(*head, *tail, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, entry)


#: what tpu_bf16_rows_mixed refuses at tier bf16x3: (n, rows, scratch)
REFUSED = {"odd": (95, 1, False), "short": (14, 1, False),
           "long": (8194, 1, False), "rows": (96, 3, False),
           "no_rows": (96, 0, False), "smem": (8192, 2, False),
           "wide_rows": (2042, 2, True), "wide_no_scratch": (2042, 1, False)}


@pytest.mark.parametrize("what", list(REFUSED))
def test_the_entry_refuses_what_it_does_not_take(cuda, what):
    """An odd N or one outside [16, 8192], rows not a power of two or none,
    a block beyond the card's shared memory (two rows of 8192), rows ≠ 1
    or no X′ buffer where n1 = N/2 > 128: refused, never run; the next
    launch is not disturbed."""
    from tpu_ocean_torch import _build
    n, rows, with_scratch = REFUSED[what]
    lib = _build.load().lib
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty(2, n, 2, device=cuda)
    tables = planes.bf16x3_rows_tables(96, True, cuda)   # never read
    scratch = torch.empty(max(1, planes.bf16x3_rows_scratch_words(1, 2, n))
                          if with_scratch else 0, dtype=torch.int32,
                          device=cuda)
    err = lib.tpu_bf16_rows_mixed(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), scratch.data_ptr() if with_scratch else None, 1,
        2, n, rows, 0, planes.TIERS["bf16x3"],
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_bf16_rows_mixed")
    good = _planes((1, 4, 106), cuda)
    assert _rel(planes.fft1d_transposed(*good, True, "float32"),
                planes.fft1d_transposed_plain(*good, True, "float32")) \
        <= TO_PLAIN
