"""The bf16 row kernel at even lengths that are not powers of two
(csrc/dft_bf16_rows_mixed.cuh, entry tpu_bf16_rows_mixed) on the card.
Every test here needs an NVIDIA GPU with nvcc: each decides inside the
``cuda`` fixture whether one exists and skips with a reason when not. This
file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_bf16_mixed_cuda.py -m cuda -q

- Both stores in both directions where n1 ≤ 128 (N = 96, 106, 160, 224,
  384, 768, 1536, 3072, 6144; ragged M at R > 1, C = 3) and where
  n1 = N/2 > 128 (N = 270, 1000, 2042, 8186 at ragged M, C = 2, a column
  tile across the channels): the launches fft.planes.bf16_rows_launches
  names and nothing else, within 2e-3·max of the plain version (fft/
  matrix.py rows_dft at bf16, the same rounded operands; chip_smoke.py's
  TIER_BAND) and 1e-2·max of float64, and the kernel's error against
  float64 within 1.1 × the plain version's on the same rows from 64 rows
  on (the two round the same operands; chip_smoke.py holds its bf16 row
  passes so).
- tpu_matrix_rows_any refuses bf16 in the direct form (the matrix engine's
  old route), and tpu_bf16_rows_mixed refuses what it does not take.
"""

import pytest
import torch

from tpu_ocean_torch.fft import planes

pytestmark = pytest.mark.cuda

#: [C, M, N] where n1 ≤ 128, then where n1 = N/2 > 128
NARROW = [(1, 96, 96), (2, 13, 96), (3, 106, 106), (1, 37, 106),
          (1, 160, 160), (1, 224, 224), (1, 384, 384), (2, 301, 768),
          (1, 1536, 1536), (1, 13, 1536), (1, 1, 1536), (1, 3072, 3072),
          (1, 7, 6144)]
WIDE = [(2, 37, 270), (1, 1000, 1000), (1, 64, 2042), (1, 1, 8186),
        (1, 8, 8186)]
CASES = [(store, shape) for shape in NARROW + WIDE
         for store in ("transposed", "natural")]
TO_PLAIN, TO_F64, F64_SPREAD = 2e-3, 1e-2, 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    planes.named_launches.clear()
    return torch.device("cuda")


def _planes(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for _ in range(2)]


def _rel(got, want):
    scale = max(w.abs().max().item() for w in want)
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("store,shape", CASES,
                         ids=[f"{s}-{'x'.join(map(str, sh))}"
                              for s, sh in CASES])
def test_bf16_mixed_kernel_matches_plain_and_float64(cuda, store, shape,
                                                     inverse):
    natural = store == "natural"
    fn, plain = ((planes.fft1d_natural_large,
                  planes.fft1d_natural_large_plain) if natural else
                 (planes.fft1d_transposed, planes.fft1d_transposed_plain))
    re, im = _planes(shape, cuda, seed=shape[-1] + shape[-2])
    got = fn(re, im, inverse, "bfloat16")
    torch.cuda.synchronize()
    assert dict(planes.named_launches) == dict.fromkeys(
        planes.bf16_rows_launches(shape[-1], natural), 1)
    want = plain(re, im, inverse, "bfloat16")
    assert _rel(got, want) <= TO_PLAIN
    z = torch.complex(re.double(), im.double())
    ref = (torch.fft.ifft(z, dim=-1, norm="forward") if inverse
           else torch.fft.fft(z, dim=-1))
    if not natural:
        ref = ref.transpose(-1, -2)
    ref = (ref.real, ref.imag)
    err = _rel(got, ref)
    assert err <= TO_F64
    if shape[0] * shape[1] >= 64:
        # over fewer rows one C ⊙ T rounded the other way in one of the two
        # moves the max error by a few percent
        assert err <= (1 + F64_SPREAD) * _rel(want, ref)


def test_the_matrix_entry_refuses_bf16_direct(cuda):
    """tpu_matrix_rows_any at tier bf16, direct form, either store: refused
    (a CUDA error), never run; bf16 direct runs tpu_bf16_rows_mixed."""
    from tpu_ocean_torch import _build
    lib = _build.load().lib
    re, im = _planes((1, 2, 96), cuda)
    out = torch.empty(2, 96, 2, device=cuda)
    tables = planes.matrix_tables(96, True, False, cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for natural in (0, 1):
        err = lib.tpu_matrix_rows_any(
            re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
            tables.data_ptr(), 1, 2, 96, 1, natural, planes.TIERS["bf16"], 0,
            stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.load().check(err, "tpu_matrix_rows_any")


#: what tpu_bf16_rows_mixed refuses: (n, rows, scratch)
REFUSED = {"power_of_two": (1024, 1, False), "odd": (95, 1, False),
           "short": (14, 1, False), "long": (8194, 1, False),
           "rows": (96, 3, False), "no_rows": (96, 0, False),
           "smem": (6144, 16, False), "wide_rows": (2042, 2, True),
           "wide_no_scratch": (2042, 1, False)}


@pytest.mark.parametrize("what", list(REFUSED))
def test_the_bf16_entry_refuses_what_it_does_not_take(cuda, what):
    """A power of two, an odd N or one outside [16, 8192], rows not a power
    of two or none, a block beyond the card's shared memory (16 rows of
    6144), rows ≠ 1 or no X′ buffer where n1 = N/2 > 128: refused, never
    run; the next launch is not disturbed."""
    from tpu_ocean_torch import _build
    n, rows, with_scratch = REFUSED[what]
    lib = _build.load().lib
    re, im = _planes((1, 2, n), cuda)
    out = torch.empty(2, n, 2, device=cuda)
    tables = planes.bf16_rows_tables(96, True, cuda)   # never read
    scratch = torch.empty(max(1, planes.bf16_rows_scratch_words(1, 2, n))
                          if with_scratch else 0, dtype=torch.int32,
                          device=cuda)
    err = lib.tpu_bf16_rows_mixed(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr(),
        tables.data_ptr(), scratch.data_ptr() if with_scratch else None, 1,
        2, n, rows, 0, planes.TIERS["bf16"],
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.load().check(err, "tpu_bf16_rows_mixed")
    good = _planes((1, 4, 106), cuda)
    assert _rel(planes.fft1d_transposed(*good, True, "bfloat16"),
                planes.fft1d_transposed_plain(*good, True, "bfloat16")) \
        <= TO_PLAIN
