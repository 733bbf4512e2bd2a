"""The bf16x3 row kernel in the direct form (csrc/dft_bf16_rows_mixed.cuh at
tier bf16x3: #1 and #2 at the B3 tier) on the CPU, where the kernel itself
cannot run (its card tests are in tests/test_torch_bf16x3_rows_cuda.py):

- Its tables (planes.bf16x3_rows_tables_np), bit for bit: where n1 ≤ 128
  (N = 16, 96, 106, 128, 384, 1024, 1536) F2 and T are _tables_np's f32
  values (F2's rows zero past n2 to whole shares of 16) and F1's hi and lo
  A fragments unpack to fft/matrix.py split_bf16(F1), zero past n1; where
  n1 = N/2 > 128 (N = 270, 2042) F1's hi and lo complex pairs are the same
  split, zero past n1, then T[1, ·] and F2 in f32.
- A numpy model of each regime's stage order as the kernel runs it, from
  the tables as the kernel reads them (F1's lo part as the complex pairs of
  its fragments, in their order): regime 1's f32 rows, stage 1 in f32
  over F2's shares of the header's b3_share outputs, its epilogue (C ⊙ T
  with each product and sum rounded alone, split once into hi and lo,
  zeros past n1), stage 2's three products (hi·hi in one sum, hi·lo + lo·hi in
  another, added once) from F1's hi fragments and its lo fragments read as
  pairs, the result at r·(N + 1) + k1·n2 + k2 and both stores at R rows a
  block with a ragged last block; regime 2's stage-1 launch (F2's f32
  product, C[1] ⊙ T[1, ·], X′'s hi and lo planes, zeros past n1), the
  tiled product's raster (every tile once), its sums promoted into f32
  every 128 complex of depth and its stores through the result tile. Every
  output written once, no row past M. Against fft/matrix.py rows_dft at
  tier bf16x3 (the plain version) within 1e-5·max: the same operands, the
  f32 sums in another order; against JAX's pallas_fft at B3 within
  TO_JAX["bf16x3"] = 5e-5·max (JAX run as tests/test_torch_sizes_matrix.py
  runs it: Pallas in interpret mode, KERNEL_B3_THRESHOLD monkeypatched in
  both packages); against float64 within 5e-5·max.
- The geometry at every even N in [16, 8192]: the shared memory and rows
  of a block against the card's 227 KB, the launch names, and the
  header's constants against the Python geometry.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean_torch.fft import matrix, planes
from tests.test_torch_bf16_mixed import (_bf16_value, _f32, _raster,
                                         _rounded, _store, _twiddle,
                                         _unpack_fragments)
from tests.test_torch_precision import (JAX_PRECISION, TO_F64, TO_JAX,
                                        _planes_np, _rel)

HEADER = (Path(planes.__file__).resolve().parent.parent / "csrc"
          / "dft_bf16_rows_mixed.cuh")
#: regime 1: n1 = N/2 < 128 (8, 48, 53), n1 = 128 (n2 = 1, 3, 8, 12)
NARROW = (16, 96, 106, 128, 384, 1024, 1536)
#: regime 2: n1 = N/2 > 128 (135, 1021)
WIDE = (270, 2042)
#: model against plain: the same operands, the f32 sums in another order
TO_PLAIN = 1e-5
SMS = 132


def _share(n):
    """The stage-1 outputs one thread computes where n1 ≤ 128, as the
    header's b3_share states them: 8 from n2 = 5, else the next power of
    two ≥ n2."""
    n2 = n // planes._split_lanes(n)[0]
    return 8 if n2 > 4 else 4 if n2 > 2 else n2


def _split(x):
    """matrix.split_bf16 on f32 values: (hi, lo) as f32 values."""
    hi, lo = matrix.split_bf16(torch.from_numpy(_f32(x)))
    return hi.numpy(), lo.numpy()


def _pairs(words):
    """Complex bf16 pairs (re low) → (re, im) bits."""
    words = np.asarray(words, np.uint32)
    return words & 0xFFFF, words >> 16


def _narrow_tables(n, inverse):
    """Regime 1's tables as the kernel reads them: F2 [f2 rows, n2] and T
    [n2, n1] as complex f32 (re, im pairs), F1's hi fragments and its lo
    pairs in fragment order, each unpacked to (re, im) bf16 bits
    [n1p, n1p]."""
    n1, n2 = planes._split_lanes(n)
    kt2 = -(-n1 // 8)
    rows = planes.bf16x3_f2_rows(n2)
    words = planes.bf16x3_rows_tables_np(n, inverse).view(np.uint32)
    f2 = words[:2 * rows * n2].view(np.float32).reshape(rows, n2, 2)
    at = 2 * rows * n2
    t = words[at:at + 2 * n].view(np.float32).reshape(n2, n1, 2)
    at += 2 * n
    frag = kt2 * kt2 * 128
    assert words.size == at + frag + frag // 2
    hi = _unpack_fragments(words[at:at + frag], kt2, kt2)
    return f2, t, hi, _unpack_pairs(words[at + frag:], kt2)


def _unpack_pairs(words, kt):
    """F1's lo pairs [kt, kt, 32, 2] in A-fragment order (tile (tm, kb),
    lane (g, q): row 8·tm + g, depths 8·kb + 2q + h) → (re, im) bits."""
    w = np.asarray(words, np.uint32).reshape(kt, kt, 32, 2)
    lane = np.arange(32)
    i = 8 * np.arange(kt)[:, None, None] + lane // 4
    re_ = np.zeros((8 * kt, 8 * kt), np.uint32)
    im_ = np.zeros_like(re_)
    for h in (0, 1):
        k = 8 * np.arange(kt)[None, :, None] + 2 * (lane % 4) + h
        re_[i, k], im_[i, k] = _pairs(w[..., h])
    return re_, im_


def _wide_tables(n, inverse):
    """Regime 2's: F1's hi and lo pairs [table rows, ldk] as (re, im)
    bits, T[1, ·] [n1, 2] and F2 [2, 2, 2] in f32."""
    n1 = n // 2
    rows, ldk = planes.bf16_gemm_rows(n1), planes.bf16_gemm_depth(n1)
    words = planes.bf16x3_rows_tables_np(n, inverse).view(np.uint32)
    assert words.size == 2 * rows * ldk + 2 * n1 + 8
    hi = _pairs(words[:rows * ldk].reshape(rows, ldk))
    lo = _pairs(words[rows * ldk:2 * rows * ldk].reshape(rows, ldk))
    rest = words[2 * rows * ldk:].view(np.float32)
    return hi, lo, rest[:2 * n1].reshape(n1, 2), rest[2 * n1:].reshape(2, 2, 2)


def _padded_bits(x, rows, cols):
    out = np.zeros((rows, cols), np.uint32)
    out[:x.shape[0], :x.shape[1]] = planes._bf16_bits(x)
    return out


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", NARROW)
def test_narrow_tables_are_the_f32_tables_and_their_split(n, inverse):
    n1, n2, f2r, f2i, tr, ti, f1r, f1i = planes._tables_np(n, inverse)
    assert n1 <= 128 and not planes.bf16_wide(n)
    f2, t, hi, lo = _narrow_tables(n, inverse)
    np.testing.assert_array_equal(f2[:n2, :, 0], f2r)
    np.testing.assert_array_equal(f2[:n2, :, 1], f2i)
    assert not f2[n2:].any()
    np.testing.assert_array_equal(t[..., 0], tr)
    np.testing.assert_array_equal(t[..., 1], ti)
    side = 8 * -(-n1 // 8)
    (hr, lr), (hi_, li) = _split(f1r), _split(f1i)
    for got, want in ((hi[0], hr), (hi[1], hi_), (lo[0], lr), (lo[1], li)):
        np.testing.assert_array_equal(got, _padded_bits(want, side, side))


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", WIDE)
def test_wide_tables_are_the_f32_tables_and_their_split(n, inverse):
    n1, n2, f2r, f2i, tr, ti, f1r, f1i = planes._tables_np(n, inverse)
    assert n2 == 2 and n1 > 128 and planes.bf16_wide(n)
    hi, lo, t1, f2 = _wide_tables(n, inverse)
    shape = hi[0].shape
    assert shape == (-(-n1 // 64) * 64, -(-n1 // 32) * 32)
    (hr, lr), (hi_, li) = _split(f1r), _split(f1i)
    for got, want in ((hi[0], hr), (hi[1], hi_), (lo[0], lr), (lo[1], li)):
        np.testing.assert_array_equal(got, _padded_bits(want, *shape))
    np.testing.assert_array_equal(t1[:, 0], tr[1])
    np.testing.assert_array_equal(t1[:, 1], ti[1])
    np.testing.assert_array_equal(f2[..., 0], f2r)
    np.testing.assert_array_equal(f2[..., 1], f2i)


# ------------------------------------------------------- the numpy models

def _complex(pair):
    """Complex f32 (re, im) pairs [..., 2] → complex128 of those values."""
    return pair[..., 0].astype(np.float64) + 1j * pair[..., 1]


def _to_f32(z):
    """A complex sum, exact in float64 (products of f32 or bf16 values),
    rounded to f32 in re and im: an f32 accumulation in some order."""
    return _f32(z.real), _f32(z.imag)


def _split_c(vr, vi):
    """C ⊙ T split once: (hi, lo) complex128 of bf16 values."""
    (hr, lr), (hi_, li) = _split(vr), _split(vi)
    return hr + 1j * hi_.astype(np.float64), lr + 1j * li.astype(np.float64)


def _three(f_hi, f_lo, y_hi, y_lo):
    """hi·hi into one f32 sum, hi·lo + lo·hi into another, added in f32."""
    dr, di = _to_f32(f_hi @ y_hi)
    er, ei = _to_f32(f_hi @ y_lo + f_lo @ y_hi)
    return _f32(dr + er) + 1j * _f32(di + ei).astype(np.float64)


def _model_narrow(re_, im_, inverse, natural, R):
    """Regime 1 block by block, R rows a block, on one channel [M, N]."""
    M, n = re_.shape
    n1, n2 = planes._split_lanes(n)
    n1p = 8 * -(-n1 // 8)
    share = _share(n)
    f2, t, hi, lo = _narrow_tables(n, inverse)
    f2c = _complex(f2)
    f1_hi = _bf16_value(hi[0]) + 1j * _bf16_value(hi[1]).astype(np.float64)
    f1_lo = _bf16_value(lo[0]) + 1j * _bf16_value(lo[1]).astype(np.float64)
    out = np.full(M * n, np.nan, np.complex64)
    written = np.zeros(M * n, int)
    for m0 in range(0, M, R):
        live = min(R, M - m0)
        # the load: the rows as complex f32 at r·N + n, rows past M zero
        x = np.zeros((R, n), np.complex128)
        x[:live] = re_[m0:m0 + live] + 1j * im_[m0:m0 + live].astype(
            np.float64)
        x = x.reshape(R, n2, n1)
        # stage 1 by shares of `share` outputs over F2's padded rows (each
        # k2 < n2 once); the epilogue: C ⊙ T, split once, zeros past n1
        y_hi = np.zeros((R, n2, n1p), np.complex128)
        y_lo = np.zeros_like(y_hi)
        for k0 in range(0, n2, share):
            ks = slice(k0, min(k0 + share, n2))
            cr, ci = _to_f32(np.einsum("ks,rst->rkt", f2c[ks], x))
            vr, vi = _twiddle(cr, ci, t[ks, :, 0], t[ks, :, 1])
            y_hi[:, ks, :n1], y_lo[:, ks, :n1] = _split_c(vr, vi)
        # stage 2 over the columns (r, k2): X[k1·n2 + k2]
        cols = lambda y: y.transpose(2, 0, 1).reshape(n1p, R * n2)
        z = _three(f1_hi, f1_lo, cols(y_hi), cols(y_lo))   # [n1p, R·n2]
        res = np.zeros((R, n + 1), np.complex64)
        res[:, :n] = z[:n1].reshape(n1, R, n2).transpose(1, 0, 2).reshape(
            R, n)
        _store(res, M, n, R, m0, live, natural, out, written)
    assert (written == 1).all()
    return out.reshape((M, n) if natural else (n, M))


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text()).group(1))


def _model_wide(re_, im_, inverse, natural):
    """Regime 2 on [C, M, N]: the stage-1 launch, then the tiled product."""
    C, M, n = re_.shape
    n1 = n // 2
    ldk = planes.bf16_gemm_depth(n1)
    hi, lo, t1, f2 = _wide_tables(n, inverse)
    f_hi = _bf16_value(hi[0]) + 1j * _bf16_value(hi[1]).astype(np.float64)
    f_lo = _bf16_value(lo[0]) + 1j * _bf16_value(lo[1]).astype(np.float64)
    f2c = _complex(f2)
    # gemm_prep_kernel: X′'s hi and lo planes [(c·M + m)·2 + k2, t], zeros
    # past n1
    x = (re_ + 1j * im_.astype(np.float64)).reshape(C * M, n)
    x0, x1 = x[:, :n1], x[:, n1:]
    c0 = _to_f32(f2c[0, 0] * x0 + f2c[0, 1] * x1)
    c1 = _to_f32(f2c[1, 0] * x0 + f2c[1, 1] * x1)
    d1 = _twiddle(*c1, t1[:, 0], t1[:, 1])
    xp_hi = np.zeros((C * M, 2, ldk), np.complex128)
    xp_lo = np.zeros_like(xp_hi)
    xp_hi[:, 0, :n1], xp_lo[:, 0, :n1] = _split_c(*c0)
    xp_hi[:, 1, :n1], xp_lo[:, 1, :n1] = _split_c(*d1)
    xp_hi, xp_lo = xp_hi.reshape(-1, ldk), xp_lo.reshape(-1, ldk)
    cols = 2 * C * M
    # the product, the three into one sum promoted into f32 every 128
    # complex of depth
    acc_r = np.zeros((f_hi.shape[0], cols), np.float32)
    acc_i = np.zeros_like(acc_r)
    for k in range(0, ldk, 128):
        ks = slice(k, k + 128)
        pr, pi = _to_f32(f_hi[:, ks] @ xp_hi[:, ks].T
                         + f_hi[:, ks] @ xp_lo[:, ks].T
                         + f_lo[:, ks] @ xp_hi[:, ks].T)
        acc_r, acc_i = _f32(acc_r + pr), _f32(acc_i + pi)
    y = acc_r + 1j * acc_i                      # [k1 rows, cols]
    # the raster and the stores through the 64 × 64 tile
    tile, group = planes.BF16_GEMM_TILE, _header_int("kGroup")
    k1_tiles, col_tiles = f_hi.shape[0] // tile, -(-cols // tile)
    tiles = _raster(k1_tiles, col_tiles, group)
    assert sorted(tiles) == [(a, b) for a in range(k1_tiles)
                             for b in range(col_tiles)]
    out = np.full(C * M * n, np.nan, np.complex64)
    written = np.zeros(C * M * n, int)
    p = np.arange(2 * tile)
    for tk, tc in tiles:
        e = np.zeros((tile, tile), np.complex64)   # e[k1][col]
        live = y[tk * tile:(tk + 1) * tile, tc * tile:(tc + 1) * tile]
        e[:, :live.shape[1]] = live
        k0, cm0 = 2 * tk * tile, tc * tile // 2
        for mm in range(tile // 2):
            cm = cm0 + mm
            keep = (k0 + p < n) & (cm < C * M)
            vals = e[p >> 1, 2 * mm + (p & 1)][keep]
            if natural:
                o = cm * n + k0 + p[keep]
            else:
                c, m = divmod(cm, M)
                o = (c * n + k0 + p[keep]) * M + m
            np.add.at(written, o, 1)
            out[o] = vals
    assert (written == 1).all()
    return out.reshape((C, M, n) if natural else (C, n, M))


@pytest.fixture
def b3(monkeypatch):
    """KERNEL_B3_THRESHOLD at 0 in both packages: every length at bf16x3."""
    for mod in (pf, planes):
        monkeypatch.setattr(mod, "KERNEL_B3_THRESHOLD", 0)


def _plain(re_, im_, inverse, natural):
    fn = (planes.fft1d_natural_large if natural else planes.fft1d_transposed)
    r, i = fn(torch.from_numpy(re_), torch.from_numpy(im_), inverse,
              "float32")
    return r.numpy() + 1j * i.numpy()


def _jax(re_, im_, natural):
    jfn = pf.fft1d_natural_large if natural else pf._fft1d_transposed
    jr, ji = jfn(jnp.asarray(re_), jnp.asarray(im_), True,
                 JAX_PRECISION["float32"])
    return np.asarray(jr) + 1j * np.asarray(ji)


def _f64(re_, im_, natural):
    f = np.fft.ifft(re_.astype(np.float64) + 1j * im_, axis=-1) * re_.shape[-1]
    return f if natural else np.swapaxes(f, -1, -2)


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("n", NARROW)
def test_narrow_model_matches_plain_jax_and_float64(b3, n, natural):
    """Regime 1 at the rows the wrapper gives 16 rows and at R = 4 on 13
    (a ragged last block), both directions; against JAX at B3 (the
    inverse) and float64."""
    assert planes.engine(n, "float32", not natural) == ("bf16x3", False)
    M = 16
    rows = planes.rows_per_block(1, M, n, SMS, planes.max_rows(
        n, natural, "bf16x3", False), planes.bf16x3_rows_shared_bytes)
    re_, im_ = _planes_np((1, M, n), seed=n)
    for inverse in (True, False):
        for m, R in ((M, rows), (M - 3, 4)):
            got = _model_narrow(re_[0, :m], im_[0, :m], inverse, natural, R)
            want = _plain(re_[:, :m], im_[:, :m], inverse, natural)[0]
            assert _rel(got, want) <= TO_PLAIN
    got = _model_narrow(re_[0], im_[0], True, natural, rows)
    assert _rel(got, _jax(re_, im_, natural)[0]) <= TO_JAX["bf16x3"]
    assert _rel(got, _f64(re_[0], im_[0], natural)) <= TO_F64["bf16x3"]


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("n", WIDE)
def test_wide_model_matches_plain_jax_and_float64(b3, n, natural):
    """Regime 2 at C = 2 channels of a ragged M (the last column tile part
    empty, a tile across the channels), both directions; against JAX at B3
    on one channel of 16 rows, and float64."""
    assert planes.engine(n, "float32", not natural) == ("bf16x3", False)
    re_, im_ = _planes_np((2, 37, n), seed=n)
    for inverse in (True, False):
        got = _model_wide(re_, im_, inverse, natural)
        assert _rel(got, _plain(re_, im_, inverse, natural)) <= TO_PLAIN
    re_, im_ = re_[:1, :16], im_[:1, :16]
    got = _model_wide(re_, im_, True, natural)
    assert _rel(got, _jax(re_, im_, natural)) <= TO_JAX["bf16x3"]
    assert _rel(got, _f64(re_, im_, natural)) <= TO_F64["bf16x3"]


# --------------------------------------------- blocks, names, the header

def test_every_even_length_has_a_bf16x3_block():
    """At every even N in [16, 8192], both stores, at M = N and 1 and
    C = 1 and 5: the rows are a power of two within the store's cap (1
    where n1 = N/2 > 128) and the block fits the card's shared memory;
    X′'s buffer is twice the bf16 one; the names are one launch where
    n1 ≤ 128, two elsewhere, and no launch runs the matrix engine; where
    n1 ≤ 128 F2 fits the region of F1's lo pairs, where stage 1 reads
    it."""
    for n in range(planes.MIN_N, planes.MAX_N + 1, 2):
        wide = planes.bf16_wide(n)
        for natural in (False, True):
            assert (planes.block_shared_bytes("bf16x3", False, natural)
                    is planes.bf16x3_rows_shared_bytes)
            cap = planes.max_rows(n, natural, "bf16x3", False)
            assert cap == 1 if wide else cap >= 1
            for c, m in ((1, n), (5, n), (1, 1)):
                rows = planes.rows_per_block(c, m, n, SMS, cap,
                                             planes.bf16x3_rows_shared_bytes)
                assert rows & (rows - 1) == 0 and 1 <= rows <= cap
                assert (planes.bf16x3_rows_shared_bytes(rows, n)
                        <= planes.SMEM_LIMIT), (n, natural, c, m)
                assert planes.bf16x3_rows_scratch_words(c, m, n) == (
                    4 * c * m * (-(-n // 64) * 32) if wide else 0)
            kind = "rows_natural" if natural else "rows_transposed"
            names = planes.bf16x3_rows_launches(n, natural)
            assert names == planes.direct_rows_launches(n, natural, "bf16x3")
            assert names == ([planes.BF16X3_GEMM_PREP,
                              planes.BF16X3_GEMM_NAMES[kind]] if wide
                             else [planes.BF16X3_NAMES[kind]])
            assert not any(name.startswith("matrix_") for name in names)
        if not wide:
            # F2, s-major, sits over F1's lo pairs' region during stage 1
            n1, n2 = planes._split_lanes(n)
            n1p = 8 * -(-n1 // 8)
            assert n2 * planes.bf16x3_f2_rows(n2) * 8 <= n1p * n1p * 4, n


@pytest.mark.parametrize("n", [16, 64, 128, 1024, 1536, 4096, 8192])
def test_regime_one_shared_memory_is_the_headers(n):
    """The rows as complex f32 aliased by the result, C ⊙ T's hi and lo
    planes at the header's y_stride, F1's lo pairs (n1p² × 4 B), as
    b3_shared_bytes states them; the stage-1 share as b3_share's rule."""
    n1, n2 = planes._split_lanes(n)
    n1p = 8 * -(-n1 // 8)
    for rows in (1, 2, 4, 8):
        want = (-(-rows * (n + 1) * 8 // 16) * 16
                + 2 * rows * n2 * (n1p + 8 + (n1p & 8)) * 4 + n1p * n1p * 4)
        assert planes.bf16x3_rows_shared_bytes(rows, n) == want
    share = _share(n)
    assert share in (1, 2, 4, 8) and 16 % share == 0
    assert share >= min(n2, 8) and (share == 8 or share < 2 * n2)
    assert planes.bf16x3_f2_rows(n2) % share == 0


def test_the_header_states_the_python_geometry():
    """BF16X3_GEMM_SHARED is the header's kSmemBytesBf16x3 (three stages
    of each operand's hi and lo rows), the share rule and F2's padded rows
    are b3_share's and b3_f2_rows', and the C entry takes the tier."""
    text = HEADER.read_text()
    stride = _header_int("kChunk") + 8
    stage = (_header_int("kBM") + _header_int("kBN")) * stride * 4
    assert "kSmemBytesBf16x3 = 2 * kStages * kStageWords * 4;" in text
    assert planes.BF16X3_GEMM_SHARED == 2 * _header_int("kStages") * stage
    assert "return n2 > 4 ? 8 : n2 > 2 ? 4 : n2;" in text
    assert "return (n2 + 15) / 16 * 16;" in text
    entry = (HEADER.parent / "bf16_rows_mixed.cu").read_text()
    assert re.search(r"int rows, int natural,\s+int tier, void\* stream\)",
                     entry)
