"""The bf16 row kernel at even lengths that are not powers of two
(csrc/dft_bf16_rows_mixed.cuh: #1 and #2 at precision="bfloat16") on the
CPU, where the kernel itself cannot run (its card tests are in
tests/test_torch_bf16_mixed_cuda.py):

- Its tables (planes.bf16_rows_tables_np): where n1 ≤ 128 (N = 96, 106,
  160, 384, 1536) the A fragments unpack to the bf16-rounded F2 and F1 of
  _tables_np, zero past n2 and n1, and T is the f32 table itself; where
  n1 = N/2 > 128 (N = 270, 2042) F1's complex pairs are the rounded F1,
  zero past n1, and T[1, ·] the f32 row. Bit for bit.
- The root table that regime 2 could build tiles from,
  w[(k1·t) mod n1]: bit-equal to the rounded F1 at n1 = 1021 and 4093
  (prime); at n1 = 135 it differs exactly where sin(2π·k1·t/n1) is an
  exact zero that the float64 table holds as a residue below 1e-12.
- A numpy model of each regime's stage order as the kernel runs it, from
  the tables as the kernel reads them: regime 1's load into the padded
  rows, stage 1 on F2's fragments over the padded depth, its C ⊙ T
  epilogue (each product and sum rounded alone, zeros past n1), stage 2
  on F1's fragments, the result at r·(N + 1) + k1·n2 + k2 and both stores
  at R rows a block with a ragged last block; regime 2's stage-1 launch
  into X′ (zeros past n1), the tiled product's raster (every tile once),
  its sums promoted into f32 every 128 complex of depth and its stores
  through the result tile. Every output written once, no row past M.
  Against fft/matrix.py rows_dft at tier bf16 (the plain version) within
  1e-3·max: the kernel's and the plain version's operands are the same
  bf16 values, only the f32 sums' order differs (a sum that lands near a
  bf16 rounding boundary can round C ⊙ T one way in one and the other way
  in the other: ~1e-5·max); against JAX's pallas_fft at DEFAULT within the
  bands of tests/test_torch_sizes_matrix.py (3e-2·max; 1e-2·max of
  float64), JAX run as that file runs it.
- The padded strides' bank arithmetic at every n1p the kernel meets, the
  shared memory and rows of a block at every even N, the launch names,
  and the geometry the header states.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean_torch.fft import planes
from tests.test_torch_precision import (JAX_PRECISION, TO_F64, TO_JAX,
                                        _planes_np, _rel)

HEADER = (Path(planes.__file__).resolve().parent.parent / "csrc"
          / "dft_bf16_rows_mixed.cuh")
#: regime 1: n1 = N/2 < 128 (48, 53, 80) and n1 = 128 (n2 = 3, 12)
NARROW = (96, 106, 160, 384, 1536)
#: regime 2: n1 = N/2 > 128 (135, 1021)
WIDE = (270, 2042)
#: model against plain: the same bf16 operands, the f32 sums in another
#: order
TO_PLAIN = 1e-3
SMS = 132


def _bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _rounded(x):
    """f32 → the nearest bfloat16 (ties to even), as f32 values."""
    return _bf16_value(planes._bf16_bits(np.asarray(x, np.float32)))


def _unpack_fragments(words, mt, kt):
    """planes.mma_a_fragments' layout back to the complex table's (re, im)
    bf16 bits [8·mt, 8·kt], checking that the four registers of a lane
    hold (Fr, −Fi), (Fi, Fr) at its two depths."""
    f = np.asarray(words, np.uint32).reshape(mt, kt, 32, 4)
    lane = np.arange(32)
    i = 8 * np.arange(mt)[:, None, None] + lane // 4
    re_ = np.zeros((8 * mt, 8 * kt), np.uint32)
    im_ = np.zeros_like(re_)
    for h in (0, 1):
        top, bottom = f[..., 2 * h], f[..., 2 * h + 1]
        np.testing.assert_array_equal(top & 0xFFFF, bottom >> 16)
        np.testing.assert_array_equal(top >> 16, (bottom & 0xFFFF) ^ 0x8000)
        k = 8 * np.arange(kt)[None, :, None] + 2 * (lane % 4) + h
        re_[i, k] = top & 0xFFFF
        im_[i, k] = bottom & 0xFFFF
    return re_, im_


def _padded_bits(x, rows, cols):
    out = np.zeros((rows, cols), np.uint32)
    out[:x.shape[0], :x.shape[1]] = planes._bf16_bits(x)
    return out


def _narrow_tables(n, inverse):
    """Regime 1's tables as the kernel reads them: (F2, F1) as complex
    bf16 values padded to whole tiles, T as complex f32 [n2, n1]."""
    n1, n2 = planes._split_lanes(n)
    kt1, kt2 = -(-n2 // 8), -(-n1 // 8)
    words = planes.bf16_rows_tables_np(n, inverse).view(np.uint32)
    f2_words = kt1 * kt1 * 128
    assert words.size == f2_words + 2 * n + kt2 * kt2 * 128
    f2 = _unpack_fragments(words[:f2_words], kt1, kt1)
    t = words[f2_words:f2_words + 2 * n].view(np.float32).reshape(n2, n1, 2)
    f1 = _unpack_fragments(words[f2_words + 2 * n:], kt2, kt2)
    return f2, t, f1


def _wide_tables(n, inverse):
    """Regime 2's: F1's pairs [table rows, ldk] as (re, im) bits, T[1, ·]."""
    n1 = n // 2
    rows, ldk = planes.bf16_gemm_rows(n1), planes.bf16_gemm_depth(n1)
    words = planes.bf16_rows_tables_np(n, inverse).view(np.uint32)
    assert words.size == rows * ldk + 2 * n1
    f1 = words[:rows * ldk].reshape(rows, ldk)
    t1 = words[rows * ldk:].view(np.float32).reshape(n1, 2)
    return f1 & 0xFFFF, f1 >> 16, t1


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", NARROW)
def test_narrow_tables_are_the_f32_tables_rounded(n, inverse):
    n1, n2, f2r, f2i, tr, ti, f1r, f1i = planes._tables_np(n, inverse)
    assert n1 <= 128 and not planes.bf16_wide(n)
    (f2_re, f2_im), t, (f1_re, f1_im) = _narrow_tables(n, inverse)
    kt1, kt2 = -(-n2 // 8), -(-n1 // 8)
    for got, want, side in ((f2_re, f2r, kt1), (f2_im, f2i, kt1),
                            (f1_re, f1r, kt2), (f1_im, f1i, kt2)):
        np.testing.assert_array_equal(got, _padded_bits(want, 8 * side,
                                                        8 * side))
    np.testing.assert_array_equal(t[..., 0], tr)
    np.testing.assert_array_equal(t[..., 1], ti)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", WIDE)
def test_wide_tables_are_the_f32_tables_rounded(n, inverse):
    n1, n2, _, _, tr, ti, f1r, f1i = planes._tables_np(n, inverse)
    assert n2 == 2 and n1 > 128 and planes.bf16_wide(n)
    got_re, got_im, t1 = _wide_tables(n, inverse)
    shape = got_re.shape
    assert shape == (-(-n1 // 64) * 64, -(-n1 // 32) * 32)
    np.testing.assert_array_equal(got_re, _padded_bits(f1r, *shape))
    np.testing.assert_array_equal(got_im, _padded_bits(f1i, *shape))
    np.testing.assert_array_equal(t1[:, 0], tr[1])
    np.testing.assert_array_equal(t1[:, 1], ti[1])


@pytest.mark.parametrize("n1", [135, 1021, 4093])
def test_root_tiles_against_the_rounded_table(n1):
    """w[(k1·t) mod n1], the n1 roots rounded once, against the table's
    F1 (both directions): bit-equal at the primes; at 135 only where the
    table's sine of a whole turn is the float64 residue of an exact 0."""
    n = 2 * n1
    try:
        for inverse in (True, False):
            got_re, got_im, _ = _wide_tables(n, inverse)
            got_re, got_im = got_re[:n1, :n1], got_im[:n1, :n1]
            sign = 1.0 if inverse else -1.0
            w = np.exp(sign * 2j * np.pi * np.arange(n1) / n1)
            e = np.outer(np.arange(n1), np.arange(n1)) % n1
            np.testing.assert_array_equal(
                got_re, planes._bf16_bits(w.real.astype(np.float32))[e])
            roots_im = planes._bf16_bits(w.imag.astype(np.float32))[e]
            differ = got_im != roots_im
            if n1 in (1021, 4093):
                assert not differ.any()
            else:
                # exactly the entries with k1·t ≡ 0 mod n1 off the axes
                residue = (e == 0) & (np.arange(n1)[:, None] > 0) & (
                    np.arange(n1)[None, :] > 0)
                assert differ.sum() == 460
                np.testing.assert_array_equal(differ, residue & (got_im != 0))
                assert (np.abs(_bf16_value(got_im[differ])) < 1e-12).all()
                assert (roots_im[differ] == 0).all()
    finally:
        planes.bf16_rows_tables_np.cache_clear()
        planes._tables_np.cache_clear()


# ------------------------------------------------------- the numpy models

def _f32(x):
    return np.asarray(x, np.float32)


def _cmatmul_bf16(ar, ai, br, bi):
    """(ar + i·ai) @ (br + i·bi) of bf16 values, the real form's four
    exact products summed in float64 and rounded to f32 once: an f32
    accumulation in some order."""
    a = [x.astype(np.float64) for x in (ar, ai, br, bi)]
    return (_f32(a[0] @ a[2] - a[1] @ a[3]), _f32(a[1] @ a[2] + a[0] @ a[3]))


def _twiddle(cr, ci, wr, wi):
    """C ⊙ T in f32, each product and sum rounded alone (__fmul_rn …)."""
    cr, ci, wr, wi = map(_f32, (cr, ci, wr, wi))
    return _f32(_f32(cr * wr) - _f32(ci * wi)), _f32(_f32(cr * wi)
                                                     + _f32(ci * wr))


def _store(res, M, n, R, m0, live, natural, out, written):
    """The two stores of a block's result res [R, N + 1] (complex): natural
    out[m0 + r, k] from res[idx + idx // N]; transposed out[k, m0 + r],
    r = idx & (R − 1), k = idx >> log2 R, r < live."""
    flat = res.ravel()
    if natural:
        idx = np.arange(live * n)
        o = m0 * n + idx
        vals = flat[idx + idx // n]
    else:
        idx = np.arange(R * n)
        r, k = idx & (R - 1), idx >> (R.bit_length() - 1)
        keep = r < live
        o = (k * M + m0 + r)[keep]
        vals = flat[(r * (n + 1) + k)[keep]]
    np.add.at(written, o, 1)
    out[o] = vals


def _model_narrow(re_, im_, inverse, natural, R):
    """Regime 1 block by block, R rows a block, on one channel [M, N]."""
    M, n = re_.shape
    n1, n2 = planes._split_lanes(n)
    kt1, kt2 = -(-n2 // 8), -(-n1 // 8)
    n1p = 8 * kt2
    (f2_re, f2_im), t, (f1_re, f1_im) = _narrow_tables(n, inverse)
    f2r, f2i, f1r, f1i = map(_bf16_value, (f2_re, f2_im, f1_re, f1_im))
    out = np.full(M * n, np.nan, np.complex64)
    written = np.zeros(M * n, int)
    for m0 in range(0, M, R):
        live = min(R, M - m0)
        # the load: rows rounded to bf16 pairs at (r·n2 + s)·xs + t; rows
        # past M zero, padded t never read into a live output
        xr = np.zeros((R, 8 * kt1, n1p), np.float32)
        xi = np.zeros_like(xr)
        xr[:live, :n2, :n1] = _rounded(re_[m0:m0 + live]).reshape(live, n2, n1)
        xi[:live, :n2, :n1] = _rounded(im_[m0:m0 + live]).reshape(live, n2, n1)
        # stage 1 over the padded depth; the epilogue: C ⊙ T, bf16, zeros
        # past n1 (and no row past n2)
        cr, ci = _cmatmul_bf16(f2r, f2i, xr, xi)        # [R, 8·kt1, n1p]
        cr, ci = cr[:, :n2], ci[:, :n2]
        yr, yi = np.zeros((R, n2, n1p), np.float32), np.zeros((R, n2, n1p),
                                                              np.float32)
        tr, ti = _twiddle(cr[..., :n1], ci[..., :n1], t[..., 0], t[..., 1])
        yr[..., :n1], yi[..., :n1] = _rounded(tr), _rounded(ti)
        # stage 2: X[k1·n2 + k2] over the columns (r, k2)
        dr, di = _cmatmul_bf16(f1r, f1i, yr.transpose(0, 2, 1),
                               yi.transpose(0, 2, 1))    # [R, n1p, n2]
        res = np.zeros((R, n + 1), np.complex64)
        res[:, :n] = (dr[:, :n1] + 1j * di[:, :n1]).reshape(R, n)
        _store(res, M, n, R, m0, live, natural, out, written)
    assert (written == 1).all()
    return out.reshape((M, n) if natural else (n, M))


def _raster(k1_tiles, col_tiles, group):
    """gemm_rows_kernel's block → (k1 tile, column tile)."""
    tiles = []
    for b in range(k1_tiles * col_tiles):
        per_group = group * col_tiles
        first = (b // per_group) * group
        in_group = min(group, k1_tiles - first)
        rest = b - (b // per_group) * per_group
        tiles.append((first + rest % in_group, rest // in_group))
    return tiles


def _model_wide(re_, im_, inverse, natural):
    """Regime 2 on [C, M, N]: the stage-1 launch, then the tiled product."""
    C, M, n = re_.shape
    n1 = n // 2
    ldk = planes.bf16_gemm_depth(n1)
    f1_re, f1_im, t1 = _wide_tables(n, inverse)
    fr, fi = _bf16_value(f1_re), _bf16_value(f1_im)
    # gemm_prep_kernel: X′[(c·M + m)·2 + k2, t], zeros past n1
    xr, xi = (_rounded(a).reshape(C * M, n) for a in (re_, im_))
    a, b = (xr[:, :n1], xi[:, :n1]), (xr[:, n1:], xi[:, n1:])
    c1 = (_f32(a[0] - b[0]), _f32(a[1] - b[1]))
    d1 = _twiddle(*c1, t1[:, 0], t1[:, 1])
    xp_re = np.zeros((C * M, 2, ldk), np.float32)
    xp_im = np.zeros_like(xp_re)
    xp_re[:, 0, :n1], xp_im[:, 0, :n1] = (_rounded(_f32(a[0] + b[0])),
                                          _rounded(_f32(a[1] + b[1])))
    xp_re[:, 1, :n1], xp_im[:, 1, :n1] = _rounded(d1[0]), _rounded(d1[1])
    xp_re, xp_im = xp_re.reshape(-1, ldk), xp_im.reshape(-1, ldk)
    cols = 2 * C * M
    # the product, its sums promoted into f32 every 128 complex of depth
    acc_r = np.zeros((fr.shape[0], cols), np.float32)
    acc_i = np.zeros_like(acc_r)
    promote = 128
    for k in range(0, ldk, promote):
        pr, pi = _cmatmul_bf16(fr[:, k:k + promote], fi[:, k:k + promote],
                               xp_re[:, k:k + promote].T,
                               xp_im[:, k:k + promote].T)
        acc_r, acc_i = _f32(acc_r + pr), _f32(acc_i + pi)
    y = acc_r + 1j * acc_i                      # [k1 rows, cols]
    # the raster and the stores through the 64 × 64 tile
    tile, group = planes.BF16_GEMM_TILE, 16
    k1_tiles, col_tiles = fr.shape[0] // tile, -(-cols // tile)
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


def _plain(re_, im_, inverse, natural):
    fn = (planes.fft1d_natural_large if natural else planes.fft1d_transposed)
    r, i = fn(torch.from_numpy(re_), torch.from_numpy(im_), inverse,
              "bfloat16")
    return r.numpy() + 1j * i.numpy()


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("n", NARROW)
def test_narrow_model_matches_plain_and_jax(n, natural):
    """Regime 1 at R = 8 rows (transposed) or the natural store's rows,
    a ragged last block, both directions; against JAX at DEFAULT (the
    inverse) as tests/test_torch_sizes_matrix.py runs it."""
    M = 16
    rows = planes.rows_per_block(1, M, n, SMS, planes.max_rows(
        n, natural, "bf16", False), planes.bf16_rows_shared_bytes)
    re_, im_ = _planes_np((1, M, n), seed=n)
    for inverse in (True, False):
        for m, R in ((M, rows), (M - 3, 4)):        # a ragged last block
            got = _model_narrow(re_[0, :m], im_[0, :m], inverse, natural, R)
            want = _plain(re_[:, :m], im_[:, :m], inverse, natural)[0]
            assert _rel(got, want) <= TO_PLAIN
    jre, jim = jnp.asarray(re_), jnp.asarray(im_)
    jfn = pf.fft1d_natural_large if natural else pf._fft1d_transposed
    jr, ji = jfn(jre, jim, True, JAX_PRECISION["bfloat16"])
    got = _model_narrow(re_[0], im_[0], True, natural, rows)
    assert _rel(got, np.asarray(jr)[0] + 1j * np.asarray(ji)[0]) \
        <= TO_JAX["bf16"]
    f64 = np.fft.ifft(re_[0].astype(np.float64) + 1j * im_[0], axis=-1) * n
    assert _rel(got, f64 if natural else f64.T) <= TO_F64["bf16"]


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("n", WIDE)
def test_wide_model_matches_plain_and_jax(n, natural):
    """Regime 2 at C = 2 channels of a ragged M (the last column tile part
    empty, a tile across the channels), both directions; against JAX at
    DEFAULT on one channel of 16 rows."""
    shape = (2, 37, n)
    re_, im_ = _planes_np(shape, seed=n)
    for inverse in (True, False):
        got = _model_wide(re_, im_, inverse, natural)
        assert _rel(got, _plain(re_, im_, inverse, natural)) <= TO_PLAIN
    re_, im_ = re_[:1, :16], im_[:1, :16]
    jfn = pf.fft1d_natural_large if natural else pf._fft1d_transposed
    jr, ji = jfn(jnp.asarray(re_), jnp.asarray(im_), True,
                 JAX_PRECISION["bfloat16"])
    got = _model_wide(re_, im_, True, natural)
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) <= TO_JAX["bf16"]
    f64 = np.fft.ifft(re_.astype(np.float64) + 1j * im_, axis=-1) * n
    assert _rel(got, f64 if natural else f64.transpose(0, 2, 1)) \
        <= TO_F64["bf16"]


# ------------------------------------------ layouts, blocks, names, header

def _half_warp_banks(words):
    """Banks of one half warp's 64-bit loads: 16 lanes × 2 words."""
    return sorted(w % 32 for w in words)


@pytest.mark.parametrize("n1", [9, 24, 48, 53, 80, 112, 127, 128])
def test_stage2_b_loads_are_conflict_free(n1):
    """Stage 2's 64-bit B load of lane (g, q), g < 4 a half warp, reads
    words col·ys + 8·kb + 2q and + 1 (col = 8·tn + g): 32 distinct banks
    at ys = n1p + 8 + (n1p & 8) for every padded depth; n1p + 8 alone
    would not at n1p = 56 or 40."""
    n1p = -(-n1 // 8) * 8
    ys = n1p + 8 + (n1p & 8)
    for kb in range(n1p // 8):
        words = [g * ys + 8 * kb + 2 * q + h for g in range(4)
                 for q in range(4) for h in (0, 1)]
        assert _half_warp_banks(words) == list(range(32))
    if n1p in (40, 56):
        naive = [g * (n1p + 8) + 2 * q + h for g in range(4)
                 for q in range(4) for h in (0, 1)]
        assert _half_warp_banks(naive) != list(range(32))


def test_gemm_fragment_loads_are_conflict_free():
    """The tiled product's staged rows at 40 words (≡ 8 mod 32): a half
    warp's 64-bit A or B load, row g of 4, words 2q, 2q + 1 of a k-step."""
    stride = int(re.search(r"kStride = kChunk \+ (\d+)",
                           HEADER.read_text()).group(1)) + 32
    for ks in range(4):
        words = [g * stride + 8 * ks + 2 * q + h for g in range(4)
                 for q in range(4) for h in (0, 1)]
        assert _half_warp_banks(words) == list(range(32))


def test_the_header_states_the_python_geometry():
    """BF16_GEMM_TILE, BF16_GEMM_CHUNK and BF16_GEMM_SHARED are the
    header's kBM = kBN, kChunk and kSmemBytes."""
    text = HEADER.read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kBM"] == const["kBN"] == planes.BF16_GEMM_TILE
    assert const["kChunk"] == planes.BF16_GEMM_CHUNK
    stride = const["kChunk"] + 8
    stage = (const["kBM"] + const["kBN"]) * stride * 4
    assert planes.BF16_GEMM_SHARED == max(
        const["kStages"] * stage, const["kBM"] * (const["kBN"] + 2) * 8)


def test_every_even_length_has_a_bf16_block():
    """At every even N in [16, 8192], both stores, at M = N and 1 and
    C = 1 and 5: the rows are a power of two within the store's cap (1
    where n1 = N/2 > 128) and the block fits the card's shared memory;
    the names are one launch where n1 ≤ 128, two elsewhere."""
    for n in range(planes.MIN_N, planes.MAX_N + 1, 2):
        wide = planes.bf16_wide(n)
        assert wide == (n > 256 and n % 128 != 0)
        for natural in (False, True):
            cap = planes.max_rows(n, natural, "bf16", False)
            assert cap == 1 if wide else cap >= 1
            for c, m in ((1, n), (5, n), (1, 1)):
                rows = planes.rows_per_block(c, m, n, SMS, cap,
                                             planes.bf16_rows_shared_bytes)
                assert rows & (rows - 1) == 0 and 1 <= rows <= cap
                assert (planes.bf16_rows_shared_bytes(rows, n)
                        <= planes.SMEM_LIMIT), (n, natural, c, m)
                words = planes.bf16_rows_scratch_words(c, m, n)
                assert words == (2 * c * m * (-(-n // 64) * 32) if wide
                                 else 0)
            names = planes.bf16_rows_launches(n, natural)
            kind = "rows_natural" if natural else "rows_transposed"
            assert names == (
                [planes.kernel_name(kind, "bf16", False)]
                if planes.is_power_of_two(n) else
                [planes.BF16_GEMM_PREP, planes.BF16_GEMM_NAMES[kind]] if wide
                else [planes.BF16_MIXED_NAMES[kind]])


@pytest.mark.parametrize("n", [16, 64, 1024, 4096, 8192])
def test_power_of_two_blocks_keep_their_shared_memory(n):
    """At powers of two the bf16 kernel's layout is the one
    csrc/dft_bf16_rows.cuh states: rows at n1 + 4, C ⊙ T at n1 + 8."""
    n1, n2 = planes._split_lanes(n)
    for rows in (1, 2, 4, 8):
        want = (max(rows * n2 * (n1 + 4) * 4,
                    -(-rows * (n + 1) * 8 // 16) * 16)
                + rows * n2 * (n1 + 8) * 4)
        assert planes.bf16_rows_shared_bytes(rows, n) == want
