"""The bf16 fused natural-store kernel (csrc/fused_rows_natural_bf16.cuh)
on the CPU: a numpy model of its fused load, lane by lane (each lane's
group of 4 consecutive points of a row, found from the lane's index, its
global row and column, the assembly's two parts point_terms and
channel_value in f32, each point rounded once to a bf16 pair, the 16-byte
word at the row kernel's address (r·n2 + s)·(n1 + 4) + t), held bit for
bit against the bf16 row kernel's load (csrc/dft_bf16_rows.cuh) applied to
the f32 assembly formula, in every channel set and channel, at N = 16 …
1024, with a ragged M across the Nyquist row; the pass's shared memory and
rows per block at path (vii)'s shapes; every block the wrapper picks fits
the card."""

import numpy as np
import pytest
import torch

from test_torch_fused_kernels import (DZ_SIGN, EPS, LENGTH, SETS,
                                      _assemble_formula, _channel_value,
                                      _inputs, _point_terms, _row_kx)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused

SMS = 132               # the H100's SMs, as sm_count reads them on the card
SM_SHARED = 233472      # shared memory of one H100 SM (228 KB)
THREADS = 512           # bf16_rows::kThreads
LOADS_IN_FLIGHT = 4     # bf16_fused::kLoadsInFlight
MODEL_NS = [1 << i for i in range(4, 11)]
# every channel of every set
CHANNELS = [(name, ch) for name, (packed, live) in SETS.items()
            for ch in range(fused.channel_count(packed, live))]


def _bf16_rne(x):
    """f32 → the bits of the nearest bfloat16, ties to even, as uint32
    (the kernel's __float2bfloat16_rn; no NaN here)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def _staged_size(n, rows):
    """(n1, n2, the words of an s-row, the words of the staged rows)."""
    n1, n2 = planes._split_lanes(n)
    return n1, n2, n1 + 4, rows * n2 * (n1 + 4)


def _fused_load_model(h0, phase, kz, *, rows, m0, row_offset, ch, packed,
                      nch_live):
    """The fused load of the block at row m0 (R = ``rows``) from the
    [M, N] f32 inputs, lane by lane as the kernel runs it: thread tid's
    u-th group of the iteration at base is idx = base + u·512 + tid (base
    in steps of kLoadsInFlight·512), points 4·idx .. 4·idx + 3 of the
    block, read from the planes at m0·N + 4·idx; each point assembled
    (point_terms, channel_value) and rounded to a bf16 pair, re in the low
    half; groups past M stage as zero. Returns (the staged words, how
    often each word was written)."""
    m, n = phase.shape
    n1, n2, stride, size = _staged_size(n, rows)
    log2n, log2n1 = n.bit_length() - 1, n1.bit_length() - 1
    f = np.float32
    two_pi_over_l, eps2 = f(2 * np.pi / LENGTH), f(EPS) * f(EPS)
    total = rows * n // 4
    valid = min(m - m0, rows) * n // 4
    flat = [p.reshape(-1) for p in (*h0, phase)]
    words = np.zeros(size, np.uint32)
    written = np.zeros(size, int)
    tid = np.arange(THREADS)
    for base in range(0, total, LOADS_IN_FLIGHT * THREADS):
        for u in range(LOADS_IN_FLIGHT):
            idx = base + u * THREADS + tid
            idx = idx[idx < total]
            ok = idx < valid
            p = idx * 4
            r, j = p >> log2n, p & (n - 1)
            row = row_offset + m0 + r
            kx = _row_kx(row, n, two_pi_over_l, f)
            addr = (r * n2 + (j >> log2n1)) * stride + (j & (n1 - 1))
            for q in range(4):
                at = np.where(ok, m0 * n + p + q, 0)
                x = [np.where(ok, a[at], 0).astype(f) for a in flat]
                kzq = kz[j + q]
                terms = _point_terms(*x, kx, kzq, eps2, f)
                vr, vi = _channel_value(terms, kx, kzq, row, j + q, n, ch,
                                        packed, nch_live, DZ_SIGN, f)
                pair = _bf16_rne(vr) | (_bf16_rne(vi) << 16)
                words[addr + q] = np.where(ok, pair, 0)
                np.add.at(written, addr + q, 1)
    return words, written


def _row_load_model(re, im, *, rows, m0):
    """csrc/dft_bf16_rows.cuh's load of the block at row m0 from f32
    planes [M, N]: x[r, s·n1 + t] rounded to a bf16 pair (planes._bf16_bits,
    torch's rounding) at word (r·n2 + s)·(n1 + 4) + t; rows past M zero."""
    m, n = re.shape
    n1, n2, stride, size = _staged_size(n, rows)
    live = min(m - m0, rows)
    r, col = np.meshgrid(np.arange(live), np.arange(n), indexing="ij")
    addr = (r * n2 + col // n1) * stride + col % n1
    bits = [planes._bf16_bits(a[m0:m0 + live]).astype(np.uint32)
            for a in (re, im)]
    words = np.zeros(size, np.uint32)
    words[addr.ravel()] = (bits[0] | (bits[1] << 16)).ravel()
    return words


def _model_rows(n):
    """(R, M, row_offset) of a model run: R the wrapper's cap, at most N/4
    so that a block and a half (a ragged M) stay inside the grid's N rows,
    which they cross at the Nyquist row N/2."""
    rows = min(planes.max_rows(n, True, "bf16"), max(1, n // 4))
    m = rows + rows // 2 + 1
    return rows, m, n // 2 - m // 2


@pytest.mark.parametrize("channel_set,ch", CHANNELS)
@pytest.mark.parametrize("n", MODEL_NS)
def test_fused_load_stages_the_row_kernels_words_bit_for_bit(n, channel_set,
                                                             ch):
    """Each block's staged words from the fused load equal, bit for bit,
    those the bf16 row kernel stages from the f32 assembly formula
    (_assemble_formula, the JAX grouping) over the same rows; every word
    of a row is written once and the 4 pad words of each s-row never; the
    rows cross the Nyquist row and every row holds the Nyquist column."""
    packed, nch_live = SETS[channel_set]
    rows, m, row_offset = _model_rows(n)
    assert row_offset <= n // 2 < row_offset + m <= n
    h0, phase = _inputs(m, n, seed=n + 11 * ch + len(channel_set))
    kz = fused._kz_table(n, LENGTH, torch.device("cpu")).numpy()
    f = np.float32
    grow = row_offset + np.arange(m)[:, None]
    want_re, want_im = _assemble_formula(
        *h0, phase, kz[None, :], grow, np.arange(n)[None, :], n, ch, packed,
        nch_live, f(2 * np.pi / LENGTH), DZ_SIGN, f(EPS) * f(EPS))
    n1 = planes._split_lanes(n)[0]
    for m0 in range(0, m, rows):
        got, written = _fused_load_model(
            h0, phase, kz, rows=rows, m0=m0, row_offset=row_offset, ch=ch,
            packed=packed, nch_live=nch_live)
        want = _row_load_model(want_re, want_im, rows=rows, m0=m0)
        np.testing.assert_array_equal(got, want)
        pad = (np.arange(got.size) % (n1 + 4)) >= n1
        assert (written[~pad] == 1).all() and (written[pad] == 0).all()
    assert (want_re != 0).any()


# path (vii): [4096, 4096] ch 0 and the half channel's [2048, 4096] ch 1;
# on no path, ch 2 with 5 live fields and C = 5 per-channel at 4096²
@pytest.mark.parametrize("c,m,n", [(1, 4096, 4096), (1, 2048, 4096),
                                   (5, 4096, 4096), (3, 1024, 1024),
                                   (1, 13, 64)])
def test_bf16_fused_pass_takes_the_row_kernels_block(c, m, n):
    """The bf16 natural fused pass takes the bf16 row kernel's rows and
    shared memory (bf16_rows::shared_bytes: max(R·n2·(n1 + 4)·4,
    R·(N + 1)·8 to 16 bytes) + R·n2·(n1 + 8)·4): at (vii)'s shapes R = 2,
    100,368 bytes, two blocks' worth within an SM's 228 KB."""
    rows = planes.fused_rows(c, m, n, SMS, True, "bf16", False)
    assert rows == planes.rows_per_block(
        c, m, n, SMS, planes.max_rows(n, True, "bf16", False),
        planes.bf16_rows_shared_bytes)
    shared = planes.fused_block_shared_bytes("bf16", False, True)
    assert shared is planes.bf16_rows_shared_bytes
    n1, n2 = planes._split_lanes(n)
    header = (max(rows * n2 * (n1 + 4) * 4, -(-rows * (n + 1) * 8 // 16) * 16)
              + rows * n2 * (n1 + 8) * 4)
    assert shared(rows, n) == header
    if n == 4096:
        assert (rows, header) == (2, 100368)
        assert 2 * (header + 1024) <= SM_SHARED


@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_every_bf16_fused_block_the_wrapper_picks_fits(n):
    """At every batch and channel count, a block of the bf16 fused natural
    kernel is a power of two of rows within the cap
    (BF16_NATURAL_BLOCK_POINTS // N) and fits the card's 227 KB."""
    cap = planes.max_rows(n, True, "bf16", False)
    assert cap == max(1, planes.BF16_NATURAL_BLOCK_POINTS // n)
    for c in (1, 2, 3, 5):
        for m in (1, 2, 3, 7, 131, 1000, 2048, 4096, 8192):
            rows = planes.fused_rows(c, m, n, SMS, True, "bf16", False)
            assert rows & (rows - 1) == 0 and 1 <= rows <= cap
            assert planes.bf16_rows_shared_bytes(rows, n) <= planes.SMEM_LIMIT
