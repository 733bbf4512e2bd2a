"""The f32 row kernel at even lengths that are not powers of two
(csrc/rows_mixed_passes_f32.cuh), modelled on the CPU: its plan
(fft.planes.passes_plan), index maps, twiddle table and pad rule.

- A float64 numpy model runs the plan pass by pass as the kernel indexes
  it: butterfly j's inputs at j + s·L, its twiddles at the pass's table
  offset + (s − 1)·ns + (j mod ns), output s at (j − k)·ρ + k + s·ns
  through the padded exchange buffer (point a at a + (a >> e)), the
  composite radices split as the kernel's dft_split, a generic pass
  twiddled in place and summed over its p roots. Held to np.fft at every
  length chip_smoke.py's phase 3 checks and at 160 (a 5), 224 (a 7), 210 =
  2·3·5·7 and 1260 = 2²·3²·5·7, both directions: within 1e-12·max with
  the float64 table, 5e-7·max with the f32 one the kernel reads.
- At every even N in [16, 8192] that is not a power of two: the plan
  covers N, its radices are ≤ 16 wherever N's primes are ≤ 7 (a generic
  pass only for each prime above 7), each pass fits a row's threads at 16
  points a thread, the table's offsets stay inside it, and the Python twin
  of the block's shared memory fits the card's 227 KB with one row.
- The launch geometry at the paths' shapes, and the exchange buffer's bank
  conflicts at the paths' lengths, counted from the kernel's accesses.
The kernel itself runs only on the card (tests/test_torch_sizes_cuda.py).
"""

import numpy as np
import pytest

from tpu_ocean_torch.fft import planes

#: chip_smoke.py's phase-3 lengths, then a radix 5, a radix 7 and
#: products of every small prime
LENGTHS = [48, 96, 106, 160, 224, 384, 768, 1536, 2042, 3072, 6144, 8186,
           8190, 210, 1260]
#: the kernel's two-factor radices (dft_split<A, B>): A
SPLIT = {6: 2, 10: 2, 14: 2, 12: 4, 9: 3, 15: 3}


def _dft(u, sign):
    """The radix-P DFT along axis 0 as the kernel's dft<P>: a composite P
    as dft_split<A, B> (input n = B·n1 + n2, output k = k1 + A·k2, the
    twiddles e^{±2πi·n2·k1/P} between), the others directly."""
    p = len(u)
    if p in SPLIT:
        a = SPLIT[p]
        b = p // a
        y = np.empty((b, a) + u.shape[1:], complex)
        k1 = np.arange(a)
        for n2 in range(b):
            w = _dft(u[n2::b], sign)
            y[n2] = w * np.exp(sign * 2j * np.pi * n2 * k1 / p).reshape(
                (a,) + (1,) * (u.ndim - 1))
        out = np.empty_like(u)
        for k in range(a):
            out[k::a] = _dft(y[:, k], sign)
        return out
    s = np.arange(p)
    return np.tensordot(np.exp(sign * 2j * np.pi * np.outer(s, s) / p), u,
                        axes=1)


def _model(x, n, table):
    """The kernel's passes on rows x [R, n] with ``table`` (complex, the
    kernel's layout), through a padded exchange buffer of passes_stride
    columns; returns the rows in natural order."""
    sign = table[0].imag
    e = planes.passes_pad(n)
    stride = planes.passes_stride(n)
    pad = np.arange(n) + (np.arange(n) >> e)
    assert len(np.unique(pad)) == n and pad.max() < stride
    buf = np.zeros((len(x), stride), complex)
    plan = planes.passes_plan(n)
    offsets = planes.passes_twiddle_offsets(n)
    for i, ((radix, span), (tw, roots)) in enumerate(zip(plan, offsets)):
        lanes = n // radix
        row = x if i == 0 else buf[:, pad]
        if radix in planes.PASS_RADICES:
            j = np.arange(lanes)
            k = j % span
            v = np.stack([row[:, j + s * lanes] for s in range(radix)])
            if span > 1:
                for s in range(1, radix):
                    v[s] *= table[tw + (s - 1) * span + k]
            y = _dft(v, sign)
            dest = np.concatenate([(j - k) * radix + k + s * span
                                   for s in range(radix)])
            y = np.concatenate(list(y), axis=-1)
        else:
            # twiddled in place, then each output o = (q, j) over the roots
            o = np.arange(n)
            q, j = o // lanes, o % lanes
            k = j % span
            row = row.copy()
            row[:, q > 0] *= table[tw + (q[q > 0] - 1) * span + k[q > 0]]
            root = table[roots:roots + radix]
            y = np.zeros_like(row)
            for t in range(radix):
                y += row[:, j + t * lanes] * root[(t * q) % radix]
            dest = (j - k) * radix + k + q * span
        if i == len(plan) - 1:
            out = np.empty_like(x)
            out[:, dest] = y
            return out
        buf[:, pad[dest]] = y


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_passes_emulated_against_numpy(n, inverse):
    rng = np.random.default_rng(n + inverse)
    x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    want = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
    scale = np.abs(want).max()
    exact = planes.passes_table(n, inverse)
    assert len(exact) == (n - planes.passes_plan(n)[0][0] + 1
                          + planes.passes_roots(n))
    assert np.abs(_model(x, n, exact) - want).max() <= 1e-12 * scale
    f32 = planes.passes_twiddles(n, inverse, "cpu").double().numpy()
    rounded = f32[:, 0] + 1j * f32[:, 1]
    assert np.abs(rounded - exact).max() <= 2 ** -24
    assert np.abs(_model(x, n, rounded) - want).max() <= 5e-7 * scale


def test_every_even_length_has_passes_and_a_block():
    """Every even N in [16, 8192] that is not a power of two: the radices
    multiply to N with spans the products before; register radices (all ≤
    16) in non-increasing order cover N's part in 2, 3, 5, 7, one generic
    pass each prime above 7 (with multiplicity) after them, so every radix
    is ≤ 16 where N's primes are ≤ 7; at most 16 passes; each pass fits
    the row's threads (16 // ρ butterflies, 16 generic outputs or 8 pairs
    of them at N = 2p a thread, at most 1024 threads); the table is n − r + 1 + Σ generic p long with
    every offset inside it; one row's block fits the card's shared
    memory."""
    for n in range(18, planes.MAX_N + 1, 2):
        if planes.is_power_of_two(n):
            continue
        plan = planes.passes_plan(n)
        radices = [r for r, _ in plan]
        assert np.prod(radices) == n and len(plan) <= 16
        assert [s for _, s in plan] == list(np.cumprod([1] + radices[:-1]))
        small = [r for r in radices if r in planes.PASS_RADICES]
        large = radices[len(small):]
        assert small == sorted(small, reverse=True) and small
        assert large == sorted(large) and all(
            p > 7 and all(p % f for f in range(3, int(p ** 0.5) + 1, 2))
            for p in large)
        assert large == planes._small_and_large(n)[1]
        assert max(small) <= 16
        t = planes.passes_threads(n)
        assert t <= planes.PASS_MAX_THREADS
        for r, _ in plan:
            if r in planes.PASS_RADICES:
                assert -(-(n // r) // t) <= planes.PASS_POINTS // r
            elif n // r == 2:
                assert -(-r // t) <= planes.PASS_GENERIC_POINTS // 2
            else:
                assert -(-n // t) <= planes.PASS_GENERIC_POINTS
        rows = planes.passes_plan_rows(n)
        length = n - radices[0] + 1 + sum(large)
        for (radix, span), (tw, roots) in zip(plan, rows[1:, 2:]):
            assert (tw == 0) == (span == 1)
            assert tw + (radix - 1) * span * (span > 1) <= length
            assert roots + radix * (roots > 0) <= length
        assert planes.passes_shared_bytes(1, n) <= planes.SMEM_LIMIT
    planes.passes_cache_clear()


def test_plans_and_geometry_at_the_paths_shapes():
    """The paths' lengths take the fewest passes (3 at 768, 1536, 3072; a
    generic pass only for 53, 1021, 4093, 13); at [1, N, N] the transposed
    store's blocks hold 8 rows in a cluster (8 rows of 768 in one block, 4
    of 1536 in clusters of 2, 1 of 3072 in clusters of 8), 4 rows of 106
    in one block (no cluster below 512), and the natural store's one row
    of 3072; every such block has at most 512 threads and two fit an SM's
    shared memory (228 KB, 1 KB of it each block's)."""
    assert planes.passes_plan(1536) == ((16, 1), (16, 16), (6, 256))
    assert planes.passes_plan(3072) == ((16, 1), (16, 16), (12, 256))
    assert planes.passes_plan(768) == ((16, 1), (16, 16), (3, 256))
    assert planes.passes_plan(106) == ((2, 1), (53, 2))
    assert [r for r, _ in planes.passes_plan(8190)] == [15, 14, 3, 13]
    assert [r for r, _ in planes.passes_plan(8186)] == [2, 4093]
    sms = 132
    for shape, natural, rows, cluster in [
            ((1, 768, 768), False, 8, 1), ((1, 1536, 1536), False, 4, 2),
            ((1, 768, 1536), False, 4, 2), ((1, 1536, 768), False, 8, 1),
            ((1, 3072, 3072), False, 1, 8), ((1, 3072, 1536), False, 4, 2),
            ((3, 106, 106), False, 4, 1), ((1, 3072, 3072), True, 1, 1),
            ((3, 3072, 3072), True, 1, 1), ((1, 1, 1536), False, 1, 1)]:
        c, m, n = shape
        r = planes.passes_rows(c, m, n, sms, natural)
        k = 1 if natural else planes.passes_cluster(m, n, r)
        assert (r, k) == (rows, cluster), shape
        assert r * planes.passes_threads(n) <= planes.PASS_BLOCK_THREADS
        assert 2 * (planes.passes_shared_bytes(r, n, k, natural)
                    + 1024) <= 233472


def _half_warp_degree(addresses):
    """The most distinct addresses on one bank pair (address mod 16 in
    complex units) among each 16 lanes' 64-bit accesses, the worst half
    warp's."""
    worst = 1
    for h in range(0, len(addresses), 16):
        a = np.unique(addresses[h:h + 16])
        worst = max(worst, np.bincount(a % 16, minlength=16).max())
    return worst


def _exchange_accesses(n):
    """The exchange buffer's accesses of one row, as the kernel makes them:
    each pass's reads (but the first's) and writes (but the last's), a
    list of lane-ordered logical addresses an access."""
    t_row = planes.passes_threads(n)
    plan = planes.passes_plan(n)
    out = []
    for i, (radix, span) in enumerate(plan):
        lanes = n // radix
        first, last = i == 0, i == len(plan) - 1
        if radix in planes.PASS_RADICES:
            for q in range(-(-lanes // t_row)):
                j = np.arange(t_row) + t_row * q
                j = j[j < lanes]
                k = j % span
                for s in range(radix):
                    if not first:
                        out.append(j + s * lanes)
                    if not last:
                        out.append((j - k) * radix + k + s * span)
        else:
            for u in range(-(-n // t_row)):
                o = np.arange(t_row) + t_row * u
                o = o[o < n]
                q, j = o // lanes, o % lanes
                out += [j, j + lanes]
                if not last:
                    out.append((j - j % span) * radix + j % span + q * span)
    return out


@pytest.mark.parametrize("n", [768, 1536, 3072, 6144, 8190, 106, 2042])
def test_the_pad_keeps_the_exchange_free_of_bank_conflicts(n):
    """At the paths' lengths every access of the exchange buffer, padded
    by planes.passes_pad, puts a half warp on at most 2 addresses a bank
    pair, on average at most 1.6 (1.5 at 8190, whose 630-point runs
    straddle half warps of a 592-thread row); unpadded, the first pass's writes of a
    radix-16 first pass put all 16 on one pair."""
    e = planes.passes_pad(n)
    degrees = [_half_warp_degree(a + (a >> e))
               for a in _exchange_accesses(n)]
    assert max(degrees) <= 2 and np.mean(degrees) <= 1.6
    if planes.passes_plan(n)[0][0] == 16:
        assert max(_half_warp_degree(a) for a in _exchange_accesses(n)) == 16
