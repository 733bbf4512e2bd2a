"""The f32 fused natural-store kernel (csrc/fused_rows_natural_f32.cuh)
on the CPU: the two parts of the shared assembly (csrc/fused_assembly.cuh)
composed against the formula they split, bit for bit in f32; a numpy
model of the kernel, thread by thread (a thread's 16 points t + T·m of
the five planes read once, the terms no channel changes made once, then
per channel its values and the radix-16 passes of
tests/test_torch_row_kernels.py's model, stored from the last pass), run
in float64 against the float64 DFT of the float64 assembly (1e-12·max)
and in float32 against the plain version and JAX's assemble_rowfft_natural
(1e-5·max, the kernel-vs-plain band of the f32 tier), in every channel set
and every (ch_start, ch_count), with a row offset across the Nyquist row,
ragged M and both signs; its shared memory, rows per block at the paths'
shapes, routing, tables and profiler name."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_row_kernels import (SMS, _Buffer, _radix16_exact_twiddles,
                                    _radix16_passes, _Radix16Ops)
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean_torch import OCEAN_DEMO
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused

EPS = 1e-4
LENGTH = OCEAN_DEMO.length
DZ_SIGN = -1.0
# (packed, nch_live) of each channel set, by its tag
SETS = {"packed3": (True, 3), "packed5": (True, 5),
        "per_channel": (False, 3)}
# every (set, ch_start, ch_count) a launch may take
SPANS = [(name, start, count) for name, (packed, live) in SETS.items()
         for start in range(fused.channel_count(packed, live))
         for count in range(1, fused.channel_count(packed, live) - start + 1)]
MODEL_NS = [1 << i for i in range(4, 10)]


# ---- the assembly's two parts, in numpy at one rounding an operation

def _row_kx(row, n, two_pi_over_l, dtype):
    wrapped = np.where(row < n // 2, row, row - n)
    return dtype(two_pi_over_l) * wrapped.astype(dtype)


def _point_terms(h0r, h0i, h0cr, h0ci, phase, kx, kz, eps2, dtype):
    """point_terms: (h̃r, h̃i, invk)."""
    c, s = np.cos(phase).astype(dtype), np.sin(phase).astype(dtype)
    htr = (h0r + h0cr) * c + (h0ci - h0i) * s
    hti = (h0i + h0ci) * c + (h0r - h0cr) * s
    kmag2 = kx * kx + kz * kz
    with np.errstate(divide="ignore"):
        invk = np.where(kmag2 < eps2, dtype(0), dtype(1) / np.sqrt(kmag2))
    return htr, hti, invk.astype(dtype)


def _channel_value(terms, kx, kz, row, j, n, ch, packed, nch_live, dz_sign,
                   dtype):
    """channel_value: channel ``ch`` of the points from their terms."""
    htr, hti, invk = terms
    w = [dtype(ch == i) for i in range(5)]
    dz = dtype(dz_sign)
    if not packed:
        k = w[0] * dtype(1) + (w[1] * kx) * invk
        k = k + ((w[2] * dz) * kz) * invk
        k = k + w[3] * -kx
        k = k + w[4] * -kz
        return k * htr, k * hti
    rowmask = (row != n // 2).astype(dtype)
    colmask = (j != n // 2).astype(dtype)
    rx = (kx * invk) * rowmask
    rz = ((dz * kz) * invk) * colmask
    a = w[0] * (dtype(1) + rx)
    b = w[1] * rz
    if nch_live == 5:
        a = a + (w[1] * -kx) * rowmask
        b = b + (w[2] * -kz) * colmask
    return a * htr + b * hti, a * hti - b * htr


def _assemble_formula(h0r, h0i, h0cr, h0ci, phase, kz, row, j, n, ch,
                      packed, nch_live, two_pi_over_l, dz_sign, eps2):
    """The f32 assembly of one point as one formula, in the order of
    _assemble_block (fused_spectrum_fft.py:58-124), before it was split:
    the Nyquist row tested on the wrapped row."""
    f = np.float32
    c, s = np.cos(phase).astype(f), np.sin(phase).astype(f)
    htr = (h0r + h0cr) * c + (h0ci - h0i) * s
    hti = (h0i + h0ci) * c + (h0r - h0cr) * s
    half = n // 2
    wrapped = np.where(row < half, row, row - n)
    kx = f(two_pi_over_l) * wrapped.astype(f)
    kmag2 = kx * kx + kz * kz
    with np.errstate(divide="ignore"):
        invk = np.where(kmag2 < eps2, f(0), f(1) / np.sqrt(kmag2)).astype(f)
    w0, w1, w2, w3, w4 = (f(ch == i) for i in range(5))
    if not packed:
        k = w0 * f(1) + (w1 * kx) * invk
        k = k + ((w2 * f(dz_sign)) * kz) * invk
        k = k + w3 * -kx
        k = k + w4 * -kz
        return k * htr, k * hti
    rowmask = (wrapped != -half).astype(f)
    colmask = (j != half).astype(f)
    rx = (kx * invk) * rowmask
    rz = ((f(dz_sign) * kz) * invk) * colmask
    a = w0 * (f(1) + rx)
    b = w1 * rz
    if nch_live == 5:
        a = a + (w1 * -kx) * rowmask
        b = b + (w2 * -kz) * colmask
    return a * htr + b * hti, a * hti - b * htr


def _inputs(m, n, seed):
    """h0 planes [M, N] f32 and a phase [M, N] f32: uniform in [0, 2π)
    with a share far outside it (the absolute-time mode's phases)."""
    rng = np.random.default_rng(seed)
    h0 = [rng.normal(size=(m, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0, 2 * np.pi, size=(m, n))
    far = rng.random((m, n)) < 0.25
    phase[far] = rng.uniform(-3e4, 3e4, size=far.sum())
    return h0, phase.astype(np.float32)


@pytest.mark.parametrize("channel_set,ch",
                         [(name, ch) for name, (packed, live) in SETS.items()
                          for ch in range(fused.channel_count(packed, live))])
def test_assembly_parts_compose_to_the_formula_bit_for_bit(channel_set, ch):
    """point_terms then channel_value round the same products and sums as
    the formula they split: every channel of every set equal bit for bit
    in f32, at rows 0..N−1 (the Nyquist row N/2 and the origin, where
    |k| < ε, among them) and the Nyquist column."""
    packed, nch_live = SETS[channel_set]
    n = 64
    h0, phase = _inputs(n, n, seed=7 * ch + len(channel_set))
    f = np.float32
    row = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    kz = fused._kz_table(n, LENGTH, torch.device("cpu")).numpy()[None, :]
    two_pi_over_l = f(2 * np.pi / LENGTH)
    eps2 = f(EPS) * f(EPS)
    want = _assemble_formula(*h0, phase, kz, row, j, n, ch, packed, nch_live,
                             two_pi_over_l, DZ_SIGN, eps2)
    kx = _row_kx(row, n, two_pi_over_l, f)
    terms = _point_terms(*h0, phase, kx, kz, eps2, f)
    got = _channel_value(terms, kx, kz, row, j, n, ch, packed, nch_live,
                         DZ_SIGN, f)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    assert terms[2][0, 0] == 0          # the origin, below ε


# ---- a numpy model of the kernel

def _fused_model(h0, phase, kz, *, rows, table, dtype, two_pi_over_l, eps2,
                 row_offset, ch_start, ch_count, packed, nch_live, log,
                 store=None):
    """The kernel on [M, N] inputs with R = ``rows``, block by block and
    thread by thread at ``dtype``: each thread (row, t) reads its points
    t + T·m of the five planes once, makes their terms once, then for each
    channel its 16 values, the radix-16 passes (sharing one exchange
    buffer across the channels) and the store of output s at t + T·s of
    the channel's plane. Returns [C, M, N] complex; appends the device
    loads and stores ("load"/"store", float offsets in a plane, live
    lanes) and the exchange accesses to ``log``. With ``store`` (the
    transposed kernel's, tests/test_torch_fused_transposed.py),
    store(c, m0, row, t, v, buf) takes each channel's last-pass outputs
    and the exchange buffer instead, and what it stores is its own."""
    m, n = phase.shape
    t_row = n // 16
    threads = rows * t_row
    assert threads <= planes.RADIX16_MAX_THREADS
    tid = np.arange(threads)
    row, t = tid // t_row, tid % t_row
    ops = _Radix16Ops(dtype, table[0, 1])
    tw = table.astype(dtype)
    buf = _Buffer(rows * planes.radix16_stride(n), dtype)
    out = np.zeros((ch_count, m, n), np.complex128)
    writes = np.zeros((ch_count, m, n), int)
    for m0 in range(0, m, rows):
        live = m0 + row < m
        rr = np.minimum(m0 + row, m - 1)
        grow = row_offset + m0 + row
        kx = _row_kx(grow, n, two_pi_over_l, dtype)
        terms, kzv = [], []
        for j in range(16):
            a = t + t_row * j
            x = [np.where(live, p[rr, a], 0).astype(dtype) for p in (*h0, phase)]
            log.append(("load", rr * n + a, live))
            kzv.append(kz[a].astype(dtype))
            terms.append(_point_terms(*x, kx, kzv[j], eps2, dtype))
        for c in range(ch_count):
            v = [_channel_value(terms[j], kx, kzv[j], grow, t + t_row * j, n,
                                ch_start + c, packed, nch_live, DZ_SIGN,
                                dtype)
                 for j in range(16)]
            v = _radix16_passes(v, n, row, t, ops, tw, buf, log)
            if store is not None:
                store(c, m0, row, t, v, buf)
                continue
            for s in range(16):
                a = t + t_row * s
                log.append(("store", rr * n + a, live))
                vr, vi = v[s]
                out[c, rr[live], a[live]] = (vr[live].astype(np.float64)
                                             + 1j * vi[live].astype(np.float64))
                np.add.at(writes, (c, rr[live], a[live]), 1)
    assert store is not None or (writes == 1).all()
    return out


def _model_case(n):
    """(rows, M, row_offset) of a model run at length n: R the wrapper's
    cap (at most 8), M a block and a half (ragged), the rows across the
    Nyquist row N/2."""
    rows = min(planes.fused_natural_max_rows(n), 8)
    m = rows + rows // 2 + 1
    return rows, m, n // 2 - m // 2


def _coalesced(log, n):
    """Every warp's loads and stores of live rows are runs of consecutive
    floats, a whole warp's 32 from N = 512 on."""
    run = min(32, n // 16)
    for what, addr, live in log:
        if what not in ("load", "store"):
            continue
        for w in range(0, addr.size, 32):
            a, ok = addr[w:w + 32], live[w:w + 32]
            if ok.all():
                pieces = np.split(a, np.flatnonzero(np.diff(a) != 1) + 1)
                assert all(p.size % run == 0 for p in pieces), (what, n)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("span", SPANS, ids=lambda s: f"{s[0]}-{s[1]}+{s[2]}")
def test_fused_model_matches_float64_and_plain(span, inverse):
    """The model in float64 (exact twiddles, kx and kz from 2π/L in
    float64) within 1e-12·max of the float64 DFT of the float64 assembly
    (chip_smoke.assembly_f64), and in float32 (the f32 twiddles, kz table
    and 2π/L) within 1e-5·max of assemble_rowfft_natural_plain, each
    channel on its own scale; every output written once, the device
    accesses coalesced."""
    channel_set, ch_start, ch_count = span
    packed, nch_live = SETS[channel_set]
    n = MODEL_NS[SPANS.index(span) % len(MODEL_NS)]
    rows, m, row_offset = _model_case(n)
    h0, phase = _inputs(m, n, seed=n + ch_start + 7 * ch_count)
    kw = dict(row_offset=row_offset, ch_start=ch_start, ch_count=ch_count,
              packed=packed, nch_live=nch_live)
    wrapped = np.where(np.arange(n) < n // 2, np.arange(n), np.arange(n) - n)
    log = []
    got64 = _fused_model(
        [p.astype(np.float64) for p in h0], phase.astype(np.float64),
        2 * np.pi * wrapped / LENGTH, rows=rows,
        table=_radix16_exact_twiddles(n, inverse), dtype=np.float64,
        two_pi_over_l=2 * np.pi / LENGTH, eps2=EPS * EPS, log=log, **kw)
    _coalesced(log, n)
    th0 = tuple(map(torch.from_numpy, h0))
    tphase = torch.from_numpy(phase)
    f = np.float32
    got32 = _fused_model(
        h0, phase, fused._kz_table(n, LENGTH, torch.device("cpu")).numpy(),
        rows=rows, table=planes.radix16_twiddles_np(n, inverse),
        dtype=np.float32, two_pi_over_l=f(2 * np.pi / LENGTH),
        eps2=f(EPS) * f(EPS), log=[], **kw)
    pr, pi = fused.assemble_rowfft_natural_plain(
        th0, tphase, LENGTH, DZ_SIGN, epsilon=EPS, inverse=inverse, **kw)
    for c in range(ch_count):
        ar, ai = chip_smoke.assembly_f64(
            th0, tphase, LENGTH, DZ_SIGN, epsilon=EPS, ch=ch_start + c,
            packed=packed, nch_live=nch_live, row_offset=row_offset)
        x = ar.numpy() + 1j * ai.numpy()
        want = (np.fft.ifft(x, axis=-1) * n if inverse
                else np.fft.fft(x, axis=-1))
        assert np.abs(got64[c] - want).max() <= 1e-12 * np.abs(want).max()
        plain = pr[c].numpy().astype(np.float64) + 1j * pi[c].numpy()
        scale = max(np.abs(pr[c].numpy()).max(), np.abs(pi[c].numpy()).max())
        assert np.abs(got32[c] - plain).max() <= 1e-5 * scale


@pytest.mark.parametrize("channel_set", list(SETS))
def test_fused_model_f32_matches_jax(channel_set):
    """The model in float32 against JAX's assemble_rowfft_natural (the
    Pallas kernel in interpret mode) on the same inputs, every channel of
    the set in one call over rows N/4 .. 3N/4 − 1, each within 1e-5 of its
    own max."""
    packed, nch_live = SETS[channel_set]
    n, m = 128, 64
    count = fused.channel_count(packed, nch_live)
    h0, phase = _inputs(m, n, seed=len(channel_set))
    phase = np.mod(phase, np.float32(2 * np.pi)).astype(np.float32)
    kw = dict(row_offset=n // 4, ch_start=0, ch_count=count, packed=packed,
              nch_live=nch_live)
    wr, wi = jfused.assemble_rowfft_natural(
        tuple(map(jnp.asarray, h0)), jnp.asarray(phase), LENGTH, DZ_SIGN,
        epsilon=EPS, **kw)
    f = np.float32
    got = _fused_model(
        h0, phase, fused._kz_table(n, LENGTH, torch.device("cpu")).numpy(),
        rows=planes.fused_natural_max_rows(n),
        table=planes.radix16_twiddles_np(n, True), dtype=np.float32,
        two_pi_over_l=f(2 * np.pi / LENGTH), eps2=f(EPS) * f(EPS), log=[],
        **kw)
    for c in range(count):
        want = np.asarray(wr)[c].astype(np.float64) + 1j * np.asarray(wi)[c]
        scale = max(np.abs(np.asarray(wr)[c]).max(),
                    np.abs(np.asarray(wi)[c]).max())
        assert np.abs(got[c] - want).max() <= 1e-5 * scale


# ---- shared memory, rows, routing

def test_fused_natural_shared_bytes_of_the_header():
    """fused_radix16::shared_bytes: the radix-16 row kernel's exchange
    buffer, R·S complex (S also at N = 16, where the passes need none),
    then h̃, R·N complex: 67,584 bytes at N = 4096, R = 1 (three blocks
    fit an SM's 228 KB); 135,168 at N = 8192, R = 1."""
    sizes = {(4096, 1): 67584, (8192, 1): 135168, (2048, 2): 67584,
             (1024, 4): 67584, (64, 64): 75776, (16, 256): 100352}
    for (n, rows), want in sizes.items():
        assert planes.fused_natural_shared_bytes(rows, n) == want
        assert planes.fused_natural_shared_bytes(rows, n) == \
            rows * n * 8 + (planes.radix16_shared_bytes(rows, n) or
                            rows * 33 * 8)
    assert 3 * (planes.fused_natural_shared_bytes(1, 4096) + 1024) <= 233472


# the f32 natural fused pass at the paths' shapes: (iv) [4096, 4096] ch 0
# and the half channel's [2048, 4096]; (xiii) and its fields_at C = 3;
# (xii) C = 5: one row a block, ⌈M / R⌉ blocks whatever C
@pytest.mark.parametrize("c,m,n,rows", [(1, 4096, 4096, 1), (3, 4096, 4096, 1),
                                        (5, 4096, 4096, 1), (1, 2048, 4096, 1),
                                        (3, 1024, 1024, 4), (2, 13, 64, 1)])
def test_fused_natural_rows_per_block_at_the_paths_shapes(c, m, n, rows):
    got = planes.fused_rows(c, m, n, SMS, True, "f32", False)
    assert got == rows
    assert planes.fused_rows(1, m, n, SMS, True, "f32", False) == got
    assert got * n // 16 <= planes.RADIX16_MAX_THREADS
    assert planes.fused_natural_shared_bytes(got, n) <= planes.SMEM_LIMIT


@pytest.mark.parametrize("n", [1 << i for i in range(4, 14)])
def test_every_fused_natural_block_the_wrapper_picks_fits(n):
    """At every batch, a block of the f32 fused natural kernel fits the
    card's shared memory and 512 threads; the cap keeps
    FUSED_NATURAL_BLOCK_POINTS."""
    cap = planes.fused_natural_max_rows(n)
    assert cap * n <= max(n, planes.FUSED_NATURAL_BLOCK_POINTS)
    for c in (1, 2, 3, 5):
        for m in (1, 2, 3, 7, 131, 1000, 2048, 4096, 8192):
            rows = planes.fused_rows(c, m, n, SMS, True, "f32", False)
            assert rows & (rows - 1) == 0 and 1 <= rows <= cap
            assert planes.fused_natural_shared_bytes(rows, n) <= \
                planes.SMEM_LIMIT
            assert rows * n // 16 <= planes.RADIX16_MAX_THREADS


# (tier, split3, natural) of a fused pass → the kernel it runs
FUSED_ROUTES = [("f32", False, True, "radix16"),
                ("f32", False, False, "radix16_transposed"),
                ("bf16", False, True, "bf16_rows"),
                ("bf16", False, False, "engine"),
                ("bf16x3", False, True, "engine"),
                ("bf16x3", False, False, "engine"),
                ("bf16x3", True, False, "engine"), ("f32", True, False, "engine")]


@pytest.mark.parametrize("tier,split3,natural,route", FUSED_ROUTES)
def test_fused_routing_names_one_kernel_a_pass(tier, split3, natural, route):
    """The f32 direct fused passes run kernels of their own, the natural
    store csrc/fused_rows_natural_f32.cuh and the transposed store
    csrc/fused_rows_transposed_f32.cuh (each its rows cap, both the
    natural kernel's shared bytes, whose exchange buffer holds the
    transposed store's tile, and the radix-16 twiddles), and the bf16 natural fused pass runs
    its own (csrc/fused_rows_natural_bf16.cuh: the bf16 row kernel's
    shared bytes, rows cap and fragment tables); every other fused pass
    keeps fused_rows_kernel's (the matrix engine at bf16, bf16x3 and
    B3)."""
    radix16 = route in ("radix16", "radix16_transposed")
    bf16 = route == "bf16_rows"
    assert planes._stockham(tier, split3) == radix16
    assert planes._fused_bf16(tier, split3, natural) == bf16
    assert planes.fused_block_shared_bytes(tier, split3, natural) is {
        "radix16": planes.fused_natural_shared_bytes,
        "radix16_transposed": planes.fused_natural_shared_bytes,
        "bf16_rows": planes.bf16_rows_shared_bytes}.get(route,
                                                        planes.shared_bytes)
    n = 1024
    assert planes.fused_rows(3, 4096, n, SMS, natural, tier, split3) == {
        "radix16": planes.fused_natural_max_rows(n),
        "radix16_transposed": planes.fused_transposed_max_rows(n),
        "bf16_rows": planes.max_rows(n, True, "bf16")}.get(
            route, planes.max_rows(n, natural))
    cpu = torch.device("cpu")
    tables = planes.fused_tables(n, True, tier, split3, natural, cpu)
    want = (planes.radix16_twiddles(n, True, cpu) if radix16 else
            planes.bf16_rows_tables(n, True, cpu) if bf16 else
            planes.tables_for(n, True, tier, split3, cpu))
    assert torch.equal(tables, want)
    # each launch keeps its count name
    name = planes.kernel_name("fused_natural" if natural else
                              "fused_transposed", tier, split3, "packed5")
    assert name.startswith("matrix_") == (route in ("engine", "bf16_rows"))
