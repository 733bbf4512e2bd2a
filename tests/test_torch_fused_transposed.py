"""The f32 fused transposed-store kernel (csrc/fused_rows_transposed_f32.cuh)
on the CPU: a numpy model of the kernel, thread by thread (the f32 fused
natural kernel's load groups, held terms, channel loop and radix-16
passes, tests/test_torch_fused_kernels.py's model, then this kernel's
store: each thread's last-pass outputs written into a tile at r·G + k,
G = gather_stride(R, N), in the exchange buffer, and the tile read back R
rows at one k, the next k after them, stored at out[c, k, m0 + r]), run
in float64 against the
float64 DFT of the float64 assembly (1e-12·max) and in float32 against
assemble_rowfft_plain and JAX's assemble_rowfft (1e-5·max, the
kernel-vs-plain band of the f32 tier), in every channel set and every
(ch_start, ch_count), with a row offset across the Nyquist row, ragged M
and both signs; a half-warp bank model of the tile's writes and read-out
at every N and R the wrapper can pick; its shared memory, rows per block
at the paths' shapes and the blocks the wrapper picks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_fused_kernels import (DZ_SIGN, EPS, LENGTH, MODEL_NS, SETS,
                                      SPANS, _coalesced, _fused_model,
                                      _inputs)
from test_torch_row_kernels import SMS, _radix16_exact_twiddles, _round_degree
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused

ALL_NS = [1 << i for i in range(4, 14)]


class _TransposedStore:
    """The kernel's store, for _fused_model: after a channel's passes
    (and the barrier after them) each thread (row, t) writes its output s
    at k = t + T·s into the tile at row·G + k, in the exchange buffer;
    after the next barrier the block reads item i = tid + j·threads
    (j < 16) at r = i mod R, k = i / R and stores it at out[c, k, m0 + r]
    where m0 + r < M. Logs the tile's accesses ("tile write", "tile
    read": shared addresses of one access a thread, complex units) and
    the device stores ("store_t": float offsets in the [N, M] plane, live
    lanes)."""

    def __init__(self, m, n, rows, ch_count, log):
        self.m, self.n, self.rows, self.log = m, n, rows, log
        self.t_row = n // 16
        self.threads = rows * self.t_row
        self.g = planes.cluster_gather_stride(rows, n)
        self.out = np.zeros((ch_count, n, m), np.complex128)
        self.writes = np.zeros((ch_count, n, m), int)

    def __call__(self, c, m0, row, t, v, tile):
        n, rows, g = self.n, self.rows, self.g
        # the barrier after the passes: the exchange buffer's points are
        # spent; the tile fits it
        assert rows * g <= tile.re.size
        tile.begin()
        for s in range(16):
            a = row * g + t + self.t_row * s
            self.log.append(("tile write", a, None))
            tile.write(a, *v[s])
        tile.check_writes(rows * n)
        # the barrier after the writes; then R rows at one k, the next k
        live_rows = min(rows, self.m - m0)
        tid = np.arange(self.threads)
        for j in range(16):
            i = tid + j * self.threads
            r, k = i % rows, i // rows
            a = r * g + k
            self.log.append(("tile read", a, None))
            vr, vi = tile.read(a)
            ok = r < live_rows
            self.log.append(("store_t", k * self.m + m0 + r, ok))
            assert not (np.isnan(vr[ok]).any() or np.isnan(vi[ok]).any())
            self.out[c, k[ok], m0 + r[ok]] = (vr[ok].astype(np.float64)
                                              + 1j * vi[ok].astype(np.float64))
            np.add.at(self.writes, (c, k[ok], m0 + r[ok]), 1)


def _transposed_model(h0, phase, kz, *, rows, log, **kw):
    """The kernel on [M, N] inputs with R = ``rows``: [C, N, M] complex,
    every output written once."""
    m, n = phase.shape
    store = _TransposedStore(m, n, rows, kw["ch_count"], log)
    _fused_model(h0, phase, kz, rows=rows, log=log, store=store, **kw)
    assert (store.writes == 1).all()
    return store.out


def _store_runs(log, rows):
    """Every warp's stores of live rows are runs of R consecutive floats
    (R rows at one k of the [N, M] plane)."""
    for what, addr, live in log:
        if what != "store_t":
            continue
        for w in range(0, addr.size, 32):
            a, ok = addr[w:w + 32], live[w:w + 32]
            if ok.all():
                pieces = np.split(a, np.flatnonzero(np.diff(a) != 1) + 1)
                assert all(p.size % rows == 0 for p in pieces), rows


def _model_case(n):
    """(rows, M, row_offset) of a model run at length n: R the wrapper's
    cap, M a block and a half (ragged), the rows across the Nyquist row
    N/2."""
    rows = planes.fused_transposed_max_rows(n)
    m = rows + rows // 2 + 1
    return rows, m, n // 2 - m // 2


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("span", SPANS, ids=lambda s: f"{s[0]}-{s[1]}+{s[2]}")
def test_fused_transposed_model_matches_float64_and_plain(span, inverse):
    """The model in float64 (exact twiddles, kx and kz from 2π/L in
    float64) within 1e-12·max of the float64 DFT of the float64 assembly
    (chip_smoke.assembly_f64), transposed, and in float32 (the f32
    twiddles, kz table and 2π/L) within 1e-5·max of assemble_rowfft_plain,
    which is itself held within 1e-5·max of that float64 DFT first, each
    channel on its own scale; every output written once; the device
    loads coalesced, the stores runs of R floats; the tile's writes and
    read-out free of bank conflicts."""
    channel_set, ch_start, ch_count = span
    packed, nch_live = SETS[channel_set]
    n = MODEL_NS[SPANS.index(span) % len(MODEL_NS)]
    rows, m, row_offset = _model_case(n)
    h0, phase = _inputs(m, n, seed=n + ch_start + 7 * ch_count)
    kw = dict(row_offset=row_offset, ch_start=ch_start, ch_count=ch_count,
              packed=packed, nch_live=nch_live)
    wrapped = np.where(np.arange(n) < n // 2, np.arange(n), np.arange(n) - n)
    log = []
    got64 = _transposed_model(
        [p.astype(np.float64) for p in h0], phase.astype(np.float64),
        2 * np.pi * wrapped / LENGTH, rows=rows,
        table=_radix16_exact_twiddles(n, inverse), dtype=np.float64,
        two_pi_over_l=2 * np.pi / LENGTH, eps2=EPS * EPS, log=log, **kw)
    _coalesced(log, n)
    _store_runs(log, rows)
    threads = rows * n // 16
    for what, addr, _ in log:
        if what.startswith("tile"):
            assert _round_degree(addr, threads) == 1, (what, n, rows)
    th0 = tuple(map(torch.from_numpy, h0))
    tphase = torch.from_numpy(phase)
    f = np.float32
    got32 = _transposed_model(
        h0, phase, fused._kz_table(n, LENGTH, torch.device("cpu")).numpy(),
        rows=rows, table=planes.radix16_twiddles_np(n, inverse),
        dtype=np.float32, two_pi_over_l=f(2 * np.pi / LENGTH),
        eps2=f(EPS) * f(EPS), log=[], **kw)
    pr, pi = fused.assemble_rowfft_plain(
        th0, tphase, LENGTH, DZ_SIGN, epsilon=EPS, inverse=inverse, **kw)
    for c in range(ch_count):
        ar, ai = chip_smoke.assembly_f64(
            th0, tphase, LENGTH, DZ_SIGN, epsilon=EPS, ch=ch_start + c,
            packed=packed, nch_live=nch_live, row_offset=row_offset)
        x = ar.numpy() + 1j * ai.numpy()
        want = (np.fft.ifft(x, axis=-1) * n if inverse
                else np.fft.fft(x, axis=-1)).T
        assert np.abs(got64[c] - want).max() <= 1e-12 * np.abs(want).max()
        plain = pr[c].numpy().astype(np.float64) + 1j * pi[c].numpy()
        scale = max(np.abs(pr[c].numpy()).max(), np.abs(pi[c].numpy()).max())
        # the plain version against float64 first, so that a mismatch below
        # names the side that moved
        assert np.abs(plain - want).max() <= 1e-5 * scale, \
            f"channel {ch_start + c}: the plain version moved from float64"
        assert np.abs(got32[c] - plain).max() <= 1e-5 * scale


@pytest.mark.parametrize("channel_set", list(SETS))
def test_fused_transposed_model_f32_matches_jax(channel_set):
    """The model in float32 against JAX's assemble_rowfft (the Pallas
    kernel in interpret mode) on the same inputs, every channel of the set
    in one call over rows N/4 .. 3N/4 − 1, each within 1e-5 of its own
    max."""
    packed, nch_live = SETS[channel_set]
    n, m = 128, 64
    count = fused.channel_count(packed, nch_live)
    h0, phase = _inputs(m, n, seed=len(channel_set))
    phase = np.mod(phase, np.float32(2 * np.pi)).astype(np.float32)
    kw = dict(row_offset=n // 4, ch_start=0, ch_count=count, packed=packed,
              nch_live=nch_live)
    wr, wi = jfused.assemble_rowfft(
        tuple(map(jnp.asarray, h0)), jnp.asarray(phase), LENGTH, DZ_SIGN,
        epsilon=EPS, **kw)
    f = np.float32
    got = _transposed_model(
        h0, phase, fused._kz_table(n, LENGTH, torch.device("cpu")).numpy(),
        rows=planes.fused_transposed_max_rows(n),
        table=planes.radix16_twiddles_np(n, True), dtype=np.float32,
        two_pi_over_l=f(2 * np.pi / LENGTH), eps2=f(EPS) * f(EPS), log=[],
        **kw)
    for c in range(count):
        want = np.asarray(wr)[c].astype(np.float64) + 1j * np.asarray(wi)[c]
        scale = max(np.abs(np.asarray(wr)[c]).max(),
                    np.abs(np.asarray(wi)[c]).max())
        assert np.abs(got[c] - want).max() <= 1e-5 * scale


# ---- the tile's banks

def _tile_degrees(n, rows, stride):
    """(worst write degree, worst read-out degree) of the tile's 64-bit
    accesses at R = ``rows`` with row stride ``stride``, half warp by half
    warp: the writes of output s at row·stride + t + T·s, the read-out of
    item i = tid + j·threads at (i mod R)·stride + i / R."""
    t_row = n // 16
    threads = rows * t_row
    tid = np.arange(threads)
    row, t = tid // t_row, tid % t_row
    write = max(_round_degree(row * stride + t + t_row * s, threads)
                for s in range(16))
    i = tid[None, :] + threads * np.arange(16)[:, None]
    read = max(_round_degree(a, threads)
               for a in (i % rows) * stride + i // rows)
    return write, read


@pytest.mark.parametrize("n", ALL_NS)
def test_tile_writes_and_read_out_are_conflict_free(n):
    """At every R the wrapper can pick at length n (the powers of two up
    to fused_transposed_max_rows), the tile's writes and its read-out
    meet no bank conflict with G = gather_stride(R, N). The exchange
    buffer's own stride S = N + N/16 would not do from N = 256 on (S ≡ 0
    mod 16: R rows at one k on one bank pair); and where rows share a half
    warp of the writes (N < 256) and the cap is 256/N, twice the cap's
    rows would conflict."""
    cap = planes.fused_transposed_max_rows(n)
    rows = 1
    while rows <= cap:
        g = planes.cluster_gather_stride(rows, n)
        assert g >= n
        assert _tile_degrees(n, rows, g) == (1, 1), rows
        if n >= 256 and rows > 1:
            s = planes.radix16_stride(n)
            assert s % 16 == 0
            assert _tile_degrees(n, rows, s)[1] == rows
        rows *= 2
    if n < 256 and cap == 256 // n:
        rows = 2 * cap
        assert _tile_degrees(n, rows,
                             planes.cluster_gather_stride(rows, n))[0] > 1


# ---- shared memory, rows

@pytest.mark.parametrize("n", ALL_NS)
def test_fused_transposed_shared_bytes_of_the_header(n):
    """The kernel's launch takes the fused natural kernel's shared memory
    (fused_radix16::shared_bytes, planes.fused_natural_shared_bytes): the
    exchange buffer R·S (S also at N = 16) and h̃, R·N complex; the tile,
    R·gather_stride(R, N) complex, lies in the exchange buffer, which holds
    it at every N and R (G ≤ N + 15 < S): at N = 1024, R = 8, 69,632 +
    65,536 = 135,168 bytes, where a third region would add 65,664."""
    sizes = {(1024, 8): 135168, (1024, 4): 67584, (2048, 4): 135168,
             (4096, 2): 135168, (8192, 1): 135168, (16, 8): 3136,
             (64, 4): 4736, (256, 8): 33792}
    shared = planes.fused_block_shared_bytes("f32", False, False)
    assert shared is planes.fused_natural_shared_bytes
    for rows in (1, 2, 4, 8, 16):
        got = shared(rows, n)
        assert got == rows * 8 * (planes.radix16_stride(n) + n)
        assert got == sizes.get((n, rows), got)
        assert planes.cluster_gather_stride(rows, n) <= n + 15 < \
            planes.radix16_stride(n)
    assert planes.radix16_stride(1024) * 8 * 8 == 69632
    assert planes.cluster_gather_stride(8, 1024) * 8 * 8 == 65664


# the f32 transposed fused pass at the paths' shapes: (ii) [1024, 1024]
# ch 0 and the half channel's [512, 1024]; (x) C = 3; (xi) C = 2 and its
# half channel; (iv) in the transposed regime [4096, 4096] and its half
# channel; a small batch: ⌈M / R⌉ blocks whatever C
@pytest.mark.parametrize("c,m,n,rows", [(1, 1024, 1024, 8), (1, 512, 1024, 4),
                                        (3, 1024, 1024, 8), (2, 1024, 1024, 8),
                                        (1, 4096, 4096, 2), (1, 2048, 4096, 2),
                                        (2, 13, 64, 1)])
def test_fused_transposed_rows_per_block_at_the_paths_shapes(c, m, n, rows):
    got = planes.fused_rows(c, m, n, SMS, False, "f32", False)
    assert got == rows
    assert planes.fused_rows(1, m, n, SMS, False, "f32", False) == got
    assert got * n // 16 <= planes.RADIX16_MAX_THREADS
    assert planes.fused_natural_shared_bytes(got, n) <= planes.SMEM_LIMIT


@pytest.mark.parametrize("n", ALL_NS)
def test_every_fused_transposed_block_the_wrapper_picks_fits(n):
    """At every batch, a block of the f32 fused transposed kernel is a
    power of two of rows within the cap, fits the card's shared memory
    and 512 threads, and where rows share a half warp (N < 256) holds at
    most 16 threads' worth of rows (R·T ≤ 16)."""
    cap = planes.fused_transposed_max_rows(n)
    assert 1 <= cap <= planes.FUSED_TRANSPOSED_MAX_ROWS
    for c in (1, 2, 3, 5):
        for m in (1, 2, 3, 7, 131, 1000, 2048, 4096, 8192):
            rows = planes.fused_rows(c, m, n, SMS, False, "f32", False)
            assert rows & (rows - 1) == 0 and 1 <= rows <= cap
            assert planes.fused_natural_shared_bytes(rows, n) <= \
                planes.SMEM_LIMIT
            assert rows * n // 16 <= planes.RADIX16_MAX_THREADS
            if n < 256:
                assert rows * n // 16 <= 16
