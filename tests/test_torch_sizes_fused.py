"""The fused sizes slice on the CPU: ``pallas_fused`` at even lengths that
are not powers of two.

- The fused wrappers (ops.fused_spectrum.assemble_rowfft and
  assemble_rowfft_natural, their plain versions here) against the JAX
  package's (Pallas in interpret mode) at N = 96, 106 = 2·53 and 160, in
  the three channel sets: every channel of the set over all rows and the
  half channel's rows 0..N/2−1 (its last channel alone), and at 106 a
  batch of rows at a row offset from channel 1 on; each channel within
  1e-5·max of its own, inputs from a numpy seed.
- The solver's ``pallas_fused`` against the JAX solver from one injected
  h0, 10 steps, within tests/test_packing.py's 1e-5 bands: the natural
  regime at 96 (both packages' transposed-store cap at 32), the spectral
  set (packed, 5 live fields, normals in torch) at 96, and the complex
  state at 106 (the per-channel set).
- The kernel's blocks (csrc/fused_rows_mixed_f32.cuh), modelled in
  float64 numpy: a block of R rows of one channel assembles its live rows
  at their global rows, zeros past M, runs the plan's stages as
  tests/test_torch_sizes.py emulates them and stores its live rows; at a
  ragged M and a row offset, both stores, against np.fft of the
  assembly.
- The rows per block of every fused pass (fft.planes.fused_rows) at every
  even N in [16, 8192] fit the card's shared memory.
The kernel itself runs only on the card (tests/test_torch_sizes_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean.fft import pallas_fft
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, fields_to_numpy,
                             state_from_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused
from tests.test_packing import _assert_fields_close
from tests.test_torch_sizes import _emulate
from tests.test_torch_solver import (SLICE, _h0_pair, _jax_config,
                                     _steps_against_jax,
                                     _ten_steps_against_jax)

EPS = 1e-4
LENGTH = 434.48
#: (packed, nch_live) of each channel set
SETS = {"packed3": (True, 3), "packed5": (True, 5),
        "per_channel": (False, 3)}


def _inputs(m, n, seed):
    """h0 pair planes and a phase in [0, 2π), [M, N] f32 each."""
    rng = np.random.default_rng(seed)
    h0 = [rng.normal(size=(m, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0.0, 2 * np.pi, size=(m, n)).astype(np.float32)
    return h0, phase


def _rows(n, rows, natural, count):
    """(M, row offset, first channel, channels) of a batch: all N rows and
    every channel; the half channel (rows 0..N/2−1, the set's last
    channel); or rows from N/4 on, from channel 1. JAX's natural store
    takes M divisible by 8 only, so there M is rounded down to it."""
    m, offset, ch, c = {"all": (n, 0, 0, count),
                        "half": (n // 2, 0, count - 1, 1),
                        "offset": (n // 2 - 3, n // 4, 1, count - 1)}[rows]
    return (m - m % 8 if natural else m), offset, ch, c


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("channel_set", list(SETS))
@pytest.mark.parametrize("n,rows", [(n, rows) for n in (96, 106, 160)
                                    for rows in ("all", "half")]
                         + [(106, "offset")])
def test_fused_wrappers_match_jax(n, rows, channel_set, natural):
    packed, nch_live = SETS[channel_set]
    m, offset, ch, count = _rows(n, rows, natural,
                                 fused.channel_count(packed, nch_live))
    h0, phase = _inputs(m, n, seed=n + m + ch)
    kw = dict(epsilon=EPS, ch_start=ch, ch_count=count, row_offset=offset,
              packed=packed, nch_live=nch_live)
    jfn = jfused.assemble_rowfft_natural if natural else jfused.assemble_rowfft
    tfn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    wr, wi = jfn(tuple(map(jnp.asarray, h0)), jnp.asarray(phase), LENGTH,
                 -1.0, **kw)
    gr, gi = tfn(tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
                 LENGTH, -1.0, **kw)
    assert gr.shape == ((count, m, n) if natural else (count, n, m))
    for c in range(count):
        for got, want in ((gr[c], wr[c]), (gi[c], wi[c])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_fused_natural_regime_at_96(monkeypatch):
    """Path (i)'s switches on ``pallas_fused`` at N = 96 with both packages'
    transposed-store cap at 32: the fused natural-store row passes (the
    full channel over 96 rows, the half channel over 48), the axis −2
    column passes and the half channel's length-48 columns."""
    monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    with pallas_fft.transposed_store_cap(32):
        _, jf, _, tf = _ten_steps_against_jax(96, backend="pallas_fused")
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_fused_spectral_set_at_96():
    """The spectral config on ``pallas_fused``, packed + half with 5 live
    fields and the normals in torch, at N = 96."""
    cfg = OCEAN_DEMO.replace(resolution=96, normals_mode="spectral")
    switches = dict(SLICE, fft_backend="pallas_fused", pallas_fields=False)
    del switches["real_state"]
    *_, jf, _, tf = _steps_against_jax(cfg, switches, 10, seed=97)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_complex_state_on_pallas_fused_at_106():
    """N = 106 = 2·53: the complex state's ``pallas_fused`` transform (the
    per-channel set, channels 0..2, then the column pass), the fields in
    torch."""
    cfg = OCEAN_DEMO.replace(resolution=106)
    ref = JaxSolver(_jax_config(cfg), fft_backend="pallas_fused")
    port = OceanSolver(cfg, device="cpu", fft_backend="pallas_fused")
    assert port.fft_backend == "pallas_fused" and not port.real_state
    h0, h0c = _h0_pair(cfg, seed=107)
    js = ref.init(h0=h0, h0_conj=h0c)
    ts = state_from_numpy(js, "cpu")
    for _ in range(10):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def _kernel_model(h0, phase, n, rows_per_block, natural, *, ch, packed,
                  nch_live, row_offset):
    """One channel as the fused mixed-radix kernel computes it, in float64:
    block b holds rows b·R .. b·R + R − 1 of the batch; its live rows are
    assembled at their global rows (the plain assembly's f32 values), the
    rows past M are zeros; the plan's stages (_emulate, the exact table)
    run on all R rows; the live rows are stored, natural [M, N] or
    transposed [N, M]."""
    m = phase.shape[0]
    table = planes.mixed_table(n, True)
    out = np.full((m, n) if natural else (n, m), np.nan, np.complex128)
    for m0 in range(0, m, rows_per_block):
        live = min(m - m0, rows_per_block)
        block = np.zeros((rows_per_block, n), np.complex128)
        sl = slice(m0, m0 + live)
        re, im = fused._assemble_plain(
            tuple(torch.from_numpy(p[sl]) for p in h0),
            torch.from_numpy(phase[sl]), LENGTH, -1.0, epsilon=EPS,
            row_offset=row_offset + m0, ch=ch, packed=packed,
            nch_live=nch_live)
        block[:live] = re.double().numpy() + 1j * im.double().numpy()
        res = _emulate(block, n, table)[:live]
        if natural:
            out[sl] = res
        else:
            out[:, sl] = res.T
    return out


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("n,m,rows_per_block", [(106, 37, 8), (96, 13, 4),
                                                (160, 48, 2)])
def test_the_kernels_blocks_modelled_in_numpy(n, m, rows_per_block,
                                              natural):
    """A ragged last block (M not a multiple of R) at a row offset that
    crosses the Nyquist row: every channel of the packed set with 5 live
    fields and of the per-channel set, each row stored once, within
    1e-12·max of np.fft of the plain assembly."""
    offset = n // 2 - m // 2
    h0, phase = _inputs(m, n, seed=n + m)
    for channel_set in ("packed5", "per_channel"):
        packed, nch_live = SETS[channel_set]
        for ch in range(fused.channel_count(packed, nch_live)):
            got = _kernel_model(h0, phase, n, rows_per_block, natural,
                                ch=ch, packed=packed, nch_live=nch_live,
                                row_offset=offset)
            re, im = fused._assemble_plain(
                tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase),
                LENGTH, -1.0, epsilon=EPS, row_offset=offset, ch=ch,
                packed=packed, nch_live=nch_live)
            want = np.fft.ifft(re.double().numpy() + 1j * im.double().numpy(),
                               axis=-1) * n
            if not natural:
                want = want.T
            assert np.isfinite(got).all()
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_every_fused_pass_has_a_block():
    """planes.fused_rows at every even N in [16, 8192], both stores, one
    and five channels, M = N and M = 1: rows a power of two within the
    store's cap, a block within the card's shared memory (SMEM_LIMIT) by
    the geometry of the kernel that N runs (the mixed-radix one where N is
    not a power of two), and the entry's table that geometry's."""
    sms = 132
    for n in range(16, planes.MAX_N + 1, 2):
        mixed = not planes.is_power_of_two(n)
        for natural in (False, True):
            shared = (planes.mixed_shared_bytes if mixed else
                      planes.fused_block_shared_bytes("f32", False, natural))
            cap = (planes.mixed_max_rows(n, natural) if mixed else
                   planes.fused_natural_max_rows(n) if natural else
                   planes.fused_transposed_max_rows(n))
            for c in (1, 5):
                for m in (n, 1):
                    r = planes.fused_rows(c, m, n, sms, natural, "f32", False)
                    assert r >= 1 and r & (r - 1) == 0 and r <= cap
                    assert shared(r, n) <= planes.SMEM_LIMIT
        if mixed and n % 50 == 6:
            tables = planes.fused_tables(n, True, "f32", False, False,
                                         torch.device("cpu"))
            assert tables.shape == (len(planes.mixed_table(n, True)), 2)
    planes.mixed_table.cache_clear()
    planes.mixed_twiddles_np.cache_clear()
    planes.mixed_twiddles.cache_clear()
