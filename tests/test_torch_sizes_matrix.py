"""The last sizes slice on the CPU: every tier and form at even lengths that
are not powers of two, which the card runs on the matrix-form engine
(csrc/dft_matrix.cuh) behind the mixed-radix kernels' loads and stores
(csrc/rows_mixed_f32.cuh, csrc/fused_rows_mixed_f32.cuh).

- The plain row DFT and the fused plain passes (fft/matrix.py behind
  fft.planes.rows_plain and the torch assembly) against the JAX kernels
  (Pallas in interpret mode, both packages' switches monkeypatched as
  tests/test_torch_precision.py does) and against float64, both stores:
  bf16 and bf16x3 at N = 96 (n1 = 48), 106 (n1 = 53, odd) and 160
  (n1 = 80); bf16 at 384 (n1 = 128, n2 = 3); the three-factor form at f32,
  bf16 and bf16x3 at 384. Bands as tests/test_torch_precision.py's.
- OceanSolver at precision="bfloat16" against the JAX solver from one
  injected h0, 3 steps: path (i)'s switches at N = 96 on ``pallas`` and
  ``pallas_fused``, the natural regime at 96 (both packages' caps at 32),
  and the complex state at 106 on both backends; test_bfloat16_solver_
  tracks_jax's bands.
- The size rule: check_card_sizes takes every even N in [16, 8192] at
  both precisions, thresholds lowered or not, fused or not, and refuses
  odd N and N outside that range.
- The kernels' launch geometry modelled on the host at every even N in
  [16, 8192] that is not a power of two, at each tier and form, row and
  fused: rows a power of two within the store's cap, the two buffers in
  the card's shared memory, whole warps, the grid; and the engine's n1
  rule (lanes_n1, read from the header) against both packages'
  _split_lanes at every even N.
The kernels themselves run only on the card (tests/test_torch_sizes_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, fields_to_numpy,
                             state_from_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fused_spectrum as fused
from tests.test_torch_precision import (  # noqa: F401 (switches: a fixture)
    JAX_PRECISION, TO_F64, TO_JAX, _planes_np, _rel, _select,
    _steps_against_jax, switches)
from tests.test_torch_solver import _h0_pair, _jax_config

HEADER = Path(planes.__file__).resolve().parent.parent / "csrc" / \
    "dft_matrix.cuh"
#: (tier, split3, n): the direct tiers at n1 = N/2 (48, 53, 80) and at
#: n1 = 128, n2 = 3; the three-factor form at 384 at every tier
CASES = ([(tier, False, n) for tier in ("bf16", "bf16x3")
          for n in (96, 106, 160)]
         + [("bf16", False, 384)]
         + [(tier, True, 384) for tier in ("f32", "bf16", "bf16x3")])
#: the natural store has no three-factor form
STORE_CASES = [(*c, natural) for c in CASES for natural in (False, True)
               if not (natural and c[1])]
#: rows of a batch: JAX's natural store takes M divisible by 8
M = 16


def _ids(cases):
    return [f"{t}{',split3' if s else ''}-{n}"
            + ("" if not c else ("-natural" if c[0] else "-transposed"))
            for t, s, n, *c in cases]


# ---------------------------------------- the plain versions against JAX

@pytest.mark.parametrize("tier,split3,n,natural", STORE_CASES,
                         ids=_ids(STORE_CASES))
def test_rows_plain_matches_jax_kernel_and_float64(switches, tier, split3, n,
                                                   natural):
    precision = _select(switches, tier, split3, n)
    assert planes.engine(n, precision, not natural) == (tier, split3)
    re_, im_ = _planes_np((1, M, n), seed=n)
    jre, jim = jnp.asarray(re_), jnp.asarray(im_)
    tre, tim = torch.from_numpy(re_), torch.from_numpy(im_)
    if natural:
        want = pf.fft1d_natural_large(jre, jim, True, JAX_PRECISION[precision])
        got = planes.fft1d_natural_large(tre, tim, True, precision)
    else:
        want = pf._fft1d_transposed(jre, jim, True, JAX_PRECISION[precision])
        got = planes.fft1d_transposed(tre, tim, True, precision)
    f64 = np.fft.ifft(re_.astype(np.float64) + 1j * im_, axis=-1) * n
    if not natural:
        f64 = f64.transpose(0, 2, 1)
    for g, w, r in zip(got, want, (f64.real, f64.imag)):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TO_JAX[tier]
        assert _rel(g.numpy(), r) <= TO_F64[tier]


@pytest.mark.parametrize("tier,split3,n,natural", STORE_CASES,
                         ids=_ids(STORE_CASES))
def test_fused_plain_matches_jax_kernel_and_float64(switches, tier, split3, n,
                                                    natural):
    """Channel 1 of the packed set with 3 live fields at a row offset across
    the Nyquist row (rows N/2 − 8 .. N/2 + 7)."""
    precision = _select(switches, tier, split3, n)
    rng = np.random.default_rng(n + 1)
    h0 = [rng.normal(size=(M, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0, 2 * np.pi, size=(M, n)).astype(np.float32)
    kw = dict(epsilon=1e-4, ch_start=1, ch_count=1, row_offset=n // 2 - 8)
    jfn = jfused.assemble_rowfft_natural if natural else jfused.assemble_rowfft
    tfn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    want = jfn(tuple(map(jnp.asarray, h0)), jnp.asarray(phase), 434.48, -1.0,
               precision=JAX_PRECISION[precision], packed=True, nch_live=3,
               **kw)
    h0_t, phase_t = tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase)
    got = tfn(h0_t, phase_t, 434.48, -1.0, precision=precision, **kw)
    # float64 transform of the port's own f32 assembly
    ar, ai = fused._assemble_plain(h0_t, phase_t, 434.48, -1.0, epsilon=1e-4,
                                   row_offset=kw["row_offset"], ch=1)
    f64 = np.fft.ifft(ar.double().numpy() + 1j * ai.double().numpy(),
                      axis=-1)[None] * n
    if not natural:
        f64 = f64.transpose(0, 2, 1)
    for g, w, r in zip(got, want, (f64.real, f64.imag)):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TO_JAX[tier]
        assert _rel(g.numpy(), r) <= TO_F64[tier]


# ----------------------------------------------------------- the solver

def _assert_bf16_tracks(got, want):
    """test_bfloat16_solver_tracks_jax's bands: JAX's CPU DEFAULT dots are
    f32, so its fields stand in for float64, and the port's bf16 fields lie
    within 1e-2·max of them."""
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z"):
        assert _rel(getattr(got, name), getattr(want, name)) <= 1e-2, name
    assert np.isfinite(got.normal).all() and np.isfinite(got.foam).all()


@pytest.mark.parametrize("natural", [False, True],
                         ids=["transposed", "natural"])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_bfloat16_solver_tracks_jax_at_96(backend, natural, monkeypatch):
    """Path (i)'s switches at N = 96 (rows and columns of 96, the half
    channel's of 48), precision="bfloat16", 3 steps; the natural regime
    with both packages' transposed-store caps at 32."""
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
        with pf.transposed_store_cap(32):
            got, want = _steps_against_jax(96, backend, "bfloat16")
    else:
        got, want = _steps_against_jax(96, backend, "bfloat16")
    _assert_bf16_tracks(got, want)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_bfloat16_complex_state_tracks_jax_at_106(backend):
    """The complex state at N = 106 = 2·53 (n1 = 53, the engine's odd
    depth padded to 56 on the card), precision="bfloat16", 3 steps; on
    ``pallas_fused`` the per-channel set."""
    cfg = OCEAN_DEMO.replace(resolution=106, precision="bfloat16")
    ref = JaxSolver(_jax_config(cfg), fft_backend=backend)
    port = OceanSolver(cfg, device="cpu", fft_backend=backend)
    assert not port.real_state and port.precision == "bfloat16"
    h0, h0c = _h0_pair(cfg, seed=106)
    js = ref.init(h0=h0, h0_conj=h0c)
    ts = state_from_numpy(js, "cpu")
    for _ in range(3):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    _assert_bf16_tracks(fields_to_numpy(tf), jf)


# ------------------------------------------------- the kernels' geometry

def _header_lanes_n1():
    """The header's lanes_n1 as a Python function of n: its return
    expression ``c ? a : b``, C's integer division as //."""
    body = re.search(r"constexpr int lanes_n1\(int n\) \{\s*return (.+?);",
                     HEADER.read_text()).group(1)
    cond, a, b = re.fullmatch(r"(.+) \? (.+) : (.+)", body).groups()
    code = f"({a}) if ({cond}) else ({b})".replace("/", "//")
    return lambda n: eval(code, {}, {"n": n})


def test_the_engines_n1_rule_is_split_lanes_at_every_even_length():
    lanes_n1 = _header_lanes_n1()
    for n in range(planes.MIN_N, planes.MAX_N + 1, 2):
        n1 = lanes_n1(n)
        assert n1 == planes._split_lanes(n)[0] == pf._split_lanes(n)[0], n
        assert n % n1 == 0 and (n1 == 128 or n // n1 == 2)


#: (tier, split3) of the engine's modes: every tier and form but f32 direct
ENGINE_MODES = [("bf16", False), ("bf16x3", False), ("f32", True),
                ("bf16", True), ("bf16x3", True)]


def _threads(rows, n):
    """MatrixEngine::threads: rows·n/2 threads up to 512 (block_threads),
    rounded up to whole warps, at least one."""
    t = min(rows * n // 2, 512)
    return max(32, -(-t // 32) * 32)


@pytest.mark.parametrize("tier,split3", ENGINE_MODES,
                         ids=[f"{t}{',split3' if s else ''}"
                              for t, s in ENGINE_MODES])
def test_every_even_length_has_a_matrix_block(tier, split3):
    """At every even N in [16, 8192] that is not a power of two (the
    three-factor form where 128 | N, transposed only), row and fused, at
    M = N and 1 and C = 1 and 5: the size rule takes it, the rows are a
    power of two within the store's cap whose two buffers (and one row's,
    131 KB at N = 8190) fit the card's shared memory, the threads are
    whole warps within 512, and the grid's ⌈M/R⌉ blocks a channel cover
    the M rows with a ragged last block only."""
    sms = 132
    for n in range(planes.MIN_N + 2, planes.MAX_N + 1, 2):
        if planes.is_power_of_two(n):
            continue
        if split3 and planes._split_lanes(n)[0] != 128:
            with pytest.raises(ValueError, match="three-factor"):
                planes.require_card_kernel(n, tier, split3)
            continue
        assert planes.matrix_mixed_shared_bytes(1, n) <= planes.SMEM_LIMIT
        for natural in (False, True) if not split3 else (False,):
            planes.require_card_kernel(n, tier, split3, fused=True)
            for c, m in ((1, n), (5, n), (1, 1)):
                rows = planes.mixed_rows(c, m, n, sms, natural, tier, split3)
                fused_rows = planes.fused_rows(c, m, n, sms, natural, tier,
                                               split3)
                assert rows == fused_rows
                assert rows & (rows - 1) == 0
                assert rows <= planes.mixed_max_rows(n, natural)
                assert (planes.matrix_mixed_shared_bytes(rows, n)
                        <= planes.SMEM_LIMIT)
                threads = _threads(rows, n)
                assert threads % 32 == 0 and 32 <= threads <= 512
                grid = -(-m // rows)
                assert (grid - 1) * rows < m <= grid * rows


@pytest.mark.parametrize("lowered", [False, True],
                         ids=["defaults", "thresholds_at_0"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_check_card_sizes_takes_every_even_length(precision, lowered,
                                                  monkeypatch):
    """check_card_sizes returns for every even N in [16, 8192], fused or
    not, with the half channel's N/2 columns where N/2 is an even length
    too,
    with both thresholds at their defaults or at 0 (bf16x3 and the
    three-factor form wherever they apply); it raises ValueError for odd N
    and N outside that range."""
    if lowered:
        monkeypatch.setattr(planes, "KERNEL_B3_THRESHOLD", 0)
        monkeypatch.setattr(planes, "THREE_FACTOR_THRESHOLD", 0)
    for n in range(planes.MIN_N, planes.MAX_N + 1, 2):
        for fused in (False, True):
            planes.check_card_sizes(n, precision, fused=fused,
                                    half=n % 4 == 0 and n >= 32)
    for n in (15, 17, 95, 8191, 14, 8194, 16384):
        for fused in (False, True):
            with pytest.raises(ValueError, match="even lengths"):
                planes.check_card_sizes(n, precision, fused=fused)


def test_matrix_rows_per_block():
    """8 transposed rows of 1536 (two buffers of 8 rows: 197 KB), 4 of 2042;
    natural: 4 rows of 768 (4096 // 768 = 5, rounded down), 2 of 1536, one
    from 3072 on; a one-row pass takes one."""
    def rows(m, n, natural):
        return planes.mixed_rows(1, m, n, 132, natural, "bf16", False)
    assert rows(1536, 1536, False) == 8 and rows(2042, 2042, False) == 4
    assert rows(768, 768, True) == 4 and rows(1536, 1536, True) == 2
    assert rows(3072, 3072, True) == 1 and rows(8190, 8190, True) == 1
    assert rows(1, 1536, False) == 1
    assert planes.matrix_mixed_shared_bytes(1, 8190) == 2 * 8191 * 8


def test_large_tables_are_cached_two_at_a_time():
    """At n1 above LARGE_N1 the tables (F1 alone 134 MB at n1 = 4095) are
    cached in a cache of their own of two entries, the small ones in 32."""
    planes.matrix_tables.cache_clear()
    planes._tables_np.cache_clear()
    cpu = torch.device("cpu")
    small = planes.matrix_tables(96, True, False, cpu)
    for n in (2052, 2054, 2058):          # n1 = 1026, 1027, 1029
        for inverse in (True, False):
            planes.matrix_tables(n, inverse, False, cpu)
    assert planes.matrix_tables(96, True, False, cpu) is small
    tab = planes.matrix_tables(2058, False, False, cpu)
    assert planes.matrix_tables(2058, False, False, cpu) is tab
    planes.matrix_tables(2052, True, False, cpu)
    planes.matrix_tables(2054, True, False, cpu)
    assert planes.matrix_tables(2058, False, False, cpu) is not tab
    assert tab.shape == (4 + 2 * 1029 + 1029 ** 2, 2)
    planes.matrix_tables.cache_clear()
    planes._tables_np.cache_clear()
