"""The port's precision tiers and three-factor form against the JAX package
(Pallas in interpret mode, its module switches monkeypatched as its own
tests do): the tables, the tier and form rules, the plain versions of the
matrix-form engine (fft/matrix.py) against the JAX kernels and against
float64, and OceanSolver at precision="bfloat16".

Bands (max abs error over max |reference|):
- against float64: 1e-2 at bf16, 5e-5 at bf16x3 (tests/test_pallas_kernels
  .py:232), 1e-5 for the three-factor form at f32 (:259);
- against the JAX kernel: bf16x3 and f32 three-factor as against float64
  (JAX rounds bf16x3 for real, with jnp casts); at bf16 the JAX package's
  envelope 3e-2 (tests/test_switch_matrix.py:93), since XLA's DEFAULT dot on
  the CPU is plain f32 while the port rounds to bf16.

At bf16x3 both packages run stage 1 (F2) at f32 and split the stage-2
operands only (``p1 = HIGHEST`` in the JAX kernels): the real plane, t1 −
t2 in both, within 1.5e-6·max of the JAX kernel for the row DFT and 2e-6
for the fused kernel (with stage 1 split too the port read 3.6–4.5e-6 and
3.5–4.1e-6 there); the imaginary plane, which JAX forms with Gauss's
t3 − t1 − t2, within the bf16x3 band.

The JAX package cannot run bf16x3 in the three-factor form:
``_stage2_split3`` passes its tier "bf16x3" on to ``lax.dot_general``,
which refuses it (ValueError). Against that pair the JAX side runs the
three-factor form at f32 (HIGHEST), within the bf16x3 band.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean import config as jcfg
from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean.ops import fused_spectrum_fft as jfused
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import OCEAN_DEMO, OceanSolver, fields_to_numpy, state_from_numpy
from tpu_ocean_torch.fft import matrix, planes
from tpu_ocean_torch.ops import fused_spectrum as fused
import chip_smoke
from tests.test_packing import _assert_fields_close
from tests.test_torch_solver import SLICE, _h0_pair

OFF = 1 << 30
TO_F64 = {"bf16": 1e-2, "bf16x3": 5e-5, "f32": 1e-5}
TO_JAX = {"bf16": 3e-2, "bf16x3": 5e-5, "f32": 1e-5}
JAX_PRECISION = {"bfloat16": jax.lax.Precision.DEFAULT,
                 "float32": jax.lax.Precision.HIGHEST}


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.fixture
def switches(monkeypatch):
    """Set KERNEL_B3_THRESHOLD and THREE_FACTOR_THRESHOLD in both packages."""
    def set_both(b3=OFF, split3=OFF):
        for mod in (pf, planes):
            monkeypatch.setattr(mod, "KERNEL_B3_THRESHOLD", b3)
            monkeypatch.setattr(mod, "THREE_FACTOR_THRESHOLD", split3)
        if split3 < OFF:
            # bf16x3 × three-factor raises in the JAX package: f32 there
            monkeypatch.setattr(pf, "KERNEL_B3_THRESHOLD", OFF)
    return set_both


# ---- tables and rules

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", [16, 64, 128, 256, 1024, 4096])
def test_tables_are_bit_equal_to_jax(n, inverse):
    got, want = planes._tables_np(n, inverse), pf._tables_np(n, inverse)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("inverse", [True, False])
def test_split3_tables_are_bit_equal_to_jax(inverse):
    for g, w in zip(planes._split3_tables_np(128, inverse),
                    pf._split3_tables_np(128, inverse)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("b3,split3", [(OFF, OFF), (512, 512), (128, 64),
                                       (0, 0)])
def test_tier_and_form_rules_agree_with_jax(monkeypatch, b3, split3):
    for mod in (pf, planes):
        monkeypatch.setattr(mod, "KERNEL_B3_THRESHOLD", b3)
        monkeypatch.setattr(mod, "THREE_FACTOR_THRESHOLD", split3)
    for n in [2 ** k for k in range(4, 14)]:
        n1 = planes._split_lanes(n)[0]
        assert n1 == pf._split_lanes(n)[0]
        assert (planes.kernel_tier(n, "float32") == "bf16x3") == (
            pf.kernel_precision(n, jax.lax.Precision.HIGHEST) == pf.B3)
        assert planes.kernel_tier(n, "bfloat16") == "bf16"
        assert (pf.kernel_precision(n, jax.lax.Precision.DEFAULT)
                == jax.lax.Precision.DEFAULT)
        assert planes.use_split3(n, n1) == pf._use_split3(n, n1)
        # the natural store has no three-factor form
        assert not planes.engine(n, "float32", transposed=False)[1]


def test_kernel_tier_refuses_other_precisions():
    with pytest.raises(ValueError, match="precision"):
        planes.kernel_tier(256, "float16")


@pytest.mark.parametrize("split3", [False, True])
def test_matrix_tables_are_laid_out_as_the_engine_reads_them(split3):
    n1, n2, *mats = planes._tables_np(1024, True)
    if split3:
        mats = mats[:4] + list(planes._split3_tables_np(n1, True))
    t = planes.matrix_tables(1024, True, split3, torch.device("cpu")).numpy()
    sizes = [a.size for a in mats[::2]]
    assert t.shape == (sum(sizes), 2)
    starts = np.cumsum([0] + sizes)
    for j, (re, im) in enumerate(zip(mats[::2], mats[1::2])):
        np.testing.assert_array_equal(t[starts[j]:starts[j + 1], 0], re.ravel())
        np.testing.assert_array_equal(t[starts[j]:starts[j + 1], 1], im.ravel())


def _unpermute_fragments(frags):
    """The real-form matrix [2·8mt, 2·8kt] (rows: re of every output, then
    im; columns: re of every depth k, then im) as bf16 bits, read back from
    A fragments uint32 [mt, kt, 32, 4] by mma.sync.m16n8k16's layout:
    register j of lane (g, q) holds rows g (j even) or g + 8 (j odd) of the
    16 × 16 tile and its columns 2q, 2q + 1 (j < 2) or 2q + 8, 2q + 9, the
    first in the low half; a column pair is (re, im) of one depth, pair c
    being k = 8·kb + 2·(c mod 4) + c div 4."""
    mt, kt = frags.shape[:2]
    out = np.zeros((2 * 8 * mt, 2 * 8 * kt), np.uint16)
    for tm in range(mt):
        for kb in range(kt):
            for lane in range(32):
                g, q = divmod(lane, 4)
                for j in range(4):
                    word = int(frags[tm, kb, lane, j])
                    c = q + 4 * (j // 2)
                    i = 8 * tm + g
                    k = 8 * kb + 2 * (c % 4) + c // 4
                    row = i + (8 * mt if j % 2 else 0)
                    out[row, k] = word & 0xFFFF
                    out[row, 8 * kt + k] = word >> 16
    return out


def _real_form_bits(fr, fi, to_bf16):
    """[[Fr, −Fi], [Fi, Fr]] of f32 (m, k) tables, zero-padded to whole
    8 × 8 tiles, as the bits of ``to_bf16`` (a rounding to bfloat16)."""
    m, k = fr.shape
    pad = ((0, -m % 8), (0, -k % 8))
    fr, fi = np.pad(fr, pad), np.pad(fi, pad)
    real = np.block([[fr, -fi], [fi, fr]])
    return np.asarray(to_bf16(real)).view(np.uint16)


def _jnp_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))


def _torch_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).view(
        torch.int16).numpy()


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", [16, 64, 128, 1024, 4096, 8192])
def test_bf16_rows_tables_are_the_f32_tables_rounded(n, inverse):
    """The bf16 transposed row kernel's tables (csrc/dft_bf16_rows.cuh):
    F2 and F1 are the f32 tables of _tables_np rounded to bf16 bit for bit,
    as torch rounds them (the plain version) and as the JAX package's
    tables cast with jnp.bfloat16; T is the f32 table itself."""
    n1, n2, f2r, f2i, tr, ti, f1r, f1i = planes._tables_np(n, inverse)
    jn1, jn2, *jax_mats = pf._tables_np(n, inverse)
    assert (jn1, jn2) == (n1, n2)
    words = planes.bf16_rows_tables_np(n, inverse).view(np.uint32)
    k1, k2 = -(-n1 // 8), -(-n2 // 8)
    f2_words, t_words = k2 * k2 * 128, 2 * n
    assert words.size == f2_words + t_words + k1 * k1 * 128
    f2 = _unpermute_fragments(words[:f2_words].reshape(k2, k2, 32, 4))
    f1 = _unpermute_fragments(words[f2_words + t_words:].reshape(k1, k1, 32, 4))
    jf2r, jf2i, jtr, jti, jf1r, jf1i = jax_mats
    for got, (fr, fi), (jr, ji) in ((f2, (f2r, f2i), (jf2r, jf2i)),
                                   (f1, (f1r, f1i), (jf1r, jf1i))):
        np.testing.assert_array_equal(got, _real_form_bits(fr, fi, _torch_bf16))
        np.testing.assert_array_equal(got, _real_form_bits(jr, ji, _jnp_bf16))
    t = words[f2_words:f2_words + t_words].view(np.float32).reshape(n2, n1, 2)
    np.testing.assert_array_equal(t[..., 0], jtr)
    np.testing.assert_array_equal(t[..., 1], jti)


@pytest.mark.parametrize("m,k", [(1, 1), (2, 2), (4, 4), (8, 8), (8, 16),
                                 (24, 8), (64, 64)])
def test_mma_a_fragments_unpermute_to_the_real_form(m, k):
    """Reading mma_a_fragments back by the PTX fragment layout gives the
    real form [[Fr, −Fi], [Fi, Fr]] of any table, zero-padded to whole
    tiles: a register or lane out of place, or a wrong sign, would not."""
    rng = np.random.default_rng(m * 100 + k)
    fr, fi = (rng.normal(size=(m, k)).astype(np.float32) for _ in range(2))
    frags = planes.mma_a_fragments(fr, fi)
    assert frags.shape == (-(-m // 8), -(-k // 8), 32, 4)
    assert frags.dtype == np.uint32
    np.testing.assert_array_equal(_unpermute_fragments(frags),
                                  _real_form_bits(fr, fi, _torch_bf16))


@pytest.mark.parametrize("shape,rows", [
    ((1, 1024, 1024), 8), ((1, 512, 1024), 4), ((1, 1024, 512), 8),
    ((1, 1, 1024), 1), ((1, 4096, 4096), 4), ((1, 4096, 2048), 8),
    ((1, 64, 8192), 1), ((1, 3000, 8192), 2)])
def test_bf16_rows_blocks_fit_shared_memory(shape, rows):
    """The bf16 row kernel's rows per block: its bf16 buffers take twice
    the rows of the engine's two f32 buffers at N = 4096 and 8192, within
    the card's shared memory, with either store; other passes keep
    theirs (the f32 direct passes their own kernels')."""
    c, m, n = shape
    shared = planes.block_shared_bytes("bf16", False, natural=False)
    assert shared is planes.bf16_rows_shared_bytes
    assert planes.block_shared_bytes("bf16", False, natural=True) is shared
    got = planes.rows_per_block(c, m, n, sms=132, shared=shared)
    assert got == rows
    assert shared(got, n) <= planes.SMEM_LIMIT
    for tier, split3, natural in (("bf16", True, False),
                                  ("bf16x3", False, False),
                                  ("bf16x3", False, True)):
        assert (planes.block_shared_bytes(tier, split3, natural)
                is planes.shared_bytes)
    assert (planes.block_shared_bytes("f32", False, True)
            is planes.radix16_shared_bytes)
    assert (planes.block_shared_bytes("f32", False, False)
            is planes.cluster_rows_block_bytes)


# ---- the row DFT and fused plain versions against the JAX kernels

# (tier, split3, n): the direct tiers at N = 64 (n1 = 32, n2 = 2) and 256;
# the three-factor form at N = 256 with the threshold at 128
CASES = [("bf16", False, 64), ("bf16", False, 256),
         ("bf16x3", False, 64), ("bf16x3", False, 256),
         ("f32", True, 256), ("bf16x3", True, 256), ("bf16", True, 256)]
# the natural store has no three-factor form
STORE_CASES = [(*c, natural) for c in CASES for natural in (False, True)
               if not (natural and c[1])]


def _select(switches, tier, split3, n):
    """Switch both packages to (tier, split3) at side n; returns the
    port's precision argument."""
    switches(b3=n // 2 if tier == "bf16x3" else OFF,
             split3=n // 2 if split3 else OFF)
    return "bfloat16" if tier == "bf16" else "float32"


def _planes_np(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("tier,split3,n,natural", STORE_CASES)
def test_rows_plain_matches_jax_kernel_and_float64(switches, tier, split3, n,
                                                   natural):
    precision = _select(switches, tier, split3, n)
    assert planes.engine(n, precision, not natural) == (tier, split3)
    re, im = _planes_np((1, 16, n), seed=n)
    jre, jim = jnp.asarray(re), jnp.asarray(im)
    if natural:
        want = pf.fft1d_natural_large(jre, jim, True, JAX_PRECISION[precision])
        got = planes.fft1d_natural_large(torch.from_numpy(re),
                                         torch.from_numpy(im), True, precision)
    else:
        want = pf._fft1d_transposed(jre, jim, True, JAX_PRECISION[precision])
        got = planes.fft1d_transposed(torch.from_numpy(re),
                                      torch.from_numpy(im), True, precision)
    f64 = np.fft.ifft(re.astype(np.float64) + 1j * im, axis=-1) * n
    if not natural:
        f64 = f64.transpose(0, 2, 1)
    for g, w, r in zip(got, want, (f64.real, f64.imag)):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TO_JAX[tier]
        assert _rel(g.numpy(), r) <= TO_F64[tier]


@pytest.mark.parametrize("tier,split3,n,natural", STORE_CASES)
def test_fused_plain_matches_jax_kernel_and_float64(switches, tier, split3, n,
                                                    natural):
    precision = _select(switches, tier, split3, n)
    m = 16
    rng = np.random.default_rng(n + 1)
    h0 = [rng.normal(size=(m, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0, 2 * np.pi, size=(m, n)).astype(np.float32)
    kw = dict(epsilon=1e-4, ch_start=1, ch_count=1, row_offset=0)
    jfn = jfused.assemble_rowfft_natural if natural else jfused.assemble_rowfft
    tfn = fused.assemble_rowfft_natural if natural else fused.assemble_rowfft
    want = jfn(tuple(map(jnp.asarray, h0)), jnp.asarray(phase), 434.48, -1.0,
               precision=JAX_PRECISION[precision], packed=True, nch_live=3,
               **kw)
    h0_t, phase_t = tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase)
    got = tfn(h0_t, phase_t, 434.48, -1.0, precision=precision, **kw)
    # float64 transform of the port's own f32 assembly
    ar, ai = fused._assemble_plain(h0_t, phase_t, 434.48, -1.0, epsilon=1e-4,
                                   row_offset=0, ch=1)
    f64 = np.fft.ifft(ar.double().numpy() + 1j * ai.double().numpy(),
                      axis=-1)[None] * n
    if not natural:
        f64 = f64.transpose(0, 2, 1)
    for g, w, r in zip(got, want, (f64.real, f64.imag)):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TO_JAX[tier]
        assert _rel(g.numpy(), r) <= TO_F64[tier]


# the real plane at B3 against the JAX kernel: rows and fused (above)
B3_REAL_TO_JAX = {"rows": 1.5e-6, "fused": 2e-6}


@pytest.mark.parametrize("n", [256, 1024])
def test_b3_rows_plain_runs_stage_1_at_f32_as_jax(switches, n):
    """The plain row DFT at bf16x3 in the direct form against the JAX
    kernel at B3 (pf._fft1d_transposed, interpret mode) on 16 seeded rows:
    their real planes are t1 − t2 of the same split operands and differ
    by f32 rounding alone where both keep stage 1 at f32."""
    precision = _select(switches, "bf16x3", False, n)
    re, im = _planes_np((1, 16, n), seed=n)
    want = pf._fft1d_transposed(jnp.asarray(re), jnp.asarray(im), True,
                                JAX_PRECISION[precision])
    got = planes.fft1d_transposed(torch.from_numpy(re), torch.from_numpy(im),
                                  True, precision)
    assert _rel(got[0].numpy(), want[0]) <= B3_REAL_TO_JAX["rows"]
    assert _rel(got[1].numpy(), want[1]) <= TO_JAX["bf16x3"]


@pytest.mark.parametrize("n", [256, 1024])
def test_b3_fused_plain_runs_stage_1_at_f32_as_jax(switches, n):
    """assemble_rowfft_plain at bf16x3 in the direct form against the JAX
    fused kernel at B3 on 16 seeded rows of channel 1 (the real plane
    read 0.83–1.17e-6·max at N = 256 and 1024 on two seeds, 3.5–4.1e-6
    with stage 1 split)."""
    precision = _select(switches, "bf16x3", False, n)
    m = 16
    rng = np.random.default_rng(n + 1)
    h0 = [rng.normal(size=(m, n)).astype(np.float32) for _ in range(4)]
    phase = rng.uniform(0, 2 * np.pi, size=(m, n)).astype(np.float32)
    kw = dict(epsilon=1e-4, ch_start=1, ch_count=1, row_offset=0)
    want = jfused.assemble_rowfft(
        tuple(map(jnp.asarray, h0)), jnp.asarray(phase), 434.48, -1.0,
        precision=JAX_PRECISION[precision], packed=True, nch_live=3, **kw)
    got = fused.assemble_rowfft_plain(
        tuple(map(torch.from_numpy, h0)), torch.from_numpy(phase), 434.48,
        -1.0, precision=precision, **kw)
    assert _rel(got[0].numpy(), want[0]) <= B3_REAL_TO_JAX["fused"]
    assert _rel(got[1].numpy(), want[1]) <= TO_JAX["bf16x3"]


def test_bf16x3_keeps_stage_1_at_f32():
    """rows_dft at bf16x3 equals, bit for bit, stage 1 at f32 followed by
    the bf16x3 stage 2: with one row whose stage 1 is exact at f32 but not
    at bf16x3 (the depth sums of a split operand round otherwise)."""
    n = 256
    n1, n2, f2r, f2i, tr, ti, f1r, f1i = planes._tables_np(n, True)
    re, im = (torch.from_numpy(a) for a in _planes_np((1, 2, n), seed=5))
    got = matrix.rows_dft(re, im, planes._tables_np(n, True), None, "bf16x3")
    t = [torch.from_numpy(a) for a in (f2r, f2i, tr, ti, f1r, f1i)]
    cr, ci = matrix._cmatmul(t[0], t[1], re.reshape(1, 2, n2, n1),
                             im.reshape(1, 2, n2, n1), "f32")
    cr, ci = matrix._twiddle(cr, ci, t[2], t[3])
    dr, di = matrix._cmatmul(t[4], t[5], cr.transpose(-1, -2),
                             ci.transpose(-1, -2), "bf16x3")
    assert torch.equal(got[0], dr.reshape(1, 2, n))
    assert torch.equal(got[1], di.reshape(1, 2, n))


def test_bf16_rounds_operands_and_bf16x3_splits_them():
    x = torch.tensor([1.0 + 2 ** -9, 3.0, -1.0 - 3 * 2 ** -9])
    np.testing.assert_array_equal(matrix.round_bf16(x).numpy(),
                                  [1.0, 3.0, -1.0 - 2 ** -7])  # ties to even
    hi, lo = matrix.split_bf16(x)
    assert torch.equal(hi + lo, x)


def test_cpu_calls_do_not_count_matrix_launches():
    re, im = map(torch.from_numpy, _planes_np((1, 8, 64), 3))
    planes.named_launches.clear()
    planes.fft1d_transposed(re, im, True, "bfloat16")
    assert not planes.named_launches


# ---- the solver

def _steps_against_jax(n, backend, precision, steps=3):
    cfg = OCEAN_DEMO.replace(resolution=n, precision=precision)
    ref = JaxSolver(jcfg.OceanConfig(**dataclasses.asdict(cfg)),
                    **{**SLICE, "fft_backend": backend})
    h0, h0c = _h0_pair(cfg, seed=n)
    js = ref.init(h0=h0, h0_conj=h0c)
    port = OceanSolver(cfg, device="cpu", **{**SLICE, "fft_backend": backend})
    assert port.precision == precision
    ts = state_from_numpy(js, "cpu")
    for _ in range(steps):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    return fields_to_numpy(tf), jf


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("n", [64, 128])
def test_bfloat16_solver_tracks_jax(n, backend, natural, monkeypatch):
    """precision="bfloat16", 3 steps, both regimes (natural forced with the
    cap at 32 as tests/test_torch_fused.py does). JAX's CPU DEFAULT dots
    are f32, so its fields stand in for float64: the port's bf16 fields
    within 1e-2·max of them, inside the JAX envelope of 3e-2."""
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
        with pf.transposed_store_cap(32):
            got, want = _steps_against_jax(n, backend, "bfloat16")
    else:
        got, want = _steps_against_jax(n, backend, "bfloat16")
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z"):
        assert _rel(getattr(got, name), getattr(want, name)) <= 1e-2, name
    assert np.isfinite(got.normal).all() and np.isfinite(got.foam).all()


@pytest.mark.parametrize("tier", ["f32", "bf16x3"])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_float32_solver_with_lowered_switches_matches_jax(switches, backend,
                                                          tier):
    """N = 128 (n1 = 128, n2 = 1) with THREE_FACTOR_THRESHOLD = 64 in both
    packages: every 128-long pass takes the three-factor form (#1b, #5b);
    with KERNEL_B3_THRESHOLD = 64 too, at bf16x3 (the JAX side at f32,
    see the module docstring). The fields within tests/test_packing.py's
    bands at 1e-5 (f32) or, at bf16x3, 5e-5 with chip_smoke.py's
    sensitivity bands for normals and foam."""
    switches(b3=64 if tier == "bf16x3" else OFF, split3=64)
    assert planes.engine(128, "float32", True) == (tier, True)
    got, want = _steps_against_jax(128, backend, "float32")
    if tier == "f32":
        _assert_fields_close(got, want, 1e-5)
        return
    # at bf16x3 a few fold texels' normals move by more than 2e-4 for the
    # ~5e-6 input error: chip_smoke's first-order sensitivity band
    want = type(got)(*(np.asarray(getattr(want, k)) for k in got._fields))
    chip_smoke.compare_fields(got, want, OCEAN_DEMO.replace(resolution=128),
                              "bf16x3", against="jax", rel=TO_F64[tier])


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_bfloat16_really_engages(backend):
    """The port's bf16 fields differ from its f32 fields (JAX's CPU ones
    cannot, test_switch_matrix.py:94-97), by about bf16's rounding."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    h0, h0c = _h0_pair(cfg, seed=2)
    out = {}
    for precision in ("float32", "bfloat16"):
        s = OceanSolver(cfg.replace(precision=precision), device="cpu",
                        **{**SLICE, "fft_backend": backend})
        _, f = s.step(s.init(h0=h0, h0_conj=h0c), 1 / 60)
        out[precision] = f.height.numpy()
    rel = _rel(out["bfloat16"], out["float32"])
    assert 1e-4 < rel < 1e-2
