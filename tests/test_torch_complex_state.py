"""The port's complex state (``real_state=False``), its backends' modules
and the centered layout, against the float64 oracle and the JAX package.

- Oracle parity: ``OceanSolver`` with the JAX package's defaults (the
  ``reference`` backend, the complex state) on tests/test_parity.py's
  centered case and injected h0, with its bands: 64² after one step (rtol
  1e-4, atol 2e-5·max, foam 25× with the 0.1% texel rule) and after 20
  steps (rtol 1e-3, atol 2e-4·max); N = 12 at L = 12, unit width 1 (the
  FFT Mesh demo's grid; its own L = 12.39 is not N·unit_width and needs
  eval_mode="direct", tests/test_torch_eval_direct.py); odd N = 9 and 15. The other
  centered backends at 64² and ``matmul`` at odd N, where the JAX package
  sends ``pallas`` there, the same way.
- The modules: each backend's transform, the centered modulation, the
  complex assembly, the Hermitian projection and the oracle's foam
  against the JAX functions.
- The state: init (injected or drawn), symmetrize, state_from_numpy and
  state_to_numpy.
- bfloat16: ``matmul`` and ``pallas`` against the JAX f32 solver within
  its bf16 envelope 3e-2 (tests/test_switch_matrix.py:93), and against the
  port's bf16 plain tier.
- The defaults and every ValueError rule of the JAX constructor, and its
  warn-and-use-``matmul`` size rule.

The backend matrix against the JAX solver is tests/test_torch_complex_backends.py."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, evolve as jev, fields as jfields
from tpu_ocean import grids as jgrids
from tpu_ocean.fft import get_ifft2 as jax_get_ifft2
from tpu_ocean.fft.reference import centered_modulation as jax_modulation
from tpu_ocean.oracle import Oracle
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, OceanConfig, OceanSolver, Simulation,
                             OceanState, OceanStateReal, fields_to_numpy,
                             state_from_numpy, state_to_numpy)
from tpu_ocean_torch import evolve as tev, fields as tfields, grids as tgrids
from tpu_ocean_torch.fft import BACKENDS, get_ifft2
from tpu_ocean_torch.fft.matmul import ifft2_matmul
from tpu_ocean_torch.fft.reference import centered_modulation
from tpu_ocean_torch.fft.stockham import ifft2_stockham
from tests.test_parity import _assert_fields_close as assert_oracle_close
from tests.test_parity import _make_case
from tests.test_torch_complex_backends import assert_fields_match

DT = 1.0 / 60.0


def _port_case(n, length=None, amplitude=0.05):
    """tests/test_parity.py's centered case as a port config, with its
    injected pair and the oracle on that pair."""
    cfg, h0, h0c = _make_case(n, length, amplitude=amplitude)
    return (OceanConfig(**dataclasses.asdict(cfg)), h0, h0c,
            Oracle(cfg, h0=h0, h0_conj=h0c))


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _run(solver, h0, h0c, steps):
    state = solver.init(h0=h0, h0_conj=h0c)
    for _ in range(steps):
        state, fields = solver.step(state, DT)
    return state, fields


# ---------------------------------------------------------------- oracle

def test_default_solver_matches_oracle_64sq_one_step():
    """BASELINE config 1 on the port's defaults."""
    cfg, h0, h0c, oracle = _port_case(64)
    solver = OceanSolver(cfg, device="cpu")
    assert (solver.fft_backend, solver.real_state) == ("reference", False)
    state, fields = _run(solver, h0, h0c, 1)
    assert isinstance(state, OceanState)
    assert_oracle_close(fields_to_numpy(fields), oracle.fields(DT),
                        rtol=1e-4, atol_scale=2e-5)


def test_default_solver_matches_oracle_64sq_20_steps():
    """Config 2's bands after 20 steps (absolute time: the oracle at 20·dt)."""
    cfg, h0, h0c, oracle = _port_case(64)
    _, fields = _run(OceanSolver(cfg, device="cpu"), h0, h0c, 20)
    assert_oracle_close(fields_to_numpy(fields), oracle.fields(20 * DT),
                        rtol=1e-3, atol_scale=2e-4)


@pytest.mark.parametrize("backend", ["stockham", "matmul", "pallas"])
def test_centered_backends_match_oracle_64sq_one_step(backend):
    cfg, h0, h0c, oracle = _port_case(64)
    _, fields = _run(OceanSolver(cfg, device="cpu", fft_backend=backend),
                     h0, h0c, 1)
    assert_oracle_close(fields_to_numpy(fields), oracle.fields(DT),
                        rtol=1e-4, atol_scale=2e-5)


def test_fft_mesh_grid_matches_oracle():
    """N = 12 at L = 12, unit width 1: the FFT Mesh demo's grid at a length
    the centered transform lands on exactly."""
    cfg, h0, h0c, oracle = _port_case(12, 12.0)
    assert (cfg.resolution, cfg.length, cfg.unit_width) == (12, 12.0, 1.0)
    _, fields = _run(OceanSolver(cfg, device="cpu"), h0, h0c, 1)
    assert_oracle_close(fields_to_numpy(fields), oracle.fields(DT),
                        rtol=1e-4, atol_scale=2e-5)


@pytest.mark.parametrize("backend", ["reference", "matmul"])
@pytest.mark.parametrize("n", [9, 15])
def test_odd_n_matches_oracle(n, backend):
    """Odd N: η = ½ in the modulation for both parities (c2e6e55)."""
    cfg, h0, h0c, oracle = _port_case(n)
    _, fields = _run(OceanSolver(cfg, device="cpu", fft_backend=backend),
                     h0, h0c, 1)
    assert_oracle_close(fields_to_numpy(fields), oracle.fields(DT),
                        rtol=1e-4, atol_scale=2e-5)


# ---------------------------------------------------------------- modules

def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("n", [16, 64])
def test_backend_transforms_match_float64_and_jax(backend, n):
    """Each backend's unnormalized inverse FFT2 of [3, N, N] within 1e-6·max
    of float64 numpy, and within 2e-6·max of the JAX backend's."""
    x = _complex((3, n, n), seed=n)
    want = np.fft.ifft2(x.astype(np.complex128)) * (n * n)
    got = get_ifft2(backend, n)(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert got.dtype == np.complex64 and got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-6 * scale
    jax_out = np.asarray(jax_get_ifft2(backend, n)(x))
    assert np.abs(got - jax_out).max() <= 2e-6 * scale


@pytest.mark.parametrize("n", [9, 12, 24])
def test_matmul_takes_any_n_and_both_forms(n):
    x = torch.from_numpy(_complex((2, n, n), seed=n))
    want = np.fft.ifft2(x.numpy().astype(np.complex128)) * (n * n)
    for mode in ("four_step", "direct"):
        got = ifft2_matmul(x, mode=mode).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), mode


def test_unknown_backend_and_sizes_raise():
    with pytest.raises(ValueError):
        get_ifft2("cufft", 64)
    with pytest.raises(ValueError):
        ifft2_stockham(torch.from_numpy(_complex((1, 12, 12), seed=0)))
    with pytest.raises(ValueError):
        ifft2_matmul(torch.from_numpy(_complex((1, 16, 16), seed=0)),
                     precision="float16")


@pytest.mark.parametrize("n", [8, 9, 12, 16])
def test_centered_modulation_bit_equal(n):
    for a, b in zip(tgrids.centered_ifft_factors(n, float(n), 1.0),
                    jgrids.centered_ifft_factors(n, float(n), 1.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(centered_modulation(n, float(n), 1.0),
                    jax_modulation(n, float(n), 1.0)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        centered_modulation(n, 12.39, 1.0)


def _pair_and_phase(n, seed):
    rng = np.random.default_rng(seed)
    return (_complex((n, n), seed), _complex((n, n), seed + 1),
            rng.uniform(0, 2 * np.pi, size=(n, n)).astype(np.float32))


def test_complex_assembly_and_projection_match_jax():
    n = 32
    h0, h0c, phase = _pair_and_phase(n, 3)
    cfg = OCEAN_DEMO.replace(resolution=n)
    coeffs = np.asarray(tev.spectrum_coefficients(cfg).real, np.float32)
    pack = np.asarray(tev.packed_coefficients(cfg, 5), np.float32)
    t = [torch.from_numpy(a) for a in (h0, h0c, phase)]
    got = tev.assemble_spectra(*t, torch.from_numpy(coeffs)).numpy()
    want = np.asarray(jev.assemble_spectra(h0, h0c, phase, coeffs))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    got = tev.assemble_spectra_packed(*t, torch.from_numpy(pack)).numpy()
    want = np.asarray(jev.assemble_spectra_packed(h0, h0c, phase, pack))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    a, ac = tev.hermitize_pair(t[0], t[1])
    ja, jac = jev.hermitize_pair(h0, h0c)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
    again = tev.hermitize_pair(a, ac)
    assert torch.equal(again[0], a) and torch.equal(again[1], ac)


def test_whitecap_oracle_matches_jax():
    rng = np.random.default_rng(8)
    dx, dz = (rng.normal(scale=0.7, size=(24, 40)).astype(np.float32)
              for _ in range(2))
    normal = rng.normal(size=(24, 40, 3)).astype(np.float32)
    got = tfields.whitecap_oracle(torch.from_numpy(dx), torch.from_numpy(dz),
                                  torch.from_numpy(normal))
    want = jfields.whitecap_oracle(dx, dz, normal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------- the state

@pytest.mark.parametrize("layout,packed", [("centered", False),
                                           ("fft", False), ("fft", True)])
def test_injected_init_bit_equal_to_jax(layout, packed):
    """The injected pair, symmetrized only where packed, as the JAX init."""
    cfg, h0, h0c, _ = _port_case(32)
    cfg = cfg.replace(spectrum_layout=layout)
    js = JaxSolver(_jax_cfg(cfg), pack_channels=packed).init(h0=h0,
                                                             h0_conj=h0c)
    ts = OceanSolver(cfg, device="cpu", pack_channels=packed).init(
        h0=h0, h0_conj=h0c)
    assert ts.h0.dtype == torch.complex64
    for name in OceanState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    if not packed:
        np.testing.assert_array_equal(ts.h0.numpy(), h0.astype(np.complex64))


def test_drawn_init_matches_the_real_state_draw():
    """One generator state gives the complex and the real state one h0; the
    centered draw is seeded and takes P at ±k of the centered grid."""
    cfg = OCEAN_DEMO.replace(resolution=32)
    c = OceanSolver(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    r = OceanSolver(cfg, device="cpu", fft_backend="pallas",
                    real_state=True).init(torch.Generator().manual_seed(3))
    assert isinstance(r, OceanStateReal)
    for a, b in ((c.h0.real, r.h0_re), (c.h0.imag, r.h0_im),
                 (c.h0_conj.real, r.h0c_re), (c.h0_conj.imag, r.h0c_im)):
        assert torch.equal(a, b)
    centered = OceanSolver(OceanConfig(resolution=32, length=32.0),
                           device="cpu")
    a, b = centered.init(), centered.init()
    assert torch.equal(a.h0, b.h0) and torch.equal(a.h0_conj, b.h0_conj)
    assert a.h0.abs().max() > 0 and a.h0[16, 16] == 0     # P(k = 0) = 0


def test_symmetrize_is_idempotent_on_the_complex_state():
    cfg = OCEAN_DEMO.replace(resolution=32)
    solver = OceanSolver(cfg, device="cpu", pack_channels=True)
    a = solver.init()
    again = solver.symmetrize(a)
    assert torch.equal(a.h0, again.h0) and torch.equal(a.h0_conj,
                                                       again.h0_conj)


def test_state_from_numpy_round_trips_a_complex_jax_state():
    cfg, h0, h0c, _ = _port_case(32)
    ref = JaxSolver(_jax_cfg(cfg))
    js, _ = ref.step(ref.init(h0=h0, h0_conj=h0c), DT)
    ts = state_from_numpy(js, "cpu")
    assert isinstance(ts, OceanState)
    back = state_to_numpy(ts)
    for name in OceanState._fields:
        want = np.asarray(getattr(js, name))
        assert getattr(back, name).dtype == want.dtype, name
        np.testing.assert_array_equal(getattr(back, name), want)
    again = state_from_numpy(ts, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(ts, again))
    # and it steps on as the JAX state does
    js, jf = ref.step(js, DT)
    ts, tf = OceanSolver(cfg, device="cpu").step(ts, DT)
    assert_fields_match(tf, jf, cfg)


# ---------------------------------------------------------------- bfloat16

def _bf16_case(backend):
    cfg, h0, h0c, _ = _port_case(64)
    b16 = OceanSolver(cfg.replace(precision="bfloat16"), device="cpu",
                      fft_backend=backend)
    return cfg, h0, h0c, _run(b16, h0, h0c, 3)[1]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("backend", ["matmul", "pallas"])
def test_bfloat16_complex_backends_track_jax_f32(backend):
    """JAX's CPU DEFAULT dots are f32, so its f32 solver stands in for
    float64: the port's bf16 fields within the JAX envelope 3e-2, and off
    the port's f32 fields by more than f32 rounding (the tier engaged)."""
    cfg, h0, h0c, got = _bf16_case(backend)
    ref = JaxSolver(_jax_cfg(cfg), fft_backend=backend)
    js = ref.init(h0=h0, h0_conj=h0c)
    for _ in range(3):
        js, want = ref.step(js, DT)
    got = fields_to_numpy(got)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z"):
        assert _rel(getattr(got, name), np.asarray(getattr(want, name))) \
            <= 3e-2, name
    assert np.isfinite(got.normal).all() and np.isfinite(got.foam).all()
    f32 = fields_to_numpy(_run(OceanSolver(cfg, device="cpu",
                                           fft_backend=backend),
                               h0, h0c, 3)[1])
    assert _rel(got.height, f32.height) > 1e-4


def test_bfloat16_pallas_is_the_bf16_plain_tier():
    """On the CPU the complex ``pallas`` route at bf16 is the port's bf16
    plain tier: its transform equals two bf16 plain row passes bit for bit.
    It and ``matmul`` at bf16 (other factors, the same rounding of both
    operands, fft/matrix.py) each lie within the two-pass bf16 band 4e-3
    (chip_smoke.BF16_REL) of float64, and off it by more than f32
    rounding."""
    from tpu_ocean_torch.fft import planes
    x = torch.from_numpy(_complex((3, 64, 64), seed=5))
    got = planes.ifft2_pallas(x, precision="bfloat16")
    re, im = planes.fft1d_transposed_plain(x.real.contiguous(),
                                           x.imag.contiguous(), True,
                                           "bfloat16")
    re, im = planes.fft1d_transposed_plain(re, im, True, "bfloat16")
    assert torch.equal(got, torch.complex(re, im))
    mm = ifft2_matmul(x, precision="bfloat16")
    want = np.fft.ifft2(x.numpy().astype(np.complex128)) * 64 * 64
    for out in (got, mm):
        assert 1e-4 < _rel(out.numpy(), want) <= 4e-3


# ---------------------------------------------------------------- the rules

def test_defaults_build_the_complex_reference_solver():
    """OceanSolver(OceanConfig()) means what it means in JAX: 256², the
    centered layout, absolute time, spectral normals, the reference
    backend on the complex state; one step against the JAX defaults."""
    cfg = OceanConfig()
    port = OceanSolver(cfg, device="cpu")
    ref = JaxSolver(_jax_cfg(cfg))
    for name in ("fft_backend", "real_state", "pack_channels",
                 "half_spectrum", "pallas_fields"):
        assert getattr(port, name) == getattr(ref, name), name
    # config 2's Phillips-shaped pair (test_parity: scaled like a physical
    # spectrum so that the bands mean something)
    _, h0, h0c = _make_case(256, amplitude=0.2)
    js, jf = ref.step(ref.init(h0=h0, h0_conj=h0c), DT)
    ts, tf = _run(port, h0, h0c, 1)
    assert_fields_match(tf, jf, cfg)
    state, fields = port.step(port.init(), DT)
    assert state.h0.dtype == torch.complex64 and int(state.step) == 1
    assert all(torch.isfinite(f).all() for f in fields)


#: (config changes, solver keywords): each raises ValueError in JAX
RULES = {
    "eval_mode": ({}, dict(eval_mode="spectral")),
    "real_state_backend": ({"spectrum_layout": "fft"},
                           dict(real_state=True)),
    "real_state_layout": ({}, dict(real_state=True, fft_backend="pallas")),
    "fields_kernel_normals": ({"spectrum_layout": "fft"},
                              dict(pallas_fields=True)),
    "fields_kernel_layout": ({"normals_mode": "stencil"},
                             dict(pallas_fields=True)),
    "fields_kernel_n": ({"spectrum_layout": "fft", "normals_mode": "stencil",
                         "resolution": 36, "length": 36.0},
                        dict(pallas_fields=True)),
    "direct_layout": ({"spectrum_layout": "fft"}, dict(eval_mode="direct")),
    "real_state_small_n": ({"spectrum_layout": "fft", "resolution": 12,
                            "length": 12.0},
                           dict(real_state=True, fft_backend="pallas")),
    "pack_layout": ({}, dict(pack_channels=True)),
    "half_unpacked": ({"spectrum_layout": "fft"}, dict(half_spectrum=True)),
    "half_complex": ({"spectrum_layout": "fft"},
                     dict(pack_channels=True, half_spectrum=True)),
    "half_n": ({"spectrum_layout": "fft", "resolution": 40, "length": 40.0},
               dict(real_state=True, fft_backend="pallas",
                    pack_channels=True, half_spectrum=True)),
    "fused_layout": ({}, dict(fft_backend="pallas_fused")),
    "centered_length": ({"length": 30.0}, {}),
    "unknown_backend": ({}, dict(fft_backend="cufft")),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_every_jax_value_error_rule_raises_value_error(rule):
    changes, kw = RULES[rule]
    cfg = OceanConfig(resolution=32, length=32.0).replace(**changes)
    with pytest.raises(ValueError):
        JaxSolver(_jax_cfg(cfg), **kw)
    with pytest.raises(ValueError):
        OceanSolver(cfg, device="cpu", **kw)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("n", [12, 9])
def test_sizes_jax_sends_to_matmul_go_there_with_its_warning(n, backend):
    """N < 16 or odd on a pallas backend: the JAX constructor warns and
    takes ``matmul``; so does the port's, with the same text, and the
    step matches JAX's."""
    layout = "fft" if backend == "pallas_fused" else "centered"
    cfg = _port_case(n)[0].replace(spectrum_layout=layout)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ref = JaxSolver(_jax_cfg(cfg), fft_backend=backend)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        port = OceanSolver(cfg, device="cpu", fft_backend=backend)
    assert ref.fft_backend == port.fft_backend == "matmul"
    text = f"{backend} unsupported at N={n}; falling back to 'matmul'"
    assert [str(w.message) for w in tw] == [text]
    assert text in [str(w.message) for w in jw]
    _, h0, h0c, _ = _port_case(n)
    js, jf = ref.step(ref.init(h0=h0, h0_conj=h0c), DT)
    ts, tf = _run(port, h0, h0c, 1)
    assert_fields_match(tf, jf, cfg)


def test_card_size_rule_for_the_kernel_backends():
    """On the card ``pallas_fused`` takes power-of-two N in [16, 8192], and
    ``pallas`` at f32 every other even N there too
    (fft.planes.require_card_kernel):
    at N = 96 (JAX keeps its pallas pipeline there) the fused kernels and
    ``pallas`` at bf16 are refused before anything is allocated on the
    device, naming the ROADMAP row; ``pallas`` at f32 and ``reference``
    are not."""
    cfg = OCEAN_DEMO.replace(resolution=96)
    with pytest.raises(ValueError, match="sizes"):
        OceanSolver(cfg, device="cuda", fft_backend="pallas_fused")
    with pytest.raises(ValueError, match="sizes"):
        OceanSolver(cfg.replace(precision="bfloat16"), device="cuda",
                    fft_backend="pallas")
    if not torch.cuda.is_available():
        for backend in ("pallas", "reference"):
            with pytest.raises((AssertionError, RuntimeError)):
                OceanSolver(cfg, device="cuda", fft_backend=backend)


@pytest.mark.parametrize("what", ["direct", "gpu_hash_seeds", "reconfigure",
                                  "mesh"])
def test_unported_parts_raise_not_implemented(what):
    """The parts of the JAX defaults' solver that once raised
    NotImplementedError now run as in JAX: the direct sum steps within
    1e-5·max of JAX's, the shader-hash h0 raises JAX's ValueError outside
    the fft layout, and an unchanged config reconfigures into a solver
    that shares the tables. What stays unported still raises, naming its
    ROADMAP item: the distributed runtime, Simulation(mesh=...)."""
    cfg = OceanConfig(resolution=32, length=32.0)
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="item 14"):
            Simulation(cfg, device="cpu", mesh=object())
        return
    if what == "direct":
        _, h0, h0c = _make_case(32)
        ref = JaxSolver(_jax_cfg(cfg), eval_mode="direct")
        js, jf = ref.step(ref.init(h0=h0, h0_conj=h0c), DT)
        ts, tf = _run(OceanSolver(cfg, device="cpu", eval_mode="direct"),
                      h0, h0c, 1)
        assert_fields_match(tf, jf, cfg)
        return
    solver = OceanSolver(cfg, device="cpu")
    if what == "gpu_hash_seeds":
        with pytest.raises(ValueError, match="spectrum_layout='fft'"):
            JaxSolver(_jax_cfg(cfg)).init(gpu_hash_seeds=(1, 2))
        with pytest.raises(ValueError, match="spectrum_layout='fft'"):
            solver.init(gpu_hash_seeds=(1, 2))
        return
    state = solver.init()
    new, fresh = solver.reconfigure(state, cfg)
    assert new is not solver and new.omega is solver.omega
    assert torch.equal(fresh.h0, state.h0)      # the same seed, the same draw
