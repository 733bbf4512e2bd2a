"""``eval_mode="direct"`` and the shader-hash h0 of tpu_ocean_torch against
the float64 oracle and the JAX package.

- The direct sum (F_c = Eᵀ·C_c·E in f32): on tests/test_parity.py's
  incommensurate case (N = 12, L = 12.39 over a unit grid, the FFT Mesh
  demo's, which the centered FFT refuses) against the float64 oracle with
  that test's bands (rtol 1e-4, atol 2e-5·max, foam 25×); and against the
  JAX solver's direct step from one injected h0 on every backend it takes,
  in both time modes, with ``fields_at`` and ``velocity``, within the
  bands of tests/test_torch_complex_backends.py (1e-5·max, a stencil
  normal's and the foam's widened by the first-order effect of the
  measured input differences). ``cfg.precision`` does not reach it.
- ``spectra.h0_pair_gpu_hash`` bit-equal to JAX's at N = 16, 64 and 1024,
  and ``init(gpu_hash_seeds=...)`` bit-equal to the JAX solver's state on
  either state, packed or not; then 3 steps within the same bands."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, spectra as jspec
from tpu_ocean.oracle import Oracle
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import FFT_MESH_DEMO, OCEAN_DEMO, OceanConfig, OceanSolver
from tpu_ocean_torch import spectra as tspec
from tests.test_parity import _assert_fields_close as assert_oracle_close
from tests.test_parity import _make_case
from tests.test_torch_complex_backends import assert_fields_match

DT = 1.0 / 60.0


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _mesh_case(n=12, length=12.39, seed=5):
    """tests/test_parity.py's direct-mode case: L ≠ N·unit_width."""
    cfg = OceanConfig(
        resolution=n, length=length, unit_width=1.0, wind=(5.0, 3.0),
        amplitude=0.01, choppiness=1.0, dispersion_mode="quantized",
        evolution_mode="absolute", spectrum_layout="centered",
        normals_mode="spectral")
    rng = np.random.default_rng(seed)
    h0 = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return cfg, h0, h0c


def test_direct_matches_float64_oracle_incommensurate_length():
    """tests/test_parity.py:82 on the port: one step of 0.1 s."""
    cfg, h0, h0c = _mesh_case()
    solver = OceanSolver(cfg, device="cpu", eval_mode="direct")
    state, fields = solver.step(solver.init(h0=h0, h0_conj=h0c), 0.1)
    want = Oracle(_jax_cfg(cfg), h0=h0, h0_conj=h0c).fields(0.1)
    assert_oracle_close(fields, want, rtol=1e-4, atol_scale=2e-5)


def test_direct_matches_float64_oracle_fft_mesh_demo_100_steps():
    """FFT_MESH_DEMO itself (its own L = 12.39, damping 0.001), h0 drawn
    from a generator, 100 steps: the oracle at t = 100·dt (absolute time
    is stateless), with tests/test_parity.py's config-2 bands."""
    solver = OceanSolver(FFT_MESH_DEMO, device="cpu", eval_mode="direct")
    state = solver.init(torch.Generator().manual_seed(3))
    for _ in range(100):
        state, fields = solver.step(state, DT)
    want = Oracle(_jax_cfg(FFT_MESH_DEMO), h0=state.h0.numpy(),
                  h0_conj=state.h0_conj.numpy()).fields(float(state.t))
    assert_oracle_close(fields, want, rtol=1e-3, atol_scale=2e-4)


def test_direct_refuses_the_centered_fft_length_and_the_fft_layout():
    """The centered FFT refuses L ≠ N·unit_width (the modulation is exact
    only there); the direct sum takes it. Both packages refuse the direct
    sum in the fft layout."""
    cfg, _, _ = _mesh_case()
    with pytest.raises(ValueError):
        OceanSolver(cfg, device="cpu")
    fft_cfg = cfg.replace(spectrum_layout="fft", length=12.0)
    for make in (lambda: JaxSolver(_jax_cfg(fft_cfg), eval_mode="direct"),
                 lambda: OceanSolver(fft_cfg, device="cpu",
                                     eval_mode="direct")):
        with pytest.raises(ValueError, match="centered"):
            make()


#: (backend, N, length, time mode, normals): the JAX solver's direct step
#: assembles in jnp on every backend (pallas and pallas_fused too, the
#: fused route being an fft-mode route; N = 12 sends them to matmul)
DIRECT_CASES = [
    ("reference", 12, 12.39, "absolute", "spectral"),
    ("reference", 16, 17.0, "phase", "stencil"),
    ("matmul", 32, 30.5, "absolute", "stencil"),
    ("pallas", 16, 16.0, "phase", "spectral"),
    ("pallas", 12, 12.39, "absolute", "spectral"),
    ("pallas_fused", 32, 32.0, "absolute", "spectral"),
    ("stockham", 16, 15.2, "phase", "spectral"),
]


@pytest.mark.parametrize("backend,n,length,mode,normals", DIRECT_CASES)
def test_direct_step_matches_jax(backend, n, length, mode, normals):
    cfg, _, _ = _make_case(n, amplitude=0.2)
    cfg = OceanConfig(**dataclasses.asdict(cfg)).replace(
        length=length, unit_width=1.0, evolution_mode=mode,
        normals_mode=normals, dt_multiplier=1.5)
    _, h0, h0c = _make_case(n, amplitude=0.2)
    with warnings.catch_warnings():
        # N < 16 sends pallas to matmul in both, with a warning
        warnings.simplefilter("ignore")
        ref = JaxSolver(_jax_cfg(cfg), fft_backend=backend,
                        eval_mode="direct")
        port = OceanSolver(cfg, device="cpu", fft_backend=backend,
                           eval_mode="direct")
    assert port.fft_backend == ref.fft_backend
    js, ts = ref.init(h0=h0, h0_conj=h0c), port.init(h0=h0, h0_conj=h0c)
    for _ in range(3):
        js, jf = ref.step(js, DT)
        ts, tf = port.step(ts, DT)
    assert_fields_match(tf, jf, cfg)
    d = np.abs(ts.phase.numpy() - np.asarray(js.phase))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-6
    _close(port.velocity(ts), ref.velocity(js))
    if mode == "absolute":
        assert_fields_match(port.fields_at(ts, 0.7), ref.fields_at(js, 0.7),
                            cfg)
        _close(port.velocity(ts, 0.7), ref.velocity(js, 0.7))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_direct_sum_runs_at_f32_whatever_the_precision():
    """JAX passes Precision.HIGHEST to the direct einsum at either
    precision: the port's bfloat16 config gives the float32 config's
    fields bit for bit."""
    cfg, h0, h0c = _mesh_case()
    out = []
    for precision in ("float32", "bfloat16"):
        solver = OceanSolver(cfg.replace(precision=precision), device="cpu",
                             eval_mode="direct")
        out.append(solver.step(solver.init(h0=h0, h0_conj=h0c), DT)[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_direct_basis_is_the_float64_basis_cast_once():
    """E[n, i] = e^{i·k_n·x_i} from the centered wavenumbers and the mesh
    coordinates in float64, as the JAX solver builds ex_re and ex_im."""
    cfg, _, _ = _mesh_case()
    port = OceanSolver(cfg, device="cpu", eval_mode="direct")
    ref = JaxSolver(_jax_cfg(cfg), eval_mode="direct")
    np.testing.assert_array_equal(port.basis.real.numpy(),
                                  np.asarray(ref._consts["ex_re"]))
    np.testing.assert_array_equal(port.basis.imag.numpy(),
                                  np.asarray(ref._consts["ex_im"]))


def test_direct_transform_in_blocks_matches_float64():
    """The contraction in blocks of DIRECT_BLOCK terms (4 at N = 256, L ≠
    N·unit_width): within 3e-7·max of the float64 sum on random spectra,
    closer than one product over all 256 terms (4.8e-7 measured)."""
    from tpu_ocean_torch import grids
    from tpu_ocean_torch.solver import DIRECT_BLOCK
    n = 256
    assert n // DIRECT_BLOCK == 4
    cfg = OceanConfig(resolution=n, length=n * 1.0137)
    solver = OceanSolver(cfg, device="cpu", eval_mode="direct")
    rng = np.random.default_rng(1)
    c = (rng.normal(size=(2, n, n))
         + 1j * rng.normal(size=(2, n, n))).astype(np.complex64)
    e = np.exp(1j * np.outer(grids.wavenumbers_1d(n, cfg.length, "centered"),
                             grids.coordinate_1d(n, 1.0)))
    want = np.stack([e.T @ ci.astype(np.complex128) @ e for ci in c])
    got = solver._transform(torch.from_numpy(c)).numpy()
    one = (solver.basis.T @ torch.from_numpy(c) @ solver.basis).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 3e-7
    assert err < np.abs(one - want).max() / np.abs(want).max()


# ------------------------------------------------------------ shader hash

@pytest.mark.parametrize("n", [16, 64, 1024])
def test_h0_pair_gpu_hash_bit_equal_to_jax(n):
    cfg = OCEAN_DEMO.replace(resolution=n)
    args = (n, cfg.length, cfg.phillips_amplitude, cfg.wind, 0.37, 0.81,
            cfg.damping)
    for got, want in zip(tspec.h0_pair_gpu_hash(*args),
                         jspec.h0_pair_gpu_hash(*args)):
        assert got.dtype == want.dtype == np.complex64
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_uv_random_f32_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    u, v = rng.uniform(0, 1, size=(2, 64, 64)).astype(np.float32)
    for salt, r in ((10.612, 0.185), (11.899, 1.62)):
        got = tspec.uv_random_f32(u, v, salt, r)
        want = jspec.uv_random_f32(u, v, salt, r)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


#: (real_state, pack_channels, half_spectrum, backend)
HASH_SWITCHES = [(False, False, False, "reference"),
                 (False, True, False, "pallas"),
                 (True, False, False, "pallas"),
                 (True, True, True, "pallas_fused")]


@pytest.mark.parametrize("real,packed,half,backend", HASH_SWITCHES)
def test_gpu_hash_init_bit_equal_to_jax_then_steps(real, packed, half,
                                                   backend):
    cfg = OCEAN_DEMO.replace(resolution=64)
    kw = dict(fft_backend=backend, real_state=real, pack_channels=packed,
              half_spectrum=half, pallas_fields=real)
    ref = JaxSolver(_jax_cfg(cfg), **kw)
    port = OceanSolver(cfg, device="cpu", **kw)
    js = ref.init(gpu_hash_seeds=(0.37, 0.81))
    ts = port.init(gpu_hash_seeds=(0.37, 0.81))
    assert type(ts).__name__ == type(js).__name__
    for name in ts._fields:       # symmetrized where packed, as JAX
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for _ in range(3):
        js, jf = ref.step(js, DT)
        ts, tf = port.step(ts, DT)
    assert_fields_match(tf, jf, cfg)


def test_gpu_hash_seeds_give_way_to_an_injected_pair_and_need_the_fft_layout():
    cfg = OCEAN_DEMO.replace(resolution=16)
    solver = OceanSolver(cfg, device="cpu")
    h0 = np.full((16, 16), 0.5 + 0.25j, np.complex64)
    state = solver.init(h0=h0, h0_conj=h0, gpu_hash_seeds=(0.1, 0.2))
    np.testing.assert_array_equal(state.h0.numpy(), h0)
    centered = OceanSolver(cfg.replace(spectrum_layout="centered",
                                       length=16.0), device="cpu")
    with pytest.raises(ValueError, match="spectrum_layout='fft'"):
        centered.init(gpu_hash_seeds=(0.1, 0.2))
