"""tpu_ocean_torch host tables and per-step elementwise stages against the
JAX package: configs field by field, the float64-built f32 tables bit for
bit, the phase update bit for bit, the packed assembly and the Hermitian
projection to f32 rounding."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean import config as jcfg, evolve as jev, grids as jgrids
from tpu_ocean import spectra as jspec
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import config as tcfg, evolve as tev, grids as tgrids
from tpu_ocean_torch import spectra as tspec
from tpu_ocean_torch.solver import OceanSolver

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)


def _cfgs(n):
    return [tcfg.OCEAN_DEMO.replace(resolution=n),
            tcfg.OCEAN_DEMO.replace(resolution=n, length=float(n))]


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["OCEAN_DEMO", "FFT_MESH_DEMO", "POND_DEMO"])
def test_presets_equal_field_by_field(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == \
        dataclasses.asdict(getattr(jcfg, name))


def test_constants_equal():
    for name in ("G", "PI", "EPSILON", "DAMPING_GPU", "DAMPING_CPU"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("layout", ["fft", "centered"])
@pytest.mark.parametrize("n", [16, 64])
def test_grids_bit_equal(layout, n):
    for a, b in zip(tgrids.wavevector_grid(n, 434.48, layout),
                    jgrids.wavevector_grid(n, 434.48, layout)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgrids.coordinate_1d(n, 1.5),
                                  jgrids.coordinate_1d(n, 1.5))


@pytest.mark.parametrize("n", [64, 128])
def test_solver_tables_bit_equal(n):
    """ω, pack, x0 and z0 as the two solvers hold them (float64 → f32)."""
    for cfg in _cfgs(n):
        port = OceanSolver(cfg, device="cpu", **SLICE)
        ref = JaxSolver(_jax_cfg(cfg), **SLICE)._consts
        np.testing.assert_array_equal(port.omega.numpy(), np.asarray(ref["omega"]))
        np.testing.assert_array_equal(port.pack.numpy(), np.asarray(ref["pack"]))
        np.testing.assert_array_equal(port.x0.numpy(), np.asarray(ref["x0"]))
        np.testing.assert_array_equal(port.z0.numpy(), np.asarray(ref["z0"]))


@pytest.mark.parametrize("mode", ["quantized", "capillary"])
def test_float64_tables_bit_equal(mode):
    cfg = tcfg.OCEAN_DEMO.replace(resolution=32, dispersion_mode=mode)
    jc = _jax_cfg(cfg)
    np.testing.assert_array_equal(tev.omega_grid(cfg), jev.omega_grid(jc))
    np.testing.assert_array_equal(tev.spectrum_coefficients(cfg),
                                  jev.spectrum_coefficients(jc))
    for nch in (3, 5):
        np.testing.assert_array_equal(tev.packed_coefficients(cfg, nch),
                                      jev.packed_coefficients(jc, nch))


@pytest.mark.parametrize("model", ["phillips", "jonswap"])
def test_spectrum_pair_bit_equal(model):
    cfg = tcfg.OCEAN_DEMO.replace(resolution=32, spectrum_model=model,
                                  jonswap_depth=20.0)
    kx, kz, _ = tgrids.wavevector_grid(32, cfg.length, "fft")
    args = (kx, kz, cfg.phillips_amplitude, cfg.wind, cfg.damping, cfg.length,
            model, cfg.jonswap_kw)
    for a, b in zip(tspec._spectrum_pair(*args), jspec._spectrum_pair(*args)):
        np.testing.assert_array_equal(a, b)


def test_h0_sampling_is_seeded_and_scaled():
    """The port draws from a CPU torch.Generator (it cannot replay
    jax.random): one seed gives one h0, and |h0|²/P averages 1."""
    def draw(seed):
        return tspec.h0_pair_fft_planes(torch.Generator().manual_seed(seed),
                                        64, 434.48, 4.1e-5, (14.45, 12.0), 0.01)
    a, b, c = draw(3), draw(3), draw(4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    kx, kz, _ = tgrids.wavevector_grid(64, 434.48, "fft")
    p = tspec.phillips(kx, kz, 4.1e-5, (14.45, 12.0), 0.01)
    power = (a[0] ** 2 + a[1] ** 2).double().numpy()
    live = p > 0
    assert abs(np.mean(power[live] / p[live]) - 1.0) < 0.1
    assert np.all(power[~live] == 0)


def test_phase_update_bit_equal():
    rng = np.random.default_rng(0)
    phase = rng.uniform(0, 2 * np.pi, (64, 64)).astype(np.float32)
    omega = rng.uniform(0, 40, (64, 64)).astype(np.float32)
    dt = np.float32(np.float32(1 / 60) * np.float32(1.5))
    for _ in range(3):
        want = np.asarray(jev.evolve_phase_accumulate(
            jnp.asarray(phase), jnp.asarray(omega), jnp.asarray(dt)))
        got = tev.evolve_phase_accumulate(torch.from_numpy(phase),
                                          torch.from_numpy(omega), float(dt))
        np.testing.assert_array_equal(got.numpy(), want)
        phase = np.array(want)


def _planes(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, n)).astype(np.float32) for _ in range(4)]


def test_packed_assembly_matches_jax():
    n = 64
    cfg = tcfg.OCEAN_DEMO.replace(resolution=n)
    pack = np.asarray(tev.packed_coefficients(cfg, 3), np.float32)
    planes = _planes(n, 1)
    phase = np.random.default_rng(2).uniform(0, 2 * np.pi, (n, n)).astype(np.float32)
    want = jev.assemble_spectra_packed_real(
        [jnp.asarray(p) for p in planes], jnp.asarray(phase), jnp.asarray(pack))
    got = tev.assemble_spectra_packed_real(
        [torch.from_numpy(p) for p in planes], torch.from_numpy(phase),
        torch.from_numpy(pack))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("shape", [(64, 64), (32, 64)])
def test_negflip_bit_equal(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(tev.negflip(torch.from_numpy(x)).numpy(),
                                  np.asarray(jev.negflip(jnp.asarray(x))))


def test_hermitize_planes_matches_jax():
    planes = _planes(64, 4)
    want = jev.hermitize_planes(*map(jnp.asarray, planes))
    got = tev.hermitize_planes(*map(torch.from_numpy, planes))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
