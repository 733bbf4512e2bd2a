"""tpu_ocean_torch's pond family against the JAX package: the wave banks,
gerstner_eval, the wave-bank kernel's plain version (the CPU side of
ops/gerstner_bank.py) against the Pallas kernel in interpret mode,
sinusoid_eval, the velocities, PondSolver in every mode with and without
the kernel, and PondSimulation's clock. Inputs come from numpy; the
banks from numpy's default_rng in both packages.

Tolerance for the Gerstner paths: atol=2e-5, rtol=1e-5, the JAX package's
own Pallas-vs-jnp band (tests/test_pallas_kernels.py:58). The port's f32
arithmetic repeats JAX's order; what differs is the summation order over W
in the broadcast form, the normalization (1/√ in the kernel form, n/|n| in
the broadcast form, each against both JAX functions) and sin/cos by an
ulp."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ocean import config as jcfg, grids as jgrids
from tpu_ocean import gerstner as jg
from tpu_ocean.ops.gerstner_pallas import gerstner_pallas
from tpu_ocean.runtime import PondSimulation as JaxPondSimulation
from tpu_ocean_torch import (POND_DEMO, PondConfig, PondSimulation, PondSolver,
                             WaveBank, pond_fields_to_numpy,
                             wavebank_from_numpy)
from tpu_ocean_torch import gerstner as tg, grids as tgrids
from tpu_ocean_torch.ops import gerstner_bank as gb

TOL = dict(atol=2e-5, rtol=1e-5)
T = 2.3
BANKS = ["from_packed4", "level_one", "random"]


def _banks(kind):
    """(JAX bank, port bank) of one kind, from POND_DEMO's parameters."""
    if kind == "random":
        return jg.WaveBank.random(7, 16), WaveBank.random(7, 16)
    jax_cfg = jcfg.PondConfig(**dataclasses.asdict(POND_DEMO))
    return getattr(jg.WaveBank, kind)(jax_cfg), getattr(WaveBank, kind)(POND_DEMO)


def _grids(n=64):
    x, z = jgrids.coordinate_grid(n, 1.0)
    return x.astype(np.float32), z.astype(np.float32)


def _close(got, want, **tol):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), **(tol or TOL))


@pytest.mark.parametrize("kind", BANKS)
def test_banks_equal_jax_banks(kind):
    jb, tb = _banks(kind)
    assert len(tb) == len(jb)
    for name, want in jb.as_arrays().items():
        np.testing.assert_array_equal(tb.as_arrays()[name], want)


@pytest.mark.parametrize("kind", BANKS)
def test_wavebank_from_numpy_carries_the_jax_bank(kind):
    jb, tb = _banks(kind)
    got = wavebank_from_numpy(jb.as_arrays())
    for name, want in jb.as_arrays().items():
        np.testing.assert_array_equal(got.as_arrays()[name], want)
    # and the carried bank evaluates as the port's own
    x, z = map(torch.from_numpy, _grids(16))
    for a, b in zip(gb.gerstner_bank_plain(got, x, z, T),
                    gb.gerstner_bank_plain(tb, x, z, T)):
        assert torch.equal(a, b)


def test_coordinate_grid_equals_jax():
    for n, w in ((64, 1.0), (9, 0.5)):
        for a, b in zip(tgrids.coordinate_grid(n, w),
                        jgrids.coordinate_grid(n, w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["analytic", "flat"])
def test_gerstner_eval_matches_jax(mode):
    jb, tb = _banks("random")
    x, z = _grids()
    want = jg.gerstner_eval(jb, jnp.asarray(x), jnp.asarray(z), T, mode)
    got = tg.gerstner_eval(tb, torch.from_numpy(x), torch.from_numpy(z), T, mode)
    assert got.normal.shape == (64, 64, 3)
    _close(got, want)


@pytest.mark.parametrize("mode", ["analytic", "flat"])
def test_gerstner_bank_plain_matches_jax_pallas(mode):
    """The kernel's plain version against the Pallas kernel (rsqrt) and the
    jnp twin (n/|n|), both within the same band."""
    jb, tb = _banks("random")
    x, z = _grids()
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    got = gb.gerstner_bank(tb, torch.from_numpy(x), torch.from_numpy(z), T, mode)
    assert got[3].shape == (64, 64, 3)
    _close(got, gerstner_pallas(jb, jx, jz, T, mode))
    _close(got, jg.gerstner_eval(jb, jx, jz, T, mode))


@pytest.mark.parametrize("t", [0.0, T, 61.7])
def test_sinusoid_eval_matches_jax(t):
    x, z = _grids()
    jax_cfg = jcfg.PondConfig(resolution=64, displacement_mode="wave")
    cfg = PondConfig(resolution=64, displacement_mode="wave")
    want = jg.sinusoid_eval(jax_cfg, jnp.asarray(x), jnp.asarray(z), t)
    got = tg.sinusoid_eval(cfg, torch.from_numpy(x), torch.from_numpy(z), t)
    _close(got, want)


@pytest.mark.parametrize("family", ["gerstner", "wave"])
def test_velocities_match_jax(family):
    x, z = _grids()
    if family == "gerstner":
        jb, tb = _banks("random")
        want = jg.gerstner_velocity(jb, jnp.asarray(x), jnp.asarray(z), T)
        got = tg.gerstner_velocity(tb, torch.from_numpy(x), torch.from_numpy(z), T)
    else:
        cfg = PondConfig(resolution=64, displacement_mode="wave")
        jax_cfg = jcfg.PondConfig(**dataclasses.asdict(cfg))
        want = jg.sinusoid_velocity(jax_cfg, jnp.asarray(x), jnp.asarray(z), T)
        got = tg.sinusoid_velocity(cfg, torch.from_numpy(x), torch.from_numpy(z), T)
    _close([got], [want])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["gerstner", "wave", "off"])
def test_pond_solver_matches_jax(mode, use_pallas):
    cfg = PondConfig(resolution=64, displacement_mode=mode)
    jax_cfg = jcfg.PondConfig(**dataclasses.asdict(cfg))
    bank = WaveBank.random(3, 8) if mode == "gerstner" else None
    jbank = jg.WaveBank.random(3, 8) if mode == "gerstner" else None
    ref = jg.PondSolver(jax_cfg, bank=jbank, use_pallas=use_pallas)
    port = PondSolver(cfg, bank=bank, use_pallas=use_pallas, device="cpu")
    for t in (0.0, 1.0 / 60.0, T):
        _close(port.fields(t), ref.fields(t))
        _close([port.velocity(t)], [ref.velocity(t)])


def test_pond_solver_default_bank_is_packed4():
    """No bank: POND_DEMO's packed 4-wave bank, through the kernel's plain
    version, against JAX's Pallas path."""
    ref = jg.PondSolver(jcfg.PondConfig(resolution=64), use_pallas=True)
    port = PondSolver(PondConfig(resolution=64), use_pallas=True, device="cpu")
    assert len(port.bank) == 4
    _close(port.fields(10.0), ref.fields(10.0))


def test_pond_simulation_clock_matches_jax():
    """state is the clock (tests/test_velocity.py:249-262), the fields of
    the last step are the JAX runtime's, and the aliases hold."""
    cfg = PondConfig(resolution=32)
    sim = PondSimulation(cfg, dt=0.25, use_pallas=True, device="cpu")
    ref = JaxPondSimulation(jcfg.PondConfig(**dataclasses.asdict(cfg)), dt=0.25,
                            use_pallas=True)
    with sim:
        sim.run(3)
        ref.run(3)
    assert sim.step_count == 3 and sim.state == pytest.approx(0.75)
    assert sim.world_length == ref.world_length == 32.0
    assert torch.equal(sim.solver.velocity(sim.state), sim.solver.velocity(0.75))
    assert torch.equal(sim.fields.height, sim.fields.offset_y)
    _close(sim.fields, ref.fields)


def test_serving_aliases_negate_the_offsets():
    """disp_x/disp_z = −offset_x/−offset_z (tests/test_gerstner.py:152),
    as the JAX PondFields, so x − disp_x == x + offset_x."""
    x, z = map(torch.from_numpy, _grids(16))
    f = tg.gerstner_eval(WaveBank.random(1, 4), x, z, 0.7)
    assert torch.equal(f.disp_x, -f.offset_x)
    assert torch.equal(f.disp_z, -f.offset_z)
    assert torch.equal(f.height, f.offset_y)
    jf = jg.gerstner_eval(jg.WaveBank.random(1, 4), jnp.asarray(x.numpy()),
                          jnp.asarray(z.numpy()), 0.7)
    _close([f.disp_x, f.disp_z], [jf.disp_x, jf.disp_z])


def test_pond_fields_to_numpy():
    f = PondSolver(PondConfig(resolution=16), device="cpu").fields(1.0)
    host = pond_fields_to_numpy(f)
    assert isinstance(host, tg.PondFields)
    for a, b in zip(host, f):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())


def test_cpu_calls_do_not_count_launches():
    before = gb.gerstner_bank.launches
    PondSolver(PondConfig(resolution=16), use_pallas=True, device="cpu").fields(1.0)
    assert gb.gerstner_bank.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "ndim", "contiguous",
                                 "empty", "bank_rows", "no_waves", "mode"])
def test_gerstner_bank_rejects_bad_input(bad):
    x, z = map(torch.from_numpy, _grids(16))
    bank = gb.pack_bank(WaveBank.random(0, 4), "cpu")
    mode = "analytic"
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        z = z[:8].contiguous()
    elif bad == "ndim":
        x, z = x[None], z[None]
    elif bad == "contiguous":
        x = x.t()
    elif bad == "empty":
        x, z = x[:0], z[:0]
    elif bad == "bank_rows":
        bank = bank[:5]
    elif bad == "no_waves":
        bank = bank[:, :0]
    elif bad == "mode":
        mode = "wave"
    with pytest.raises((TypeError, ValueError)):
        gb.gerstner_bank(bank, x, z, 1.0, mode)


def test_default_device_is_the_card():
    """No device argument means CUDA: with no card the constructor raises
    (as torch does) instead of running on the CPU."""
    cfg = PondConfig(resolution=16)
    if torch.cuda.is_available():
        assert PondSolver(cfg).device.type == "cuda"
        assert PondSimulation(cfg).solver.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            PondSolver(cfg)
        with pytest.raises((AssertionError, RuntimeError)):
            PondSimulation(cfg)
