"""tpu_ocean_torch.OceanSolver against the JAX real-state solver
(``fft_backend="pallas"`` or ``"pallas_fused"``, ``real_state=True``, Pallas
in interpret mode): one numpy h0 pair is injected into the JAX solver, its
state is carried across with state_from_numpy, and both step. The main
path (packed + half with the fields kernel) steps 10 times; every other
combination of the channel set (per-channel, packed, packed + half), the
normals (stencil with the fields kernel, stencil in torch, spectral) and
the time mode (phase, absolute) steps 3 times at N = 64. All 8 fields are
held to tests/test_packing.py's bands: 1e-5·max, normals 2e-4 abs, foam
25×; fields_at and velocity to 1e-5·max."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, grids as jgrids, spectra as jspec
from tpu_ocean.fft import pallas_fft
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, fields_to_numpy,
                             state_from_numpy)
from tpu_ocean_torch.fft import planes
from tests.test_packing import _assert_fields_close

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _h0_pair(cfg, seed):
    """Phillips-shaped random (h0, h0_conj), drawn once in numpy."""
    n = cfg.resolution
    kx, kz, _ = jgrids.wavevector_grid(n, cfg.length, "fft")
    p_pos, p_neg = jspec._spectrum_pair(kx, kz, cfg.phillips_amplitude,
                                        cfg.wind, cfg.damping, cfg.length,
                                        "phillips", None)
    rng = np.random.default_rng(seed)

    def draw(p):
        return ((rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
                * np.sqrt(p / 2.0))
    return draw(p_pos), np.conj(draw(p_neg))


def _pair(n, length, backend="pallas"):
    cfg = OCEAN_DEMO.replace(resolution=n, length=length or OCEAN_DEMO.length)
    return cfg, JaxSolver(jcfg.OceanConfig(**dataclasses.asdict(cfg)),
                          **{**SLICE, "fft_backend": backend})


def _jax_config(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _steps_against_jax(cfg, switches, steps, seed):
    """The JAX and the port solver with ``switches`` (OceanSolver keywords)
    from one injected h0, ``steps`` steps of 1/60; returns both solvers and
    their last states and fields."""
    ref = JaxSolver(_jax_config(cfg), real_state=True, **switches)
    port = OceanSolver(cfg, device="cpu", real_state=True, **switches)
    h0, h0c = _h0_pair(cfg, seed=seed)
    js = ref.init(h0=h0, h0_conj=h0c)
    ts = port.init(h0=h0, h0_conj=h0c)
    for name in ts._fields:       # symmetrized only where packed, as JAX
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for _ in range(steps):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    return ref, port, js, jf, ts, tf


#: the channel sets: per-channel, packed, packed + half
CHANNEL_SETS = {"per_channel": dict(pack_channels=False, half_spectrum=False),
                "packed": dict(pack_channels=True, half_spectrum=False),
                "packed_half": dict(pack_channels=True, half_spectrum=True)}
#: the normals: stencil with the fields kernel, stencil in torch, spectral
NORMALS = {"stencil_kernel": ("stencil", True),
           "stencil_torch": ("stencil", False),
           "spectral": ("spectral", False)}


def _ten_steps_against_jax(n, length=None, backend="pallas"):
    """Both solvers from one injected h0, 10 steps; returns the last states
    and fields. Inside a transposed_store_cap the JAX solver is built and
    traced in the natural regime."""
    cfg, ref = _pair(n, length, backend)
    h0, h0c = _h0_pair(cfg, seed=n)
    js = ref.init(h0=h0, h0_conj=h0c)
    port = OceanSolver(cfg, device="cpu", **{**SLICE, "fft_backend": backend})
    ts = state_from_numpy(js, "cpu")
    dt = 1 / 60
    for _ in range(10):
        js, jf = ref.step(js, dt)
        ts, tf = port.step(ts, dt)
    return js, jf, ts, tf


@pytest.mark.parametrize("length", [None, "n"])
@pytest.mark.parametrize("n", [64, 128])
def test_step_matches_jax_solver(n, length):
    js, jf, ts, tf = _ten_steps_against_jax(
        n, float(n) if length == "n" else None)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    # the jitted JAX step contracts φ + ω·dt into one FMA (the eager
    # function, held bit-equal in test_torch_tables, does not): ≤ 1 ulp
    d = np.abs(ts.phase.numpy() - np.asarray(js.phase))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-6
    assert int(ts.step) == int(js.step) == 10
    assert float(ts.t) == float(js.t)


@pytest.mark.parametrize("n", [64, 128])
def test_init_planes_equal_jax_init(n):
    """Injected h0 → the same symmetrized planes, bit for bit."""
    cfg, ref = _pair(n, None)
    h0, h0c = _h0_pair(cfg, seed=1)
    js = ref.init(h0=h0, h0_conj=h0c)
    ts = OceanSolver(cfg, device="cpu", **SLICE).init(h0=h0, h0_conj=h0c)
    for name in ts._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


def test_symmetrize_is_idempotent_and_init_is_seeded():
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=64), device="cpu",
                         **SLICE)
    a = solver.init()
    b = solver.init(torch.Generator().manual_seed(OCEAN_DEMO.seed))
    again = solver.symmetrize(a)
    for name in ("h0_re", "h0_im", "h0c_re", "h0c_im"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert torch.equal(getattr(a, name), getattr(again, name))


def test_state_from_numpy_round_trip():
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=64), device="cpu",
                         **SLICE)
    s, _ = solver.step(solver.init(), 1 / 60)
    back = state_from_numpy(s, "cpu")
    for name in s._fields:
        a, b = getattr(s, name), getattr(back, name)
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_foam_decay_keeps_the_larger_foam():
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=64, foam_decay=0.35),
                         device="cpu", **SLICE)
    s = solver.init()
    s, f1 = solver.step(s, 1 / 60)
    s, f2 = solver.step(s, 1 / 60)
    assert torch.equal(s.foam_accum, f2.foam)
    assert bool((f2.foam >= f1.foam * np.exp(-0.35 / 60) - 1e-7).all())


@pytest.mark.parametrize("normals", list(NORMALS))
@pytest.mark.parametrize("channels", list(CHANNEL_SETS))
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_every_real_state_configuration_matches_jax(backend, channels,
                                                    normals):
    """Every real-state switch the JAX solver takes in the fft layout, 3
    steps at N = 64: the unpacked extraction takes re[0], im[1..4], the
    packed one re[0], im[0], re[1], im[1], re[2]."""
    mode, fields_kernel = NORMALS[normals]
    cfg = OCEAN_DEMO.replace(resolution=64, normals_mode=mode)
    *_, js, jf, ts, tf = _steps_against_jax(
        cfg, dict(fft_backend=backend, pallas_fields=fields_kernel,
                  **CHANNEL_SETS[channels]), 3, seed=5)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    assert int(ts.step) == int(js.step) == 3
    assert float(ts.t) == float(js.t)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("channels,normals", [("packed_half", "stencil_kernel"),
                                              ("per_channel", "spectral")])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_absolute_mode_fields_at_and_velocity_match_jax(backend, channels,
                                                        normals):
    """evolution_mode="absolute" (t += dt/t_division, φ = ω·t, the phase
    kept), then fields_at(state, t) and velocity(state) and velocity at a
    given t: the half route with half_spectrum, else the full transform."""
    mode, fields_kernel = NORMALS[normals]
    cfg = OCEAN_DEMO.replace(resolution=64, normals_mode=mode,
                             evolution_mode="absolute", t_division=1.5)
    ref, port, js, jf, ts, tf = _steps_against_jax(
        cfg, dict(fft_backend=backend, pallas_fields=fields_kernel,
                  **CHANNEL_SETS[channels]), 3, seed=6)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    assert float(ts.t) == float(js.t)
    assert torch.equal(ts.phase, torch.zeros_like(ts.phase))
    _assert_fields_close(fields_to_numpy(port.fields_at(ts, 2.5)),
                         ref.fields_at(js, 2.5), 1e-5)
    _close(port.velocity(ts), ref.velocity(js))
    _close(port.velocity(ts, t=0.75), ref.velocity(js, t=0.75))


@pytest.mark.parametrize("channels", ["per_channel", "packed_half"])
def test_phase_mode_velocity_matches_jax(channels):
    """velocity at the state's phase, with ρ = dt_multiplier: the half
    route (packed + half) and the full one (per-channel)."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    ref, port, js, _, ts, _ = _steps_against_jax(
        cfg, dict(fft_backend="pallas", **CHANNEL_SETS[channels]), 2, seed=7)
    _close(port.velocity(ts), ref.velocity(js))
    with pytest.raises(ValueError):
        port.velocity(ts, t=1.0)
    with pytest.raises(ValueError):
        port.fields_at(ts, 1.0)


@pytest.mark.parametrize("channels,normals", [("per_channel", "stencil_torch"),
                                              ("packed", "spectral"),
                                              ("packed_half", "spectral")])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_natural_regime_configurations_match_jax(backend, channels, normals,
                                                 monkeypatch):
    """N = 128 with both packages' transposed-store cap at 32: the 4096²
    code path for the per-channel set (C = 3) and the spectral sets (C = 3
    packed, 2 + the half channel), 3 steps."""
    mode, fields_kernel = NORMALS[normals]
    monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    cfg = OCEAN_DEMO.replace(resolution=128, normals_mode=mode)
    with pallas_fft.transposed_store_cap(32):
        *_, jf, _, tf = _steps_against_jax(
            cfg, dict(fft_backend=backend, pallas_fields=fields_kernel,
                      **CHANNEL_SETS[channels]), 3, seed=8)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_normals_spectral_matches_jax():
    from tpu_ocean.fields import normals_spectral as jax_normals_spectral
    from tpu_ocean_torch.fields import normals_spectral
    rng = np.random.default_rng(9)
    sx, sz = (rng.normal(scale=0.5, size=(32, 48)).astype(np.float32)
              for _ in range(2))
    got = normals_spectral(torch.from_numpy(sx), torch.from_numpy(sz))
    want = np.asarray(jax_normals_spectral(sx, sz))
    assert got.shape == (32, 48, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("change", [
    dict(cfg=dict(spectrum_layout="centered")),
    dict(kw=dict(fft_backend="reference")),
    dict(kw=dict(fft_backend="stockham")),
    dict(kw=dict(fft_backend="matmul")),
    dict(kw=dict(eval_mode="direct")),
    dict(kw=dict(real_state=False)),
])
def test_off_slice_configurations_raise(change):
    """The configurations off the real-state slice. Each builds a
    complex-state solver, with the JAX package's defaults for the switches
    it does not set, and takes one step against the JAX solver within
    tests/test_packing.py's bands; eval_mode="direct" (the direct sum)
    takes the centered layout it requires."""
    kw = change.get("kw", {})
    layout = ("centered" if kw.get("eval_mode") == "direct" else
              change.get("cfg", {}).get("spectrum_layout", "fft"))
    cfg = OCEAN_DEMO.replace(resolution=64, length=64.0, unit_width=1.0,
                             **{**change.get("cfg", {}),
                                "spectrum_layout": layout})
    ref = JaxSolver(_jax_config(cfg), **kw)
    port = OceanSolver(cfg, device="cpu", **kw)
    assert not port.real_state and port.fft_backend == ref.fft_backend
    assert port.cfg.spectrum_layout == layout
    h0, h0c = _h0_pair(cfg, seed=4)
    js, ts = ref.init(h0=h0, h0_conj=h0c), port.init(h0=h0, h0_conj=h0c)
    js, jf = ref.step(js, 1 / 60)
    ts, tf = port.step(ts, 1 / 60)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    assert int(ts.step) == int(js.step) == 1


@pytest.mark.parametrize("call", ["gpu_hash_seeds", "reconfigure"])
def test_unported_methods_raise(call):
    """The two methods the slice's solver once refused, now ported:
    init(gpu_hash_seeds=...) gives the JAX solver's state bit for bit
    (symmetrized, as packed), and reconfigure with an init-only change
    keeps the tables, the phase, the clock and the step."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    solver = OceanSolver(cfg, device="cpu", **SLICE)
    if call == "gpu_hash_seeds":
        got = solver.init(gpu_hash_seeds=(1, 2))
        want = JaxSolver(_jax_config(cfg), **SLICE).init(gpu_hash_seeds=(1, 2))
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        return
    state, _ = solver.step(solver.init(), 1 / 60)
    new, fresh = solver.reconfigure(state, cfg.replace(amplitude=0.9))
    assert new.pack is solver.pack and new.omega is solver.omega
    assert fresh.phase is state.phase and int(fresh.step) == 1
    assert not torch.equal(fresh.h0_re, state.h0_re)


@pytest.mark.parametrize("change", [
    dict(cfg=dict(normals_mode="spectral"), kw=dict(pallas_fields=True)),
    dict(kw=dict(pack_channels=False, half_spectrum=True)),
    dict(kw=dict(eval_mode="spectral")),
])
def test_what_jax_refuses_raises_value_error(change):
    """The JAX solver's ValueError rules, in both packages: the fields
    kernel needs stencil normals, the half route needs packing."""
    cfg = OCEAN_DEMO.replace(resolution=64, **change.get("cfg", {}))
    kw = dict(SLICE, **change.get("kw", {}))
    with pytest.raises(ValueError):
        JaxSolver(_jax_config(cfg), **kw)
    with pytest.raises(ValueError):
        OceanSolver(cfg, device="cpu", **kw)


@pytest.mark.parametrize("n", [40, 96])
def test_sizes_the_kernels_do_not_take_raise(n):
    """N % 16 != 0 is refused everywhere (as in JAX). N = 96 steps on the
    CPU; on the card the size rule (fft.planes.check_card_sizes) takes it
    at f32 in the direct form and refuses it at bf16, naming the ROADMAP
    row, before anything is allocated there."""
    cfg = OCEAN_DEMO.replace(resolution=n)
    if n % 16:
        for device in ("cuda", "cpu"):
            with pytest.raises(ValueError):
                OceanSolver(cfg, device=device, **SLICE)
        return
    planes.check_card_sizes(n, "float32", half=True)
    with pytest.raises(ValueError, match="sizes"):
        OceanSolver(cfg.replace(precision="bfloat16"), device="cuda", **SLICE)
    solver = OceanSolver(cfg, device="cpu", **SLICE)
    state, fields = solver.step(solver.init(), 1 / 60)
    assert int(state.step) == 1 and bool(torch.isfinite(fields.height).all())


@pytest.mark.parametrize("n", [64, 128])
def test_fused_step_matches_jax_fused_solver(n):
    js, jf, ts, tf = _ten_steps_against_jax(n, backend="pallas_fused")
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    assert int(ts.step) == int(js.step) == 10


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_natural_regime_step_matches_jax_solver(backend, monkeypatch):
    """N = 128 with both packages' transposed-store cap at 32: the 4096²
    code path (natural-store row passes, axis −2 column passes)."""
    monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    with pallas_fft.transposed_store_cap(32):
        _, jf, _, tf = _ten_steps_against_jax(128, backend=backend)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


@pytest.mark.parametrize("natural", [False, True])
def test_fused_step_matches_unfused_step(natural, monkeypatch):
    """The fused route (f32 in-kernel coefficients) against the unfused one
    (float64-built pack table) on one h0, within 5e-6·max
    (tests/test_half_spectrum.py:82-98)."""
    if natural:
        monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    cfg = OCEAN_DEMO.replace(resolution=64)
    h0, h0c = _h0_pair(cfg, seed=3)
    a = OceanSolver(cfg, device="cpu", **SLICE)
    b = OceanSolver(cfg, device="cpu", **{**SLICE,
                                          "fft_backend": "pallas_fused"})
    sa, sb = a.init(h0=h0, h0_conj=h0c), b.init(h0=h0, h0_conj=h0c)
    for _ in range(3):
        sa, fa = a.step(sa, 1 / 60)
        sb, fb = b.step(sb, 1 / 60)
    _assert_fields_close(fields_to_numpy(fb), fields_to_numpy(fa), 5e-6)


def test_default_device_is_the_card():
    """No device argument means CUDA, for the JAX defaults (the complex
    reference solver) and for the slice: with no card the constructor
    raises (as torch does) instead of running on the CPU."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    for kw in ({}, SLICE):
        if torch.cuda.is_available():
            assert OceanSolver(cfg, **kw).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                OceanSolver(cfg, **kw)


def test_import_does_not_load_jax():
    code = ("import sys, tpu_ocean_torch; "
            "bad = [m for m in ('jax', 'tpu_ocean') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
