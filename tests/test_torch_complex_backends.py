"""tpu_ocean_torch.OceanSolver on the complex state (``real_state=False``)
against the JAX ``OceanSolver(real_state=False)``, on every backend
(``reference``, ``stockham``, ``matmul``, ``pallas``, ``pallas_fused``;
Pallas in interpret mode), in both layouts where JAX allows them (the
centered layout takes no packing, no fields kernel and no fused backend),
per-channel and packed, with stencil normals (the fields kernel or torch)
and spectral normals, in phase and absolute time. One numpy h0 pair is
injected into both solvers, the states must agree bit for bit
(symmetrized only where packed), and both take 3 steps at N = 32; the 8
fields are held to tests/test_packing.py's bands (1e-5·max, normals 2e-4
abs, foam 25×), a stencil normal's 2e-4 and the foam's band widened by
the first-order effect of the measured differences of their inputs
(assert_fields_match): at a fold a 5e-6 input difference can move a
stencil normal by ~2e-3 (one texel at N = 32 on ``matmul`` read 3.1e-4
against JAX, whose XLA products sum in another order). ``velocity`` is held to
1e-5·max in every phase-mode case; ``fields_at`` and absolute-time
``velocity`` on every backend, in the centered layout where JAX allows
it."""

import dataclasses

import numpy as np
import pytest

from tpu_ocean import config as jcfg
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import OceanConfig, OceanSolver, fields_to_numpy
import chip_smoke
from tests.test_packing import _assert_fields_close
from tests.test_parity import _make_case

N = 32
BACKENDS = ("reference", "stockham", "matmul", "pallas", "pallas_fused")
#: the normals: stencil with the fields kernel, stencil in torch, spectral
NORMALS = {"stencil_kernel": ("stencil", True),
           "stencil_torch": ("stencil", False),
           "spectral": ("spectral", False)}


def _valid(backend, layout, packed, normals):
    """The JAX solver's rules: packing, the fields kernel and the fused
    backend need the fft layout."""
    return layout == "fft" or not (packed or normals == "stencil_kernel"
                                   or backend == "pallas_fused")


def _mode(packed, normals):
    """Phase or absolute time, alternating over the channel sets and
    normals so that each backend and layout runs both."""
    return "absolute" if (normals == "spectral") != packed else "phase"


CASES = [(b, layout, packed, normals)
         for b in BACKENDS for layout in ("fft", "centered")
         for packed in (False, True) for normals in NORMALS
         if _valid(b, layout, packed, normals)]


def _case(backend, layout, packed, normals, mode):
    """(port config, JAX solver, port solver, h0, h0_conj): test_parity's
    centered case at N = 32 in ``layout``, with dt_multiplier and
    t_division off 1 so that ρ and the clock's division are exercised."""
    cfg, h0, h0c = _make_case(N)
    kind, fields_kernel = NORMALS[normals]
    cfg = OceanConfig(**dataclasses.asdict(cfg)).replace(
        spectrum_layout=layout, normals_mode=kind, evolution_mode=mode,
        dt_multiplier=1.5, t_division=1.5)
    kw = dict(fft_backend=backend, pack_channels=packed,
              pallas_fields=fields_kernel)
    ref = JaxSolver(jcfg.OceanConfig(**dataclasses.asdict(cfg)), **kw)
    port = OceanSolver(cfg, device="cpu", **kw)
    assert (port.real_state, port.fft_backend) == (False, ref.fft_backend)
    return cfg, ref, port, h0, h0c


def _steps(ref, port, h0, h0c, steps):
    js, ts = ref.init(h0=h0, h0_conj=h0c), port.init(h0=h0, h0_conj=h0c)
    for name in ts._fields:       # symmetrized only where packed, as JAX
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for _ in range(steps):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    return js, jf, ts, tf


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def assert_fields_match(got, want, cfg):
    """The port's fields (torch) against the JAX solver's, with
    tests/test_packing.py's bands, two of them widened by the first-order
    effect of the measured differences of their inputs, as chip_smoke's
    compare_fields widens them: a stencil normal's 2e-4 by its sensitivity
    to the fields it is made from (normal_sensitivity), and the foam's
    25·1e-5·max by 1.5·(|δJ| + 0.3·|δn|), smoothstep's slope being ≤ 1.5
    (the Jacobian's error is relative to its largest value, which can be
    three orders above the foam's threshold near 1)."""
    got = fields_to_numpy(got)
    want = type(got)(*(np.asarray(getattr(want, k)) for k in got._fields))
    n_err = np.abs(got.normal - want.normal).max(-1)
    if cfg.normals_mode == "stencil":
        chop = cfg.choppiness
        delta = max(np.abs(got.height - want.height).max(),
                    chop * np.abs(got.disp_x - want.disp_x).max(),
                    chop * np.abs(got.disp_z - want.disp_z).max())
        band = 2e-4 + chip_smoke.normal_sensitivity(want, cfg, delta)
        assert (n_err <= band).all(), (
            f"normal {n_err.max():.3e}, worst err/band "
            f"{(n_err / band).max():.3f}")
        got = got._replace(normal=want.normal)
    f_band = (25e-5 * max(np.abs(want.foam).max(), 1e-9)
              + 1.5 * (np.abs(got.jacobian - want.jacobian) + 0.3 * n_err))
    f_err = np.abs(got.foam - want.foam)
    assert (f_err <= f_band).all(), (
        f"foam {f_err.max():.3e}, worst err/band {(f_err / f_band).max():.3f}")
    _assert_fields_close(got._replace(foam=want.foam), want, 1e-5)


@pytest.mark.parametrize("backend,layout,packed,normals", CASES)
def test_every_complex_configuration_matches_jax(backend, layout, packed,
                                                 normals):
    mode = _mode(packed, normals)
    cfg, ref, port, h0, h0c = _case(backend, layout, packed, normals, mode)
    js, jf, ts, tf = _steps(ref, port, h0, h0c, 3)
    assert_fields_match(tf, jf, cfg)
    assert int(ts.step) == int(js.step) == 3
    assert float(ts.t) == float(js.t)
    # the jitted JAX step contracts φ + ω·dt into one FMA: ≤ 1 ulp
    d = np.abs(ts.phase.numpy() - np.asarray(js.phase))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-6
    if mode == "phase":
        # at the state's phase, ρ = dt_multiplier; no t, no fields_at
        _close(port.velocity(ts), ref.velocity(js))
        with pytest.raises(ValueError):
            port.velocity(ts, t=1.0)
        with pytest.raises(ValueError):
            port.fields_at(ts, 1.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fields_at_and_velocity_match_jax(backend):
    """Absolute time, spectral normals, per-channel, the centered layout
    (``pallas_fused``: the fft layout, its velocity on torch.fft as the
    JAX package's on jnp.fft): fields_at(state, t), velocity(state) and
    velocity(state, t)."""
    layout = "fft" if backend == "pallas_fused" else "centered"
    cfg, ref, port, h0, h0c = _case(backend, layout, False, "spectral",
                                    "absolute")
    js, _, ts, _ = _steps(ref, port, h0, h0c, 2)
    assert_fields_match(port.fields_at(ts, 2.5), ref.fields_at(js, 2.5), cfg)
    _close(port.velocity(ts), ref.velocity(js))
    _close(port.velocity(ts, t=0.75), ref.velocity(js, t=0.75))
