"""tpu_ocean_torch.CascadeSolver on the CPU against the JAX package's
``tpu_ocean.cascade.CascadeSolver`` (Pallas in interpret mode).

torch cannot replay jax.random, so every comparison starts from the JAX
solver's initial state, h0 included, carried into the port by
``convert.cascade_state_from_numpy``; both step 3 times at N = 32 (64 with
the half spectrum) with 2-3 bands. The fields are held to the bands of the
port's single-patch parity tests (``assert_fields_match``: 1e-5·max, the
stencil normals and the foam widened by the first-order effect of the
measured input differences), computed on the combined surface (choppiness
1, the display length's texel); the phase within 1e-6 (the jitted JAX
step contracts φ + ω·dt into one FMA), the step count exactly and the
clock within one f32 ulp (assert_states_match), ``velocity`` and
``velocity_at_held_phase`` within 1e-5·max.

Also: every ValueError of the JAX constructor with its message, in its
order; ``mesh=`` raising NotImplementedError naming ROADMAP item 14;
``default_cascade`` equal to JAX's; the band-batched evolve helpers
bit-equal to their per-band form and the per-band Hermitian projection
bit-equal to JAX's vmap; ``reconfigure``, init-only (the tables shared,
phase, clock and step kept) and structural; and the real state's step
making exactly one row-DFT call a pass for all bands (5 at C = B packed +
half)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_ocean import cascade as jcascade, config as jcfg
from tpu_ocean.evolve import hermitize_pair as jax_hermitize_pair
from tpu_ocean_torch import cascade as tcascade, evolve
from tpu_ocean_torch.cascade import CascadeSolver, default_cascade
from tpu_ocean_torch.convert import (cascade_state_from_numpy,
                                     cascade_state_to_numpy)
from tpu_ocean_torch.fft import planes
from tests.test_torch_complex_backends import assert_fields_match

DT = 1.0 / 60.0


def jax_cfgs(cfgs):
    return [jcfg.OceanConfig(**dataclasses.asdict(c)) for c in cfgs]


def bands(n=32, lengths=(100.0, 13.0, 5.0), **kw):
    """default_cascade with dt_multiplier and choppiness off their defaults
    per band, so that both are exercised band by band."""
    return [c.replace(dt_multiplier=1.0 + 0.25 * i, choppiness=0.5 + 0.2 * i,
                      **kw)
            for i, c in enumerate(default_cascade(n=n, lengths=lengths))]


def combined_cfg(solver):
    """The config assert_fields_match reads for the combined surface: the
    effective displacements carry no further chop, the texel is the
    display length's."""
    return solver.cfgs[0].replace(choppiness=1.0,
                                  length=solver.display_length)


def pair(cfgs, key=3, **kw):
    """(JAX solver, port solver on the CPU, JAX init state, port copy)."""
    ref = jcascade.CascadeSolver(jax_cfgs(cfgs), **kw)
    port = CascadeSolver(cfgs, device="cpu", **kw)
    js = ref.init(jax.random.PRNGKey(key))
    return ref, port, js, cascade_state_from_numpy(js, "cpu")


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def assert_states_match(ts, js):
    """Phase within 1e-6, step exactly, the clock within one f32 ulp: in
    absolute time XLA compiles dt / t_division as dt · f32(1/t_division),
    and the port divides, as its OceanSolver does (bit-equal in phase
    time, where t ← t + dt)."""
    d = np.abs(ts.phase.numpy() - np.asarray(js.phase))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-6
    want = np.float32(js.t)
    assert abs(np.float32(ts.t) - want) <= np.spacing(want)
    assert int(ts.step) == int(js.step)


def run_both(ref, port, js, ts, steps=3):
    for _ in range(steps):
        js, jf = ref.step(js, DT)
        ts, tf = port.step(ts, DT)
    assert_fields_match(tf, jf, combined_cfg(port))
    assert_states_match(ts, js)
    return js, ts


# ------------------------------------------------------------- validation

def _bad_cases():
    cfgs = default_cascade(n=32)
    return [
        ([], {}),
        ([cfgs[0].replace(foam_decay=0.5)] + cfgs[1:], {}),
        ([c.replace(normals_mode="spectral") for c in cfgs],
         dict(pallas_fields=True)),
        (default_cascade(n=36), dict(pallas_fields=True)),
        (cfgs, dict(real_state=True)),
        (cfgs, dict(real_state=True, fft_backend="reference")),
        (cfgs[:1] + [cfgs[1].replace(resolution=64)], {}),
        (cfgs[:1] + [cfgs[1].replace(evolution_mode="absolute")], {}),
        (cfgs[:1] + [cfgs[1].replace(dispersion_mode="quantized")], {}),
        ([cfgs[0].replace(spectrum_layout="centered")], {}),
        (cfgs, dict(half_spectrum=True, fft_backend="pallas",
                    real_state=True)),
        (cfgs, dict(half_spectrum=True, pack_channels=True)),
        (default_cascade(n=32), dict(half_spectrum=True, pack_channels=True,
                                     fft_backend="pallas", real_state=True)),
        (default_cascade(n=72), dict(half_spectrum=True, pack_channels=True,
                                     fft_backend="pallas", real_state=True)),
        (cfgs, dict(fft_backend="pallas_fused")),
        (cfgs, dict(fft_backend="bogus")),
        # the first of two faults raises, as in JAX's order
        ([cfgs[0].replace(foam_decay=0.5, spectrum_layout="centered")],
         dict(real_state=True)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_cases())))
def test_validation_errors_match_jax(case):
    cfgs, kw = _bad_cases()[case]
    with pytest.raises(ValueError) as want:
        jcascade.CascadeSolver(jax_cfgs(cfgs), **kw)
    with pytest.raises(ValueError) as got:
        CascadeSolver(cfgs, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_mesh_raises_naming_item_14():
    with pytest.raises(NotImplementedError, match="item 14"):
        CascadeSolver(default_cascade(n=32), mesh=object(), device="cpu")
    # a config JAX refuses still raises its ValueError first
    with pytest.raises(ValueError, match="foam_decay"):
        CascadeSolver([default_cascade(n=32)[0].replace(foam_decay=1.0)],
                      mesh=object(), device="cpu")


def test_default_cascade_matches_jax():
    for kw in ({}, dict(n=64, lengths=(500.0, 50.0), wind=(3.0, 9.0),
                        amplitude=0.7, choppiness=1.1)):
        got = [dataclasses.asdict(c) for c in default_cascade(**kw)]
        want = [dataclasses.asdict(c) for c in jcascade.default_cascade(**kw)]
        assert got == want


# --------------------------------------------------- the band-batched helpers

def test_batched_helpers_equal_their_per_band_form():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    b, n = 3, 16
    h0 = [t(b, n, n) for _ in range(4)]
    phase, coeffs, pack = t(b, n, n), t(b, 3, n, n), t(b, 4, n, n)
    cplx = torch.complex(h0[0], h0[1]), torch.complex(h0[2], h0[3])
    for fn, args in (
            (evolve.assemble_spectra_real, (h0, phase, coeffs)),
            (evolve.assemble_spectra_packed_real, (h0, phase, pack)),
            (evolve.hermitize_planes, h0),
            (evolve.assemble_spectra, (*cplx, phase, coeffs)),
            (evolve.assemble_spectra_packed, (*cplx, phase, pack)),
            (evolve.hermitize_pair, cplx)):
        whole = fn(*args)
        whole = whole if isinstance(whole, tuple) else (whole,)
        for i in range(b):
            band_args = [tuple(p[i] for p in a) if isinstance(a, list)
                         else a[i] for a in args]
            one = fn(*band_args)
            one = one if isinstance(one, tuple) else (one,)
            for w, o in zip(whole, one):
                assert torch.equal(w[i], o), fn.__name__


@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
def test_symmetrize_matches_jax_vmap(real):
    cfgs = bands()
    unpacked = jcascade.CascadeSolver(jax_cfgs(cfgs))
    js = unpacked.init(jax.random.PRNGKey(1))
    h0, h0c = np.asarray(js.h0), np.asarray(js.h0_conj)
    a, ac = jax.vmap(jax_hermitize_pair)(js.h0, js.h0_conj)
    kw = dict(fft_backend="pallas", real_state=True) if real else {}
    port = CascadeSolver(cfgs, device="cpu", pack_channels=True, **kw)
    ts = port.init(h0=h0, h0_conj=h0c)
    if real:
        got = (ts.h0_re, ts.h0_im, ts.h0c_re, ts.h0c_im)
        want = (np.real(a), np.imag(a), np.real(ac), np.imag(ac))
    else:
        got, want = (ts.h0, ts.h0_conj), (a, ac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # idempotent, as the resume contract needs
    again = port.symmetrize(ts)
    for g, w in zip(again, ts):
        assert torch.equal(g, w)


# ------------------------------------------------------------ the steps

COMPLEX = [(backend, packed, normals)
           for backend in ("reference", "stockham", "matmul", "pallas")
           for packed in (False, True) for normals in ("stencil", "spectral")
           if backend == "reference" or (packed, normals) in
           ((False, "stencil"), (True, "spectral"))]


@pytest.mark.parametrize("backend,packed,normals", COMPLEX)
def test_complex_state_matches_jax(backend, packed, normals):
    cfgs = bands(normals_mode=normals)
    ref, port, js, ts = pair(cfgs, fft_backend=backend, pack_channels=packed)
    assert isinstance(ts, tcascade.CascadeState)
    js, ts = run_both(ref, port, js, ts)
    close(port.velocity(ts), ref.velocity(js))
    close(port.velocity_at_held_phase(ts), ref.velocity_at_held_phase(js))
    with pytest.raises(ValueError):
        port.velocity(ts, t=1.0)


REAL = [(packed, half, fields, normals)
        for packed in (False, True) for half in (False, True)
        for fields in (False, True) for normals in ("stencil", "spectral")
        if (packed or not half) and not (fields and normals == "spectral")]


@pytest.mark.parametrize("packed,half,fields,normals", REAL)
def test_real_state_matches_jax(packed, half, fields, normals):
    n = 64 if half else 32
    cfgs = bands(n=n, normals_mode=normals)
    ref, port, js, ts = pair(cfgs, fft_backend="pallas", real_state=True,
                             pack_channels=packed, half_spectrum=half,
                             pallas_fields=fields)
    assert isinstance(ts, tcascade.CascadeStateReal)
    js, ts = run_both(ref, port, js, ts)
    close(port.velocity(ts), ref.velocity(js))
    close(port.velocity_at_held_phase(ts), ref.velocity_at_held_phase(js))


@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
def test_absolute_mode_matches_jax(real):
    cfgs = bands(n=64, evolution_mode="absolute",
                 dispersion_mode="quantized", t_division=1.5)
    kw = (dict(fft_backend="pallas", real_state=True, pack_channels=True,
               half_spectrum=True, pallas_fields=True) if real else {})
    ref, port, js, ts = pair(cfgs, **kw)
    js, ts = run_both(ref, port, js, ts)
    # the state keeps its phase; t advances by dt / t_division
    assert not ts.phase.any()
    close(port.velocity(ts), ref.velocity(js))
    close(port.velocity(ts, t=0.37), ref.velocity(js, t=0.37))
    close(port.velocity_at_held_phase(ts), ref.velocity_at_held_phase(js))


def test_display_length_and_positions_match_jax():
    cfgs = bands()
    ref, port, js, ts = pair(cfgs, display_length=77.0)
    assert port.display_length == ref.display_length == 77.0
    np.testing.assert_array_equal(port._x0.numpy(), np.asarray(ref._x0))
    np.testing.assert_array_equal(port._z0.numpy(), np.asarray(ref._z0))
    default = CascadeSolver(cfgs, device="cpu")
    assert default.display_length == max(c.length for c in cfgs)
    run_both(ref, port, js, ts, steps=1)


def test_step_is_one_row_dft_call_a_pass_for_all_bands(monkeypatch):
    """The real state's step, packed + half at B = 3: 5 row-DFT calls,
    each at C = 3 (the full channel's two passes; the half channel's rows,
    Nyquist row and columns), and velocity 3 at C = 3; unpacked, 2 calls
    at C = B·3."""
    calls = []
    original = planes.fft1d_transposed

    def counted(re, im, *args):
        calls.append(tuple(re.shape))
        return original(re, im, *args)

    monkeypatch.setattr(planes, "fft1d_transposed", counted)
    cfgs = bands(n=64)
    solver = CascadeSolver(cfgs, device="cpu", fft_backend="pallas",
                           real_state=True, pack_channels=True,
                           half_spectrum=True, pallas_fields=True)
    state = solver.init()
    solver.step(state, DT)
    assert calls == [(3, 64, 64), (3, 64, 64), (3, 32, 64), (3, 1, 64),
                     (3, 64, 32)]
    calls.clear()
    solver.velocity(state)
    assert [c[0] for c in calls] == [3, 3, 3]
    calls.clear()
    CascadeSolver(cfgs, device="cpu", fft_backend="pallas",
                  real_state=True).step(state, DT)
    assert calls == [(9, 64, 64), (9, 64, 64)]


# ------------------------------------------------------------ reconfigure

@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
def test_reconfigure_init_only_shares_tables_keeps_phase(real):
    kw = (dict(fft_backend="pallas", real_state=True, pack_channels=True)
          if real else {})
    cfgs = bands()
    solver = CascadeSolver(cfgs, device="cpu", **kw)
    st = solver.init()
    for _ in range(3):
        st, _ = solver.step(st, DT)
    new_cfgs = [c.replace(wind=(4.0, 11.0), amplitude=0.9) for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert solver2 is not solver and solver2.cfgs == new_cfgs
    for name in ("_omega", "_coeffs", "_x0", "_z0", "_chop"):
        assert getattr(solver2, name) is getattr(solver, name), name
    assert st2.phase is st.phase and st2.t is st.t and st2.step is st.step
    # h0 drawn afresh from new_cfgs[0].seed, as a fresh solver draws it
    control = CascadeSolver(new_cfgs, device="cpu", **kw)
    fresh = control.init()
    for name in fresh._fields[:-3]:
        assert torch.equal(getattr(st2, name), getattr(fresh, name)), name
    cst = fresh._replace(phase=st.phase, t=st.t, step=st.step)
    for _ in range(2):
        st2, f2 = solver2.step(st2, DT)
        cst, fc = control.step(cst, DT)
    for a, b in zip(f2, fc):
        close(a, b, 1e-6)


def test_reconfigure_structural_rebuilds_and_matches_jax():
    cfgs = bands()
    ref, port, js, ts = pair(cfgs)
    js, _ = ref.step(js, DT)
    ts, _ = port.step(ts, DT)
    new_cfgs = [c.replace(choppiness=1.3) for c in cfgs]
    jsolver, jst = ref.reconfigure(js, jax_cfgs(new_cfgs))
    tsolver, tst = port.reconfigure(ts, new_cfgs)
    assert tsolver._coeffs is not port._coeffs
    assert torch.equal(tst.phase, ts.phase) and int(tst.step) == 1
    assert np.array_equal(tsolver._chop.numpy().ravel(), jsolver._chop)
    # the new h0 comes from each package's own RNG: share JAX's
    tst = cascade_state_from_numpy(jst, "cpu")
    run_both(jsolver, tsolver, jst, tst, steps=2)
    # a new N starts over; a band-count change raises
    grown = [c.replace(resolution=64) for c in cfgs]
    _, fresh = port.reconfigure(ts, grown)
    assert int(fresh.step) == 0 and fresh.phase.shape == (3, 64, 64)
    for solver in (ref, port):
        with pytest.raises(ValueError, match="band"):
            solver.reconfigure(js if solver is ref else ts,
                               (jax_cfgs if solver is ref else list)(
                                   new_cfgs[:2]))


def test_state_round_trips_through_numpy():
    cfgs = bands()
    for kw in ({}, dict(fft_backend="pallas", real_state=True)):
        solver = CascadeSolver(cfgs, device="cpu", **kw)
        st, _ = solver.step(solver.init(), DT)
        back = cascade_state_from_numpy(cascade_state_to_numpy(st), "cpu")
        assert type(back) is type(st)
        for a, b in zip(back, st):
            assert a.dtype == b.dtype and torch.equal(a, b)
