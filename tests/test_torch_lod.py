"""tpu_ocean_torch.LODCascadeSolver on the CPU against the JAX package's
``tpu_ocean.lod`` (Pallas in interpret mode), and the port's own twins of
tests/test_lod.py's invariants.

- ``band_max_omega``, ``nyquist_periods`` and ``periods_for_distance``
  equal to JAX's, list for list, over band sets, time steps, camera
  distances and caps;
- the schedule: the slots and the distinct subsets equal to JAX's; over 8
  frames with periods [4, 2, 1] (and [1, 2, 1], whose subset {0, 2} is
  not a run of bands, and [2, 2, 4], whose odd frames refresh no band)
  both solvers, started from the JAX LODState carried
  across by ``convert.cascade_state_from_numpy``, give the same fields
  every frame (``assert_fields_match``), the same plane cache (1e-5·max)
  and phases (within 1e-6), in phase and absolute time, complex and real,
  and the same ``velocity`` at the held phases;
- the port alone, with tests/test_lod.py's bands: held bands' planes
  bit-equal between refreshes and their phases not advanced; at frames
  where every band refreshes, the combined height within 1e-4 and, at 8,
  the phases within 1e-5 of the plain cascade stepped every frame; the
  previous state left as it was (the scatter writes new tensors);
- ValueErrors (bad periods, a dt off the schedule), the host-side frame,
  the live-channel plane cache, and ``reconfigure``: an init-only change
  shares every table and sub-step and keeps the frame and phases; a
  structural one keeps the schedule."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, lod as jlod
from tpu_ocean_torch import lod
from tpu_ocean_torch.cascade import CascadeSolver, default_cascade
from tpu_ocean_torch.convert import cascade_state_from_numpy
from tpu_ocean_torch.lod import LODCascadeSolver
from tests.test_torch_cascade import (DT, assert_states_match, bands, close,
                                      combined_cfg, jax_cfgs)
from tests.test_torch_complex_backends import assert_fields_match

N = 32
PRODUCTION = dict(fft_backend="pallas", real_state=True, pack_channels=True,
                  half_spectrum=True, pallas_fields=True)


def _bands(n=N):
    """tests/test_lod.py's bands."""
    return default_cascade(n=n, lengths=(1000.0, 130.0, 17.0))


@pytest.mark.parametrize("n,lengths", [(32, (1000.0, 130.0, 17.0)),
                                       (1024, (1000.0, 130.0, 17.0)),
                                       (256, (500.0, 40.0, 9.0, 2.0))])
def test_periods_match_jax(n, lengths):
    cfgs = default_cascade(n=n, lengths=lengths)
    cfgs += [cfgs[0].replace(dispersion_mode="quantized")]
    for c in cfgs:
        assert lod.band_max_omega(c) == jlod.band_max_omega(
            jcfg.OceanConfig(**dataclasses.asdict(c)))
    for dt in (1 / 60, 1 / 240, 1 / 24):
        for kw in ({}, dict(oversample=4.0, max_period=16)):
            assert (lod.nyquist_periods(cfgs, dt, **kw)
                    == jlod.nyquist_periods(jax_cfgs(cfgs), dt, **kw))
            for dist in (50.0, 100.0, 250.0, 800.0, 3000.0, 1e5):
                assert (lod.periods_for_distance(cfgs, dt, dist, **kw)
                        == jlod.periods_for_distance(jax_cfgs(cfgs), dt,
                                                     dist, **kw))


def test_schedule_tables_match_jax():
    for periods in ([4, 2, 1], [8, 4, 1], [1, 2, 1], [2, 2, 2]):
        port = LODCascadeSolver(_bands(), periods=periods, device="cpu")
        ref = jlod.LODCascadeSolver(jax_cfgs(_bands()), periods=periods)
        assert port._slots == ref._slots
        assert set(port._substeps) == set(ref._substeps)
        assert port.schedule_len == ref.schedule_len


SCHEDULE = [("phase", "complex", [4, 2, 1]), ("phase", "real", [4, 2, 1]),
            ("phase", "real", [1, 2, 1]), ("phase", "complex_packed",
                                           [4, 2, 1]),
            ("absolute", "complex", [4, 2, 1]), ("absolute", "real",
                                                 [2, 4, 1]),
            ("phase", "complex", [2, 2, 4])]


@pytest.mark.parametrize("mode,state,periods", SCHEDULE)
def test_schedule_matches_jax_over_8_frames(mode, state, periods):
    n = 64 if state == "real" else N
    extra = (dict(evolution_mode="absolute", dispersion_mode="quantized",
                  t_division=1.5) if mode == "absolute" else {})
    cfgs = bands(n=n, lengths=(1000.0, 130.0, 17.0), **extra)
    kw = {"complex": {}, "complex_packed": dict(pack_channels=True),
          "real": PRODUCTION}[state]
    ref = jlod.LODCascadeSolver(jax_cfgs(cfgs), periods=periods, dt=DT, **kw)
    port = LODCascadeSolver(cfgs, periods=periods, dt=DT, device="cpu", **kw)
    js = ref.init(jax.random.PRNGKey(11))
    ts = cascade_state_from_numpy(js, "cpu")
    # the port's priming of the same state agrees with JAX's
    close(port._planes_at(ts.cascade, port.inner._coeffs), js.planes)
    for frame in range(1, 9):
        js, jf = ref.step(js)
        ts, tf = port.step(ts)
        assert ts.frame == js.frame == frame
        assert_fields_match(tf, jf, combined_cfg(port.inner))
        close(ts.planes, js.planes)
        assert_states_match(ts.cascade, js.cascade)
    close(port.velocity(ts), ref.velocity(js))


def test_held_band_planes_frozen_between_refreshes():
    lod_solver = LODCascadeSolver(_bands(), periods=[4, 2, 1], dt=DT,
                                  device="cpu")
    st = lod_solver.init()
    p_init = st.planes.clone()
    phase_init = st.cascade.phase.clone()
    st1, _ = lod_solver.step(st)                    # frame 1: band 2 only
    assert torch.equal(st.planes, p_init)           # the old state untouched
    assert torch.equal(st.cascade.phase, phase_init)
    assert torch.equal(st1.planes[:2], p_init[:2])
    assert torch.equal(st1.cascade.phase[:2], phase_init[:2])
    assert (st1.planes[2] - p_init[2]).abs().max() > 0
    st2, _ = lod_solver.step(st1)                   # frame 2: bands 1, 2
    assert torch.equal(st2.planes[0], p_init[0])
    assert (st2.planes[1] - st1.planes[1]).abs().max() > 0
    st3, _ = lod_solver.step(st2)                   # frame 3: band 2
    assert torch.equal(st3.planes[:2], st2.planes[:2])
    st4, _ = lod_solver.step(st3)                   # frame 4: every band
    assert (st4.planes[0] - p_init[0]).abs().max() > 0


@pytest.mark.parametrize("kw", [{}, PRODUCTION], ids=["complex", "real"])
def test_refresh_frames_match_the_plain_cascade(kw):
    n = 64 if kw else N
    cfgs = _bands(n)
    plain = CascadeSolver(cfgs, device="cpu", **kw)
    lod_solver = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=DT,
                                  device="cpu", **kw)
    sp, sl = plain.init(), lod_solver.init()
    for f in range(1, 9):
        sp, fp = plain.step(sp, DT)
        sl, fl = lod_solver.step(sl)
        if f % 4 == 0:
            np.testing.assert_allclose(fl.height.numpy(), fp.height.numpy(),
                                       rtol=0, atol=1e-4)
    np.testing.assert_allclose(sl.cascade.phase.numpy(), sp.phase.numpy(),
                               rtol=0, atol=1e-5)


def test_all_period_one_matches_plain_cascade():
    cfgs = _bands()
    plain = CascadeSolver(cfgs, device="cpu")
    lod_solver = LODCascadeSolver(cfgs, periods=[1, 1, 1], dt=DT,
                                  device="cpu")
    sp, sl = plain.init(), lod_solver.init()
    for _ in range(4):
        sp, fp = plain.step(sp, DT)
        sl, fl = lod_solver.step(sl)
        for name in ("height", "disp_x"):
            np.testing.assert_allclose(getattr(fl, name).numpy(),
                                       getattr(fp, name).numpy(), rtol=0,
                                       atol=1e-4)


def test_bad_periods_and_dt_rejected():
    for periods in ([3, 1, 1], [1, 1], [0, 1, 1]):
        with pytest.raises(ValueError) as want:
            jlod.LODCascadeSolver(jax_cfgs(_bands()), periods=periods, dt=DT)
        with pytest.raises(ValueError) as got:
            LODCascadeSolver(_bands(), periods=periods, dt=DT, device="cpu")
        assert str(got.value) == str(want.value)
    solver = LODCascadeSolver(_bands(), periods=[1, 1, 1], dt=DT,
                              device="cpu")
    st = solver.init()
    with pytest.raises(ValueError, match="fixed dt"):
        solver.step(st, dt=DT * 2)
    solver.step(st, dt=DT)                          # the schedule's dt is fine
    with pytest.raises(NotImplementedError, match="item 14"):
        LODCascadeSolver(_bands(), mesh=object(), device="cpu")


def test_frame_is_a_host_int_and_cache_holds_live_planes():
    solver = LODCascadeSolver(_bands(), periods=[2, 1, 1], dt=DT,
                              device="cpu")
    st = solver.init()
    assert isinstance(st.frame, int) and st.frame == 0
    st, _ = solver.step(st)
    assert isinstance(st.frame, int) and st.frame == 1
    assert solver.plane_count == 3 and st.planes.shape == (3, 3, N, N)
    packed = LODCascadeSolver(_bands(), dt=DT, pack_channels=True,
                              device="cpu")
    assert packed.init().planes.shape == (3, 3, N, N)
    spec = [c.replace(normals_mode="spectral") for c in _bands()]
    spectral = LODCascadeSolver(spec, dt=DT, device="cpu")
    assert spectral.plane_count == 5
    assert spectral.init().planes.shape == (3, 5, N, N)
    # the default schedule is nyquist_periods
    assert solver.periods == [2, 1, 1]
    assert (LODCascadeSolver(_bands(), dt=DT, device="cpu").periods
            == lod.nyquist_periods(_bands(), DT))


@pytest.mark.parametrize("kw", [{}, PRODUCTION], ids=["complex", "real"])
def test_reconfigure_init_only_keeps_schedule_and_tables(kw):
    n = 64 if kw else N
    cfgs = _bands(n)
    solver = LODCascadeSolver(cfgs, periods=[4, 1, 1], dt=DT, device="cpu",
                              **kw)
    st = solver.init()
    for _ in range(2):
        st, _ = solver.step(st)
    new_cfgs = [c.replace(amplitude=2.0 * c.amplitude, wind=(9.0, 3.0))
                for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert st2.frame == st.frame and solver2.periods == solver.periods
    assert solver2._substeps is solver._substeps
    for name in ("_omega", "_coeffs", "_x0", "_z0"):
        assert getattr(solver2.inner, name) is getattr(solver.inner, name)
    assert torch.equal(st2.cascade.phase, st.cascade.phase)
    # the cache is re-rendered at the held phases under the new spectrum
    assert (st2.planes - st.planes).abs().max() > 0
    close(st2.planes, solver2._planes_at(st2.cascade, solver2.inner._coeffs),
          1e-6)
    st3, f3 = solver2.step(st2)
    assert st3.frame == st.frame + 1 and torch.isfinite(f3.height).all()


def test_reconfigure_structural_keeps_schedule():
    cfgs = _bands()
    solver = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=DT, device="cpu")
    st = solver.init()
    st, _ = solver.step(st)
    new_cfgs = [c.replace(choppiness=1.3) for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert solver2.inner._coeffs is not solver.inner._coeffs
    assert solver2.periods == [4, 2, 1] and st2.frame == 1
    assert torch.equal(st2.cascade.phase, st.cascade.phase)
    st2, f2 = solver2.step(st2)
    assert torch.isfinite(f2.height).all()
    # a new N starts the schedule over
    _, fresh = solver.reconfigure(st, [c.replace(resolution=64)
                                       for c in cfgs])
    assert fresh.frame == 0 and fresh.planes.shape == (3, 3, 64, 64)
