"""tpu_ocean_torch.Simulation and OceanSolver.reconfigure on the CPU, the
port's twins of tests/test_runtime.py and of the reconfigure tests of
tests/test_diagnostics.py, held against the JAX package where both can
run the same thing.

- The run loop, metrics, resume, export, live reconfigure and the config
  refusal, as tests/test_runtime.py checks them; the export through the
  native exporter only (a failed build raises, where JAX falls back to
  viz), its .npy files bit-equal to the fields of their steps.
- reconfigure: an init-only change shares every table of the solver (the
  same tensors) and keeps phase, clock, step and foam bit for bit; a
  length change builds new tables; a resolution change restarts. The new
  solver's switches are the JAX reconfigure's. torch cannot replay
  jax.random, so after a reconfigure both packages' states take one
  shared h0 (``_replace``), step 3 times and meet within the bands of
  tests/test_torch_complex_backends.py (1e-5·max, a stencil normal's and
  the foam's widened by the first-order effect of the input
  differences)."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg
from tpu_ocean.runtime import Simulation as JaxSimulation
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, OceanConfig, OceanSolver, Simulation,
                             state_from_numpy)
from tpu_ocean_torch import native
from tests.test_torch_complex_backends import assert_fields_match

DT = 1.0 / 60.0
SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)


def _cfg(resolution=32, **kw):
    base = dict(resolution=resolution, length=float(resolution),
                wind=(6.0, 4.0), amplitude=0.1,
                evolution_mode="phase", dispersion_mode="capillary",
                spectrum_layout="fft", normals_mode="stencil")
    base.update(kw)
    return OceanConfig(**base)


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------ tests/test_runtime.py twins

def test_run_loop_and_metrics(tmp_path):
    with Simulation(_cfg(), fft_backend="reference", out_dir=str(tmp_path),
                    device="cpu") as sim:
        f = sim.run(5)
        assert sim.step_count == 5
        assert torch.isfinite(f.height).all()
        assert sim.metrics.summary()["steps"] >= 4


def test_auto_resume_from_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    sim1 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=2, device="cpu")
    sim1.run(6)
    phase1 = sim1.state.phase.clone()
    sim1.close()

    sim2 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=2, device="cpu")
    assert sim2.step_count == 6        # resumed, not restarted
    assert torch.equal(sim2.state.phase, phase1)
    sim2.run(2)
    assert sim2.step_count == 8
    sim2.close()


def test_export_every(tmp_path):
    """Height and foam every 2 steps, each file the float64 of the f32
    field its step returned (exact), the writer flushed with no error."""
    out = str(tmp_path / "run")
    kept = {}
    with Simulation(_cfg(), fft_backend="reference", out_dir=out,
                    export_every=2, device="cpu") as sim:
        sim.run(4, callback=lambda s: kept.__setitem__(
            s.step_count, (s.fields.height.clone(), s.fields.foam.clone())))
        assert sim._exporter.errors() == 0
    exported = sorted(os.listdir(os.path.join(out, "fields")))
    assert exported == [f"{name}_{k:08d}.npy" for name in ("foam", "height")
                        for k in (2, 4)]
    for k in (2, 4):
        for name, field in zip(("height", "foam"), kept[k]):
            got = np.load(os.path.join(out, "fields", f"{name}_{k:08d}.npy"))
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, field.numpy().astype(np.float64))


def test_live_reconfigure(tmp_path):
    with Simulation(_cfg(), fft_backend="reference", device="cpu") as sim:
        sim.run(3)
        sim.reconfigure(_cfg(amplitude=0.5))
        assert sim.step_count == 3     # phase/step preserved
        sim.run(2)
        assert sim.step_count == 5


def test_resume_refuses_config_mismatch(tmp_path):
    out = str(tmp_path / "run")
    sim1 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=1, device="cpu")
    sim1.run(2)
    sim1.close()
    with pytest.raises(ValueError, match="different config"):
        Simulation(_cfg(amplitude=0.9), fft_backend="reference",
                   out_dir=out, checkpoint_every=1, device="cpu")


def test_restart_after_a_resolution_change_resumes_the_new_config(tmp_path):
    """A reconfigure to a new N restarts the step count and clears the
    checkpoints, so a restart resumes the new config's own file. The JAX
    package keeps the old config's files, named and kept by step: they
    outrank the new run's, and its restart refuses its own config
    (ROADMAP Queue 3; a deliberate difference)."""
    out = str(tmp_path / "run")
    new = _cfg(16)
    kw = dict(fft_backend="reference", out_dir=out, checkpoint_every=2,
              device="cpu")
    with Simulation(_cfg(), **kw) as sim:
        sim.run(6)
        sim.reconfigure(new)
        sim.run(4)
        want = sim.state
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        f"state_{k:010d}.npz" for k in (2, 4)]
    with Simulation(new, **kw) as again:
        assert again.step_count == 4
        for name in want._fields:
            assert torch.equal(getattr(again.state, name),
                               getattr(want, name)), name
        again.step()


def test_reconfigure_updates_metrics_grid_points():
    cfg = OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    sim = Simulation(cfg, device="cpu")
    sim.step()
    assert sim.metrics.grid_points == 16 * 16
    sim.reconfigure(cfg.replace(resolution=32, length=32.0))
    assert sim.metrics.grid_points == 32 * 32 and sim.step_count == 0
    sim.step()
    assert sim.step_count == 1


# ----------------------------------------------------- the port's own checks

def test_simulation_defaults_are_jax_simulation_defaults():
    """Simulation's backend defaults to matmul, as JAX's; the solver's
    switches are the same."""
    cfg = _cfg(16)
    port, ref = Simulation(cfg, device="cpu"), JaxSimulation(_jax_cfg(cfg))
    for name in ("fft_backend", "real_state", "pack_channels",
                 "half_spectrum", "pallas_fields"):
        assert getattr(port.solver, name) == getattr(ref.solver, name), name
    assert port.solver.fft_backend == "matmul" and port.dt == ref.dt
    assert port.world_length == ref.world_length


def test_metrics_stream_gets_one_jsonl_line_a_step():
    buf = io.StringIO()
    sim = Simulation(_cfg(16), fft_backend="reference", metrics_stream=buf,
                     device="cpu")
    sim.run(7)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [r["step"] for r in lines] == list(range(1, 8))
    assert set(lines[0]) == {"step", "sim_time", "wall_dt_s",
                             "grid_points_per_s", "updates_per_s"}
    assert lines[-1]["sim_time"] == round(7 * DT, 6)


def test_resume_continues_bit_for_bit_on_the_slice(tmp_path):
    """The real-state slice (packed + half, the fields kernel's plain
    version): 4 steps, resume, 2 more, against 6 uninterrupted steps
    from the same generator: state and fields bit-equal."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    out = str(tmp_path / "run")
    with Simulation(cfg, out_dir=out, checkpoint_every=2, device="cpu",
                    generator=torch.Generator().manual_seed(7),
                    **SLICE) as sim:
        sim.run(4)
    with Simulation(cfg, out_dir=out, checkpoint_every=2, device="cpu",
                    **SLICE) as resumed:
        assert resumed.step_count == 4
        got = resumed.run(2)
    with Simulation(cfg, device="cpu", generator=torch.Generator().manual_seed(7),
                    **SLICE) as whole:
        want = whole.run(6)
    for a, b in zip(resumed.state, whole.state):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_failed_exporter_build_raises_with_the_compiler_output(tmp_path,
                                                               monkeypatch):
    """No fallback: a source that does not compile raises RuntimeError
    naming the compiler's complaint, from Simulation too."""
    bad = tmp_path / "exporter.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            native.AsyncExporter(str(tmp_path / "fields"))
        with pytest.raises(RuntimeError, match="exporter.cpp"):
            Simulation(_cfg(16), fft_backend="reference",
                       out_dir=str(tmp_path / "run"), export_every=1,
                       device="cpu")
    finally:
        native.load.cache_clear()


def test_exporter_alone_writes_npy(tmp_path):
    with native.AsyncExporter(str(tmp_path)) as ex:
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        assert ex.submit("x", 5, torch.from_numpy(a))
        ex.flush()
        assert ex.pending() == 0 and ex.errors() == 0
    np.testing.assert_array_equal(np.load(tmp_path / "x_00000005.npy"),
                                  a.astype(np.float64))


# ------------------------------------------------------------ reconfigure

def _jax_reconfigured(cfg, kw, new_cfg, steps=2, seed=0):
    """The JAX and the port solver with ``kw``, ``steps`` steps from one
    injected h0, then reconfigured to ``new_cfg``."""
    from tests.test_torch_solver import _h0_pair
    ref = JaxSolver(_jax_cfg(cfg), **kw)
    port = OceanSolver(cfg, device="cpu", **kw)
    h0, h0c = _h0_pair(cfg, seed=seed)
    js, ts = ref.init(h0=h0, h0_conj=h0c), port.init(h0=h0, h0_conj=h0c)
    for _ in range(steps):
        js, _ = ref.step(js, DT)
        ts, _ = port.step(ts, DT)
    return ref, port, js, ts, ref.reconfigure(js, _jax_cfg(new_cfg)), \
        port.reconfigure(ts, new_cfg)


#: (solver keywords, config changes): init-only changes, a length change
#: (new tables, same N), a resolution change (restart)
RECONFIGURE_CASES = {
    "slice-wind": (SLICE, dict(wind=(10.0, 6.0), amplitude=0.5)),
    "slice-length": (SLICE, dict(length=80.0)),
    "slice-resolution": (SLICE, dict(resolution=128, length=128.0)),
    "complex-seed": (dict(fft_backend="matmul"), dict(seed=3, damping=0.02)),
    "complex-dispersion": (dict(fft_backend="reference", pack_channels=True),
                           dict(dispersion_mode="quantized")),
}


@pytest.mark.parametrize("case", list(RECONFIGURE_CASES))
def test_reconfigure_matches_jax_with_a_shared_h0(case):
    kw, changes = RECONFIGURE_CASES[case]
    cfg = OCEAN_DEMO.replace(resolution=64, foam_decay=0.5)
    new_cfg = cfg.replace(**changes)
    ref, port, js, ts, (jsolver, jst), (tsolver, tst) = _jax_reconfigured(
        cfg, kw, new_cfg)
    for name in ("fft_backend", "eval_mode", "real_state", "pack_channels",
                 "half_spectrum", "pallas_fields"):
        assert getattr(tsolver, name) == getattr(jsolver, name), name
    assert tsolver.cfg == new_cfg and tsolver.device == port.device
    init_only = set(changes) <= OceanSolver.INIT_ONLY_FIELDS
    same_n = new_cfg.resolution == cfg.resolution
    # the tables: shared on an init-only change, new otherwise
    assert (tsolver.omega is port.omega) == init_only
    if init_only:
        for name in ("pack", "coeffs", "x0", "z0", "pre", "post"):
            assert getattr(tsolver, name, None) is getattr(port, name, None)
    for name in ("phase", "t", "step", "foam_accum"):
        if same_n:
            assert torch.equal(getattr(tst, name), getattr(ts, name)), name
        else:
            assert not getattr(tst, name).any(), name
    # one shared h0 (torch cannot replay jax.random), then both step
    h0_fields = ("h0_re", "h0_im", "h0c_re", "h0c_im") if kw.get(
        "real_state") else ("h0", "h0_conj")
    tst = tst._replace(**{k: getattr(state_from_numpy(jst, "cpu"), k)
                          for k in h0_fields})
    for _ in range(3):
        jst, jf = jsolver.step(jst, DT)
        tst, tf = tsolver.step(tst, DT)
    assert_fields_match(tf, jf, new_cfg)
    assert int(tst.step) == int(jst.step)


def test_reconfigure_preserves_phase():
    """tests/test_diagnostics.py's twin: the spectrum is re-rendered, the
    phase and the step stay."""
    s = OceanSolver(_cfg(64, amplitude=0.3, wind=(8.0, 5.0)), device="cpu")
    st = s.init(torch.Generator().manual_seed(0))
    for _ in range(4):
        st, _ = s.step(st, DT)
    s2, st2 = s.reconfigure(st, _cfg(64, amplitude=0.9, wind=(12.0, 2.0)))
    assert torch.equal(st2.phase, st.phase) and int(st2.step) == 4
    assert not torch.allclose(st2.h0, st.h0)       # a new spectrum
    st2, f = s2.step(st2, DT)
    assert torch.isfinite(f.height).all()


def test_reconfigure_resolution_change_resets():
    s = OceanSolver(_cfg(64), device="cpu")
    st, _ = s.step(s.init(), DT)
    s2, st2 = s.reconfigure(st, _cfg(32))
    assert st2.phase.shape == (32, 32) and int(st2.step) == 0


def test_reconfigure_init_only_shares_the_tables():
    """The port's counterpart of reusing the compiled step: a wind and
    amplitude change shares the tables and the transform; a length change
    rebuilds them."""
    cfg = OceanConfig(resolution=32, length=32.0, wind=(5.0, 3.0),
                      amplitude=0.1, spectrum_layout="fft",
                      normals_mode="stencil")
    s1 = OceanSolver(cfg, fft_backend="matmul", device="cpu")
    st, _ = s1.step(s1.init(), DT)
    s2, st2 = s1.reconfigure(st, cfg.replace(wind=(9.0, 1.0), amplitude=0.3))
    assert s2._ifft2 is s1._ifft2 and s2.coeffs is s1.coeffs
    assert torch.equal(st2.phase, st.phase)
    assert not torch.equal(st2.h0, st.h0)
    st2, f2 = s2.step(st2, DT)
    assert torch.isfinite(f2.height).all()
    s3, _ = s1.reconfigure(st, cfg.replace(length=64.0))
    assert s3.omega is not s1.omega and s3.coeffs is not s1.coeffs


def test_reconfigure_draws_from_the_generator():
    """The fresh h0 comes from ``generator`` (default: seeded with the new
    config's seed), so a given generator state gives the draw init gives."""
    cfg = _cfg(32)
    s = OceanSolver(cfg, device="cpu")
    new_cfg = cfg.replace(seed=11)
    _, default = s.reconfigure(s.init(), new_cfg)
    _, given = s.reconfigure(s.init(), new_cfg,
                             torch.Generator().manual_seed(11))
    want = OceanSolver(new_cfg, device="cpu").init()
    assert torch.equal(default.h0, want.h0) and torch.equal(given.h0, want.h0)
