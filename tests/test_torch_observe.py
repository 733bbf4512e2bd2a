"""tpu_ocean_torch.observe and tpu_ocean_torch.diagnostics against the JAX
package's, on the CPU.

- Metrics: with both packages' clocks replaced by one fake clock, the
  JSONL and CSV records are the same text, and so are the summaries; a
  run of zero steps reports zeros.
- check_finite raises FloatingPointError naming the leaf as JAX names it;
  profile_trace writes a trace with the named scopes in it;
  stage_breakdown returns the JAX keys and refuses the complex state.
- diagnostics: on the same fields (a port step at 64²), every statistic
  within 1e-6 relative of JAX's (f32 reductions in other orders); the
  spectrum and the peak period (numpy float64 in both) equal; the
  test_diagnostics.py twins."""

import io
import json
import os

import numpy as np
import pytest
import torch

from tpu_ocean import diagnostics as jdiag, observe as jobs
from tpu_ocean_torch import (OCEAN_DEMO, OceanConfig, OceanSolver, Metrics,
                             fields_to_numpy)
from tpu_ocean_torch import diagnostics as tdiag, observe as tobs

DT = 1.0 / 60.0


class _Clock:
    """perf_counter stand-in: advances by a fixed sequence of walls."""

    def __init__(self, walls):
        self.t, self.walls, self.calls = 100.0, list(walls), 0

    def perf_counter(self):
        self.calls += 1
        if self.calls % 2 == 0:      # the end of a measure()
            self.t += self.walls[(self.calls // 2 - 1) % len(self.walls)]
        return self.t


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_metrics_records_are_the_jax_records(monkeypatch, fmt):
    walls = [0.0125, 0.003, 0.0041, 0.0029, 0.0033]
    out = {}
    for name, mod in (("port", tobs), ("jax", jobs)):
        monkeypatch.setattr(mod, "time", _Clock(walls))
        buf = io.StringIO()
        m = mod.Metrics(grid_points=64 * 64, emit=buf, emit_format=fmt)
        for i in range(5):
            with m.measure(sim_dt=DT, **({"band": i} if i == 2 else {})):
                pass
        out[name] = (buf.getvalue(), m.summary(), m.last.as_dict())
    assert out["port"] == out["jax"]
    lines = out["port"][0].splitlines()
    assert len(lines) == (5 if fmt == "jsonl" else 6)
    if fmt == "jsonl":
        assert json.loads(lines[2])["band"] == 2


def test_metrics_summary_handles_zero_steps():
    out = Metrics(grid_points=64).summary()
    assert out == jobs.Metrics(grid_points=64).summary()
    assert out["steps"] == 0 and out["mean_ms"] == 0.0


def test_check_finite_names_the_leaf_as_jax_does():
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=16), device="cpu")
    _, fields = solver.step(solver.init(), DT)
    tobs.check_finite(fields, "step 1")
    bad = fields._replace(foam=fields.foam.clone())
    bad.foam[3, 4] = float("nan")
    messages = []
    for check, tree in ((tobs.check_finite, bad),
                        (jobs.check_finite, fields_to_numpy(bad))):
        with pytest.raises(FloatingPointError) as err:
            check(tree, "step 1")
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "non-finite values in .foam (step 1)"
    with pytest.raises(FloatingPointError, match=r"\['h'\]\[1\]"):
        tobs.check_finite({"h": [torch.zeros(2), torch.tensor([1j * np.inf])]})
    tobs.check_finite((torch.arange(3), np.ones(2)))       # ints pass


def test_profile_trace_writes_a_trace_with_the_named_scopes(tmp_path):
    solver = OceanSolver(OCEAN_DEMO.replace(resolution=16), device="cpu")
    state = solver.init()
    with tobs.profile_trace(str(tmp_path)) as prof:
        with tobs.named_scope("ocean_step"):
            solver.step(state, DT)
    names = {e.key for e in prof.key_averages()}
    assert "ocean_step" in names
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert "ocean_step" in f.read()


def test_stage_breakdown_real_state():
    cfg = OceanConfig(resolution=64, length=64.0, wind=(7.0, 4.0),
                      amplitude=0.2, spectrum_layout="fft",
                      normals_mode="stencil", evolution_mode="phase")
    s = OceanSolver(cfg, fft_backend="pallas", real_state=True, device="cpu")
    bd = tobs.stage_breakdown(s, s.init(), ks=(4, 8, 16))
    assert set(bd) == {"full_ms", "transform_ms", "dispersion_ms",
                       "fields_ms", "assembly_transform_ms", "full_suspect",
                       "transform_suspect", "dispersion_suspect"}
    assert bd["full_ms"] > 0 and bd["transform_ms"] > 0
    assert bd["full_ms"] >= bd["dispersion_ms"] * 0.5
    sc = OceanSolver(cfg, fft_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="real"):
        tobs.stage_breakdown(sc, sc.init())


def test_planes_from_phase_are_the_fields_inputs():
    """stage_breakdown's transform stage: the planes _fields_from_phase
    extracts its fields from, on both states."""
    cfg = OCEAN_DEMO.replace(resolution=64)
    for kw in (dict(fft_backend="pallas", real_state=True,
                    pack_channels=True, half_spectrum=True),
               dict(fft_backend="reference")):
        s = OceanSolver(cfg, device="cpu", **kw)
        st = s.init()
        phase = st.phase + 0.25
        height, disp_x, disp_z = s._planes_from_phase(st, phase)
        f = s._fields_from_phase(st, phase)
        assert torch.equal(f.height, height) and torch.equal(f.disp_z, disp_z)


# ------------------------------------------------------------ diagnostics

def _fields():
    cfg = OCEAN_DEMO.replace(resolution=64, amplitude=4.0)
    solver = OceanSolver(cfg, device="cpu", fft_backend="pallas",
                         real_state=True, pack_channels=True,
                         pallas_fields=True)
    state = solver.init(torch.Generator().manual_seed(2))
    for _ in range(3):
        state, fields = solver.step(state, DT)
    return cfg, fields


def test_diagnostics_match_jax_on_the_same_fields():
    cfg, fields = _fields()
    arrays = fields_to_numpy(fields)
    for name in ("significant_wave_height", "surface_variance",
                 "foam_coverage"):
        arg = fields.foam if name == "foam_coverage" else fields.height
        got = float(getattr(tdiag, name)(arg))
        want = float(getattr(jdiag, name)(np.asarray(arg)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    got, want = tdiag.energy_budget(fields), jdiag.energy_budget(arrays)
    assert set(got) == set(want)
    assert 0 < got["foam_cover"] < 1
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    for nbins in (0, 10):
        k, e = tdiag.omnidirectional_spectrum(fields.height, cfg.length, nbins)
        jk, je = jdiag.omnidirectional_spectrum(arrays.height, cfg.length,
                                                nbins)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(e, je)
    assert (tdiag.peak_period(fields.height, cfg.length)
            == jdiag.peak_period(arrays.height, cfg.length))


def test_hs_matches_definition():
    h = torch.from_numpy(np.random.default_rng(0).normal(0, 0.5, (64, 64))
                         .astype(np.float32))
    hs = float(tdiag.significant_wave_height(h))
    np.testing.assert_allclose(hs, 4 * float(np.std(h.numpy())), rtol=1e-6)


def test_spectrum_peak_of_monochromatic_wave():
    n, length = 64, 64.0
    x = np.arange(n) * (length / n)
    kx = 2 * np.pi * 4 / length          # mode 4
    h = torch.from_numpy(np.cos(np.outer(kx * x, np.ones(n))))
    k, e = tdiag.omnidirectional_spectrum(h, length)
    np.testing.assert_allclose(k[1:][np.argmax(e[1:])], kx, rtol=0.15)
    np.testing.assert_allclose(tdiag.peak_period(h, length),
                               2 * np.pi / np.sqrt(9.81 * kx), rtol=0.15)


def test_energy_budget_block():
    _, f = _fields()
    b = tdiag.energy_budget(f)
    assert b["hs"] > 0 and 0 <= b["foam_cover"] <= 1
    assert np.isfinite(b["min_jacobian"])


def test_foam_coverage_rename_keeps_alias():
    foam = torch.tensor([[0.0, 1.0], [1.0, 0.2]])
    assert float(tdiag.foam_coverage(foam)) == 0.5
    assert tdiag.steepness is tdiag.foam_coverage


def test_foam_accumulation_keeps_foam_above_the_instantaneous():
    """test_diagnostics.py's persistent foam on the port: at or above the
    instantaneous foam, and the instantaneous path keeps zeros."""
    cfg = OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0),
                      amplitude=0.8, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    inst = OceanSolver(cfg, device="cpu")
    acc = OceanSolver(cfg.replace(foam_decay=0.5), device="cpu")
    si = inst.init(torch.Generator().manual_seed(4))
    sa = acc.init(torch.Generator().manual_seed(4))
    for _ in range(10):
        si, fi = inst.step(si, DT)
        sa, fa = acc.step(sa, DT)
    assert (fa.foam >= fi.foam - 1e-6).all()
    assert float(tdiag.foam_coverage(fa.foam)) >= float(
        tdiag.foam_coverage(fi.foam))
    assert not si.foam_accum.any()
