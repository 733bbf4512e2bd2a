"""Cascade and LOD checkpoints, and tpu_ocean_torch.CascadeSimulation, on the
CPU against the JAX package (``tpu_ocean.checkpoint``,
``tpu_ocean.runtime.CascadeSimulation``).

- A file either package writes (plain cascade and LOD, complex and real
  state, with configs and schedule) loads in the other, every leaf
  bit-equal, into either state; ``load_checkpoint`` on such a file says to
  use ``load_cascade_checkpoint`` in both packages, and
  ``load_cascade_checkpoint`` on a single-patch file says the reverse;
  ``cascade_checkpoint_periods`` reads the schedule.
- CascadeSimulation: the run loop and metrics; a resume (plain and LOD,
  complex and real) continuing bit for bit; the resume of a directory the
  JAX CascadeSimulation wrote, stepped on by both within the port's parity
  bands; its four refusals (other band configs, the other checkpoint kind,
  another LOD schedule, fewer cached planes than the solver needs, each
  with the JAX package's message) and the cut of extra cached planes; the
  export of height and foam; a live reconfigure keeping phase, schedule
  and step count."""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from tpu_ocean import checkpoint as jckpt
from tpu_ocean import lod as jlod
from tpu_ocean.cascade import CascadeSolver as JaxCascade
from tpu_ocean.runtime import CascadeSimulation as JaxCascadeSimulation
from tpu_ocean_torch import (CascadeSimulation, CascadeSolver,
                             LODCascadeSolver, checkpoint)
from tpu_ocean_torch.cascade import CascadeState, CascadeStateReal
from tpu_ocean_torch.convert import (cascade_state_from_numpy,
                                     cascade_state_to_numpy)
from tpu_ocean_torch.lod import LODState
from tests.test_torch_cascade import (DT, assert_states_match, bands,
                                      combined_cfg, jax_cfgs)
from tests.test_torch_complex_backends import assert_fields_match

REAL = dict(fft_backend="pallas", real_state=True, pack_channels=True)


def _port_state(kind, real):
    """A port state of ``kind`` ("cascade" or "lod") after 3 steps."""
    cfgs = bands()
    kw = REAL if real else {}
    if kind == "lod":
        solver = LODCascadeSolver(cfgs, periods=[4, 2, 1], device="cpu", **kw)
    else:
        solver = CascadeSolver(cfgs, device="cpu", **kw)
    st = solver.init()
    for _ in range(3):
        st, _ = solver.step(st, DT)
    return cfgs, st


def _leaves(state):
    """{name: numpy} of a cascade or LOD state, the h0 pair as complex."""
    out = {}
    if hasattr(state, "frame"):
        out.update(planes=np.asarray(state.planes), frame=state.frame)
        state = state.cascade
    if hasattr(state, "h0_re"):
        out.update(h0=np.asarray(state.h0_re) + 1j * np.asarray(state.h0_im),
                   h0_conj=np.asarray(state.h0c_re)
                   + 1j * np.asarray(state.h0c_im))
    else:
        out.update(h0=np.asarray(state.h0), h0_conj=np.asarray(state.h0_conj))
    out.update(phase=np.asarray(state.phase), t=np.asarray(state.t),
               step=np.asarray(state.step))
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("kind", ["cascade", "lod"])
@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
def test_port_files_load_in_jax(tmp_path, kind, real):
    cfgs, st = _port_state(kind, real)
    periods = [4, 2, 1] if kind == "lod" else None
    path = checkpoint.save_cascade_checkpoint(str(tmp_path / "c"), st, cfgs,
                                              periods=periods)
    assert path.endswith(".npz")
    host = cascade_state_to_numpy(st)
    for want_real in (False, True):
        got, got_cfgs = jckpt.load_cascade_checkpoint(path,
                                                      real_state=want_real)
        assert isinstance(got, jlod.LODState) == (kind == "lod")
        _assert_same(got, host)
        assert got_cfgs == jax_cfgs(cfgs)
    assert jckpt.cascade_checkpoint_periods(path) == periods
    with pytest.raises(ValueError, match="multi-band.*load_cascade"):
        jckpt.load_checkpoint(path)


@pytest.mark.parametrize("kind", ["cascade", "lod"])
@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
def test_jax_files_load_in_the_port(tmp_path, kind, real):
    cfgs = bands()
    kw = REAL if real else {}
    if kind == "lod":
        solver = jlod.LODCascadeSolver(jax_cfgs(cfgs), periods=[2, 1, 1],
                                       **kw)
        st = solver.init(jax.random.PRNGKey(2))
        st, _ = solver.step(st)
    else:
        solver = JaxCascade(jax_cfgs(cfgs), **kw)
        st, _ = solver.step(solver.init(jax.random.PRNGKey(2)), DT)
    path = str(tmp_path / "c.npz")
    jckpt.save_cascade_checkpoint(path, st, jax_cfgs(cfgs),
                                  periods=[2, 1, 1] if kind == "lod" else None)
    for want_real in (False, True):
        got, got_cfgs = checkpoint.load_cascade_checkpoint(
            path, real_state=want_real, device="cpu")
        cst = got.cascade if kind == "lod" else got
        assert isinstance(cst, CascadeStateReal if want_real
                          else CascadeState)
        assert cst.step.dtype == torch.int32 and isinstance(
            getattr(got, "frame", 0), int)
        _assert_same(cascade_state_to_numpy(got), st)
        assert got_cfgs == cfgs
    assert checkpoint.cascade_checkpoint_periods(path) == (
        [2, 1, 1] if kind == "lod" else None)
    with pytest.raises(ValueError, match="multi-band.*load_cascade"):
        checkpoint.load_checkpoint(path, device="cpu")


def test_single_patch_file_refused_by_the_cascade_loader(tmp_path):
    from tpu_ocean_torch import OCEAN_DEMO, OceanSolver
    cfg = OCEAN_DEMO.replace(resolution=32)
    path = checkpoint.save_checkpoint(
        str(tmp_path / "one"), OceanSolver(cfg, device="cpu").init(), cfg)
    for load in (checkpoint.load_cascade_checkpoint,
                 jckpt.load_cascade_checkpoint):
        with pytest.raises(ValueError, match="single-patch.*load_checkpoint"):
            load(path)
    assert checkpoint.cascade_checkpoint_periods(path) is None


# ------------------------------------------------------- CascadeSimulation

def test_run_loop_metrics_and_export(tmp_path):
    stream = io.StringIO()
    with CascadeSimulation(bands(), out_dir=str(tmp_path), export_every=2,
                           metrics_stream=stream, device="cpu") as sim:
        f = sim.run(4)
        assert sim.step_count == 4 and torch.isfinite(f.height).all()
        assert sim.world_length == 100.0
        steps = [json.loads(line)["step"]
                 for line in stream.getvalue().splitlines()]
        assert steps == [1, 2, 3, 4]
        assert sim._exporter.errors() == 0
        for name in ("height", "foam"):
            got = np.load(tmp_path / "fields" / f"{name}_00000004.npy")
            np.testing.assert_array_equal(
                got, getattr(f, name).numpy().astype(np.float64))


@pytest.mark.parametrize("lod", [False, True], ids=["plain", "lod"])
@pytest.mark.parametrize("kw", [{}, REAL], ids=["complex", "real"])
def test_resume_continues_bit_for_bit(tmp_path, lod, kw):
    cfgs = bands()
    sched = dict(periods=[4, 2, 1]) if lod else {}
    out = str(tmp_path / "run")
    sim1 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=3,
                             device="cpu", **sched, **kw)
    sim1.run(6)
    sim1.close()
    sim2 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=3,
                             device="cpu", **sched, **kw)
    assert sim2.step_count == 6
    assert isinstance(sim2.state, LODState) == lod
    whole = CascadeSimulation(cfgs, device="cpu", **sched, **kw)
    want = whole.run(10)
    got = sim2.run(4)
    sim2.close()
    # the same state and the same ops in the same process
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    if lod:
        assert sim2.state.frame == whole.state.frame == 10


def test_resume_of_a_jax_run_matches_jax(tmp_path):
    """The JAX CascadeSimulation writes an LOD run (the production
    switches at 64²); the port resumes it, and both step 4 more frames."""
    cfgs = bands(n=64)
    kw = dict(fft_backend="pallas", real_state=True, pack_channels=True,
              half_spectrum=True, pallas_fields=True, periods=[4, 2, 1])
    out = str(tmp_path / "run")
    ref = JaxCascadeSimulation(jax_cfgs(cfgs), out_dir=out,
                               checkpoint_every=3,
                               seed_key=jax.random.PRNGKey(5), **kw)
    ref.run(6)
    ref.close()
    port = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=100,
                             device="cpu", **kw)
    assert port.step_count == 6
    ref = JaxCascadeSimulation(jax_cfgs(cfgs), out_dir=out,
                               checkpoint_every=100, **kw)
    for _ in range(4):
        jf, tf = ref.step(), port.step()
    assert_fields_match(tf, jf, combined_cfg(port.solver.inner))
    assert_states_match(port.state.cascade, ref.state.cascade)
    assert port.state.frame == ref.state.frame == 10


def _refusals():
    cfgs = bands()
    spectral = [c.replace(normals_mode="spectral") for c in cfgs]
    return {
        # (first run, resume, the error the resume raises)
        "configs": (dict(cfgs=cfgs),
                    dict(cfgs=[c.replace(choppiness=0.9) for c in cfgs]),
                    "different band configs"),
        "kind_lod_on_plain": (dict(cfgs=cfgs),
                              dict(cfgs=cfgs, periods=[2, 1, 1]),
                              "checkpoint kind"),
        "kind_plain_on_lod": (dict(cfgs=cfgs, periods=[2, 1, 1]),
                              dict(cfgs=cfgs), "checkpoint kind"),
        "schedule": (dict(cfgs=cfgs, periods=[4, 2, 1]),
                     dict(cfgs=cfgs, periods=[4, 4, 1]), "LOD schedule"),
        "planes": (dict(cfgs=cfgs, periods=[2, 1, 1]),
                   dict(cfgs=spectral, periods=[2, 1, 1]), "caches 3 planes"),
    }


@pytest.mark.parametrize("name", list(_refusals()))
def test_resume_refusals_match_jax(tmp_path, name):
    first, again, message = _refusals()[name]
    for package in ("port", "jax"):
        out = str(tmp_path / package)
        if package == "port":
            sim = CascadeSimulation(first["cfgs"], out_dir=out,
                                    checkpoint_every=2, device="cpu",
                                    periods=first.get("periods"))
        else:
            sim = JaxCascadeSimulation(jax_cfgs(first["cfgs"]), out_dir=out,
                                       checkpoint_every=2,
                                       periods=first.get("periods"))
        sim.run(2)
        sim.close()
    if name == "planes":
        # JAX refuses the other configs first; the planes check needs the
        # configs to match, so drop them from the file as a pre-config
        # writer would have
        for package in ("port", "jax"):
            path = tmp_path / package / "ckpt" / "state_0000000002.npz"
            z = dict(np.load(path))
            del z["configs_json"]
            np.savez(path, **z)
    with pytest.raises(ValueError, match=message) as got:
        CascadeSimulation(again["cfgs"], out_dir=str(tmp_path / "port"),
                          checkpoint_every=2, device="cpu",
                          periods=again.get("periods"))
    with pytest.raises(ValueError) as want:
        JaxCascadeSimulation(jax_cfgs(again["cfgs"]),
                             out_dir=str(tmp_path / "jax"),
                             checkpoint_every=2,
                             periods=again.get("periods"))
    assert (str(got.value).replace(str(tmp_path / "port"), "D")
            == str(want.value).replace(str(tmp_path / "jax"), "D"))


def test_extra_cached_planes_are_cut(tmp_path):
    """A cache of 5 planes a band resumed by a stencil solver keeps the
    leading 3 (the live ones), as JAX does."""
    cfgs = bands()
    spectral = [c.replace(normals_mode="spectral") for c in cfgs]
    out = str(tmp_path / "run")
    sim = CascadeSimulation(spectral, out_dir=out, checkpoint_every=2,
                            periods=[2, 1, 1], device="cpu")
    sim.run(2)
    planes = sim.state.planes.clone()
    sim.close()
    path = tmp_path / "run" / "ckpt" / "state_0000000002.npz"
    z = dict(np.load(path))
    del z["configs_json"]
    np.savez(path, **z)
    resumed = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2,
                                periods=[2, 1, 1], device="cpu")
    assert torch.equal(resumed.state.planes, planes[:, :3])
    assert resumed.step_count == 2
    resumed.step()


@pytest.mark.parametrize("lod", [False, True], ids=["plain", "lod"])
def test_reconfigure_live(lod):
    cfgs = bands()
    sim = CascadeSimulation(cfgs, device="cpu",
                            **(dict(periods=[4, 2, 1]) if lod else {}))
    sim.run(3)
    before = sim.state
    old = sim.solver
    new_cfgs = [c.replace(wind=(3.0, 9.0)) for c in cfgs]
    sim.reconfigure(new_cfgs)
    assert sim.step_count == 3 and sim.cfgs == new_cfgs
    after = sim.state
    if lod:
        assert after.frame == before.frame
        assert sim.solver._substeps is old._substeps
        before, after = before.cascade, after.cascade
        inner_old, inner_new = old.inner, sim.solver.inner
    else:
        inner_old, inner_new = old, sim.solver
    assert torch.equal(after.phase, before.phase)
    assert inner_new._coeffs is inner_old._coeffs
    assert torch.isfinite(sim.step().height).all()
    # a new N restarts the count (JAX's rule, kept for parity)
    sim.reconfigure([c.replace(resolution=64) for c in new_cfgs])
    assert sim.step_count == 0


@pytest.mark.parametrize("lod", [False, True], ids=["plain", "lod"])
def test_restart_after_a_resolution_change_resumes_the_new_config(tmp_path,
                                                                  lod):
    """CascadeSimulation.reconfigure to a new N clears the checkpoints with
    the step count, so a restart resumes the new bands' own file (ROADMAP
    Queue 3; the JAX package keeps the old files, which outrank the new
    ones by step)."""
    out = str(tmp_path / "run")
    kw = dict(out_dir=str(out), checkpoint_every=2, device="cpu",
              **(dict(periods=[4, 2, 1]) if lod else {}))
    new_cfgs = [c.replace(resolution=16) for c in bands()]
    with CascadeSimulation(bands(), **kw) as sim:
        sim.run(6)
        sim.reconfigure(new_cfgs)
        sim.run(2)
        want = sim.state
    with CascadeSimulation(new_cfgs, **kw) as again:
        assert again.step_count == 2 and again.cfgs == new_cfgs
        _assert_same(again.state, want)
        again.step()
