"""tpu_ocean_torch.checkpoint on the CPU: the twins of
tests/test_checkpoint.py's npz tests, and checkpoints across packages.

- Save and load round-trip bit for bit, a resume continues the trajectory
  bit for bit, the manager keeps its interval and retention, a real-state
  Simulation resumes into the real state, and a file written from one
  state loads into the other.
- The file is the JAX package's: the same keys, dtypes and shapes, and
  for one state the same arrays bit for bit.
- Across packages: a JAX Simulation runs 6 steps with checkpoints every
  2; the port's Simulation resumes the directory at step 6, and so does a
  JAX one; after 2 more steps the two agree within the bands of
  tests/test_torch_complex_backends.py (1e-5·max, a stencil normal's 2e-4
  and the foam's 25·1e-5·max widened by the first-order effect of the
  measured input differences). Then the port writes and JAX resumes;
  real-state files into complex solvers and back; a version-1 file (no
  foam_accum) loads zeros in both."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg
from tpu_ocean.checkpoint import load_checkpoint as jax_load
from tpu_ocean.checkpoint import save_checkpoint as jax_save
from tpu_ocean.runtime import Simulation as JaxSimulation
from tpu_ocean_torch import (OceanConfig, OceanSolver, OceanStateReal,
                             Simulation, CheckpointManager, load_checkpoint,
                             save_checkpoint, state_from_numpy)
from tests.test_torch_complex_backends import assert_fields_match

DT = 1.0 / 60.0


def _cfg(**kw):
    base = dict(resolution=32, length=32.0, wind=(6.0, 4.0), amplitude=0.05,
                evolution_mode="phase", dispersion_mode="capillary",
                spectrum_layout="fft", normals_mode="stencil")
    base.update(kw)
    return OceanConfig(**base)


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _assert_states_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


# -------------------------------------------- tests/test_checkpoint.py twins

@pytest.mark.parametrize("real", [False, True])
def test_save_load_roundtrip(tmp_path, real):
    cfg = _cfg()
    kw = dict(fft_backend="pallas", real_state=True) if real else {}
    solver = OceanSolver(cfg, device="cpu", **kw)
    state = solver.init(torch.Generator().manual_seed(3))
    for _ in range(5):
        state, _ = solver.step(state, DT)
    p = str(tmp_path / "ckpt")
    assert save_checkpoint(p, state, cfg) == p + ".npz"
    restored, cfg2 = load_checkpoint(p, real_state=real, device="cpu")
    assert cfg2 == cfg
    for a, b in zip(state, restored):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resume_is_bitwise_continuing(tmp_path):
    cfg = _cfg()
    solver = OceanSolver(cfg, device="cpu")
    state = solver.init(torch.Generator().manual_seed(3))
    for _ in range(3):
        state, _ = solver.step(state, DT)
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, state, cfg)
    cont = state
    for _ in range(4):
        cont, f_direct = solver.step(cont, DT)
    restored, _ = load_checkpoint(p, device="cpu")
    for _ in range(4):
        restored, f_resumed = solver.step(restored, DT)
    assert torch.equal(f_direct.height, f_resumed.height)
    assert torch.equal(cont.phase, restored.phase)


def test_manager_interval_and_retention(tmp_path):
    cfg = _cfg()
    solver = OceanSolver(cfg, device="cpu")
    state = solver.init()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), interval=2, keep=2,
                            load_fn=lambda p: load_checkpoint(p, device="cpu"))
    saved = []
    for _ in range(9):
        state, _ = solver.step(state, DT)
        p = mgr.maybe_save(state, cfg)
        if p:
            saved.append(p)
    assert len(saved) == 4          # steps 2, 4, 6, 8
    assert mgr.latest().endswith("state_0000000008.npz")
    assert sorted(os.listdir(tmp_path / "ckpts")) == [
        "state_0000000006.npz", "state_0000000008.npz"]
    st, _ = mgr.restore_latest()
    assert int(st.step) == 8


def test_real_state_simulation_checkpoint_resume(tmp_path):
    """A real-state Simulation resumes into the real state and continues
    bit for bit."""
    cfg = _cfg(wind=(8.0, 5.0), amplitude=0.4)
    kw = dict(fft_backend="pallas", real_state=True, pack_channels=True,
              device="cpu")
    out = str(tmp_path / "run")
    sim1 = Simulation(cfg, out_dir=out, checkpoint_every=2, **kw)
    sim1.run(2)
    sim1.close()
    ref = Simulation(cfg, **kw)
    f_ref = ref.run(4)
    sim2 = Simulation(cfg, out_dir=out, checkpoint_every=2, **kw)
    assert isinstance(sim2.state, OceanStateReal) and sim2.step_count == 2
    f2 = sim2.run(2)
    sim2.close()
    assert torch.equal(f2.height, f_ref.height)


def test_checkpoint_cross_representation_round_trip(tmp_path):
    cfg = _cfg(wind=(8.0, 5.0), amplitude=0.4)
    real = OceanSolver(cfg, fft_backend="pallas", real_state=True, device="cpu")
    sr = real.init(torch.Generator().manual_seed(6))
    p = str(tmp_path / "real_ckpt")
    save_checkpoint(p, sr, cfg)
    sc, cfg2 = load_checkpoint(p, device="cpu")          # complex view
    assert cfg2 == cfg and sc.h0.dtype == torch.complex64
    assert torch.equal(sc.h0.real, sr.h0_re)
    assert torch.equal(sc.h0_conj.imag, sr.h0c_im)
    sr2, _ = load_checkpoint(p, real_state=True, device="cpu")
    assert isinstance(sr2, OceanStateReal) and torch.equal(sr2.h0_im, sr.h0_im)


def test_loader_refuses_a_cascade_checkpoint(tmp_path):
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.checkpoint import save_cascade_checkpoint
    cfgs = default_cascade(n=16)
    p = str(tmp_path / "casc.npz")
    save_cascade_checkpoint(p, CascadeSolver(cfgs).init(), cfgs)
    with pytest.raises(ValueError, match="multi-band"):
        load_checkpoint(p, device="cpu")


def test_a_newer_version_is_refused(tmp_path):
    cfg = _cfg()
    p = save_checkpoint(str(tmp_path / "c"), OceanSolver(cfg, device="cpu").init())
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    payload["version"] = np.int64(3)
    np.savez(p, **payload)
    with pytest.raises(ValueError, match="newer"):
        load_checkpoint(p, device="cpu")


# ------------------------------------------------------ across the packages

@pytest.mark.parametrize("real", [False, True])
def test_file_format_is_the_jax_format(tmp_path, real):
    """One state written by both packages: the same keys, and every array
    bit-equal with the same dtype and shape."""
    cfg = _cfg()
    kw = dict(fft_backend="pallas", real_state=True) if real else {}
    solver = OceanSolver(cfg, device="cpu", **kw)
    state = solver.step(solver.init(), DT)[0]
    mine = save_checkpoint(str(tmp_path / "port"), state, cfg)
    theirs = str(tmp_path / "jax.npz")
    jax_save(theirs, jax_load(mine, real_state=real)[0], _jax_cfg(cfg))
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


#: (writer, reader's state): the JAX package's ``reference`` complex run and
#: its real-state ``pallas`` packed run; each is resumed by both packages
#: into the writer's state kind and into the other kind
CROSS = {"reference": dict(fft_backend="reference"),
         "real": dict(fft_backend="pallas", real_state=True,
                      pack_channels=True)}


def _resume_both(d, cfg, kw_port, kw_jax, steps=2):
    """The port's and JAX's Simulation resuming copies of run directory
    ``d``, then ``steps`` steps each: (port sim, port fields, JAX sim, JAX
    fields)."""
    dp, dj = d + "_port", d + "_jax"
    shutil.copytree(d, dp)
    shutil.copytree(d, dj)
    port = Simulation(cfg, out_dir=dp, checkpoint_every=2, device="cpu",
                      **kw_port)
    ref = JaxSimulation(_jax_cfg(cfg), out_dir=dj, checkpoint_every=2,
                        **kw_jax)
    assert port.step_count == ref.step_count
    resumed = port.state
    for _ in range(steps):
        tf, jf = port.step(), ref.step()
    return port, tf, ref, jf, resumed


@pytest.mark.parametrize("reader", list(CROSS))
@pytest.mark.parametrize("writer", list(CROSS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, writer, reader):
    cfg = _cfg(amplitude=0.3)
    d = str(tmp_path / "run")
    with JaxSimulation(_jax_cfg(cfg), out_dir=d, checkpoint_every=2,
                       **CROSS[writer]) as sim:
        sim.run(6)
    port, tf, ref, jf, resumed = _resume_both(d, cfg, CROSS[reader],
                                              CROSS[reader])
    assert port.step_count == 8 and int(port.state.step) == 8
    assert isinstance(resumed, OceanStateReal) == (reader == "real")
    assert_fields_match(tf, jf, cfg)


@pytest.mark.parametrize("reader", list(CROSS))
@pytest.mark.parametrize("writer", list(CROSS))
def test_port_checkpoint_resumes_in_jax(tmp_path, writer, reader):
    cfg = _cfg(amplitude=0.3)
    d = str(tmp_path / "run")
    with Simulation(cfg, out_dir=d, checkpoint_every=2, device="cpu",
                    **CROSS[writer]) as sim:
        sim.run(6)
        last = sim.state
    port, tf, ref, jf, _ = _resume_both(d, cfg, CROSS[reader], CROSS[reader])
    assert ref.step_count == 8
    # the JAX reader restored the port's state (symmetrized where packed)
    restored = jax_load(os.path.join(d, "ckpt", "state_0000000006.npz"),
                        real_state=reader == "real")[0]
    if writer == reader:
        _assert_states_equal(state_from_numpy(restored, "cpu"), last)
    assert_fields_match(tf, jf, cfg)


def test_version_1_file_loads_zero_foam_in_both(tmp_path):
    """A file from before foam accumulation: version 1, no foam_accum."""
    cfg = _cfg(foam_decay=0.5)
    solver = OceanSolver(cfg, device="cpu")
    state = solver.init()
    for _ in range(3):
        state, _ = solver.step(state, DT)
    assert state.foam_accum.any()
    p = save_checkpoint(str(tmp_path / "v1"), state, cfg)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files if k != "foam_accum"}
    payload["version"] = np.int64(1)
    np.savez(p, **payload)
    mine, _ = load_checkpoint(p, device="cpu")
    theirs, _ = jax_load(p)
    assert not mine.foam_accum.any() and mine.foam_accum.shape == (32, 32)
    _assert_states_equal(mine, state_from_numpy(theirs, "cpu"))
    real, _ = load_checkpoint(p, real_state=True, device="cpu")
    assert not real.foam_accum.any()
