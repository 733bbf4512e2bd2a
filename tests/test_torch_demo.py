"""The port's demo CLI (``python -m tpu_ocean_torch``) on the CPU against
the JAX package's (``tpu_ocean.demo``):

- ``ocean`` at --res 32 (checkpoints, dumps, mesh, clipmap) and
  ``ocean --production --res 64``: torch cannot replay jax.random, so one
  numpy h0 pair is injected into both packages' ``OceanSolver.init`` with
  monkeypatch; both write the same files, and the final fields' .npy files
  agree within tests/test_torch_solver.py's bands (tests/test_packing.py:
  1e-5·max, normals 2e-4, foam 25×); the checkpoints hold the same state
  within the same bands; the render is viz.shade_ocean of the saved fields;
- ``fftmesh``: rc 0, its printed oracle-vs-solver error within 1e-6 of
  JAX's (both draw the oracle's h0 from numpy's default_rng);
- ``pond --waves 8``, with and without ``--pallas`` (the wave-bank
  kernel's plain version here, Pallas in interpret mode in JAX): the same
  bank from the same seed, the .npy files within atol 2e-5, rtol 1e-5;
- ``cascade`` at --res 32 (the complex state on ``reference``, with and
  without ``--camera``) and ``cascade --production --camera 3000 --res
  64`` (the LOD schedule on the production switches): one numpy [B, N, N]
  h0 pair injected into both packages' ``CascadeSolver.init`` (hermitized
  by each solver's own symmetrize where it packs); the same files and the
  same printed LOD schedule, the final fields within the cascade parity
  bands (tests/test_torch_cascade.py), the render the shading of the
  saved fields;
- ``serve --device cpu`` streams two frames to a client, bit-equal to a
  Simulation of the same config and seed; the default device of
  ``ocean`` and ``serve`` is the card, with no fallback;
- ``python -m tpu_ocean_torch --help`` lists the five subcommands."""

import os
import re
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean import cascade as jcascade, demo as jdemo, solver as jsolver
from tpu_ocean_torch import (OCEAN_DEMO, _png, cascade as tcascade, demo,
                             solver as tsolver, viz)
from tpu_ocean_torch.solver import OceanFields
from tests.test_packing import _assert_fields_close
from tests.test_torch_cascade import jax_cfgs
from tests.test_torch_complex_backends import assert_fields_match
from tests.test_torch_solver import _h0_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POND_TOL = dict(atol=2e-5, rtol=1e-5)


def _inject(monkeypatch, h0, h0c):
    """Every OceanSolver.init of both packages takes (h0, h0c)."""
    for cls in (jsolver.OceanSolver, tsolver.OceanSolver):
        original = cls.init

        def init(self, *args, _original=original, **kw):
            return _original(self, h0=h0, h0_conj=h0c)
        monkeypatch.setattr(cls, "init", init)


def _run_both(tmp_path, argv):
    """Run the port's CLI (on the CPU) and JAX's with the same arguments;
    return the two output directories."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert demo.main(argv + ["--out", str(port), "--device", "cpu"]) == 0
    assert jdemo.main(argv + ["--out", str(ref)]) == 0
    return port, ref


def _files(d):
    return sorted(os.path.relpath(os.path.join(root, f), d)
                  for root, _, files in os.walk(d) for f in files)


def _fields(d, prefix, step):
    return OceanFields(*(np.load(d / f"{prefix}_{name}_{step:06d}.npy")
                         for name in OceanFields._fields))


@pytest.mark.parametrize("argv,n", [
    (["ocean", "--res", "32", "--steps", "4", "--checkpoint-every", "2",
      "--dump-every", "2", "--save-mesh", "--save-clipmap"], 32),
    (["ocean", "--production", "--res", "64", "--steps", "3",
      "--checkpoint-every", "3"], 64),
], ids=["reference_32", "production_64"])
def test_ocean_cli_matches_jax(tmp_path, monkeypatch, argv, n):
    cfg = OCEAN_DEMO.replace(resolution=n, length=float(n))
    _inject(monkeypatch, *_h0_pair(cfg, seed=n))
    port, ref = _run_both(tmp_path, argv)
    assert _files(port) == _files(ref)
    steps = int(argv[argv.index("--steps") + 1])
    got, want = _fields(port, "ocean", steps), _fields(ref, "ocean", steps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    _assert_fields_close(got, want, 1e-5)
    # the render is the shading of the saved fields
    np.testing.assert_array_equal(
        _png.read_png(str(port / "ocean_render.png")),
        (viz.shade_ocean(got) * 255).astype(np.uint8))
    for name in _files(port):
        if name.startswith("ckpt"):
            a, b = np.load(port / name), np.load(ref / name)
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                if key == "phase":      # an FMA in the jitted step: ≤ 1 ulp
                    d = np.abs(a[key] - b[key])
                    assert np.minimum(d, 2 * np.pi - d).max() < 1e-5
                else:
                    np.testing.assert_array_equal(a[key], b[key], key)
        elif name.endswith(".obj"):
            a = (port / name).read_text().splitlines()
            b = (ref / name).read_text().splitlines()
            assert len(a) == len(b) and a[0] == b[0]
            assert [x for x in a if x[:2] == "f "] == [x for x in b
                                                       if x[:2] == "f "]
            va = np.array([x.split()[1:] for x in a if x[:2] == "v "], float)
            vb = np.array([x.split()[1:] for x in b if x[:2] == "v "], float)
            np.testing.assert_allclose(va, vb, atol=2e-5 * np.abs(vb).max())


def _error(text):
    return float(re.search(r"max rel height error at t=[\d.]+: (\S+)",
                           text).group(1))


@pytest.mark.parametrize("steps", ["10", "45"])
def test_fftmesh_cli_error_matches_jax(tmp_path, capsys, steps):
    argv = ["fftmesh", "--steps", steps]
    assert demo.main(argv + ["--out", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    got = _error(capsys.readouterr().err)
    assert jdemo.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    want = _error(capsys.readouterr().err)
    assert got < 1e-3 and abs(got - want) <= 1e-6
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_pond_cli_matches_jax(tmp_path, pallas):
    argv = ["pond", "--res", "32", "--steps", "3", "--waves", "8",
            "--seed", "5"] + (["--pallas"] if pallas else [])
    port, ref = _run_both(tmp_path, argv)
    assert _files(port) == _files(ref)
    for name in ("offset_x", "offset_y", "offset_z", "normal"):
        np.testing.assert_allclose(np.load(port / f"pond_{name}_000003.npy"),
                                   np.load(ref / f"pond_{name}_000003.npy"),
                                   **POND_TOL, err_msg=name)
    for name in ("pond_render.png", "pond_render_cubemap.png",
                 "pond_render_realtime.png"):
        assert _png.read_png(str(port / name)).shape == (32, 32, 3)


def _inject_cascade(monkeypatch, h0, h0c):
    """Every CascadeSolver.init of both packages starts from the [B, N, N]
    pair (h0, h0c), projected by the solver's own symmetrize."""
    original = jcascade.CascadeSolver.init

    def jax_init(self, key=None):
        st = original(self, key)
        if self.real_state:
            st = st._replace(
                h0_re=jnp.asarray(h0.real, jnp.float32),
                h0_im=jnp.asarray(h0.imag, jnp.float32),
                h0c_re=jnp.asarray(h0c.real, jnp.float32),
                h0c_im=jnp.asarray(h0c.imag, jnp.float32))
        else:
            st = st._replace(h0=jnp.asarray(h0, jnp.complex64),
                             h0_conj=jnp.asarray(h0c, jnp.complex64))
        return self.symmetrize(st)

    port_init = tcascade.CascadeSolver.init

    def torch_init(self, *args, **kw):
        return port_init(self, h0=h0, h0_conj=h0c)

    monkeypatch.setattr(jcascade.CascadeSolver, "init", jax_init)
    monkeypatch.setattr(tcascade.CascadeSolver, "init", torch_init)


@pytest.mark.parametrize("argv,n", [
    (["cascade", "--res", "32", "--steps", "3", "--dump-every", "3"], 32),
    (["cascade", "--res", "32", "--steps", "3", "--pack", "--camera",
      "300"], 32),
    (["cascade", "--production", "--res", "64", "--steps", "4", "--camera",
      "3000", "--dump-every", "2"], 64),
], ids=["reference_32", "lod_packed_32", "production_lod_64"])
def test_cascade_cli_matches_jax(tmp_path, monkeypatch, capsys, argv, n):
    cfgs = tcascade.default_cascade(n=n)
    st = jcascade.CascadeSolver(jax_cfgs(cfgs)).init(jax.random.PRNGKey(n))
    _inject_cascade(monkeypatch, np.asarray(st.h0), np.asarray(st.h0_conj))
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert demo.main(argv + ["--out", str(port), "--device", "cpu"]) == 0
    port_err = capsys.readouterr().err
    assert jdemo.main(argv + ["--out", str(ref)]) == 0
    jax_err = capsys.readouterr().err
    if "--camera" in argv:
        schedule = [line for line in jax_err.splitlines()
                    if line.startswith("# LOD periods")]
        assert len(schedule) == 1 and schedule[0] in port_err.splitlines()
    assert _files(port) == _files(ref)
    steps = int(argv[argv.index("--steps") + 1])
    got, want = _fields(port, "cascade", steps), _fields(ref, "cascade", steps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    # the combined surface: effective displacements, the display texel
    assert_fields_match(OceanFields(*map(torch.from_numpy, got)), want,
                        cfgs[0].replace(choppiness=1.0, length=1000.0))
    np.testing.assert_array_equal(
        _png.read_png(str(port / "cascade_render.png")),
        (viz.shade_ocean(got) * 255).astype(np.uint8))


def test_serve_scene_serves_two_frames(tmp_path, monkeypatch, capsys):
    """``serve --device cpu`` binds the port it is given, prints the
    address in the JAX CLI's format and streams frames bit-equal to a
    Simulation of the same config and seed. FrameServer.run waits (bounded)
    for the test's client before it steps, as the JAX stream_client's pump
    does, and for the client's end after (stop() at the CLI's exit closes
    the streams at once, frames still queued or not)."""
    from tpu_ocean_torch import serve
    from tpu_ocean_torch.runtime import Simulation

    original = serve.FrameServer.run

    def run_with_the_client(self, steps=None):
        deadline = time.monotonic() + 60
        while self.client_count == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        original(self, steps)
        t.join(timeout=60)

    monkeypatch.setattr(serve.FrameServer, "run", run_with_the_client)
    with socket.socket() as probe:        # a free port to hand the CLI
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    frames, errs = [], []

    def client():
        deadline = time.monotonic() + 60
        while True:
            try:
                frames.extend(serve.stream_frames("127.0.0.1", port,
                                                  max_frames=2))
                return
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    errs.append("no server")
                    return
                time.sleep(0.01)
            except Exception as e:
                errs.append(e)
                return

    t = threading.Thread(target=client, daemon=True)
    t.start()
    argv = ["serve", "--res", "32", "--steps", "3", "--seed", "5",
            "--port", str(port), "--fields", "height,normal,foam",
            "--device", "cpu", "--out", str(tmp_path)]
    assert demo.main(argv) == 0
    t.join(timeout=60)
    assert not t.is_alive() and not errs, errs
    assert (f"# serving 32^2 [height,normal,foam] on 127.0.0.1:{port} "
            f"(3 steps)") in capsys.readouterr().err.splitlines()
    assert [m["step"] for m, _ in frames] == [1, 2]
    offline = Simulation(OCEAN_DEMO.replace(resolution=32, length=32.0),
                         fft_backend="reference",
                         generator=torch.Generator().manual_seed(5),
                         device="cpu")
    for meta, planes in frames:
        out = offline.step()
        assert meta["t"] == meta["step"] * offline.dt
        for name in ("height", "normal", "foam"):
            np.testing.assert_array_equal(planes[name],
                                          getattr(out, name).numpy())


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for cmd in ("ocean", "serve"):
        with pytest.raises((AssertionError, RuntimeError)):
            demo.main([cmd, "--res", "32", "--steps", "1",
                       "--out", str(tmp_path)])
    assert not any(f.endswith(".npy") for f in os.listdir(tmp_path))


def test_module_entry_point_help():
    out = subprocess.run([sys.executable, "-m", "tpu_ocean_torch", "--help"],
                         cwd=REPO, check=True, capture_output=True,
                         text=True).stdout
    assert out.startswith("usage: tpu_ocean_torch")
    for cmd in ("ocean", "fftmesh", "pond", "cascade", "serve"):
        assert cmd in out
