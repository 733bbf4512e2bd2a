"""tpu_ocean_torch.viz and its PNG writer against tpu_ocean/viz.py on the
same fields (JAX solver output, carried across as tensors):

- the built-in viridis table is matplotlib's, and ``_png.colormap`` gives
  matplotlib's bytes;
- ``_png`` files decode through PIL to the pixels written (RGB and RGBA,
  odd sizes), and ``_png.read_png`` reads them back;
- ``save_fields`` writes the JAX package's file names, the .npy files
  equal and the PNG pixels equal as PIL decodes both;
- ``shade_ocean`` and ``shade_pond`` (every reflection, with and without
  refraction) are bit-equal to JAX's, and so are the saved renders' pixels;
- ``save_mesh_obj`` and ``save_clipmap_obj`` write byte-equal text;
- with PIL and matplotlib unimportable, the port still writes every file,
  and a colormap other than viridis raises ImportError naming it."""

import dataclasses
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ocean import config as jcfg, viz as jviz
from tpu_ocean.gerstner import PondSolver as JaxPondSolver, WaveBank as JaxBank
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, POND_DEMO, OceanConfig, _png, viz)
from tpu_ocean_torch.gerstner import PondFields
from tpu_ocean_torch.solver import OceanFields


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _ocean(cfg, steps=2):
    """JAX fields after ``steps`` steps, and the same values as a port
    OceanFields of tensors."""
    solver = JaxSolver(_jax_cfg(cfg))
    state = solver.init()
    for _ in range(steps):
        state, fields = solver.step(state, 1.0 / 60.0)
    port = OceanFields(*(torch.from_numpy(np.array(f)) for f in fields))
    return fields, port


def _pond(n=24):
    cfg = jcfg.PondConfig(**{**dataclasses.asdict(POND_DEMO), "resolution": n})
    fields = JaxPondSolver(cfg, bank=JaxBank.random(0, 8)).fields(1.7)
    return fields, PondFields(*(torch.from_numpy(np.array(f)) for f in fields))


CENTERED = OceanConfig(resolution=16, length=16.0, wind=(8.0, 5.0),
                       amplitude=0.5)
FFT = OCEAN_DEMO.replace(resolution=20, length=20.0)


@pytest.fixture(scope="module")
def centered():
    return _ocean(CENTERED)


@pytest.fixture(scope="module")
def fft():
    return _ocean(FFT)


@pytest.fixture(scope="module")
def pond():
    return _pond()


def test_viridis_table_is_matplotlibs():
    cmap = matplotlib.colormaps["viridis"]
    assert cmap.N == len(_png.VIRIDIS) == 256
    np.testing.assert_array_equal(np.asarray(_png.VIRIDIS),
                                  np.asarray(cmap.colors))
    a = np.linspace(-0.25, 1.25, 4001)
    a[::97] = np.nan
    a = np.concatenate([a, [0.0, 1.0, 255 / 256, np.nextafter(1.0, 0.0)]])
    np.testing.assert_array_equal(_png.colormap(a),
                                  (cmap(a) * 255).astype(np.uint8))
    np.testing.assert_array_equal(_png.colormap(a, "magma"),
                                  (matplotlib.colormaps["magma"](a) * 255)
                                  .astype(np.uint8))


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (13, 7, 4),
                                   (33, 65, 4)])
def test_png_round_trips_through_pil(tmp_path, shape):
    px = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    path = _png.write_png(str(tmp_path / "sub" / "a.png"), px)
    with Image.open(path) as im:
        assert im.mode == {3: "RGB", 4: "RGBA"}[shape[2]]
        np.testing.assert_array_equal(np.asarray(im), px)
    np.testing.assert_array_equal(_png.read_png(path), px)


def test_png_rejects_other_inputs(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        _png.write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3)))
    with pytest.raises(ValueError, match="uint8"):
        _png.write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.uint8))
    path = str(tmp_path / "pil.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)       # grayscale
    with pytest.raises(ValueError, match="RGB"):
        _png.read_png(path)


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("which", ["centered", "fft", "pond"])
def test_save_fields_matches_jax(tmp_path, which, request):
    jf, tf = request.getfixturevalue(which)
    prefix = "pond" if which == "pond" else "ocean"
    got = viz.save_fields(str(tmp_path / "port"), tf, prefix=prefix, step=7)
    want = jviz.save_fields(str(tmp_path / "jax"), jf, prefix=prefix, step=7)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p)
                                                  for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for g, w in zip(got, want):
        if g.endswith(".npy"):
            a, b = np.load(g), np.load(w)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(_pil(g), _pil(w))
            assert _pil(g).shape[-1] == 4


def test_shade_ocean_bit_equal(tmp_path, fft, centered):
    for jf, tf in (fft, centered):
        np.testing.assert_array_equal(viz.shade_ocean(tf), jviz.shade_ocean(jf))
        kw = dict(light_dir=(0.2, 0.9, -0.1), base_color=(0.1, 0.3, 0.2),
                  specular_power=12.0)
        np.testing.assert_array_equal(viz.shade_ocean(tf, **kw),
                                      jviz.shade_ocean(jf, **kw))
    jf, tf = fft
    got = viz.save_render_png(str(tmp_path / "a.png"), tf)
    want = jviz.save_render_png(str(tmp_path / "b.png"), jf)
    np.testing.assert_array_equal(_pil(got), _pil(want))


POND_CASES = [dict(reflection=r, refraction=f)
              for r in ("procedural", "cubemap", "realtime")
              for f in (False, True)]


@pytest.mark.parametrize("kw", POND_CASES,
                         ids=[f"{c['reflection']}-{c['refraction']}"
                              for c in POND_CASES])
def test_shade_pond_bit_equal(tmp_path, pond, kw):
    jf, tf = pond
    np.testing.assert_array_equal(viz.shade_pond(tf, **kw),
                                  jviz.shade_pond(jf, **kw))
    got = viz.save_pond_render_png(str(tmp_path / "a.png"), tf, **kw)
    want = jviz.save_pond_render_png(str(tmp_path / "b.png"), jf, **kw)
    np.testing.assert_array_equal(_pil(got), _pil(want))


def test_shade_pond_assets_and_ocean_fields_bit_equal(pond, fft):
    jf, tf = pond
    n = tf.offset_y.shape[0]
    env = viz.procedural_sky_equirect(16, 32, sun_dir=(0.1, 0.9, 0.3))
    np.testing.assert_array_equal(
        env, jviz.procedural_sky_equirect(16, 32, sun_dir=(0.1, 0.9, 0.3)))
    scene = np.random.default_rng(0).random((n, n, 3))
    bottom = np.random.default_rng(1).random((n, n, 3))
    kw = dict(cubemap=env, cube_tint=(1.0, 0.5, 0.2), bottom=bottom,
              refraction=True, distortion=3.0)
    for reflection in ("cubemap", "realtime"):
        np.testing.assert_array_equal(
            viz.shade_pond(tf, reflection=reflection, scene=scene, **kw),
            jviz.shade_pond(jf, reflection=reflection, scene=scene, **kw))
    # an ocean frame through the pond shader (it reads height there)
    np.testing.assert_array_equal(viz.shade_pond(fft[1]),
                                  jviz.shade_pond(fft[0]))
    with pytest.raises(ValueError, match="reflection"):
        viz.shade_pond(tf, reflection="screenspace")


def _text(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [dict(), dict(display_scale=True),
                                dict(decimate=3), dict(decimate=5,
                                                       display_scale=True)])
def test_save_mesh_obj_byte_equal(tmp_path, centered, kw):
    jf, tf = centered
    got = viz.save_mesh_obj(str(tmp_path / "a.obj"), tf, CENTERED, **kw)
    want = jviz.save_mesh_obj(str(tmp_path / "b.obj"), jf,
                              _jax_cfg(CENTERED), **kw)
    assert _text(got) == _text(want)


@pytest.mark.parametrize("kw", [
    dict(), dict(camera=(3.0, -5.0), levels=2, fine_cells=4),
    dict(camera=(-7.5, 7.5), levels=3, fine_cells=4, display_scale=True)])
def test_save_clipmap_obj_byte_equal(tmp_path, fft, kw):
    jf, tf = fft
    got = viz.save_clipmap_obj(str(tmp_path / "a.obj"), tf, FFT, **kw)
    want = jviz.save_clipmap_obj(str(tmp_path / "b.obj"), jf, _jax_cfg(FFT),
                                 **kw)
    assert _text(got) == _text(want)
    m = viz.clipmap_mesh_arrays(tf, FFT, **kw)
    w = jviz.clipmap_mesh_arrays(jf, _jax_cfg(FFT), **kw)
    for key in w:
        np.testing.assert_array_equal(m[key], w[key])


def test_writes_without_pil_and_matplotlib(tmp_path, monkeypatch, fft, pond):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    jf, tf = fft
    written = viz.save_fields(str(tmp_path), tf, prefix="ocean", step=1)
    assert sum(p.endswith(".png") for p in written) == 7
    viz.save_render_png(str(tmp_path / "render.png"), tf)
    viz.save_mesh_obj(str(tmp_path / "mesh.obj"), tf, FFT)
    viz.save_clipmap_obj(str(tmp_path / "clip.obj"), tf, FFT, fine_cells=4)
    for kw in POND_CASES:
        viz.save_pond_render_png(str(tmp_path / "pond.png"), pond[1], **kw)
    for p in written:
        assert os.path.getsize(p) > 0
    np.testing.assert_array_equal(
        _png.read_png(str(tmp_path / "ocean_height_000001.png")),
        _png.colormap(viz._normalize01(tf.height.numpy().astype(np.float64))))
    with pytest.raises(ImportError, match="'magma'"):
        viz.save_field_png(str(tmp_path / "m.png"), tf.height, cmap="magma")
