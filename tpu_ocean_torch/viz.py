"""Field exporters — the replacement for the reference's surface shaders
(L4, SURVEY.md §2.2).

JAX counterpart: ``tpu_ocean/viz.py``, every public function with the same
arguments and outputs. The reference consumes solver outputs in
TestOcean.shader / the pond über-shader to draw pixels. Here the
prognostic fields themselves are the product; this module dumps them for
inspection: PNG heatmaps, .npy planes, OBJ meshes, and shaded renders that
reproduce the ocean demo material's look (wrapped diffuse + Blinn-Phong +
foam, TestOcean.shader:81-96) and the pond über-shader's, so visual parity
with the reference demos can be eyeballed.

The shading and geometry run on the host in float64 numpy, as the JAX
package's do; each field a function reads is copied from its device once
(``_to_host``). The PNGs go through ``_png``, which needs neither PIL nor
matplotlib, and carry the same pixels as the JAX package's files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpu_ocean_torch import _png
from tpu_ocean_torch.grids import coordinate_1d, coordinate_grid


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize01(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    if hi - lo < 1e-20:
        return np.zeros_like(a)
    return (a - lo) / (hi - lo)


def save_field_png(path: str, field, cmap: str = "viridis") -> str:
    """One scalar field [N, N] → RGBA PNG heatmap (viridis built in; any
    other ``cmap`` needs matplotlib, see _png.colormap)."""
    a = _normalize01(_to_host(field).astype(np.float64))
    return _png.write_png(path, _png.colormap(a, cmap))


def save_fields(directory: str, fields, prefix: str = "ocean",
                step: Optional[int] = None) -> list:
    """Dump every scalar plane of an OceanFields/PondFields tuple as PNG+npy."""
    os.makedirs(directory, exist_ok=True)
    tag = f"_{step:06d}" if step is not None else ""
    written = []
    for name, value in fields._asdict().items():
        a = _to_host(value)
        base = os.path.join(directory, f"{prefix}_{name}{tag}")
        np.save(base + ".npy", a)
        written.append(base + ".npy")
        if a.ndim == 2:
            written.append(save_field_png(base + ".png", a))
    return written


def shade_ocean(fields, light_dir=(0.5, 0.5, -0.7),
                base_color=(0.08, 0.22, 0.35), foam_color=(0.9, 0.95, 1.0),
                specular_power: float = 96.0) -> np.ndarray:
    """CPU re-implementation of the demo material's fragment stage
    (TestOcean.shader:81-96): wrapped diffuse + Blinn-Phong specular + rim +
    foam² blend. Returns float RGB [N, N, 3] in [0, 1]."""
    n = _to_host(fields.normal).astype(np.float64)
    foam = _to_host(fields.foam).astype(np.float64)
    l = -np.asarray(light_dir, dtype=np.float64)
    l /= np.linalg.norm(l)
    view = np.asarray([0.0, 1.0, 0.0])
    half = (l + view) / np.linalg.norm(l + view)

    ndotl = np.clip((n @ l) * 0.5 + 0.5, 0.0, 1.0)          # wrapped diffuse
    spec = np.clip(n @ half, 0.0, 1.0) ** specular_power
    rim = (1.0 - np.clip(n @ view, 0.0, 1.0)) ** 2

    base = np.asarray(base_color)
    fc = np.asarray(foam_color)
    rgb = base * ndotl[..., None] + spec[..., None] * 0.6 + rim[..., None] * 0.1
    f2 = np.clip(foam, 0.0, 1.0)[..., None] ** 2             # foam² :93
    rgb = rgb * (1.0 - f2) + fc * f2
    return np.clip(rgb, 0.0, 1.0)


def save_render_png(path: str, fields, **kw) -> str:
    """shade_ocean(fields, **kw) → RGB PNG."""
    rgb = (shade_ocean(fields, **kw) * 255).astype(np.uint8)
    return _png.write_png(path, rgb)


def procedural_sky_equirect(height: int = 32, width: int = 64,
                            sky_color=(0.65, 0.78, 0.9),
                            horizon_color=(0.85, 0.88, 0.9),
                            sun_dir=(0.4, 0.55, 0.2),
                            sun_color=(1.0, 0.96, 0.85)) -> np.ndarray:
    """A small equirectangular environment map [H, W, 3] — the asset-free
    default for shade_pond(reflection='cubemap'): vertical zenith→horizon
    gradient plus a soft sun disc, standing in for the demo material's
    _CubeMap texture (MistralWaterCommon.cginc:149-153)."""
    v = np.linspace(0.0, np.pi, height)               # polar angle (0=zenith)
    u = np.linspace(-np.pi, np.pi, width, endpoint=False)
    theta, phi = np.meshgrid(v, u, indexing="ij")
    d = np.stack([np.sin(theta) * np.sin(phi), np.cos(theta),
                  np.sin(theta) * np.cos(phi)], axis=-1)
    pitch = np.clip(d[..., 1], 0.0, 1.0)[..., None]
    img = (np.asarray(horizon_color) * (1 - pitch)
           + np.asarray(sky_color) * pitch)
    s = np.asarray(sun_dir, np.float64)
    s /= np.linalg.norm(s)
    sun = np.clip((d @ s), 0.0, 1.0) ** 64
    img = img + np.asarray(sun_color) * sun[..., None]
    return np.clip(img, 0.0, 1.0)


def sample_equirect(env: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Nearest sample of an equirect map [H, W, 3] along unit ``directions``
    [..., 3] — the CPU texCUBE (MistralWaterCommon.cginc:152)."""
    h, w = env.shape[:2]
    d = directions / np.maximum(
        np.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0))        # 0=zenith
    phi = np.arctan2(d[..., 0], d[..., 2])                  # [-π, π)
    i = np.clip((theta / np.pi) * (h - 1), 0, h - 1).astype(np.intp)
    j = ((phi + np.pi) / (2 * np.pi) * w).astype(np.intp) % w
    return env[i, j]


def procedural_scene_frame(n: int, sky_color=(0.65, 0.78, 0.9),
                           horizon_color=(0.85, 0.88, 0.9)) -> np.ndarray:
    """Asset-free default for shade_pond(reflection='realtime'): a stand-in
    for what the reference's reflection camera sees above the water — a
    zenith→horizon gradient with a sun disc and a dark 'dock' strip near
    the horizon edge (an asymmetric feature, so the mirroring is visible
    and testable). [N, N, 3] float RGB."""
    i = np.linspace(0.0, 1.0, n)[:, None]                    # 0 = far/zenith
    img = (np.asarray(sky_color)[None, None] * (1 - i[..., None])
           + np.asarray(horizon_color)[None, None] * i[..., None])
    jj = np.arange(n)[None, :]
    sun = np.exp(-(((i * n - 0.2 * n) ** 2 + (jj - 0.7 * n) ** 2)
                   / (0.003 * n * n + 1e-9)))
    img = img + np.asarray([1.0, 0.96, 0.8])[None, None] * sun[..., None]
    dock = (i > 0.9).astype(np.float64)                      # near edge
    img = img * (1 - 0.8 * dock[..., None])
    return np.clip(img, 0.0, 1.0)


def planar_reflection(scene: np.ndarray, normal: np.ndarray,
                      distortion: float = 8.0) -> np.ndarray:
    """The _REFLECTIONTYPE_REALTIME analogue (MistralWaterCommon.cginc:
    153-159): the reference renders the scene from a camera MIRRORED about
    the water plane into _ReflectionTex and samples it with projected,
    normal-perturbed UVs (tex2Dproj(_ReflectionTex, I.screenPos + bump)).
    Here the mirrored render is the ``scene`` frame flipped about the water
    line, and the projective UV perturbation is the surface normal's xz
    footprint in texels — the same distortion rule the GrabPass refraction
    stand-in uses, applied to the mirrored image instead of the bottom."""
    nn = normal.shape[0]
    mirrored = np.asarray(scene, np.float64)[::-1]   # reflection-camera flip
    off_i = np.rint(normal[..., 0] * distortion).astype(np.intp)
    off_j = np.rint(normal[..., 2] * distortion).astype(np.intp)
    ii, jj = np.meshgrid(np.arange(nn), np.arange(nn), indexing="ij")
    return mirrored[(ii + off_i) % nn, (jj + off_j) % nn]


def shade_pond(fields, water_color=(0.12, 0.35, 0.38),
               deep_color=(0.02, 0.08, 0.12), sky_color=(0.65, 0.78, 0.9),
               horizon_color=(0.85, 0.88, 0.9), depth: float = 3.0,
               foam_threshold: float = 0.92,
               reflection: str = "procedural",
               cubemap: Optional[np.ndarray] = None,
               cube_tint=(1.0, 1.0, 1.0),
               scene: Optional[np.ndarray] = None,
               refraction: bool = False,
               bottom: Optional[np.ndarray] = None,
               distortion: float = 8.0) -> np.ndarray:
    """CPU re-implementation of the pond über-shader's fragment stage
    (MistralWaterBasic.shader + MistralWaterCommon.cginc:73-213) — the
    keyword-matrix features rendered procedurally:

      * depth fog: view-depth tint lerp(water, deep) (cginc:128-142),
        depth proxied by surface height below rest level;
      * fresnel reflection, per the _REFLECTIONTYPE keyword pair
        (MistralWaterBasic.shader:89-92): ``reflection='procedural'`` is the
        analytic two-color sky blend; ``reflection='cubemap'`` samples an
        equirect environment map along reflect(-view, normal) with a tint —
        texCUBE(_CubeMap, worldReflect) * _CubeTint (cginc:149-153, 189-195);
        pass ``cubemap=[H, W, 3]`` or get procedural_sky_equirect();
        ``reflection='realtime'`` is the _REFLECTIONTYPE_REALTIME half:
        the ``scene`` frame (default procedural_scene_frame) mirrored about
        the water plane and sampled at normal-distorted projected texels —
        tex2Dproj(_ReflectionTex, screenPos + bump) (cginc:153-159);
      * ``refraction=True``: the GrabPass stand-in (cginc:98-142) — a
        ``bottom`` image (default: procedural sand checker) sampled at
        normal-DISTORTED texel coordinates (offset = normal.xz · distortion,
        the _Distortion screen-UV shift at cginc:98) and attenuated by the
        depth proxy, replacing the flat depth-fog base;
      * edge foam where the surface is near the rest level with high normal
        tilt — the shoreline-foam term (cginc:174-185).

    Returns float RGB [N, N, 3] in [0, 1].
    """
    if reflection not in ("procedural", "cubemap", "realtime"):
        raise ValueError(f"reflection must be 'procedural', 'cubemap', or "
                         f"'realtime', got {reflection!r}")
    n = _to_host(fields.normal).astype(np.float64)
    h = _to_host(fields.offset_y if hasattr(fields, "offset_y")
                 else fields.height).astype(np.float64)

    view = np.asarray([0.0, 1.0, 0.0])
    cos_v = np.clip(n @ view, 0.0, 1.0)

    # depth fog (deeper = darker): map height into [0,1] depth factor
    depth_f = np.clip(0.5 - h / (2.0 * max(depth, 1e-6)), 0.0, 1.0)
    water = np.asarray(water_color)
    deep = np.asarray(deep_color)
    if refraction:
        # normal-distorted bottom sample, depth-attenuated: the cheap
        # tex2Dproj(_GrabTexture, distorted UV) + lerp(shallow·refr, deep,
        # 1−refr.a) chain of cginc:111-142 with the solver's height as the
        # depth proxy
        nn = h.shape[0]
        if bottom is None:
            ii, jj = np.meshgrid(np.arange(nn), np.arange(nn), indexing="ij")
            checker = (((ii // 8) + (jj // 8)) % 2).astype(np.float64)
            bottom = (np.asarray([0.76, 0.7, 0.5])[None, None]
                      * (0.8 + 0.2 * checker)[..., None])   # sandy checker
        off_i = np.rint(n[..., 0] * distortion).astype(np.intp)
        off_j = np.rint(n[..., 2] * distortion).astype(np.intp)
        ii, jj = np.meshgrid(np.arange(nn), np.arange(nn), indexing="ij")
        refr = bottom[(ii + off_i) % nn, (jj + off_j) % nn]
        refr_a = (1.0 - depth_f)[..., None]        # saturate(_DepthAmount/Δz)
        base = water * refr * refr_a + deep * (1 - refr_a)
    else:
        base = water * (1 - depth_f[..., None]) + deep * depth_f[..., None]

    # fresnel (Schlick, F0=0.02) toward the selected reflection source
    f = 0.02 + 0.98 * (1.0 - cos_v) ** 5
    if reflection == "cubemap":
        env = cubemap if cubemap is not None else procedural_sky_equirect(
            sky_color=sky_color, horizon_color=horizon_color)
        # reflect(-view, normal) = 2(n·v)n − v (view is +y overhead)
        refl = 2.0 * cos_v[..., None] * n - view[None, None]
        sky = sample_equirect(np.asarray(env, np.float64), refl)
        sky = sky * np.asarray(cube_tint)[None, None]
    elif reflection == "realtime":
        if scene is None:
            scene = procedural_scene_frame(h.shape[0], sky_color=sky_color,
                                           horizon_color=horizon_color)
        sky = planar_reflection(scene, n, distortion)
    else:
        refl_pitch = np.clip(2 * cos_v * n[..., 1] - view[1], 0.0, 1.0)
        sky = (np.asarray(horizon_color)[None, None]
               * (1 - refl_pitch[..., None])
               + np.asarray(sky_color)[None, None] * refl_pitch[..., None])
    rgb = base * (1 - f[..., None]) + sky * f[..., None]

    # edge foam: high tilt near the rest level
    tilt = 1.0 - n[..., 1]
    edge = np.clip((tilt / (1 - foam_threshold + 1e-9))
                   * np.exp(-np.abs(h)), 0.0, 1.0)
    rgb = rgb * (1 - edge[..., None] * 0.6) + edge[..., None] * 0.6
    return np.clip(rgb, 0.0, 1.0)


def save_pond_render_png(path: str, fields, **kw) -> str:
    """shade_pond(fields, **kw) → RGB PNG."""
    rgb = (shade_pond(fields, **kw) * 255).astype(np.uint8)
    return _png.write_png(path, rgb)


def mesh_arrays(fields, cfg, display_scale: bool = False,
                decimate: int = 1):
    """Displaced display-mesh geometry as arrays — the reference's one
    output artifact with no other equivalent here (VERDICT r4 missing #1).

    Rebuilds the centered vertex grid (OceanRenderer.cs:172-207 /
    FFTMesh.cs:101-139: x_i = (i − N/2)·w, + w/2 for even N — the :183
    half-cell offset), displaces it by the solver fields, and emits the
    reference's exact triangulation — two triangles per interior quad with
    the :188-199 winding — plus uv = i/(N−1) and the per-vertex normals.

    ``display_scale=False`` (default) uses the FFTMesh.cs convention the
    fields already carry: vertex = (pos_x, height, pos_z), i.e. x0 −
    chop·disp (FFTMesh.cs:243-245). ``display_scale=True`` applies the GPU
    demo's ÷8 display convention instead (TestOcean.shader:65-66: y =
    height/8, xz += −chop·disp/8 — see docs/parity.md on the ÷8 ledger).

    ``decimate=d`` exports every d-th grid point (a 1024² frame is 1M
    vertices / 2M triangles of OBJ text otherwise). Returns a dict with
    ``vertices`` [M², 3] f32, ``uv`` [M², 2] f32, ``normals`` [M², 3] f32,
    ``faces`` [F, 3] i64 (0-based, reference winding).
    """
    h = _to_host(fields.height)
    n_grid = h.shape[0]
    d = max(1, int(decimate))
    sel = np.arange(0, n_grid, d)
    n = sel.size
    if n < 2:
        raise ValueError(f"decimate={d} leaves {n} vertices per side; "
                         f"need at least 2")
    sub = np.ix_(sel, sel)
    hh = h[sub]
    if display_scale:
        # GPU demo convention: the rest-grid vertex plus the ÷8-scaled
        # displacement (TestOcean.shader:65-66)
        x0, z0 = coordinate_grid(n_grid, getattr(cfg, "unit_width", 1.0))
        dx = _to_host(fields.disp_x)[sub]
        dz = _to_host(fields.disp_z)[sub]
        chop = getattr(cfg, "choppiness", 1.0)
        vx = x0[sub] - chop * dx / 8.0
        vy = hh / 8.0
        vz = z0[sub] - chop * dz / 8.0
    else:
        # FFTMesh convention: fields.pos_* ARE the displaced world
        # positions on the centered grid (x0 − chop·disp, FFTMesh.cs:245);
        # a decimated export is the same physical patch, sparser sampled
        vx = _to_host(fields.pos_x)[sub]
        vy = hh
        vz = _to_host(fields.pos_z)[sub]
    verts = np.stack([vx, vy, vz], axis=-1).reshape(-1, 3).astype(np.float32)
    nrm = _to_host(fields.normal)[np.ix_(sel, sel)]
    nrm = nrm.reshape(-1, 3).astype(np.float32)
    ii = np.broadcast_to(sel[:, None] / max(n_grid - 1, 1), (n, n))
    jj = np.broadcast_to(sel[None, :] / max(n_grid - 1, 1), (n, n))
    uv = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float32)
    # triangulation — OceanRenderer.cs:188-199 verbatim: for j < N−1,
    # i < N−1 → (idx, idx+1, idx+N); i > 0 → (idx, idx−N+1, idx+1)
    idx = np.arange(n * n, dtype=np.int64).reshape(n, n)
    a = idx[:-1, :-1]
    t1 = np.stack([a, a + 1, a + n], axis=-1).reshape(-1, 3)
    b = idx[1:, :-1]
    t2 = np.stack([b, b - n + 1, b + 1], axis=-1).reshape(-1, 3)
    faces = np.concatenate([t1, t2], axis=0)
    return {"vertices": verts, "uv": uv, "normals": nrm, "faces": faces}


def _write_obj(path: str, m: dict, header: str) -> str:
    """Wavefront OBJ serialization (v/vt/vn + f v/vt/vn) shared by the
    full-grid and clipmap exporters."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, m["vertices"], fmt="v %.6f %.6f %.6f")
        np.savetxt(f, m["uv"], fmt="vt %.6f %.6f")
        np.savetxt(f, m["normals"], fmt="vn %.6f %.6f %.6f")
        t = m["faces"] + 1               # OBJ is 1-based
        np.savetxt(f, np.column_stack([t[:, 0], t[:, 0], t[:, 0],
                                       t[:, 1], t[:, 1], t[:, 1],
                                       t[:, 2], t[:, 2], t[:, 2]]),
                   fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return path


def save_mesh_obj(path: str, fields, cfg, display_scale: bool = False,
                  decimate: int = 1) -> str:
    """Write one displaced frame as a Wavefront OBJ (v/vt/vn + f v/vt/vn),
    consumable by any DCC tool — see mesh_arrays for the geometry spec."""
    m = mesh_arrays(fields, cfg, display_scale=display_scale,
                    decimate=decimate)
    return _write_obj(path, m, "# tpu_ocean displaced ocean frame "
                               "(topology: OceanRenderer.cs:172-207)")


def _clipmap_index_mesh(n: int, center, h0: int, levels: int):
    """Index-space geometry of a camera-centered clipmap: concentric square
    rings, level k at pitch 2^k, stitched crack-free.

    Returns (ij [V, 2] int, faces [F, 3] int, (i0, j0, i1, j1)) — the
    covered square is [i0, i1] × [j0, j1]. Stitch cells (coarse cells whose edge touches the finer
    ring) are triangulated as a FAN around their center — a lattice point
    of the finer level — with the finer lattice's midpoints inserted on the
    shared edges, so every boundary edge of the fine side matches a fan
    sub-edge exactly: watertight by construction (pinned by the area and
    edge-incidence tests in tests/test_mesh_export.py).
    """
    if h0 % 4 or h0 < 4:
        raise ValueError(f"h0 must be a multiple of 4 and ≥ 4 (got {h0})")
    pl_ = 2 ** (levels - 1)
    cmax = (n - 1) - (n - 1) % pl_
    ci = min(max(int(round(center[0] / pl_)) * pl_, 0), cmax)
    cj = min(max(int(round(center[1] / pl_)) * pl_, 0), cmax)

    # boxes built OUTSIDE-IN, each snapped to the NEXT level's pitch (the
    # inner boundary must lie on the coarser lattice or the stitch cells
    # cannot align to it) and clamped INTO the already-snapped outer box —
    # grid-corner clamping would otherwise let an inner box poke past its
    # outer ring (caught by the watertightness area identity in tests)
    boxes = [None] * levels
    for k in range(levels - 1, -1, -1):
        p = 2 ** (k + 1) if k < levels - 1 else 2 ** k
        h = h0 * 2 ** k
        i0, j0 = max(0, ci - h), max(0, cj - h)
        i1, j1 = min(n - 1, ci + h), min(n - 1, cj + h)
        i0, j0 = i0 - i0 % p, j0 - j0 % p
        i1, j1 = i1 - i1 % p, j1 - j1 % p
        if k < levels - 1:
            oi0, oj0, oi1, oj1 = boxes[k + 1]
            i0, j0 = max(i0, oi0), max(j0, oj0)
            i1, j1 = min(i1, oi1), min(j1, oj1)
        boxes[k] = (i0, j0, i1, j1)

    vid = {}
    verts = []

    def v(i, j):
        key = (int(i), int(j))
        if key not in vid:
            vid[key] = len(verts)
            verts.append(key)
        return vid[key]

    faces = []

    def quad(i0, j0, p):
        # winding matches mesh_arrays' reference triangles (+y geometric
        # face normals — the clipmap wound the other way before r5 and
        # rendered backface-culled from above; review finding)
        a, b = v(i0, j0), v(i0 + p, j0)
        c, d = v(i0, j0 + p), v(i0 + p, j0 + p)
        faces.append((a, d, b))
        faces.append((a, c, d))

    def fan(i0, j0, p, inner):
        """Stitch cell: fan around the center lattice point, inserting the
        fine midpoint on any edge that lies ON the inner box boundary."""
        ii0, jj0, ii1, jj1 = inner
        h = p // 2
        # which of this OUTSIDE cell's edges lie on the inner box border
        # (edge contact only; diagonal corner contact needs no midpoint)
        x_span = ii0 <= i0 and i0 + p <= ii1
        y_span = jj0 <= j0 and j0 + p <= jj1
        on_bottom = j0 == jj1 and x_span          # cell above the box
        on_top = j0 + p == jj0 and x_span         # cell below the box
        on_left = i0 == ii1 and y_span            # cell right of the box
        on_right = i0 + p == ii0 and y_span       # cell left of the box
        loop = []

        def edge(a, b, on_inner):
            loop.append(a)
            if on_inner:
                loop.append(((a[0] + b[0]) // 2, (a[1] + b[1]) // 2))

        A, B = (i0, j0), (i0 + p, j0)
        C, D = (i0 + p, j0 + p), (i0, j0 + p)
        edge(A, B, on_bottom)
        edge(B, C, on_right)
        edge(C, D, on_top)
        edge(D, A, on_left)
        cidx = v(i0 + h, j0 + h)
        m = len(loop)
        for t in range(m):
            a, b = loop[t], loop[(t + 1) % m]
            faces.append((cidx, v(*b), v(*a)))   # +y winding, as quad()

    for k in range(levels):
        p = 2 ** k
        i0, j0, i1, j1 = boxes[k]
        inner = boxes[k - 1] if k else None
        for i in range(i0, i1, p):
            for j in range(j0, j1, p):
                if inner is not None:
                    ii0, jj0, ii1, jj1 = inner
                    if (ii0 <= i and i + p <= ii1
                            and jj0 <= j and j + p <= jj1):
                        continue          # covered by the finer level
                    touches = (((i + p == ii0 or i == ii1)
                                and jj0 <= j and j + p <= jj1)
                               or ((j + p == jj0 or j == jj1)
                                   and ii0 <= i and i + p <= ii1))
                    if touches:
                        fan(i, j, p, inner)
                        continue
                quad(i, j, p)

    ij = np.asarray(verts, np.int64)
    return ij, np.asarray(faces, np.int64), boxes[-1]


def clipmap_mesh_arrays(fields, cfg, camera=(0.0, 0.0), levels: int = 3,
                        fine_cells: int = 16, display_scale: bool = False):
    """Camera-adaptive displaced mesh: full resolution near ``camera``
    (world x, z), each concentric ring half the density — the GEOMETRIC
    analogue of the reference's distance tessellation
    (UnityEdgeLengthBasedTess, MistralWaterCommon.cginc:215-296 at edge
    length 31: triangle density falls off with camera distance), closing
    VERDICT r4 missing #2 with an actual multi-resolution artifact rather
    than the serving-divisor analogue alone. Crack-free by construction
    (see _clipmap_index_mesh). Returns the mesh_arrays dict + ``levels``.
    """
    h = _to_host(fields.height)
    n = h.shape[0]
    w = getattr(cfg, "unit_width", 1.0)
    coords = coordinate_1d(n, w)
    # world → index: invert x_i = (i − N/2)·w (+ w/2 even N)
    ci = int(np.clip(np.searchsorted(coords, camera[0]), 0, n - 1))
    cj = int(np.clip(np.searchsorted(coords, camera[1]), 0, n - 1))
    ij, faces, _ = _clipmap_index_mesh(n, (ci, cj), fine_cells, levels)
    sel_i, sel_j = ij[:, 0], ij[:, 1]
    hh = h[sel_i, sel_j]
    if display_scale:
        dx = _to_host(fields.disp_x)[sel_i, sel_j]
        dz = _to_host(fields.disp_z)[sel_i, sel_j]
        chop = getattr(cfg, "choppiness", 1.0)
        vx = coords[sel_i].astype(np.float32) - chop * dx / 8.0
        vy = hh / 8.0
        vz = coords[sel_j].astype(np.float32) - chop * dz / 8.0
    else:
        vx = _to_host(fields.pos_x)[sel_i, sel_j]
        vy = hh
        vz = _to_host(fields.pos_z)[sel_i, sel_j]
    verts = np.stack([vx, vy, vz], axis=-1).astype(np.float32)
    nrm = _to_host(fields.normal)[sel_i, sel_j].astype(np.float32)
    uv = np.stack([sel_i / max(n - 1, 1), sel_j / max(n - 1, 1)],
                  axis=-1).astype(np.float32)
    return {"vertices": verts, "uv": uv, "normals": nrm, "faces": faces,
            "index_ij": ij}


def save_clipmap_obj(path: str, fields, cfg, camera=(0.0, 0.0),
                     levels: int = 3, fine_cells: int = 16,
                     display_scale: bool = False) -> str:
    """OBJ export of the camera-adaptive clipmap mesh."""
    m = clipmap_mesh_arrays(fields, cfg, camera=camera, levels=levels,
                            fine_cells=fine_cells,
                            display_scale=display_scale)
    return _write_obj(path, m,
                      "# tpu_ocean camera-adaptive clipmap frame "
                      "(tessellation analogue: "
                      "MistralWaterCommon.cginc:215-296)")
