"""Demo runner — the reference's three scenes as a CLI (L5, SURVEY.md §2.4).

JAX counterpart: ``tpu_ocean/demo.py``, with the same subcommands, flags and
output files::

    python -m tpu_ocean_torch ocean   [--steps K] [--res N] [--production]
    python -m tpu_ocean_torch fftmesh [--steps K] [--out DIR]
    python -m tpu_ocean_torch pond    [--steps K] [--waves W] [--pallas]
    python -m tpu_ocean_torch cascade [--steps K] [--res N] [--production]
                                      [--camera M]
    python -m tpu_ocean_torch serve   [--steps K] [--res N] [--port P]
                                      [--fields height,foam] [--real-state]

Each command steps the corresponding preset (Ocean Demo.unity / FFT
Mesh.unity / Pond.unity parameter sets, encoded in config.py) and exports
field snapshots — PNG heatmaps and .npy planes, plus shaded renders — the
stand-in for watching the Unity scene. Metrics stream to stderr as JSONL
(observe.Metrics); each step's record ends when the device has finished
it. ``serve`` streams the ocean's fields to TCP clients
(``serve.FrameServer``; read them with ``serve.stream_frames``, ``python
-m tpu_ocean_torch.stream_client`` or ``native/stream_client.cpp``). Every
scene runs on the CUDA card unless ``--device cpu`` is given; without a
card the default raises, as torch does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def _add_common(p, default_steps):
    p.add_argument("--steps", type=int, default=default_steps)
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--dump-every", type=int, default=0,
                   help="write snapshots every K steps (0 = final only)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--backend", type=str, default="reference")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the scene runs on (default: the CUDA "
                        "card; 'cpu' runs the kernels' plain versions)")


def run_ocean(args) -> int:
    from tpu_ocean_torch import viz
    from tpu_ocean_torch.config import OCEAN_DEMO
    from tpu_ocean_torch.convert import fields_to_numpy
    from tpu_ocean_torch.observe import Metrics
    from tpu_ocean_torch.runtime import _synchronize
    from tpu_ocean_torch.solver import OceanSolver

    cfg = OCEAN_DEMO
    if args.res:
        cfg = cfg.replace(resolution=args.res, length=float(args.res))
    kw = {}
    if args.production:
        # the headline switch set: all-real plane pipeline + fused stencil
        # kernel + Hermitian packing + half-spectrum C2R
        args.backend = "pallas"
        kw = dict(real_state=True, pallas_fields=True, pack_channels=True,
                  half_spectrum=cfg.resolution % 16 == 0
                  and cfg.resolution >= 64)
    solver = OceanSolver(cfg, device=args.device, fft_backend=args.backend,
                         **kw)
    state = solver.init(torch.Generator().manual_seed(args.seed))
    metrics = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
    mgr = None
    if args.checkpoint_every:
        from tpu_ocean_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(os.path.join(args.out, "ckpt"),
                                interval=args.checkpoint_every)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            state, fields = solver.step(state, 1.0 / 60.0)
            _synchronize(solver.device)
        if mgr is not None:
            # host-tracked step: pulling state.step would sync every frame
            mgr.maybe_save(state, cfg, step=k + 1)
        if args.dump_every and (k + 1) % args.dump_every == 0:
            viz.save_render_png(
                os.path.join(args.out, f"ocean_render_{k + 1:06d}.png"), fields)
    if fields is not None:
        host = fields_to_numpy(fields)     # one copy of each field
        viz.save_fields(args.out, host, prefix="ocean", step=args.steps)
        viz.save_render_png(os.path.join(args.out, "ocean_render.png"), host)
        if args.save_mesh:
            p = viz.save_mesh_obj(os.path.join(args.out, "ocean_mesh.obj"),
                                  host, cfg,
                                  decimate=max(1, cfg.resolution // 256))
            print(f"# mesh written: {p}", file=sys.stderr)
        if args.save_clipmap:
            p = viz.save_clipmap_obj(
                os.path.join(args.out, "ocean_clipmap.obj"), host, cfg,
                camera=(0.0, 0.0), levels=3,
                fine_cells=max(4, min(64, cfg.resolution // 8) // 4 * 4))
            print(f"# clipmap written: {p}", file=sys.stderr)
    print(f"# {args.steps} steps at {cfg.resolution}^2: "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_fftmesh(args) -> int:
    """The CPU-oracle scene (FFT Mesh.unity): runs BOTH the oracle and the
    solver on the same h0 and reports their agreement — the reference's
    visual cross-check, quantified. The solver's direct sum needs f32
    matmuls: on the card it raises if TF32 is allowed."""
    from tpu_ocean_torch import viz
    from tpu_ocean_torch.config import FFT_MESH_DEMO
    from tpu_ocean_torch.convert import fields_to_numpy
    from tpu_ocean_torch.oracle import Oracle
    from tpu_ocean_torch.solver import OceanSolver

    cfg = FFT_MESH_DEMO
    oracle = Oracle(cfg, rng=np.random.default_rng(args.seed))
    solver = OceanSolver(cfg, device=args.device, eval_mode="direct")
    state = solver.init(h0=oracle.h0.astype(np.complex64),
                        h0_conj=oracle.h0_conj.astype(np.complex64))
    t = args.steps * (1.0 / 60.0) / cfg.t_division
    ref = oracle.fields(t)
    got = fields_to_numpy(solver.fields_at(state, t))
    scale = np.max(np.abs(ref.height)) + 1e-12
    err = np.max(np.abs(got.height - ref.height)) / scale
    viz.save_fields(args.out, got, prefix="fftmesh", step=args.steps)
    print(f"# oracle-vs-solver max rel height error at t={t:.4f}: {err:.3e}",
          file=sys.stderr)
    return 0 if err < 1e-3 else 1


def run_pond(args) -> int:
    from tpu_ocean_torch import viz
    from tpu_ocean_torch.config import POND_DEMO
    from tpu_ocean_torch.convert import pond_fields_to_numpy
    from tpu_ocean_torch.gerstner import PondSolver, WaveBank
    from tpu_ocean_torch.observe import Metrics
    from tpu_ocean_torch.runtime import _synchronize

    cfg = POND_DEMO
    if args.res:
        cfg = dataclasses.replace(cfg, resolution=args.res)
    bank = (WaveBank.random(args.seed, args.waves) if args.waves
            else WaveBank.from_packed4(cfg))
    solver = PondSolver(cfg, bank=bank, use_pallas=args.pallas,
                        device=args.device)
    metrics = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            fields = solver.fields(k / 60.0)
            _synchronize(solver.device)
    if fields is not None:
        host = pond_fields_to_numpy(fields)    # one copy of each field
        viz.save_fields(args.out, host, prefix="pond", step=args.steps)
        viz.save_pond_render_png(os.path.join(args.out, "pond_render.png"),
                                 host)
        # the rest of the _REFLECTIONTYPE keyword matrix + the GrabPass
        # refraction stand-in (MistralWaterCommon.cginc:73-195)
        viz.save_pond_render_png(
            os.path.join(args.out, "pond_render_cubemap.png"), host,
            reflection="cubemap", refraction=True)
        viz.save_pond_render_png(
            os.path.join(args.out, "pond_render_realtime.png"), host,
            reflection="realtime", refraction=True)
    print(f"# {args.steps} pond steps, {len(bank)} waves: "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_cascade(args) -> int:
    """Beyond-reference scene: the 3-band production cascade (lengths 1000 /
    130 / 17 m), LOD-scheduled by camera distance with ``--camera``
    (lod.periods_for_distance)."""
    from tpu_ocean_torch import viz
    from tpu_ocean_torch.cascade import CascadeSolver, default_cascade
    from tpu_ocean_torch.convert import fields_to_numpy
    from tpu_ocean_torch.lod import LODCascadeSolver, periods_for_distance
    from tpu_ocean_torch.observe import Metrics
    from tpu_ocean_torch.runtime import _synchronize

    n = args.res or 256
    cfgs = default_cascade(n=n)
    dt = 1.0 / 60.0
    kw = dict(pack_channels=args.pack, device=args.device)
    if args.production:
        # the banded twin of the ocean scene's headline switch set: the
        # all-real banded step, the fields kernel, packing and one
        # half-spectrum call for every band's last packed channel
        args.backend = "pallas"
        kw.update(pack_channels=True, real_state=True, pallas_fields=True,
                  half_spectrum=n % 16 == 0 and n >= 64)
    if args.camera > 0:
        periods = periods_for_distance(cfgs, dt, camera_distance=args.camera)
        solver = LODCascadeSolver(cfgs, periods=periods,
                                  fft_backend=args.backend, dt=dt, **kw)
        print(f"# LOD periods {periods} (camera {args.camera:.0f} m)",
              file=sys.stderr)
    else:
        solver = CascadeSolver(cfgs, fft_backend=args.backend, **kw)
    state = solver.init(torch.Generator().manual_seed(args.seed))
    metrics = Metrics(grid_points=n ** 2, emit=sys.stderr)
    fields = None
    for k in range(args.steps):
        with metrics.measure():
            state, fields = solver.step(state, dt)
            _synchronize(solver.device)
        if args.dump_every and (k + 1) % args.dump_every == 0:
            viz.save_render_png(
                os.path.join(args.out, f"cascade_render_{k + 1:06d}.png"),
                fields)
    if fields is not None:
        host = fields_to_numpy(fields)     # one copy of each field
        viz.save_fields(args.out, host, prefix="cascade", step=args.steps)
        viz.save_render_png(os.path.join(args.out, "cascade_render.png"), host)
    print(f"# {args.steps} cascade steps ({len(cfgs)} bands at {n}^2): "
          f"{metrics.summary()}", file=sys.stderr)
    return 0


def run_serve(args) -> int:
    """Serve the ocean demo as a real-time field stream (serve.py): remote
    clients consume what Unity composited locally (OceanRenderer.cs:
    98-136). The bound address is printed on stderr."""
    from tpu_ocean_torch.config import OCEAN_DEMO
    from tpu_ocean_torch.runtime import Simulation
    from tpu_ocean_torch.serve import FrameServer

    cfg = OCEAN_DEMO if not args.res else OCEAN_DEMO.replace(
        resolution=args.res, length=float(args.res))
    kw = {}
    if args.real_state:
        kw["real_state"] = True
        if args.backend not in ("pallas", "pallas_fused"):
            args.backend = "pallas"      # real_state needs the plane backends
    if args.pack_channels:
        kw["pack_channels"] = True
    if args.half_spectrum:
        kw["half_spectrum"] = True
    sim = Simulation(cfg, fft_backend=args.backend, out_dir=args.out,
                     checkpoint_every=args.checkpoint_every,
                     export_every=args.dump_every,
                     generator=torch.Generator().manual_seed(args.seed),
                     device=args.device, **kw)
    with sim, FrameServer(sim, fields=tuple(args.fields.split(",")),
                          host=args.host, port=args.port) as server:
        host, port = server.address
        print(f"# serving {cfg.resolution}^2 [{args.fields}] on "
              f"{host}:{port} ({args.steps or 'unlimited'} steps)",
              file=sys.stderr, flush=True)
        server.run(steps=args.steps or None)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_ocean_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ocean", help="GPU ocean demo (Ocean Demo.unity)")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0,
                   help="override resolution (default: preset 1024)")
    p.add_argument("--production", action="store_true",
                   help="the headline switch set (real_state + fused "
                        "stencil + packing + half-spectrum, on the row-DFT "
                        "and fields kernels)")
    p.add_argument("--save-mesh", action="store_true",
                   help="write the final displaced frame as OBJ geometry "
                        "(two-triangles-per-quad, OceanRenderer.cs:172-207; "
                        "auto-decimated to ≤ 256 vertices per side)")
    p.add_argument("--save-clipmap", action="store_true",
                   help="write a camera-adaptive multi-resolution OBJ "
                        "(crack-free concentric rings — the tessellation "
                        "falloff of MistralWaterCommon.cginc:215-296 as "
                        "actual geometry)")

    p = sub.add_parser("fftmesh", help="CPU oracle scene (FFT Mesh.unity)")
    _add_common(p, default_steps=10)

    p = sub.add_parser("pond", help="Gerstner pond (Pond.unity)")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--waves", type=int, default=0,
                   help="random W-wave bank instead of the demo's packed 4")
    p.add_argument("--pallas", action="store_true",
                   help="the wave-bank kernel (the JAX flag's name)")

    p = sub.add_parser("cascade",
                       help="multi-band cascade (beyond-reference), "
                            "optionally LOD-scheduled via --camera")
    _add_common(p, default_steps=60)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--camera", type=float, default=0.0,
                   help="camera distance in m (>0 enables LOD scheduling)")
    p.add_argument("--pack", action="store_true",
                   help="Hermitian channel packing (B×2 transforms)")
    p.add_argument("--production", action="store_true",
                   help="the banded headline switch set (real_state + "
                        "fused combine + packing + half-spectrum)")

    p = sub.add_parser("serve",
                       help="stream solver fields to TCP clients "
                            "(real-time drop policy)")
    _add_common(p, default_steps=0)
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (printed on stderr)")
    p.add_argument("--fields", type=str, default="height,foam",
                   help="comma-separated OceanFields leaves to stream")
    p.add_argument("--real-state", action="store_true",
                   help="all-f32 solver state (pallas backend)")
    p.add_argument("--pack-channels", action="store_true",
                   help="Hermitian channel packing")
    p.add_argument("--half-spectrum", action="store_true",
                   help="C2R route for the last packed channel (needs "
                        "--pack-channels --real-state)")

    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    return {"ocean": run_ocean, "fftmesh": run_fftmesh,
            "pond": run_pond, "cascade": run_cascade,
            "serve": run_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
