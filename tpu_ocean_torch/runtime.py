"""Runtimes around the solvers: the ocean's ``Simulation``, the cascade's
``CascadeSimulation`` and the pond's ``PondSimulation``.

JAX counterpart: ``tpu_ocean/runtime.py``. ``Simulation`` owns a solver,
its state, the metrics, the periodic checkpoints and the asynchronous
export::

    sim = Simulation(cfg, fft_backend="matmul", out_dir="run0",
                     checkpoint_every=500, export_every=100)
    sim.run(10_000)        # resumes by itself if run0/ckpt holds a
    fields = sim.fields    # checkpoint; one JSONL metrics line a step

Unlike the JAX package's, the export has no fallback: the native exporter
(``native.AsyncExporter``) is the only writer, and a failed build raises.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from tpu_ocean_torch.cascade import CascadeSolver
from tpu_ocean_torch.checkpoint import (
    CheckpointManager, cascade_checkpoint_periods, load_cascade_checkpoint,
    load_checkpoint, save_cascade_checkpoint)
from tpu_ocean_torch.config import OceanConfig
from tpu_ocean_torch.gerstner import PondSolver
from tpu_ocean_torch.lod import LODCascadeSolver, LODState, periods_for_distance
from tpu_ocean_torch.observe import Metrics
from tpu_ocean_torch.solver import OceanSolver


def _synchronize(device: torch.device) -> None:
    """Return when the work queued on ``device`` is done (JAX:
    block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Simulation:
    """The ocean's lifecycle: init or resume → step loop → metrics,
    checkpoints and export (JAX: runtime.Simulation).

    With ``out_dir`` and ``checkpoint_every``, a checkpoint in
    ``out_dir/ckpt`` is resumed (a config other than ``cfg`` raises
    ValueError) and the state saved every ``checkpoint_every`` steps; with
    ``out_dir`` and ``export_every``, height and foam are written to
    ``out_dir/fields`` every ``export_every`` steps by the native exporter.
    ``generator`` draws h0 (default seeded with cfg.seed) where JAX takes
    ``seed_key``; ``device`` is the card unless ``"cpu"`` is given; the
    other keywords go to OceanSolver. ``step()`` returns when the fields
    are on the device, and the step count is kept on the host."""

    def __init__(self, cfg: OceanConfig, fft_backend: str = "matmul",
                 out_dir: Optional[str] = None, dt: float = 1.0 / 60.0,
                 checkpoint_every: int = 0, export_every: int = 0,
                 metrics_stream=None,
                 generator: Optional[torch.Generator] = None, mesh=None, *,
                 device="cuda", **solver_kw):
        if mesh is not None:
            raise NotImplementedError(
                "Simulation(mesh=...), the domain-decomposed runtime, is not "
                "ported to tpu_ocean_torch yet (ROADMAP.md Queue 1 item 14b)")
        self.cfg = cfg
        self.dt = dt
        self.solver = OceanSolver(cfg, device=device, fft_backend=fft_backend,
                                  **solver_kw)
        real, dev = self.solver.real_state, self.solver.device
        self._start(out_dir, checkpoint_every, export_every, metrics_stream,
                    generator, None,
                    lambda p: load_checkpoint(p, real_state=real, device=dev))

    def _start(self, out_dir, checkpoint_every, export_every, metrics_stream,
               generator, save_fn, load_fn):
        """Metrics, checkpoints and export around ``self.solver``: resume
        the newest checkpoint in ``out_dir/ckpt`` (through
        ``_check_restored``) or init from ``generator``."""
        self.out_dir = out_dir
        self.metrics = Metrics(grid_points=self.cfg.resolution ** 2,
                               emit=metrics_stream)
        self.fields = None
        self._exporter = None
        self._export_every = export_every
        self._dropped_exports = 0

        self._ckpt = None
        if out_dir and checkpoint_every:
            self._ckpt = CheckpointManager(
                os.path.join(out_dir, "ckpt"), interval=checkpoint_every,
                save_fn=save_fn, load_fn=load_fn)
        restored, saved_cfg = (self._ckpt.restore_latest() if self._ckpt
                               else (None, None))
        if restored is not None:
            restored = self._check_restored(restored, saved_cfg)
            # the Hermitian projection is bitwise idempotent: a no-op on a
            # state a packed solver wrote, the projection on any other
            self.state = self.solver.symmetrize(restored)
            self._steps_done = self._restored_steps(restored)
        else:
            self.state = self.solver.init(generator)
            self._steps_done = 0

        # made after the checks above: raising there with a live worker
        # thread would leak it
        if out_dir and export_every:
            from tpu_ocean_torch.native import AsyncExporter
            self._exporter = AsyncExporter(os.path.join(out_dir, "fields"))

    def _check_restored(self, state, saved_cfg):
        """Refuse a checkpoint written with another config."""
        if saved_cfg is not None and saved_cfg != self.cfg:
            raise ValueError(
                f"checkpoint in {self.out_dir!r} was written with a different "
                f"config; refusing to silently continue it. Use a fresh "
                f"out_dir, or Simulation(saved_cfg, ...) to resume "
                f"(saved: {saved_cfg})")
        return state

    def _restored_steps(self, state) -> int:
        """The step count of a restored state (one read of the device)."""
        return int(state.step)

    def _saved_config(self):
        """What a checkpoint stores as its config."""
        return self.cfg

    @property
    def step_count(self) -> int:
        return self._steps_done

    @property
    def world_length(self) -> float:
        """Physical extent (m) of the field planes."""
        return self.cfg.length

    def step(self):
        """One solver step with its metrics record; returns the fields."""
        with self.metrics.measure(sim_dt=self.dt):
            self.state, self.fields = self.solver.step(self.state, self.dt)
            _synchronize(self.solver.device)
        self._steps_done += 1
        k = self._steps_done
        if self._ckpt is not None:
            self._ckpt.maybe_save(self.state, self._saved_config(), step=k)
        if self._exporter is not None and k % self._export_every == 0:
            self._export(k)
        return self.fields

    def _export(self, k: int):
        for name in ("height", "foam"):
            if not self._exporter.submit(name, k, getattr(self.fields, name)):
                self._dropped_exports += 1
                if self._dropped_exports in (1, 10, 100, 1000):
                    print(f"# exporter ring full: {self._dropped_exports} "
                          f"snapshot(s) dropped so far", file=sys.stderr)

    def run(self, steps: int,
            callback: Optional[Callable[["Simulation"], None]] = None):
        """Step ``steps`` times (on top of any resumed progress), then wait
        for the exporter."""
        for _ in range(steps):
            self.step()
            if callback is not None:
                callback(self)
        if self._exporter is not None:
            self._exporter.flush()
        return self.fields

    def reconfigure(self, new_cfg: OceanConfig):
        """Live parameter change (OceanSolver.reconfigure); a change of N
        or layout restarts the step count and clears the checkpoints."""
        rebuilt = (new_cfg.resolution != self.cfg.resolution
                   or new_cfg.spectrum_layout != self.cfg.spectrum_layout)
        self.solver, self.state = self.solver.reconfigure(self.state, new_cfg)
        self.cfg = new_cfg
        # throughput divides by the grid points
        self.metrics.grid_points = new_cfg.resolution ** 2
        if rebuilt:
            self._restart_count()

    def _restart_count(self):
        """The step count starts over, and so do the checkpoints: files are
        named and kept by step, so the old config's higher-numbered files
        would outlive the new run's and be resumed in their place. (The
        JAX package keeps them, and a restart then refuses the config.)"""
        self._steps_done = 0
        if self._ckpt is not None:
            self._ckpt.clear()

    def close(self):
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CascadeSimulation(Simulation):
    """The Simulation lifecycle over a multi-band cascade (cascade.py),
    LOD-scheduled (lod.py) when ``periods`` or ``camera_distance`` is given
    (JAX: runtime.CascadeSimulation). The same contract: resume from
    ``out_dir`` (refusing other band configs, the other checkpoint kind,
    another LOD schedule, or fewer cached planes than the solver needs),
    JSONL metrics, periodic checkpoints and export; ``generator`` draws
    the bands' h0 where JAX takes ``seed_key``."""

    def __init__(self, cfgs, fft_backend: str = "reference",
                 out_dir: Optional[str] = None, dt: float = 1.0 / 60.0,
                 periods=None, camera_distance: float = 0.0,
                 checkpoint_every: int = 0, export_every: int = 0,
                 metrics_stream=None,
                 generator: Optional[torch.Generator] = None,
                 pack_channels: bool = False, real_state: bool = False,
                 pallas_fields: bool = False, half_spectrum: bool = False, *,
                 device="cuda"):
        self.cfgs = list(cfgs)
        self.cfg = self.cfgs[0]
        self.dt = dt
        self._lod = periods is not None or camera_distance > 0
        kw = dict(fft_backend=fft_backend, pack_channels=pack_channels,
                  real_state=real_state, pallas_fields=pallas_fields,
                  half_spectrum=half_spectrum, device=device)
        if self._lod:
            if periods is None:
                periods = periods_for_distance(self.cfgs, dt,
                                               camera_distance=camera_distance)
            self.solver = LODCascadeSolver(self.cfgs, periods=periods, dt=dt,
                                           **kw)
        else:
            self.solver = CascadeSolver(self.cfgs, **kw)
        # an LOD checkpoint carries its schedule: restored phases and caches
        # mean something only under the schedule that wrote them
        periods_meta = list(self.solver.periods) if self._lod else None
        self._start(out_dir, checkpoint_every, export_every, metrics_stream,
                    generator,
                    lambda p, s, c: save_cascade_checkpoint(
                        p, s, c, periods=periods_meta),
                    lambda p: load_cascade_checkpoint(
                        p, real_state=real_state, device=device))

    def _check_restored(self, state, saved_cfgs):
        if saved_cfgs is not None and list(saved_cfgs) != self.cfgs:
            raise ValueError(
                f"checkpoint in {self.out_dir!r} was written with different "
                f"band configs; refusing to silently continue it")
        if self._lod != isinstance(state, LODState):
            raise ValueError("checkpoint kind (lod vs plain cascade) "
                             "does not match this simulation's mode")
        if not self._lod:
            return state
        saved_p = cascade_checkpoint_periods(self._ckpt.latest())
        if saved_p is not None and saved_p != list(self.solver.periods):
            raise ValueError(
                f"checkpoint in {self.out_dir!r} was written under LOD "
                f"schedule {saved_p}, this simulation uses "
                f"{list(self.solver.periods)}; restored band caches "
                f"would be misaligned — use a fresh out_dir or the "
                f"saved schedule")
        nch = self.solver.plane_count
        if state.planes.shape[1] > nch:
            # a cache of 5 planes from stencil configs: the leading planes
            # are the live ones
            return state._replace(planes=state.planes[:, :nch])
        if state.planes.shape[1] < nch:
            raise ValueError(
                f"checkpoint caches {state.planes.shape[1]} planes per band, "
                f"this solver needs {nch} — it was written under a "
                f"different normals_mode")
        return state

    def _restored_steps(self, state) -> int:
        """An LOD state's frame (a host int), else one read of its step."""
        return state.frame if self._lod else int(state.step)

    def _saved_config(self):
        return self.cfgs

    @property
    def world_length(self) -> float:
        """Physical extent (m) of the combined planes: the display length
        (the longest band's by default)."""
        return getattr(self.solver, "inner", self.solver).display_length

    def reconfigure(self, new_cfgs):
        """Live per-band parameter change (CascadeSolver.reconfigure, or
        LODCascadeSolver.reconfigure under LOD). Init-only changes keep the
        phase and, under LOD, the schedule and frame; a change of N or
        layout restarts the step count and clears the checkpoints."""
        new_cfgs = list(new_cfgs)
        rebuilt = (new_cfgs[0].resolution != self.cfg.resolution
                   or new_cfgs[0].spectrum_layout != self.cfg.spectrum_layout)
        self.solver, self.state = self.solver.reconfigure(self.state,
                                                          new_cfgs)
        self.cfgs = new_cfgs
        self.cfg = new_cfgs[0]
        self.metrics.grid_points = new_cfgs[0].resolution ** 2
        if rebuilt:
            self._restart_count()


class PondSimulation:
    """The serving-contract runtime for the Gerstner/sinusoid pond family
    (gerstner.PondSolver): cfg / dt / step() / step_count / state / solver,
    what a frame server consumes, so the pond streams like the ocean.

    The pond is stateless in t (the reference's vertex shader evaluates
    _Time directly, MistralWaterLib.cginc:81), so ``state`` is the clock,
    which is what PondSolver.velocity takes. ``step()`` returns when the
    fields are on the device: on a CUDA device it synchronizes the current
    stream (JAX: block_until_ready)."""

    def __init__(self, cfg, bank=None, normal_mode: str = "analytic",
                 use_pallas: bool = False, dt: float = 1.0 / 60.0, *,
                 device="cuda"):
        self.cfg = cfg
        self.dt = dt
        self.solver = PondSolver(cfg, bank=bank, normal_mode=normal_mode,
                                 use_pallas=use_pallas, device=device)
        self._steps_done = 0
        self.fields = None

    @property
    def step_count(self) -> int:
        return self._steps_done

    @property
    def state(self):
        return self._steps_done * self.dt      # t — see class docstring

    @property
    def world_length(self) -> float:
        return self.cfg.resolution * self.cfg.unit_width

    def step(self):
        self._steps_done += 1
        self.fields = self.solver.fields(self.state)
        _synchronize(self.solver.device)
        return self.fields

    def run(self, steps: int):
        for _ in range(steps):
            self.step()
        return self.fields

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
