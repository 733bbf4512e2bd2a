"""Metrics, structured logging and profiling hooks.

JAX counterpart: ``tpu_ocean/observe.py``. Per-step records (step,
sim-time, wall-dt, grid points/s, updates/s) emitted as JSONL or CSV in the
JAX package's format; ``profile_trace`` captures a torch.profiler trace
(CPU and, where there is one, the CUDA device) for TensorBoard or Perfetto;
``named_scope`` marks a stage in it; ``check_finite`` raises on a NaN or
an infinity in a state or fields tuple; ``stage_breakdown`` times the
step's stages by differencing stage-subset loops, with CUDA events on the
card and the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity


@dataclass
class StepRecord:
    step: int
    sim_time: float
    wall_dt_s: float
    grid_points_per_s: float
    updates_per_s: float
    extras: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"step": self.step, "sim_time": round(self.sim_time, 6),
             "wall_dt_s": round(self.wall_dt_s, 6),
             "grid_points_per_s": round(self.grid_points_per_s, 1),
             "updates_per_s": round(self.updates_per_s, 2)}
        d.update(self.extras)
        return d


class Metrics:
    """Wall-clock throughput counters around a stepping loop::

        m = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
        with m.measure():
            state, f = solver.step(state, dt)
            torch.cuda.synchronize()
        # m.last is the StepRecord; one JSONL line already emitted
    """

    def __init__(self, grid_points: int, emit: Optional[IO] = None,
                 emit_format: str = "jsonl"):
        self.grid_points = grid_points
        self.emit_stream = emit
        self.emit_format = emit_format
        self.records: list[StepRecord] = []
        self._step = 0
        self._sim_time = 0.0

    @contextlib.contextmanager
    def measure(self, sim_dt: float = 1.0 / 60.0, **extras):
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        self._step += 1
        self._sim_time += sim_dt
        rec = StepRecord(
            step=self._step, sim_time=self._sim_time, wall_dt_s=wall,
            grid_points_per_s=self.grid_points / wall if wall > 0 else 0.0,
            updates_per_s=1.0 / wall if wall > 0 else 0.0,
            extras=extras)
        self.records.append(rec)
        if self.emit_stream is not None:
            d = rec.as_dict()
            if self.emit_format == "jsonl":
                self.emit_stream.write(json.dumps(d) + "\n")
            else:  # csv
                if len(self.records) == 1:
                    self.emit_stream.write(",".join(d.keys()) + "\n")
                self.emit_stream.write(",".join(str(v) for v in d.values())
                                       + "\n")
            self.emit_stream.flush()

    @property
    def last(self) -> Optional[StepRecord]:
        return self.records[-1] if self.records else None

    def summary(self, warmup: int = 1) -> dict:
        """Aggregate over the recorded steps after the first ``warmup``
        (the build and first launches); a run of zero steps reports
        zeros."""
        recs = self.records[warmup:] or self.records
        if not recs:
            return {"steps": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "updates_per_s": 0.0,
                    "grid_points_per_s": 0.0}
        walls = np.asarray([r.wall_dt_s for r in recs])
        return {
            "steps": len(recs),
            "mean_ms": float(walls.mean() * 1e3),
            "p50_ms": float(np.percentile(walls, 50) * 1e3),
            "p95_ms": float(np.percentile(walls, 95) * 1e3),
            "updates_per_s": float(1.0 / walls.mean()),
            "grid_points_per_s": float(self.grid_points / walls.mean()),
        }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A torch.profiler trace around a block, written into ``logdir`` as a
    Chrome trace (``*.pt.trace.json``) when the block ends; yields the
    profiler. Records the device too where CUDA is available."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def named_scope(name: str):
    """A named range in a profiler trace, around one stage."""
    return torch.profiler.record_function(name)


def _leaves(tree, path=""):
    """(path, leaf) of every tensor or array in nested NamedTuples, tuples,
    lists and dicts; paths are written as jax.tree_util.keystr writes
    them (".height", "[0]", "['a']")."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for key, item in tree.items():
            yield from _leaves(item, f"{path}[{key!r}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree, where: str = "") -> None:
    """Raise FloatingPointError if any floating or complex leaf holds a
    non-finite value."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = ((leaf.is_floating_point() or leaf.is_complex())
                   and not bool(torch.isfinite(leaf).all()))
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind in "fc" and not np.all(np.isfinite(arr))
        if bad:
            raise FloatingPointError(
                f"non-finite values in {path} {where and f'({where})'}")


def _wall_s(fn, k: int, device: torch.device) -> float:
    """Seconds for ``k`` calls of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    return time.perf_counter() - t0


def stage_breakdown(solver, state, dt: float = 1.0 / 60.0,
                    ks=(8, 32, 128)) -> dict:
    """Per-stage time of the real-state step without a profiler: three
    stage subsets, each run ``k`` times for every ``k`` in ``ks`` (the
    least of 3 runs), the time per step the least-squares slope
    of time against k (the fixed cost drops out), then differenced:

        full step                 (phase, assembly, transforms, fields)
        transform                 (phase, assembly and transforms)
        dispersion                (the phase update alone)

    Returns the JAX package's keys: {'full_ms', 'transform_ms',
    'dispersion_ms', 'fields_ms', 'assembly_transform_ms'} and a
    '<stage>_suspect' flag each, set where the times do not grow with k.
    Each subset advances its own copy of the state, so every call does
    the work of a step."""
    from tpu_ocean_torch.evolve import (evolve_phase_absolute,
                                        evolve_phase_accumulate)
    from tpu_ocean_torch.solver import OceanStateReal

    if not isinstance(state, OceanStateReal):
        raise ValueError("stage_breakdown times the all-real step "
                         "(OceanSolver(real_state=True))")
    cfg = solver.cfg
    dt32 = np.float32(dt)

    def advance(st):
        """(next state, phase of the step), as OceanSolver.step forms them."""
        if cfg.evolution_mode == "absolute":
            t_new = st.t + float(dt32 / np.float32(cfg.t_division))
            return (st._replace(t=t_new),
                    evolve_phase_absolute(solver.omega, t_new))
        phase = evolve_phase_accumulate(
            st.phase, solver.omega, float(dt32 * np.float32(cfg.dt_multiplier)))
        return st._replace(phase=phase, t=st.t + float(dt32)), phase

    def stage(name):
        carry = [state]

        def full():
            carry[0], _ = solver.step(carry[0], dt)

        def transform():
            carry[0], phase = advance(carry[0])
            solver._planes_from_phase(carry[0], phase)

        def dispersion():
            carry[0], _ = advance(carry[0])
        return {"full": full, "transform": transform,
                "dispersion": dispersion}[name]

    res = {}
    ks = sorted(ks)
    for name in ("full", "transform", "dispersion"):
        fn = stage(name)
        fn()                                  # builds and warms the kernels
        walls = [min(_wall_s(fn, k, solver.device) for _ in range(3))
                 for k in ks]
        slope = float(np.polyfit(ks, walls, 1)[0])
        res[f"{name}_ms"] = round(slope * 1e3, 4)
        res[f"{name}_suspect"] = bool(slope <= 0
                                      or any(np.diff(walls) <= 0))
    res["fields_ms"] = round(res["full_ms"] - res["transform_ms"], 4)
    res["assembly_transform_ms"] = round(
        res["transform_ms"] - res["dispersion_ms"], 4)
    return res
