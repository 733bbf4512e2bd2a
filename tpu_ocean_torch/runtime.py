"""Serving runtimes around the solvers.

JAX counterpart: ``tpu_ocean/runtime.py``. Only ``PondSimulation`` is here;
the ocean's ``Simulation`` (checkpoint, metrics, export) is ROADMAP Queue 1
item 9.
"""

from __future__ import annotations

import torch

from tpu_ocean_torch.gerstner import PondSolver


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
        if self.solver.device.type == "cuda":
            torch.cuda.current_stream(self.solver.device).synchronize()
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
