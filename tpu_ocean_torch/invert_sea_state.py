"""Sea-state inversion by adjoint optimization, on the port.

JAX counterpart: ``examples/invert_sea_state.py``, with its defaults and
its exit rule. The inverse problem "which initial spectrum h0 produced
these observed heights?" is a gradient descent through the solver:

    1. draw a ground-truth h0*, step the ocean, record height snapshots;
    2. start from h0 = 0 and minimize Σ_t ‖height(h0, t) − obs_t‖² by Adam;
    3. exit 0 if the final loss is below 1e-2 of the initial one.

``--packed`` inverts through the production step itself
(``fft_backend="pallas"``, the real state, packed + half, the fields
kernel): the row-DFT kernels' backward is the same kernels in the opposite
direction, the fields kernel's the torch twins (fft/planes.py,
ops/fields_stencil.py). It optimizes the (h0_re, h0_im) planes and derives
the conjugate-partner planes every iteration, the Hermitian-preserving
parameterization, over 4 snapshots of 3 steps of 1/30 s from zero phase.
It needs N % 16 == 0 for the example and N ≥ 64 for the half spectrum, so
under ``--packed`` N defaults to 64 and a smaller N is refused by the
script's own check with the solver's reason. (The JAX example keeps its
N = 48 there and fails at its default; a deliberate difference.)

Without ``--packed``: the complex state on ``reference`` (torch.fft) in
absolute time with spectral normals, the heights of ``fields_at`` at
t = 0.5 + 0.37·i. torch's gradient of a real loss with respect to a
complex tensor is ∂L/∂Re + i·∂L/∂Im, the conjugate of JAX's, so Adam takes
it as it is (the JAX example conjugates its own).

The truth h0 comes from a ``torch.Generator`` seeded with 0 (torch cannot
replay ``jax.random``); ``packed_problem`` and ``complex_problem`` take an
injected pair instead.

Run: python -m tpu_ocean_torch.invert_sea_state [--packed] [--n 48, 64
     with --packed]
     [--snapshots 4] [--steps 150] [--lr 5e-2] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, NamedTuple

import torch

from tpu_ocean_torch.config import OceanConfig
from tpu_ocean_torch.evolve import negflip
from tpu_ocean_torch.solver import OceanSolver

#: the packed problem's observation schedule (examples/invert_sea_state.py)
PACKED_DT, PACKED_INNER = 1.0 / 30.0, 3
#: Adam's constants
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Problem(NamedTuple):
    """An inversion: ``loss(params)`` (a 0-d f32 tensor, differentiable in
    the params), the start (zeros, one tensor a parameter) and
    ``error(params)``, |h0 − h0*| / |h0*| against the truth."""
    loss: Callable[[List[torch.Tensor]], torch.Tensor]
    start: List[torch.Tensor]
    error: Callable[[List[torch.Tensor]], float]


def _config(n: int, **fields) -> OceanConfig:
    return OceanConfig(resolution=n, length=float(n), wind=(8.0, 5.0),
                       amplitude=0.05, dispersion_mode="capillary",
                       spectrum_layout="fft", **fields)


def _truth(solver, generator, h0, h0_conj):
    if h0 is not None:
        return solver.init(h0=h0, h0_conj=h0_conj)
    return solver.init(generator or torch.Generator().manual_seed(0))


def packed_problem(n: int, snapshots: int = 4, *, device="cuda",
                   generator=None, h0=None, h0_conj=None) -> Problem:
    """The production-step inversion (the JAX example's ``run_packed``);
    params are the (h0_re, h0_im) planes. Raises ValueError where the
    solver refuses N (half_spectrum: N % 16 == 0 and N ≥ 64)."""
    cfg = _config(n, evolution_mode="phase", normals_mode="stencil")
    solver = OceanSolver(cfg, device=device, fft_backend="pallas",
                         real_state=True, pack_channels=True,
                         half_spectrum=True, pallas_fields=True)
    truth = _truth(solver, generator, h0, h0_conj)

    def observe(planes):
        h0_re, h0_im = planes
        st = truth._replace(h0_re=h0_re, h0_im=h0_im, h0c_re=negflip(h0_re),
                            h0c_im=-negflip(h0_im),
                            phase=torch.zeros_like(truth.phase))
        heights = []
        for _ in range(snapshots):
            for _ in range(PACKED_INNER):
                st, f = solver.step(st, PACKED_DT)
            heights.append(f.height)
        return heights

    with torch.no_grad():
        obs = observe([truth.h0_re, truth.h0_im])

    def loss(planes):
        err = sum(torch.mean((h - o) ** 2) for h, o in zip(observe(planes), obs))
        return err / len(obs)

    def error(planes):
        tr = (torch.sum((planes[0] - truth.h0_re) ** 2)
              + torch.sum((planes[1] - truth.h0_im) ** 2))
        tn = torch.sum(truth.h0_re ** 2) + torch.sum(truth.h0_im ** 2)
        return float(torch.sqrt(tr / tn))

    start = [torch.zeros_like(truth.h0_re), torch.zeros_like(truth.h0_im)]
    return Problem(loss, start, error)


def complex_problem(n: int, snapshots: int = 4, *, device="cuda",
                    generator=None, h0=None, h0_conj=None) -> Problem:
    """The complex-state inversion (the JAX example's default mode); the
    one param is the complex64 h0, its partner derived."""
    cfg = _config(n, evolution_mode="absolute", normals_mode="spectral")
    solver = OceanSolver(cfg, device=device)
    truth = _truth(solver, generator, h0, h0_conj)
    times = [0.5 + 0.37 * i for i in range(snapshots)]
    with torch.no_grad():
        obs = [solver.fields_at(truth, t).height for t in times]
    base = truth._replace(h0=torch.zeros_like(truth.h0),
                          h0_conj=torch.zeros_like(truth.h0_conj))

    def loss(params):
        (h0,) = params
        # the conjugate partner in the fft layout: conj(h0[(N − n) mod N])
        st = base._replace(h0=h0, h0_conj=negflip(h0).conj())
        err = sum(torch.mean((solver.fields_at(st, t).height - o) ** 2)
                  for t, o in zip(times, obs))
        return err / len(times)

    def error(params):
        return float(torch.linalg.norm(params[0] - truth.h0)
                     / torch.linalg.norm(truth.h0))

    return Problem(loss, [torch.zeros_like(truth.h0)], error)


def value_and_grad(problem: Problem, params):
    """(loss, its gradient in each param), torch's convention for complex
    params."""
    params = [p.detach().requires_grad_() for p in params]
    val = problem.loss(params)
    return val.detach(), torch.autograd.grad(val, params)


def invert(problem: Problem, steps: int, lr: float, report=None):
    """Adam from problem.start for ``steps`` iterations, as the JAX
    example runs it; ``report(i, loss, params)`` after each update.
    Returns (params, [the loss before each update])."""
    params = [p.clone() for p in problem.start]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p.real) for p in params]
    losses = []
    for i in range(steps):
        val, grads = value_and_grad(problem, params)
        losses.append(val)
        with torch.no_grad():
            for j, g in enumerate(grads):
                m[j] = B1 * m[j] + (1 - B1) * g
                v[j] = B2 * v[j] + (1 - B2) * g.abs() ** 2
                mh = m[j] / (1 - B1 ** (i + 1))
                vh = v[j] / (1 - B2 ** (i + 1))
                params[j] = params[j] - lr * mh / (torch.sqrt(vh) + ADAM_EPS)
        if report is not None:
            report(i, val, params)
    return params, [float(x) for x in losses]


def run(problem: Problem, args) -> int:
    """The JAX example's loop and printout; 0 if the loss fell below 1e-2
    of its start."""
    def report(i, val, params):
        if i % 25 == 0 or i == args.steps - 1:
            print(f"iter {i:4d}  loss {float(val):.3e}  "
                  f"rel |h0 - h0*| {problem.error(params):.3f}", flush=True)

    t0 = time.perf_counter()
    params, _ = invert(problem, args.steps, args.lr, report)
    with torch.no_grad():
        final = float(problem.loss(params))
        init = float(problem.loss(problem.start))
    print(f"loss reduced {init:.3e} → {final:.3e} "
          f"({init / max(final, 1e-30):.1f}×) in "
          f"{(time.perf_counter() - t0) * 1e3 / max(args.steps, 1):.2f} "
          f"ms/iteration on {args.device}")
    return 0 if final < init * 1e-2 else 1


def run_packed(args) -> int:
    if args.n % 16:
        raise SystemExit("--packed needs n % 16 == 0 (half-spectrum route)")
    if args.n < 64:
        # the solver's reason, before it is built
        raise SystemExit("--packed needs n >= 64: half_spectrum needs "
                         "resolution % 16 == 0 and >= 64")
    return run(packed_problem(args.n, args.snapshots, device=args.device), args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fit h0 to observed heights by Adam through the solver")
    ap.add_argument("--n", type=int, default=None,
                    help="grid side (default 48; 64 with --packed)")
    ap.add_argument("--snapshots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--packed", action="store_true",
                    help="invert on the production packed real-state + "
                         "half-spectrum pipeline (needs n %% 16 == 0 and "
                         "n >= 64)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = 64 if args.packed else 48
    if args.packed:
        return run_packed(args)
    return run(complex_problem(args.n, args.snapshots, device=args.device), args)


if __name__ == "__main__":
    sys.exit(main())
