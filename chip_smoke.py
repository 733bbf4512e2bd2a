#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — nvidia-smi's name and power limit, torch's device name;
  2. build   — nvcc builds tpu_ocean_torch/csrc/*.cu into one library;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes of the OCEAN_DEMO 1024² step;
  4. slice   — OCEAN_DEMO at 1024² through OceanSolver on the card: 60 steps
               from a seeded init; every kernel must have launched its
               per-step count; steps 51-60 are replayed on the CPU plain
               path from the card's step-50 state and compared;
  5. timing  — ms/step (CUDA events), device busy time per step and per
               layer, and each kernel's device time beside its plain
               version's (torch.profiler); warm L2, nothing asserted.
Then one JSON line of kernel results, and last {"ok": true, "device": ...}.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Without a CUDA device it stops at once. Imports no jax.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
STEPS, SNAPSHOT_AT, DT = 60, 50, 1.0 / 60.0
# per-step kernel launches of the packed + half step: row DFT = 2 passes of
# the full channel + the half channel's Nyquist row, half rows and columns
PER_STEP = {"fft_rows_transposed": 5, "fields_stencil": 1}


def log(*parts):
    print(*parts, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters=100, warmup=10):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=100):
    """(device ms per call, {kernel name: device ms per call}) of ``fn``:
    the CUDA kernel time torch.profiler records over ``iters`` calls after
    one warm-up. Unlike CUDA events around the calls, it leaves out the
    gaps in which the device waits for the host."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = {e.key: e.self_device_time_total / 1e3 / iters
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    require(per_kernel, "torch.profiler recorded no device time")
    return sum(per_kernel.values()), per_kernel


def normal_sensitivity(fields, cfg, delta):
    """Per texel, how far the normal can move when the stencil's inputs
    (height, chop·disp) move by at most ``delta``. Each component of
    u, v is a difference of two inputs, so |δu|, |δv| ≤ 2√3·δ; to first
    order c = u×v moves by |δu||v| + |u||δv| and c/|c| by twice that over
    |c|: |δn| ≤ 4√3·δ·(|u| + |v|)/|u×v|. Large where u and v are nearly
    parallel or short (folds)."""
    chop, texel = cfg.choppiness, cfg.length / cfg.resolution
    dx, h, dz = (chop * fields.disp_x.astype(np.float64),
                 fields.height.astype(np.float64),
                 chop * fields.disp_z.astype(np.float64))

    def xd(a):
        return np.roll(a, -1, 0) - np.roll(a, 1, 0)

    def zd(a):
        return np.roll(a, 1, 1) - np.roll(a, -1, 1)

    u = np.stack([xd(dx) + 2 * texel, xd(h), xd(dz)], -1)
    v = np.stack([zd(dx), zd(h), zd(dz) - 2 * texel], -1)
    lu, lv = np.linalg.norm(u, axis=-1), np.linalg.norm(v, axis=-1)
    return 4 * np.sqrt(3) * delta * (lu + lv) / np.linalg.norm(np.cross(u, v), axis=-1)


def compare_fields(card, cpu, cfg):
    """Hold the card's fields to the CPU plain path's, with the bands of
    tests/test_packing.py: 1e-5·max|cpu| for height, displacements,
    positions and Jacobian; 2e-4 for normals and 25·1e-5·max|foam| for
    foam, each plus the first-order effect of the measured input
    differences (normal_sensitivity): at 1024² a few texels sit on folds
    where any two f32 transforms give normals up to ~1e-3 apart (the CPU
    plain path alone is that far from float64 there). Foam follows J and
    n: |δfoam| ≤ 1.5·(|δJ| + 0.3·|δn|), smoothstep's slope being ≤ 1.5."""
    chop = cfg.choppiness
    err = {name: np.abs(getattr(card, name) - getattr(cpu, name))
           for name in cpu._fields}
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        band = 1e-5 * np.abs(getattr(cpu, name)).max()
        log(f"[slice] card vs cpu {name}: max abs err {err[name].max():.3e} "
            f"<= {band:.3e} (1e-5 x max|cpu|)")
        require(err[name].max() <= band, f"card and cpu disagree on {name}")
    delta = max(err["height"].max(), chop * err["disp_x"].max(),
                chop * err["disp_z"].max())
    n_err = err["normal"].max(-1)
    n_band = 2e-4 + normal_sensitivity(cpu, cfg, delta)
    log(f"[slice] card vs cpu normal: max abs err {n_err.max():.3e}; "
        f"{int((n_err > 2e-4).sum())} texels beyond 2e-4, all within 2e-4 + "
        f"sensitivity to the input error {delta:.3e}: "
        f"{bool((n_err <= n_band).all())} (worst err/band "
        f"{(n_err / n_band).max():.3f})")
    require((n_err <= n_band).all(), "card and cpu disagree on normal")
    f_raw = 25e-5 * np.abs(cpu.foam).max()
    f_band = f_raw + 1.5 * (err["jacobian"] + 0.3 * n_err)
    log(f"[slice] card vs cpu foam: max abs err {err['foam'].max():.3e}; "
        f"{int((err['foam'] > f_raw).sum())} texels beyond {f_raw:.3e} "
        f"(25e-5 x max), all within that + 1.5(|dJ| + 0.3|dn|): "
        f"{bool((err['foam'] <= f_band).all())} (worst err/band "
        f"{(err['foam'] / f_band).max():.3f})")
    require((err["foam"] <= f_band).all(), "card and cpu disagree on foam")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on an NVIDIA GPU only")
    if not (HERE / "tpu_ocean_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(tpu_ocean_torch/csrc is missing)")
    import tpu_ocean_torch
    from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, fields_to_numpy,
                                 state_from_numpy, _build)
    from tpu_ocean_torch.fft import planes
    from tpu_ocean_torch.ops import fields_stencil as fs
    require(Path(tpu_ocean_torch.__file__).resolve().parent.parent == HERE,
            f"tpu_ocean_torch imported from {tpu_ocean_torch.__file__}, "
            f"not from this checkout")
    # no kernel here uses tensor cores; TF32 is off so no plain version can
    # use it either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {kind} | "
        f"count {torch.cuda.device_count()} | tf32 off")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels = _build.load()
    log(f"[build] {kernels.path.relative_to(HERE)}: nvcc "
        f"{kernels.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"[build] {line.strip()}")

    # ---- 3. kernels vs plain, at the slice's shapes
    rng = np.random.default_rng(0)

    def planes_on_card(shape):
        return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                     for _ in range(2))

    fft_shapes = [(1, 1024, 1024), (1, 512, 1024), (1, 1024, 512), (1, 1, 1024)]
    fft_inputs = {s: planes_on_card(s) for s in fft_shapes}
    fft_err = 0.0
    for shape, (re, im) in fft_inputs.items():
        kr, ki = planes.fft1d_transposed(re, im, True)
        pr, pi = planes.fft1d_transposed_plain(re, im, True)
        torch.cuda.synchronize()
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        fft_err = max(fft_err, err)
        log(f"[kernels] fft_rows_transposed {list(shape)} inverse: max abs err "
            f"{err:.3e} = {err / scale:.3e} x max|plain| (limit 1e-5)")
        require(err <= 1e-5 * scale, f"fft_rows_transposed {shape} disagrees")

    cfg = OCEAN_DEMO
    n = cfg.resolution
    solver = OceanSolver(cfg, device=dev)
    _, f = solver.step(solver.init(torch.Generator().manual_seed(1)), DT)
    chop = cfg.choppiness
    fields_in = (chop * f.disp_x, f.height, chop * f.disp_z, cfg.length / n)
    got = fs.fields_stencil(*fields_in)
    want = fs.fields_stencil_plain(*fields_in)
    torch.cuda.synchronize()
    fields_err = 0.0
    for name, g, w, tol in zip(("normal", "foam", "jacobian"), got, want,
                               (1e-5, 1e-4, 1e-5)):
        err = (g - w).abs().max().item()
        fields_err = max(fields_err, err)
        log(f"[kernels] fields_stencil [{n}, {n}] {name}: max abs err "
            f"{err:.3e} (limit {tol:g})")
        require(err <= tol, f"fields_stencil {name} disagrees")

    # ---- 4. the slice, through the solver
    planes.fft1d_transposed.launches = 0
    fs.fields_stencil.launches = 0
    state = solver.init(torch.Generator().manual_seed(0))
    for step in range(1, STEPS + 1):
        state, fields = solver.step(state, DT)
        if step == SNAPSHOT_AT:
            snapshot = state_from_numpy(state, "cpu")
    torch.cuda.synchronize()
    launches = {"fft_rows_transposed": planes.fft1d_transposed.launches,
                "fields_stencil": fs.fields_stencil.launches}
    log(f"[slice] OCEAN_DEMO {n}x{n}, {STEPS} steps of dt 1/60: launches "
        f"{launches} (expected {STEPS} x {PER_STEP})")
    for name, per_step in PER_STEP.items():
        require(launches[name] == STEPS * per_step,
                f"{name} launched {launches[name]} times, not {STEPS * per_step}")

    card = fields_to_numpy(fields)
    require(int(state.step) == STEPS, "step counter")
    for name in card._fields:
        a = getattr(card, name)
        want_shape = (n, n, 3) if name == "normal" else (n, n)
        require(a.shape == want_shape, f"{name} has shape {a.shape}")
        require(np.isfinite(a).all(), f"{name} is not finite")
    norm_err = np.abs(np.linalg.norm(card.normal, axis=-1) - 1.0).max()
    require(norm_err <= 1e-5, f"|normal| - 1 reaches {norm_err}")
    require(card.foam.min() >= 0.0 and card.foam.max() <= 1.0, "foam outside [0, 1]")
    log(f"[slice] fields finite, shapes ok, max ||normal| - 1| {norm_err:.2e}, "
        f"foam in [{card.foam.min():.3f}, {card.foam.max():.3f}], "
        f"height max |.| {np.abs(card.height).max():.4f}")

    # replay steps 51..60 on the CPU plain path from the card's state
    cpu_solver = OceanSolver(cfg, device="cpu")
    cpu_state = snapshot
    for _ in range(STEPS - SNAPSHOT_AT):
        cpu_state, cpu_fields = cpu_solver.step(cpu_state, DT)
    cpu = fields_to_numpy(cpu_fields)
    require(np.array_equal(cpu_state.phase.numpy(), state.phase.cpu().numpy()),
            "phase differs between the card and the CPU")
    compare_fields(card, cpu, cfg)

    # ---- 5. timing: the step by CUDA events (its device timeline, gaps
    # included); device time by torch.profiler; warm L2 throughout
    step_state = [state]

    def one_step():
        step_state[0], _ = solver.step(step_state[0], DT)

    step_ms = cuda_ms(one_step, iters=200)
    busy_ms, per_kernel = device_ms(one_step, iters=50)
    groups = {"fft_rows_transposed": 0.0, "fields_stencil": 0.0, "torch ops": 0.0}
    for key, ms in per_kernel.items():
        name = next((g for g in PER_STEP if g in key), "torch ops")
        groups[name] += ms
    log(f"[timing] {kind} ({smi}): OCEAN_DEMO {n}x{n} {step_ms:.4f} ms/step, "
        f"{n * n / step_ms * 1e3:.4e} grid points/s; device busy "
        f"{busy_ms:.4f} ms/step, idle share {1 - busy_ms / step_ms:.3f}")
    log("[timing] device ms/step by layer: " + ", ".join(
        f"{g} {ms:.4f}" for g, ms in groups.items())
        + " (torch ops: phase, assembly, C2R fold, interleave, positions)")
    fft_ms = {}
    for shape, (re, im) in fft_inputs.items():
        k, _ = device_ms(lambda: planes.fft1d_transposed(re, im, True))
        p, _ = device_ms(lambda: planes.fft1d_transposed_plain(re, im, True))
        fft_ms[shape] = (k, p)
        log(f"[timing] fft_rows_transposed {list(shape)}: kernel {k:.4f} ms, "
            f"plain (cuFFT via torch.fft + transpose) {p:.4f} ms (device)")
    fk, _ = device_ms(lambda: fs.fields_stencil(*fields_in))
    fp, _ = device_ms(lambda: fs.fields_stencil_plain(*fields_in))
    log(f"[timing] fields_stencil [{n}, {n}]: kernel {fk:.4f} ms, plain "
        f"{fp:.4f} ms (device)")

    log(json.dumps({"kernels": [
        {"name": "fft_rows_transposed", "route": "cuda",
         "source": "tpu_ocean_torch/csrc/fft_rows.cu",
         "replaces": "tpu_ocean/fft/pallas_fft.py:235",
         "launches": launches["fft_rows_transposed"],
         "max_abs_err": fft_err,
         "ms": fft_ms[(1, 1024, 1024)][0], "plain_ms": fft_ms[(1, 1024, 1024)][1]},
        {"name": "fields_stencil", "route": "cuda",
         "source": "tpu_ocean_torch/csrc/fields_stencil.cu",
         "replaces": "tpu_ocean/ops/fields_pallas.py:255",
         "launches": launches["fields_stencil"],
         "max_abs_err": fields_err, "ms": fk, "plain_ms": fp},
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
