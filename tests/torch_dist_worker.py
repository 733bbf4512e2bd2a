"""Run the port's sharded code in D real processes under gloo, for the CPU
tests of tests/test_torch_distributed*.py.

``start_ranks(cases, inputs, world, workdir)`` writes the cases (JSON) and
their inputs (npz), starts ``world`` processes of

    python tests/torch_dist_worker.py SPEC DATA RANK WORLD INIT OUT

joined by a ``file://`` rendezvous in ``workdir`` (no port to pick, so it
is safe under pytest-xdist), and returns a handle whose ``result()`` waits
for them, within a timeout, and returns rank 0's outputs: a dict of numpy
arrays keyed ``"<case>/<what>"``. Each rank runs every case in order (the
collectives pair them up); rank 0 writes the global results, gathered
with DistributedOceanSolver.gather or the collectives. This module imports
torch and the port, never jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
#: seconds a spawn may take, start to end, before its processes are killed
SPAWN_TIMEOUT = 120.0


class Ranks:
    """The processes of one start_ranks call."""

    def __init__(self, procs, out: Path, timeout: float):
        self.procs, self.out, self.timeout = procs, out, timeout
        self.deadline = time.monotonic() + timeout
        self._result = None

    def result(self) -> dict:
        """Rank 0's outputs once every rank has exited 0; raises with the
        ranks' stderr otherwise, killing what still runs at the deadline."""
        if self._result is not None:
            return self._result
        logs = []
        for rank, proc in enumerate(self.procs):
            try:
                _, err = proc.communicate(
                    timeout=max(self.deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                for p in self.procs:
                    p.communicate()
                raise RuntimeError(f"ranks still running after "
                                   f"{self.timeout:.0f} s; killed")
            logs.append((rank, proc.returncode, err))
        bad = [(r, rc, e[-3000:]) for r, rc, e in logs if rc != 0]
        if bad:
            raise RuntimeError("ranks failed: " + "\n".join(
                f"rank {r} exit {rc}:\n{e}" for r, rc, e in bad))
        with np.load(self.out, allow_pickle=False) as f:
            self._result = {k: f[k] for k in f.files}
        return self._result


def start_ranks(cases, inputs: dict, world: int, workdir: Path,
                timeout: float = SPAWN_TIMEOUT) -> Ranks:
    """Start ``world`` ranks on ``cases`` (a list of dicts, see run_case)
    with ``inputs`` (a dict of numpy arrays) in ``workdir``."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec, data, out = (workdir / "cases.json", workdir / "inputs.npz",
                       workdir / "out.npz")
    spec.write_text(json.dumps(cases))
    np.savez(data, **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = f"file://{workdir / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(spec), str(data),
         str(rank), str(world), init, str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    return Ranks(procs, out, timeout)


# ------------------------------------------------------------------ the ranks

def _config(d: dict):
    from tpu_ocean_torch import OceanConfig
    return OceanConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})


def _shard(x: np.ndarray, rank: int, world: int, axis: int):
    import torch
    from tpu_ocean_torch.convert import _shard
    return torch.from_numpy(_shard(x, rank, world, axis))


def _gather(x, group, axis: int) -> np.ndarray:
    import torch
    from tpu_ocean_torch.parallel.collectives import all_gather
    return torch.cat(list(all_gather(x, group).unbind(0)), axis).cpu().numpy()


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run_case(case: dict, inputs, mesh, rank: int, world: int, out: dict):
    """One case on this rank; rank 0's ``out`` collects its results."""
    import torch
    import torch.distributed as dist
    from tpu_ocean_torch.fft import distributed as fd
    from tpu_ocean_torch.fft import planes
    from tpu_ocean_torch.parallel import collectives, halo
    from tpu_ocean_torch.parallel import initialize_distributed, make_mesh
    from tpu_ocean_torch.solver_dist import DistributedOceanSolver

    name, kind = case["name"], case["kind"]
    group = mesh.get_group("shard")

    def put(what, value):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        out[f"{name}/{what}"] = np.asarray(value)

    cap = planes.MAX_TRANSPOSED_N
    planes.MAX_TRANSPOSED_N = case.get("cap", cap)
    try:
        if kind == "roll":
            x = np.arange(np.prod(case["shape"]), dtype=np.float32).reshape(
                case["shape"])
            axis = case["axis"]
            y = halo.roll_sharded(_shard(x, rank, world, axis),
                                  case["shift"], axis, group)
            put("y", _gather(y, group, axis))
        elif kind == "roll_fn":
            x = inputs[case["input"]]
            roll = halo.make_roll_fn(group, sharded_axes=(1,))
            y = roll(roll(_shard(x, rank, world, 1), -1, 0), 2, 1)
            put("y", _gather(y, group, 1))
        elif kind == "ifft2":
            x = _shard(inputs[case["input"]], rank, world, 1)
            y = fd.ifft2_x_sharded(x, group, case["backend"],
                                   overlap_chunks=case.get("overlap", 1),
                                   precision=case.get("precision", "float32"))
            put("y", _gather(y, group, 2))
        elif kind == "channel":
            x = _shard(inputs[case["input"]], rank, world, 0)
            put("y", fd.ifft2_channel_sharded(x, group, case["backend"]).numpy())
        elif kind == "half":
            s = inputs[case["input"]]
            re = _shard(np.ascontiguousarray(s.real, np.float32), rank, world, 1)
            im = _shard(np.ascontiguousarray(s.imag, np.float32), rank, world, 1)
            y = fd.ifft2_x_sharded_half(re, im, group)
            put("y", _gather(y, group, 2))
        elif kind in ("step", "reconfigure", "roundtrip"):
            cfg = _config(case["cfg"])
            solver = DistributedOceanSolver(cfg, mesh,
                                            device=case.get("device", "cpu"),
                                            **case["solver"])
            if "h0" in case:
                state = solver.init(h0=inputs[case["h0"] + "_h0"],
                                    h0_conj=inputs[case["h0"] + "_h0c"])
            else:
                state = solver.init(torch.Generator().manual_seed(case["seed"]))
            if kind == "roundtrip":
                whole = solver.gather(state)
                again = solver.shard_state(whole)
                host = type(whole)(*(v.numpy() for v in whole))
                from_host = solver.shard_state(host)
                put("equal", all(torch.equal(a, b) and torch.equal(a, c)
                                 for a, b, c in zip(state, again, from_host)))
                # the projection of a projected pair is bitwise the pair
                put("idempotent", all(torch.equal(a, b) for a, b in
                                      zip(solver.symmetrize(state), state)))
                for k, v in whole._asdict().items():
                    put(f"state/{k}", v)
                put("mismatch", _error(
                    lambda: solver.shard_state(_other_kind(whole))))
                state, f = solver.step(again, 1 / 60)
                for k, v in solver.gather(f)._asdict().items():
                    put(f"fields/{k}", v)
                return
            staged = collectives.staged_collectives["ppermute"]
            for _ in range(case.get("steps", 2)):
                state, fields = solver.step(state, case.get("dt", 1 / 60))
            put("staged", collectives.staged_collectives["ppermute"] - staged)
            if kind == "reconfigure":
                new_cfg = cfg.replace(**{k: tuple(v) if isinstance(v, list)
                                         else v for k, v in case["new"].items()})
                new, state = solver.reconfigure(
                    state, new_cfg, torch.Generator().manual_seed(case["seed2"]))
                put("shared", new.omega is solver.omega)
                for k, v in new.gather(state)._asdict().items():
                    put(f"reconfigured/{k}", v)
                state, fields = new.step(state, 1 / 60)
                solver = new
            for k, v in solver.gather(fields)._asdict().items():
                put(f"fields/{k}", v)
            for k, v in solver.gather(state)._asdict().items():
                put(f"state/{k}", v)
            if "velocity" in case:
                t = case["velocity"]
                put("velocity", solver.gather(solver.velocity(state, t)))
        elif kind == "errors":
            for label, cfg, kw in case["configs"]:
                put(label, _error(lambda: DistributedOceanSolver(
                    _config(cfg), mesh, device="cpu", **kw)))
        elif kind == "mesh":
            put("batch", _error(lambda: make_mesh(batch=world + 1)))
            put("shard", _error(lambda: make_mesh(shard=2 * world)))
            put("no_shard_axis", _error(lambda: DistributedOceanSolver(
                _config(case["cfg"]), _NoShard(), device="cpu")))
            # a no-op where a group exists, and for one process
            initialize_distributed(f"file://{case['path']}", world, rank)
            initialize_distributed(num_processes=1)
            put("ranks", dist.get_world_size())
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    finally:
        planes.MAX_TRANSPOSED_N = cap


class _NoShard:
    """A mesh without a 'shard' axis."""
    mesh_dim_names = ("batch", "data")


def _other_kind(state):
    """The global state in the other representation."""
    import torch
    from tpu_ocean_torch.solver import OceanState, OceanStateReal
    if isinstance(state, OceanStateReal):
        return OceanState(torch.complex(state.h0_re, state.h0_im),
                          torch.complex(state.h0c_re, state.h0c_im),
                          state.phase, state.t, state.step, state.foam_accum)
    return OceanStateReal(state.h0.real, state.h0.imag, state.h0_conj.real,
                          state.h0_conj.imag, state.phase, state.t,
                          state.step, state.foam_accum)


def main(spec, data, rank, world, init, out_path):
    import torch
    import torch.distributed as dist
    from tpu_ocean_torch.parallel import make_mesh

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(shard=world)
        cases = json.loads(Path(spec).read_text())
        out = {}
        with np.load(data) as f:
            inputs = {k: f[k] for k in f.files}
        for case in cases:
            run_case(case, inputs, mesh, rank, world, out)
        dist.barrier()
        if rank == 0:
            tmp = Path(out_path).with_suffix(".tmp.npz")
            np.savez(tmp, **out)
            os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
