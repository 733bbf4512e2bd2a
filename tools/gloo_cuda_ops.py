#!/usr/bin/env python3
"""Which torch.distributed operations gloo takes for CUDA tensors on this
machine, and whether NCCL at world size 1 takes the sharded solver's three
collectives. Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 tools/gloo_cuda_ops.py

Each operation runs in its own pair of processes on the one card (a
``file://`` rendezvous, so a crash or a hang stays contained and ends at
a 90 s timeout), and prints each rank's result or error:
all_to_all_single, all_gather_into_tensor, all_gather, batch_isend_irecv,
send/recv, broadcast, all_reduce, and an all_to_all over the 'shard' group
of a ('batch', 'shard') DeviceMesh of each device type. Then, in this
process, NCCL at world size 1: all_to_all_single, all_gather_into_tensor
and a batch_isend_irecv to itself, and a DeviceMesh over it.
parallel/collectives.py stages through host memory what gloo refuses.
"""

import json
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

OPS = ["all_to_all_single", "all_gather_into_tensor", "all_gather",
       "batch_isend_irecv", "send_recv", "broadcast", "all_reduce",
       "device_mesh_cpu", "device_mesh_cuda"]


def rank_main(op, rank, world, init):
    dist.init_process_group("gloo", init_method=init, rank=int(rank),
                            world_size=int(world))
    rank, world = int(rank), int(world)
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 100 * rank
    y = torch.empty_like(x)
    out = {}
    try:
        if op == "all_to_all_single":
            dist.all_to_all_single(y, x)
        elif op == "all_gather_into_tensor":
            y = torch.empty(world * 8, device="cuda")
            dist.all_gather_into_tensor(y, x)
        elif op == "all_gather":
            ys = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(ys, x)
            y = torch.cat(ys)
        elif op == "batch_isend_irecv":
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, y, (rank - 1) % world)]):
                req.wait()
        elif op == "send_recv":
            if rank == 0:
                dist.send(x, 1)
                dist.recv(y, 1)
            else:
                dist.recv(y, 0)
                dist.send(x, 0)
        elif op in ("broadcast", "all_reduce"):
            y = x.clone()
            getattr(dist, op)(y, *((0,) if op == "broadcast" else ()))
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(op.split("_")[-1], (1, world),
                                    mesh_dim_names=("batch", "shard"))
            dist.all_to_all_single(y, x, group=mesh.get_group("shard"))
        torch.cuda.synchronize()
        out = {"ok": True, "y": y.cpu().tolist()}
    except (RuntimeError, ValueError) as e:
        out = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    print("RESULT", json.dumps(out), flush=True)
    dist.destroy_process_group()


def pair(op):
    init = f"file://{tempfile.mkdtemp()}/rendezvous"
    procs = [subprocess.Popen([sys.executable, __file__, "rank", op, str(r),
                               "2", init], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            proc.kill()
            results.append("timeout")
            continue
        line = [l for l in out.splitlines() if l.startswith("RESULT")]
        results.append(json.loads(line[0][7:]) if line else
                       {"exit": proc.returncode, "stderr": err[-300:]})
    return results


def nccl_world_one():
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/r",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    x = torch.arange(8.0, device="cuda")
    checks = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty_like(x), x),
        "batch_isend_irecv to itself": lambda: [r.wait() for r in
            dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0),
                                    dist.P2POp(dist.irecv,
                                               torch.empty_like(x), 0)])]}
    out = {}
    for name, fn in checks.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = f"RuntimeError: {str(e)[:300]}"
    dist.destroy_process_group()
    return out


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for op in OPS:
        t0 = time.time()
        result = pair(op)
        print(f"gloo {op} ({time.time() - t0:.1f} s): {json.dumps(result)}",
              flush=True)
    print(f"nccl at world size 1: {json.dumps(nccl_world_one())}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "rank":
        rank_main(*sys.argv[2:])
    else:
        main()
