"""Process-group rendezvous and the ('batch', 'shard') device mesh.

JAX counterpart: ``tpu_ocean/parallel/mesh.py``. A JAX mesh is an array of
devices; here it is a ``torch.distributed.device_mesh.DeviceMesh`` over
process ranks, one rank a process, with the same axis names:

  * ``shard`` — the domain-decomposition axis (grid rows split over the
    ranks, then columns after the transform's all_to_all);
  * ``batch`` — the ensemble axis, outermost.

A solver reads its shard group as ``mesh.get_group("shard")``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group (torch.distributed.init_process_group).

    A no-op for ``num_processes <= 1`` and when a group already exists, as
    the JAX package's. ``coordinator_address`` is ``host:port`` (or a full
    ``tcp://`` or ``file://`` URL); without it the rendezvous comes from
    the environment ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE), and where that is missing too the process runs alone, as
    JAX's does without a coordinator. ``backend`` defaults to NCCL where a
    CUDA device exists, else gloo; D ranks sharing one card need gloo
    (NCCL refuses two ranks on one GPU)."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=-1 if num_processes is None
                                else num_processes,
                                rank=-1 if process_id is None else process_id)
    except ValueError:
        # no rendezvous given and none in the environment: a plain
        # single-process run, for which distributed is a no-op
        pass


def make_mesh(shard: Optional[int] = None, batch: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ('batch', 'shard') DeviceMesh over ``devices``, a list of ranks
    (default: every rank of the default group, in order). ``shard``
    defaults to the ranks divided by ``batch``; the shard axis is
    innermost, so a shard group holds consecutive ranks. Needs an
    initialized process group (initialize_distributed) and is called by
    every rank."""
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if shard is None:
        shard = len(ranks) // batch
        if shard < 1:
            raise ValueError(f"batch={batch} exceeds the {len(ranks)} "
                             f"available device(s)")
    if batch * shard > len(ranks):
        raise ValueError(f"mesh needs batch*shard = {batch * shard} "
                         f"devices; only {len(ranks)} available")
    ranks = ranks[: batch * shard]
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(batch, shard),
                      mesh_dim_names=("batch", "shard"))
