"""The three collectives of the sharded step, over a process group.

JAX counterpart: the ``lax`` collectives ``tpu_ocean/fft/distributed.py``
and ``tpu_ocean/parallel/halo.py`` call inside shard_map:

  * ``all_to_all`` — ``lax.all_to_all(..., tiled=True)``: the 2-D
    transform's transpose;
  * ``all_gather`` — ``lax.all_gather``: the half route's Nyquist row, the
    channel-sharded transform, and ``DistributedOceanSolver.gather``;
  * ``ppermute`` — ``lax.ppermute``: the halo ring of the stencils.

Each runs its ``torch.distributed`` collective on the tensor's own device.
Under NCCL that is the card. Under gloo (D ranks sharing one card: NCCL
refuses two ranks on one GPU) gloo takes CUDA tensors for all_to_all and
all_gather, but not for send and recv: on an NVIDIA H100 with torch 2.11
gloo handed the device pointer to its TCP transport ("writev … Bad
address"). So ``ppermute`` alone stages a CUDA tensor through pinned
host buffers under gloo, explicitly, and counts it in
``staged_collectives``. The kernels' inputs and outputs stay on the card;
only the collective's buffers move. Nothing here retries a failed
collective by another route.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: collectives staged through host memory since the last clear, by name
staged_collectives = collections.Counter()


def _real_view(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its f32 pairs (a trailing axis of 2), which every
    backend carries; any other tensor unchanged."""
    return torch.view_as_real(x.contiguous()) if x.is_complex() else x


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` splits into D equal chunks along ``split_axis``; chunk j goes to
    rank j of ``group``; the chunks a rank receives are concatenated along
    ``concat_axis`` in rank order. Returns a contiguous tensor whose
    ``split_axis`` is D times shorter and ``concat_axis`` D times longer.
    At D = 1 it returns ``x``."""
    d = dist.get_world_size(group)
    if d == 1:
        return x
    split, concat = split_axis % x.dim(), concat_axis % x.dim()
    if x.shape[split] % d:
        raise ValueError(f"all_to_all: axis {split} of {tuple(x.shape)} does "
                         f"not split into {d} chunks")
    complex_ = x.is_complex()
    xr = _real_view(x)
    # all_to_all_single splits and concatenates along dim 0 only
    send = xr.movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    chunk = x.shape[split] // d
    # [d·chunk, ...] → [d, chunk, ...]: the sender's chunk back in place,
    # then the sender axis just before concat_axis, merged into it
    y = recv.reshape(d, chunk, *send.shape[1:]).movedim(1, split + 1)
    y = y.movedim(0, concat)
    shape = list(xr.shape)
    shape[split] = chunk
    shape[concat] *= d
    y = y.reshape(shape).contiguous()
    return torch.view_as_complex(y) if complex_ else y


def all_gather(x: torch.Tensor, group, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` stacked along a new leading
    axis in rank order ([D, *x.shape]), or with ``tiled`` concatenated
    along axis 0."""
    d = dist.get_world_size(group)
    complex_ = x.is_complex()
    xr = _real_view(x).contiguous()
    # the concatenated form along axis 0, which every backend takes
    out = torch.empty((d * xr.shape[0], *xr.shape[1:]), dtype=xr.dtype,
                      device=xr.device)
    dist.all_gather_into_tensor(out, xr, group=group)
    out = out.reshape(d, *xr.shape)
    if complex_:
        out = torch.view_as_complex(out)
    return out.reshape(d * x.shape[0], *x.shape[1:]) if tiled else out


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists (source, destination) pairs of ranks
    of ``group``, each rank at most once a side; a rank sends ``x`` to its
    destination and returns what its source sent, zeros where it has none.
    Under gloo a CUDA tensor is staged through pinned host buffers
    (``staged_collectives["ppermute"]``)."""
    me = dist.get_rank(group)
    dst = [b for a, b in perm if a == me]
    src = [a for a, b in perm if b == me]
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.contiguous()
    if staged:
        send = torch.empty(send.shape, dtype=send.dtype,
                           pin_memory=True).copy_(send)
        staged_collectives["ppermute"] += 1
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, r), group)
           for r in dst]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, r), group)
            for r in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if staged else recv
