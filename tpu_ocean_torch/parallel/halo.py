"""Width-|shift| halo exchange over a ring of ranks.

JAX counterpart: ``tpu_ocean/parallel/halo.py``. The stencils wrap around
the patch (a periodic boundary); on a grid split over a group the same
wrap comes from the ring: ``roll_sharded`` reproduces ``torch.roll`` of
the global array on a split axis by sending the |shift|-wide boundary
strip to the neighbouring rank (collectives.ppermute).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_ocean_torch.parallel.collectives import ppermute


def roll_sharded(x: torch.Tensor, shift: int, axis: int, group):
    """torch.roll(global_x, shift, axis) evaluated on each rank's shard of
    an axis split over ``group`` in rank order. |shift| must not exceed
    the shard's extent. At D = 1 it is torch.roll."""
    if shift == 0:
        return x
    d = dist.get_world_size(group)
    if d == 1:
        return torch.roll(x, shift, axis)
    local = x.shape[axis]
    if abs(shift) > local:
        raise ValueError(f"halo width {abs(shift)} exceeds local extent "
                         f"{local}")
    if shift > 0:
        # element i takes i − s: the first s slots come from the last s of
        # the left neighbour, which sends them to the right
        strip = x.narrow(axis, local - shift, shift)
        halo = ppermute(strip, group, [(i, (i + 1) % d) for i in range(d)])
        return torch.cat([halo, x.narrow(axis, 0, local - shift)], axis)
    s = -shift
    strip = x.narrow(axis, 0, s)
    halo = ppermute(strip, group, [(i, (i - 1) % d) for i in range(d)])
    return torch.cat([x.narrow(axis, s, local - s), halo], axis)


def make_roll_fn(group, sharded_axes: tuple):
    """A torch.roll-compatible ``roll(x, shift, axis)`` that takes the ring
    on the axes listed in ``sharded_axes`` (negative axes count from the
    end) and torch.roll on the others."""
    def roll(x, shift, axis):
        ax = axis % x.dim()
        if ax in sharded_axes:
            return roll_sharded(x, shift, ax, group)
        return torch.roll(x, shift, ax)
    return roll
