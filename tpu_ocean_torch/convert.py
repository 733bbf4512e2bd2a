"""Carry state, wave banks and fields between the JAX package and the port
as numpy.

The ocean solver's state is its "weights": the h0 pair and the accumulated
phase. ``state_from_numpy`` takes anything with the field names of the JAX
package's ``OceanState`` (complex h0 pair) or ``OceanStateReal`` (h0
planes) — a JAX state, a NamedTuple of numpy arrays, a port state — and
returns the port's state of the same kind on ``device``, field for field;
``state_to_numpy`` copies a port state back to numpy.
``cascade_state_from_numpy`` and ``cascade_state_to_numpy`` do the same
for a cascade's ``CascadeState``, ``CascadeStateReal`` and ``LODState``
(whose ``frame`` stays a host int). The pond's weights
are its wave bank: ``wavebank_from_numpy`` takes the dict of a JAX
``WaveBank.as_arrays()``. ``shard_rows`` and ``shard_cols`` cut a global
array (a JAX state's h0 planes and phase, its fields) to one rank's shard
of the domain-decomposed solver. Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ocean_torch.cascade import CascadeState, CascadeStateReal
from tpu_ocean_torch.gerstner import PondFields, WaveBank
from tpu_ocean_torch.lod import LODState
from tpu_ocean_torch.solver import OceanFields, OceanState, OceanStateReal

_DTYPES = {"step": np.int32, "h0": np.complex64, "h0_conj": np.complex64}


def _tensor(obj, name, device):
    value = getattr(obj, name)
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value, dtype=_DTYPES.get(name, np.float32))
    return torch.from_numpy(arr.copy()).to(device)


def state_from_numpy(obj, device):
    """Port state from any object with OceanState's field names (the
    complex state) or OceanStateReal's (the real state)."""
    kind = OceanState if hasattr(obj, "h0") else OceanStateReal
    return kind(**{name: _tensor(obj, name, device) for name in kind._fields})


def state_to_numpy(state):
    """A port state with every tensor copied to a host numpy array."""
    return type(state)(*(f.detach().cpu().numpy() for f in state))


def cascade_state_from_numpy(obj, device):
    """Port cascade state from any object with the field names of the JAX
    package's CascadeState (complex h0 pair), CascadeStateReal (h0 planes)
    or LODState (``cascade``, ``planes``, ``frame``), on ``device``."""
    if hasattr(obj, "frame"):
        return LODState(cascade=cascade_state_from_numpy(obj.cascade, device),
                        planes=_tensor(obj, "planes", device),
                        frame=int(obj.frame))
    kind = CascadeState if hasattr(obj, "h0") else CascadeStateReal
    return kind(**{name: _tensor(obj, name, device) for name in kind._fields})


def cascade_state_to_numpy(state):
    """A port cascade or LOD state with every tensor copied to a host numpy
    array (an LOD state's frame stays an int)."""
    if isinstance(state, LODState):
        return LODState(cascade=cascade_state_to_numpy(state.cascade),
                        planes=state.planes.detach().cpu().numpy(),
                        frame=state.frame)
    return state_to_numpy(state)


def wavebank_from_numpy(arrays) -> WaveBank:
    """Port WaveBank from a dict of 1-D arrays keyed by WaveBank's field
    names (a JAX ``WaveBank.as_arrays()``)."""
    return WaveBank(**{name: tuple(np.asarray(arrays[name], np.float64).tolist())
                       for name in WaveBank.__dataclass_fields__})


def _shard(global_np, rank: int, d: int, axis: int) -> np.ndarray:
    a = np.asarray(global_np)
    n = a.shape[axis]
    if n % d or not 0 <= rank < d:
        raise ValueError(f"axis {axis} of {a.shape} does not split into "
                         f"{d} shards, or rank {rank} is not one of them")
    return np.ascontiguousarray(np.take(a, range(rank * n // d,
                                                 (rank + 1) * n // d), axis))


def shard_rows(global_np, rank: int, d: int) -> np.ndarray:
    """Rank ``rank``'s N/D rows of a global [N, ...] array: the row split of
    DistributedOceanSolver's h0 planes and phase."""
    return _shard(global_np, rank, d, 0)


def shard_cols(global_np, rank: int, d: int) -> np.ndarray:
    """Rank ``rank``'s N/D columns of a global [N, N, ...] array: the column
    split of DistributedOceanSolver's fields and foam_accum."""
    return _shard(global_np, rank, d, 1)


def fields_to_numpy(fields: OceanFields) -> OceanFields:
    """OceanFields with every tensor copied to a host numpy array."""
    return OceanFields(*(f.detach().cpu().numpy() for f in fields))


def pond_fields_to_numpy(fields: PondFields) -> PondFields:
    """PondFields with every tensor copied to a host numpy array."""
    return PondFields(*(f.detach().cpu().numpy() for f in fields))
