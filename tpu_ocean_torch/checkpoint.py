"""Checkpoint and resume of the solver state, in the JAX package's format.

JAX counterpart: ``tpu_ocean/checkpoint.py`` (the npz path). One ``.npz``
written through a same-directory temporary file and a rename, holding
``version`` (2), the state's leaves and, with a config, ``config_json``
(``dataclasses.asdict`` as JSON). The complex leaves travel as stacked
(re, im) float32 pairs (``h0_pair``, ``h0_conj_pair``: [2, N, N]), and a
real state's planes are stored the same way, so a file either package
writes, from either state, loads in the other into either state. A
version-1 file (no ``foam_accum``) loads zeros there. Restoring and
stepping continues the trajectory bit for bit.

A cascade's checkpoint (``save_cascade_checkpoint``) adds ``kind``
("cascade" or "lod"), ``configs_json`` (the band configs as a JSON list),
and for an LOD state its plane cache (``planes``), ``frame`` and, where
given, the refresh schedule (``periods``); the state's leaves are stored
as for one patch, with a leading band axis. ``load_checkpoint`` refuses
such a file, and ``load_cascade_checkpoint`` refuses a single-patch one,
each naming the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from tpu_ocean_torch.config import OceanConfig
from tpu_ocean_torch.cascade import CascadeState, CascadeStateReal
from tpu_ocean_torch.lod import LODState
from tpu_ocean_torch.solver import OceanState, OceanStateReal

_FORMAT_VERSION = 2


def _pull(x: torch.Tensor) -> np.ndarray:
    """Device → host; a complex tensor as its stacked (re, im) planes."""
    x = x.detach()
    if x.is_complex():
        x = torch.stack([x.real, x.imag])
    return x.cpu().numpy()


def _atomic_savez(path: str, payload: dict) -> str:
    """Write ``payload`` to ``path`` (.npz appended if missing) through a
    same-directory temporary file and a rename, so a crash never leaves a
    half-written checkpoint. Returns the final path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _open_checkpoint(path: str):
    """np.load with the .npz suffix fallback and the version guard."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    version = int(z["version"])
    if version > _FORMAT_VERSION:
        z.close()
        raise ValueError(f"checkpoint version {version} is newer than "
                         f"supported {_FORMAT_VERSION}")
    return z


def save_checkpoint(path: str, state, cfg: Optional[OceanConfig] = None) -> str:
    """Write an OceanState or OceanStateReal (and the config) to ``path``
    (.npz appended if missing); returns the final path."""
    h0_pair, h0c_pair = _planes_pair(state)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "h0_pair": h0_pair,
        "h0_conj_pair": h0c_pair,
        "phase": _pull(state.phase),
        "t": _pull(state.t),
        "step": _pull(state.step),
        "foam_accum": _pull(state.foam_accum),
    }
    if cfg is not None:
        payload["config_json"] = np.bytes_(
            json.dumps(dataclasses.asdict(cfg)).encode())
    return _atomic_savez(path, payload)


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    """A stored array as a tensor on ``device``."""
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _planes_pair(state):
    """(h0_pair, h0_conj_pair): the h0 pair as stacked (re, im) f32 planes,
    from the complex state's tensors or the real state's planes."""
    if hasattr(state, "h0_re"):
        return (np.stack([_pull(state.h0_re), _pull(state.h0_im)]),
                np.stack([_pull(state.h0c_re), _pull(state.h0c_im)]))
    return _pull(state.h0), _pull(state.h0_conj)


def load_checkpoint(path: str, real_state: bool = False, device="cuda"):
    """(state, config or None) from ``path``, the state's tensors on
    ``device``. ``real_state=True`` builds an OceanStateReal straight from
    the stored planes; else an OceanState with the complex pair joined on
    the device."""
    with _open_checkpoint(path) as z:
        if "kind" in z.files:
            raise ValueError(
                f"{path!r} is a {bytes(z['kind']).decode()} checkpoint "
                f"(multi-band); use load_cascade_checkpoint")
        phase = _tensor(z["phase"], device)
        # version 1 predates foam accumulation: zeros
        foam_accum = (_tensor(z["foam_accum"], device)
                      if "foam_accum" in z.files else torch.zeros_like(phase))
        rest = dict(phase=phase, t=_tensor(z["t"], device),
                    step=_tensor(z["step"], device, torch.int32),
                    foam_accum=foam_accum)
        h0 = _tensor(z["h0_pair"], device)
        h0c = _tensor(z["h0_conj_pair"], device)
        if real_state:
            state = OceanStateReal(h0_re=h0[0], h0_im=h0[1], h0c_re=h0c[0],
                                   h0c_im=h0c[1], **rest)
        else:
            state = OceanState(h0=torch.complex(h0[0], h0[1]),
                               h0_conj=torch.complex(h0c[0], h0c[1]), **rest)
        cfg = None
        if "config_json" in z.files:
            d = json.loads(bytes(z["config_json"]).decode())
            d["wind"] = tuple(d["wind"])
            cfg = OceanConfig(**d)
    return state, cfg


def save_cascade_checkpoint(path: str, state, cfgs=None,
                            periods=None) -> str:
    """Write a CascadeState, CascadeStateReal or LODState (and the band
    configs) to ``path`` (.npz appended if missing); returns the final
    path. ``periods``, the LOD refresh schedule, is stored so that a resume
    under another schedule can be refused: restored phases only mean
    something under the schedule that wrote them."""
    is_lod = isinstance(state, LODState)
    cst = state.cascade if is_lod else state
    h0_pair, h0c_pair = _planes_pair(cst)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "kind": np.bytes_(b"lod" if is_lod else b"cascade"),
        "h0_pair": h0_pair,
        "h0_conj_pair": h0c_pair,
        "phase": _pull(cst.phase),
        "t": _pull(cst.t),
        "step": _pull(cst.step),
    }
    if is_lod:
        payload["planes"] = _pull(state.planes)
        payload["frame"] = np.int64(state.frame)
    if periods is not None:
        payload["periods"] = np.asarray(periods, np.int64)
    if cfgs is not None:
        payload["configs_json"] = np.bytes_(json.dumps(
            [dataclasses.asdict(c) for c in cfgs]).encode())
    return _atomic_savez(path, payload)


def load_cascade_checkpoint(path: str, real_state: bool = False,
                            device="cuda"):
    """(CascadeState, CascadeStateReal or LODState; the band configs or
    None) from ``path``, the tensors on ``device``. ``real_state=True``
    builds the real-plane state straight from the stored planes."""
    with _open_checkpoint(path) as z:
        if "kind" not in z.files:
            raise ValueError(f"{path!r} is a single-patch checkpoint; "
                             f"use load_checkpoint")
        rest = dict(phase=_tensor(z["phase"], device),
                    t=_tensor(z["t"], device),
                    step=_tensor(z["step"], device, torch.int32))
        h0 = _tensor(z["h0_pair"], device)
        h0c = _tensor(z["h0_conj_pair"], device)
        if real_state:
            cst = CascadeStateReal(h0_re=h0[0], h0_im=h0[1], h0c_re=h0c[0],
                                   h0c_im=h0c[1], **rest)
        else:
            cst = CascadeState(h0=torch.complex(h0[0], h0[1]),
                               h0_conj=torch.complex(h0c[0], h0c[1]), **rest)
        state = cst
        if bytes(z["kind"]).decode() == "lod":
            state = LODState(cascade=cst, planes=_tensor(z["planes"], device),
                             frame=int(z["frame"]))
        cfgs = None
        if "configs_json" in z.files:
            cfgs = []
            for d in json.loads(bytes(z["configs_json"]).decode()):
                d["wind"] = tuple(d["wind"])
                cfgs.append(OceanConfig(**d))
    return state, cfgs


def cascade_checkpoint_periods(path: str):
    """The LOD refresh schedule a cascade checkpoint was written under, or
    None for a plain cascade or a file without one; reads no state."""
    with _open_checkpoint(path) as z:
        if "periods" in z.files:
            return [int(p) for p in z["periods"]]
    return None


class CheckpointManager:
    """Periodic checkpoints with retention: every ``interval`` steps, the
    newest ``keep`` files kept, as ``state_<step:010d>.npz``."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3,
                 save_fn=None, load_fn=None):
        """``save_fn(path, state, cfg)`` and ``load_fn(path)`` default to
        save_checkpoint and load_checkpoint (on the card); a cascade's
        runtime passes save_cascade_checkpoint and
        load_cascade_checkpoint."""
        self.directory = directory
        self.interval = max(1, interval)
        self.keep = max(1, keep)
        self._save = save_fn if save_fn is not None else save_checkpoint
        self._load = load_fn if load_fn is not None else load_checkpoint
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step:010d}.npz")

    def _files(self):
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("state_") and f.endswith(".npz"))

    def maybe_save(self, state, cfg: Optional[OceanConfig] = None,
                   step: Optional[int] = None) -> Optional[str]:
        """Save at every ``interval``-th step. Pass ``step`` where the
        caller counts it on the host: reading state.step waits for the
        device (an LOD state's frame is a host int and is read instead)."""
        if step is None:
            step = state.frame if hasattr(state, "frame") else int(state.step)
        if step % self.interval != 0:
            return None
        p = self._path(step)
        self._save(p, state, cfg)
        for f in self._files()[: -self.keep]:
            os.unlink(os.path.join(self.directory, f))
        return p

    def clear(self) -> None:
        """Delete every checkpoint file of this manager: a run whose step
        count restarts (a reconfigure to a new N or layout) must not leave
        the old run's higher-numbered files to be kept and resumed in
        place of its own."""
        for f in self._files():
            os.unlink(os.path.join(self.directory, f))

    def latest(self) -> Optional[str]:
        files = self._files()
        return os.path.join(self.directory, files[-1]) if files else None

    def restore_latest(self):
        p = self.latest()
        if p is None:
            return None, None
        return self._load(p)
