"""tpu_ocean_torch's sharded slice on the card. Every test here needs an
NVIDIA GPU with nvcc: each decides inside the ``cuda`` fixture whether one
exists and skips with a reason when not. This file imports no jax; run it
with

    python -m pytest --noconftest tests/test_torch_distributed_cuda.py -m cuda -q

- parallel/collectives.py under NCCL at world size 1 in this process (NCCL
  refuses two ranks on one GPU, so one card runs it at D = 1 only):
  all_to_all, all_gather and ppermute on CUDA tensors, then the sharded
  step with OCEAN_DEMO's switches at D = 1 against OceanSolver on the
  card, bit for bit, with the same launches.
- D = 2 ranks sharing the card under gloo (tests/torch_dist_worker.py):
  the sharded step with the slice's switches, pallas_fused with
  overlap_chunks = 2, and the natural regime, each against OceanSolver on
  the card within 2e-5·max (the foam 1e-4, the normals 2e-4), ppermute
  staged through the host (gloo takes no CUDA tensor for send/recv) and
  nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

# a sibling module: pytest puts this directory on the path, and the name
# ``tests`` may be another package's on the card's machine
from torch_dist_worker import start_ranks
from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, _build,
                             fields_to_numpy, make_mesh)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil
from tpu_ocean_torch.parallel import collectives
from tpu_ocean_torch.solver_dist import DistributedOceanSolver

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)
FUSED = dict(fft_backend="pallas_fused", real_state=True, pack_channels=True,
             pallas_fields=True, overlap_chunks=2)
FIELDS = ("height", "disp_x", "disp_z", "pos_x", "pos_z", "normal", "foam",
          "jacobian")
DT = 1.0 / 60.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    torch.cuda.synchronize()
    return {"rows_transposed": planes.fft1d_transposed.launches,
            "fields": fields_stencil.fields_stencil.launches,
            **planes.named_launches}


def _reset():
    planes.fft1d_transposed.launches = 0
    fields_stencil.fields_stencil.launches = 0
    planes.named_launches.clear()


def _single(cfg, solver, steps, seed=0):
    s = OceanSolver(cfg, **{k: v for k, v in solver.items()
                            if k != "overlap_chunks"})
    st = s.init(torch.Generator().manual_seed(seed))
    for _ in range(steps):
        st, f = s.step(st, DT)
    return fields_to_numpy(f)


def test_collectives_and_the_d1_step_under_nccl(cuda, tmp_path):
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(shard=1)
        group = mesh.get_group("shard")
        assert dist.get_backend(group) == "nccl"
        x = torch.arange(24.0, device=cuda).reshape(2, 3, 4)
        assert torch.equal(collectives.all_to_all(x, group, 2, 1), x)
        assert torch.equal(collectives.all_gather(x, group)[0], x)
        staged = collectives.staged_collectives["ppermute"]
        assert torch.equal(collectives.ppermute(x, group, [(0, 0)]), x)
        assert collectives.staged_collectives["ppermute"] == staged
        cfg = OCEAN_DEMO.replace(resolution=256)
        want = _single(cfg, SLICE, 5)
        _reset()
        solver = DistributedOceanSolver(cfg, mesh, **SLICE)
        state = solver.init(torch.Generator().manual_seed(0))
        for _ in range(5):
            state, fields = solver.step(state, DT)
        assert _counts() == {"rows_transposed": 25, "fields": 5}
        got = fields_to_numpy(solver.gather(fields))
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,solver,cap", [
    ("slice", SLICE, None), ("fused", FUSED, None),
    ("slice_natural", SLICE, 128)])
def test_two_ranks_share_the_card_under_gloo(cuda, tmp_path, name, solver,
                                             cap):
    cfg = OCEAN_DEMO.replace(resolution=256)
    case = dict(name=name, kind="step", device="cuda", steps=5, seed=0,
                solver=solver,
                cfg={k: list(v) if isinstance(v, tuple) else v
                     for k, v in dataclasses.asdict(cfg).items()},
                **({"cap": cap} if cap else {}))
    _build.load()     # built once here, not by both ranks at once
    res = start_ranks([case], {}, 2, tmp_path).result()
    old = planes.MAX_TRANSPOSED_N
    planes.MAX_TRANSPOSED_N = cap or old
    try:
        want = _single(cfg, solver, 5)
    finally:
        planes.MAX_TRANSPOSED_N = old
    for field in FIELDS:
        got, w = res[f"{name}/fields/{field}"], getattr(want, field)
        band = (1e-4 if field == "foam" else 2e-4 if field == "normal"
                else 2e-5 * np.abs(w).max())
        assert np.abs(got - w).max() <= band, field
    # the fields' halo ring: two ppermutes a step, staged under gloo
    assert int(res[f"{name}/staged"]) == 2 * 5
