"""The port's cascade on the card. Every test here needs an NVIDIA GPU with
nvcc: each decides inside the ``cuda`` fixture whether one exists and skips
with a reason when not. This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_cascade_cuda.py -m cuda -q

- The production cascade (``default_cascade``, B = 3, ``pallas``, real
  state, packed + half, the fields kernel) at 256² and 1024²: exactly 5
  row-DFT launches (transposed store) a step, each at C = 3, and one
  fields-kernel launch; its fields held to the CPU plain path from the
  same state by chip_smoke.compare_fields (1e-5·max; the stencil normals
  within 2e-4 and the foam within 25·1e-5·max, each widened by the
  first-order effect of the measured input differences, since at a fold
  any two f32 transforms give normals ~1e-3 apart).
- The band-batched transform, one launch a pass at C = 3, against three
  one-band launches on the same planes: within 1e-6·max.
- LOD with periods [8, 4, 1] at 256²: 5 launches a frame at C = the
  frame's subset size (3, 2 or 1), and held bands' planes bit-equal."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_ocean_torch import (CascadeSolver, LODCascadeSolver,
                             cascade_state_from_numpy, cascade_state_to_numpy,
                             default_cascade, fields_to_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs

pytestmark = pytest.mark.cuda

PRODUCTION = dict(fft_backend="pallas", real_state=True, pack_channels=True,
                  half_spectrum=True, pallas_fields=True)
DT = 1.0 / 60.0


@pytest.fixture
def cuda(monkeypatch):
    """The card, with every launch of the row-DFT entries recorded as
    (entry, C) and the counts set to 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = []
    original = planes._launch_rows

    def recorded(entry, re, *args):
        launches.append((entry, re.shape[0]))
        return original(entry, re, *args)

    monkeypatch.setattr(planes, "_launch_rows", recorded)
    planes.fft1d_transposed.launches = 0
    planes.fft1d_natural_large.launches = 0
    fs.fields_stencil.launches = 0
    planes.named_launches.clear()
    return launches


def _close(got, want, rel):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.mark.parametrize("n", [256, 1024])
def test_production_cascade_launches_and_matches_cpu(cuda, n):
    cfgs = default_cascade(n=n)
    solver = CascadeSolver(cfgs, **PRODUCTION)
    state = solver.init()
    steps = 4
    for _ in range(steps - 1):
        state, _ = solver.step(state, DT)
    snapshot = cascade_state_from_numpy(cascade_state_to_numpy(state), "cpu")
    cuda.clear()
    state, fields = solver.step(state, DT)
    torch.cuda.synchronize()
    assert cuda == [("tpu_fft_rows_transposed", 3)] * 5
    assert planes.fft1d_transposed.launches == 5 * steps
    assert fs.fields_stencil.launches == steps
    assert not planes.named_launches
    _, want = CascadeSolver(cfgs, device="cpu", **PRODUCTION).step(snapshot,
                                                                   DT)
    # the combined surface: effective displacements, the display texel
    chip_smoke.compare_fields(
        fields_to_numpy(fields), fields_to_numpy(want),
        cfgs[0].replace(choppiness=1.0, length=solver.display_length),
        f"cascade {n}")
    cuda.clear()
    solver.velocity(state)
    torch.cuda.synchronize()
    assert cuda == [("tpu_fft_rows_transposed", 3)] * 3


@pytest.mark.parametrize("shape", [(3, 1024, 1024), (3, 512, 1024),
                                   (3, 1, 1024), (3, 1024, 512),
                                   (3, 4096, 4096)])
def test_band_batched_launch_equals_one_band_launches(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    re, im = (torch.randn(shape, generator=gen).cuda() for _ in range(2))
    natural = shape[-1] > planes.MAX_TRANSPOSED_N
    rows = planes.fft1d_natural_large if natural else planes.fft1d_transposed
    got = rows(re, im, True)
    for b in range(shape[0]):
        one = rows(re[b:b + 1].contiguous(), im[b:b + 1].contiguous(), True)
        for g, w in zip(got, one):
            _close(g[b], w[0], 1e-6)
    assert len(cuda) == 1 + shape[0]


def test_lod_launches_at_the_subset_size(cuda):
    solver = LODCascadeSolver(default_cascade(n=256), periods=[8, 4, 1],
                              **PRODUCTION)
    state = solver.init()
    for frame in range(1, 17):
        cuda.clear()
        prev = state
        state, _ = solver.step(state)
        torch.cuda.synchronize()
        subset = 3 if frame % 8 == 0 else 2 if frame % 4 == 0 else 1
        assert cuda == [("tpu_fft_rows_transposed", subset)] * 5, frame
        for b in range(3 - subset):
            assert torch.equal(state.planes[b], prev.planes[b])
    assert fs.fields_stencil.launches == 16
