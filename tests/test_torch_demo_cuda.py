"""The port's demo CLI on the card. Every test here needs an NVIDIA GPU with
nvcc: each decides inside the ``cuda`` fixture whether one exists and skips
with a reason when not. This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_demo_cuda.py -m cuda -q

- ``ocean --production --res 256``: 5 row-DFT launches (transposed store)
  and 1 fields-kernel launch a step, and the saved fields bit-equal to an
  OceanSolver with the same switches stepped from the same generator seed
  (no kernel of the path uses atomics).
- ``pond --pallas``: one wave-bank launch a step, the fields within atol
  2e-5, rtol 1e-5 of the CPU plain path at the last step's t.
- ``fftmesh``: rc 0 and no hand-kernel launch.
- ``sample`` on the card against the CPU on the same fields, at
  coordinates up to two periods of OCEAN_DEMO's 1024² grid: bit-equal."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ocean_torch import (OCEAN_DEMO, POND_DEMO, OceanSolver, PondSolver,
                             WaveBank, demo, pond_fields_to_numpy, sample)
from tpu_ocean_torch.solver import OceanFields
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs, gerstner_bank as gb

pytestmark = pytest.mark.cuda

WRAPPERS = (planes.fft1d_transposed, planes.fft1d_natural_large,
            fs.fields_stencil, gb.gerstner_bank)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for w in WRAPPERS:
        w.launches = 0
    planes.named_launches.clear()
    return torch.device("cuda")


def _counts():
    torch.cuda.synchronize()
    return {w.__name__: w.launches for w in WRAPPERS if w.launches}


def test_ocean_production_cli_launches_and_bit_equal(cuda, tmp_path):
    steps = 6
    assert demo.main(["ocean", "--production", "--res", "256", "--steps",
                      str(steps), "--seed", "3", "--out", str(tmp_path)]) == 0
    assert _counts() == {"fft1d_transposed": 5 * steps,
                         "fields_stencil": steps}
    assert not planes.named_launches
    cfg = OCEAN_DEMO.replace(resolution=256, length=256.0)
    solver = OceanSolver(cfg, fft_backend="pallas", real_state=True,
                         pack_channels=True, half_spectrum=True,
                         pallas_fields=True)
    state = solver.init(torch.Generator().manual_seed(3))
    for _ in range(steps):
        state, fields = solver.step(state, 1.0 / 60.0)
    for name, want in fields._asdict().items():
        got = np.load(tmp_path / f"ocean_{name}_{steps:06d}.npy")
        np.testing.assert_array_equal(got, want.cpu().numpy(), name)


def test_pond_pallas_cli_launches_and_matches_cpu(cuda, tmp_path):
    steps = 5
    assert demo.main(["pond", "--pallas", "--res", "64", "--waves", "16",
                      "--steps", str(steps), "--out", str(tmp_path)]) == 0
    assert _counts() == {"gerstner_bank": steps}
    cfg = dataclasses.replace(POND_DEMO, resolution=64)
    cpu = PondSolver(cfg, bank=WaveBank.random(0, 16), use_pallas=True,
                     device="cpu")
    want = pond_fields_to_numpy(cpu.fields((steps - 1) / 60.0))
    for name, w in want._asdict().items():
        np.testing.assert_allclose(
            np.load(tmp_path / f"pond_{name}_{steps:06d}.npy"), w,
            atol=2e-5, rtol=1e-5, err_msg=name)


def test_fftmesh_cli_on_the_card(cuda, tmp_path):
    assert demo.main(["fftmesh", "--out", str(tmp_path)]) == 0
    assert _counts() == {} and not planes.named_launches


def test_sample_on_the_card_is_bit_equal_to_the_cpu(cuda):
    rng = np.random.default_rng(0)
    n, length = OCEAN_DEMO.resolution, OCEAN_DEMO.length
    cpu = OceanFields(*(torch.from_numpy(rng.standard_normal(
        (n, n, 3) if name == "normal" else (n, n)).astype(np.float32) * 20)
        for name in OceanFields._fields))
    card = OceanFields(*(f.to(cuda) for f in cpu))
    pos = rng.uniform(-length, 2 * length, (4096, 2))
    got = sample.buoy_heights(card, pos, length)
    assert got.is_cuda
    assert torch.equal(got.cpu(), sample.buoy_heights(cpu, pos, length))
    for g, w in zip(sample.surface_at(card, pos[:, 0], pos[:, 1], length, 0.46),
                    sample.surface_at(cpu, pos[:, 0], pos[:, 1], length, 0.46)):
        assert torch.equal(g.cpu(), w)
