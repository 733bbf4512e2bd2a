"""tpu_ocean_torch's runtime and direct evaluation on the card. Every test
here needs an NVIDIA GPU with nvcc: each decides inside the ``cuda``
fixture whether one exists and skips with a reason when not. This file
imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_runtime_cuda.py -m cuda -q

- A Simulation of the slice (packed + half, the fields kernel) at 128²
  that checkpoints, is resumed and runs on is bit-equal, state and fields,
  to an uninterrupted run from the same generator: no kernel of the path
  uses atomics, and the checkpoint holds the state's bits.
- eval_mode="direct" on the card (cuBLAS, f32 with TF32 off) against the
  CPU within 1e-5·max, on FFT_MESH_DEMO's incommensurate grid and at 128²;
  with TF32 allowed it refuses to run."""

import numpy as np
import pytest
import torch

from tpu_ocean_torch import (FFT_MESH_DEMO, OCEAN_DEMO, OceanConfig,
                             OceanSolver, Simulation, fields_to_numpy,
                             load_checkpoint, state_from_numpy)

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)
DT = 1.0 / 60.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_simulation_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    cfg = OCEAN_DEMO.replace(resolution=128)
    out = str(tmp_path / "run")
    with Simulation(cfg, out_dir=out, checkpoint_every=5, export_every=5,
                    generator=torch.Generator().manual_seed(1), **SLICE) as sim:
        sim.run(10)
        assert sim._exporter.errors() == 0
        assert sim.state.h0_re.is_cuda
    state, saved = load_checkpoint(f"{out}/ckpt/state_0000000010.npz",
                                   real_state=True)
    assert saved == cfg and state.phase.is_cuda
    with Simulation(cfg, out_dir=out, checkpoint_every=5, **SLICE) as resumed:
        assert resumed.step_count == 10
        got = resumed.run(6)
    with Simulation(cfg, generator=torch.Generator().manual_seed(1),
                    **SLICE) as whole:
        want = whole.run(16)
    for a, b in zip(resumed.state, whole.state):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    height = np.load(f"{out}/fields/height_00000010.npy")
    assert height.shape == (128, 128) and np.isfinite(height).all()


def _direct_pair(cfg, cuda):
    card = OceanSolver(cfg, eval_mode="direct")
    cpu = OceanSolver(cfg, device="cpu", eval_mode="direct")
    state = card.init(torch.Generator().manual_seed(2))
    return card, cpu, state


@pytest.mark.parametrize("cfg", [
    FFT_MESH_DEMO,
    OceanConfig(resolution=128, length=131.5, wind=(8.0, 5.0),
                amplitude=0.05, normals_mode="stencil"),
], ids=["fft_mesh_demo", "128"])
def test_direct_on_the_card_matches_the_cpu(cuda, cfg):
    card, cpu, state = _direct_pair(cfg, cuda)
    cpu_state = state_from_numpy(state, "cpu")
    for _ in range(5):
        state, got = card.step(state, DT)
        cpu_state, want = cpu.step(cpu_state, DT)
    got, want = fields_to_numpy(got), fields_to_numpy(want)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    v_card, v_cpu = card.velocity(state).cpu().numpy(), cpu.velocity(cpu_state)
    np.testing.assert_allclose(v_card, v_cpu.numpy(), rtol=0,
                               atol=1e-5 * np.abs(v_cpu.numpy()).max())


def test_direct_refuses_tf32(cuda):
    card, _, state = _direct_pair(FFT_MESH_DEMO, cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="f32 matmuls"):
            card.step(state, DT)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
