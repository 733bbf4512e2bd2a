"""Gradients through the port on the card. Every test here needs an NVIDIA
GPU with nvcc: each decides inside the ``cuda`` fixture whether one exists
and skips with a reason when not. This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_autograd_cuda.py -m cuda -q

- The row-DFT Functions' backward (fft/planes.py): the kernel in the
  opposite direction on the swapped cotangents, against the plain version
  in the opposite direction on the same cotangents, at the forward's bands
  (1e-5·max at f32 and in the three-factor form, 2e-3 at bf16); each
  backward pass is one counted launch.
- The fields Function (ops/fields_stencil.py): its gradient bit-equal to
  torch.autograd.grad of the twins on the same inputs and cotangents, on
  the card; the kernel launches once, in the forward only.
- One production step at N = 256 (fft_backend="pallas", packed + half, the
  fields kernel): d(Σ height² + Σ foam)/d(h0_re) on the card within
  1e-5·max of the CPU's from the same state, with 5 row-DFT launches
  forward and 5 backward.
- fft_backend="pallas_fused" and the wave bank raise NotImplementedError
  on a gradient; without one they launch as before."""

import pytest
import torch

from tpu_ocean_torch import (OCEAN_DEMO, OceanSolver, WaveBank,
                             state_from_numpy)
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs
from tpu_ocean_torch.ops import gerstner_bank as gb

pytestmark = pytest.mark.cuda

SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)
BAND = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    planes.fft1d_transposed.launches = 0
    planes.fft1d_natural_large.launches = 0
    fs.fields_stencil.launches = 0
    planes.named_launches.clear()
    return torch.device("cuda")


def _planes(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for _ in range(2)]


def _launches():
    torch.cuda.synchronize()
    return (planes.fft1d_transposed.launches
            + planes.fft1d_natural_large.launches
            + sum(planes.named_launches.values()))


# (store, [C, M, N], precision, THREE_FACTOR_THRESHOLD)
CASES = [("transposed", (1, 256, 256), "float32", None),
         ("transposed", (2, 64, 1024), "float32", None),
         ("transposed", (1, 1, 1024), "float32", None),
         ("transposed", (1, 512, 1024), "bfloat16", None),
         ("transposed", (1, 256, 1024), "float32", 512),
         ("natural", (1, 64, 4096), "float32", None),
         ("natural", (2, 16, 4096), "bfloat16", None)]


@pytest.mark.parametrize("store,shape,precision,split3", CASES)
def test_fft_function_backward_matches_plain_opposite_direction(
        cuda, monkeypatch, store, shape, precision, split3):
    if split3:
        monkeypatch.setattr(planes, "THREE_FACTOR_THRESHOLD", split3)
    transposed = store == "transposed"
    fn, plain = ((planes.fft1d_transposed, planes.fft1d_transposed_plain)
                 if transposed else
                 (planes.fft1d_natural_large, planes.fft1d_natural_large_plain))
    x = [p.requires_grad_() for p in _planes(shape, cuda)]
    yr, yi = fn(*x, True, precision)
    assert _launches() == 1
    cts = _planes(yr.shape, cuda, seed=1)
    gr, gi = torch.autograd.grad((yr, yi), x, cts)
    assert _launches() == 2
    swap = ((lambda t: t.transpose(-1, -2).contiguous()) if transposed
            else (lambda t: t))
    wr, wi = (swap(w) for w in plain(*(swap(c) for c in cts), False, precision))
    scale = max(wr.abs().max().item(), wi.abs().max().item())
    err = max((gr - wr).abs().max().item(), (gi - wi).abs().max().item())
    assert err <= BAND[precision] * scale, f"{err / scale:.3e}"


@pytest.mark.parametrize("v2", [True, False])
@pytest.mark.parametrize("n", [256, 1024])
def test_fields_function_gradient_is_bit_equal_to_the_twins(cuda, monkeypatch,
                                                            n, v2):
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", v2)
    counter = fs.fields_stencil if v2 else fs.fields_stencil_v1
    counter.launches = 0
    g = torch.Generator().manual_seed(2)
    inputs = [(0.1 * torch.randn(n, n, generator=g)).to(cuda).requires_grad_()
              for _ in range(3)]
    out = fs.fields_stencil(*inputs, 0.5)
    cts = [torch.randn(o.shape, generator=g).to(cuda) for o in out]
    got = torch.autograd.grad(out, inputs, cts)
    want = torch.autograd.grad(fs.fields_twin(*inputs, 0.5), inputs, cts)
    torch.cuda.synchronize()
    assert counter.launches == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_slice_step_gradient_on_the_card_matches_the_cpu(cuda):
    cfg = OCEAN_DEMO.replace(resolution=256)
    card = OceanSolver(cfg, **SLICE)
    cpu = OceanSolver(cfg, device="cpu", **SLICE)
    st = card.init(torch.Generator().manual_seed(0))
    for _ in range(3):
        st, _ = card.step(st, 1 / 60)
    cst = state_from_numpy(st, "cpu")

    def grad(solver, state):
        leaf = state.h0_re.clone().requires_grad_()
        _, f = solver.step(state._replace(h0_re=leaf), 1 / 60)
        loss = (f.height.double() ** 2).sum() + f.foam.double().sum()
        return torch.autograd.grad(loss, leaf)[0]

    planes.fft1d_transposed.launches = 0
    fs.fields_stencil.launches = 0
    got = grad(card, st).cpu()
    torch.cuda.synchronize()
    assert planes.fft1d_transposed.launches == 10
    assert fs.fields_stencil.launches == 1
    want = grad(cpu, cst)
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_fused_and_wave_bank_refuse_a_gradient_on_the_card(cuda):
    cfg = OCEAN_DEMO.replace(resolution=256)
    solver = OceanSolver(cfg, **{**SLICE, "fft_backend": "pallas_fused"})
    st = solver.init(torch.Generator().manual_seed(0))
    leaf = st.h0_re.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match='fft_backend="pallas"'):
        solver.step(st._replace(h0_re=leaf), 1 / 60)
    with torch.no_grad():
        _, f = solver.step(st._replace(h0_re=leaf), 1 / 60)
    assert f.height.grad_fn is None and torch.isfinite(f.height).all()

    x = torch.rand(64, 64, device=cuda).requires_grad_()
    z = torch.rand(64, 64, device=cuda)
    gb.gerstner_bank.launches = 0
    with pytest.raises(NotImplementedError, match="wave-bank"):
        gb.gerstner_bank(WaveBank.random(0, 4), x, z, 0.5)
    out = gb.gerstner_bank(WaveBank.random(0, 4), x.detach(), z, 0.5)
    torch.cuda.synchronize()
    assert gb.gerstner_bank.launches == 1 and out[0].grad_fn is None
