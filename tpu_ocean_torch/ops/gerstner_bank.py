"""Gerstner wave bank: W trochoidal waves summed per grid point.

JAX counterpart: ``tpu_ocean/ops/gerstner_pallas.py`` (``gerstner_pallas``).
Per wave w, in f32 and in the TPU kernel's order (gerstner_pallas.py:38-59):

    φ_w  = f_w·(x·dx_w + z·dz_w) + ω_w·t
    ox  += s_w·a_w·dx_w·cos φ_w,  oz += s_w·a_w·dz_w·cos φ_w,  oy += a_w·sin φ_w
    nx  −= dx_w·f_w·a_w·cos φ_w,  nz −= dz_w·f_w·a_w·cos φ_w,
    ny  −= s_w·f_w·a_w·sin φ_w

then the normal (nx, 1 + ny, nz)·(1/√(nx² + (1 + ny)² + nz²)) in
``"analytic"`` mode, or the reference's flat (0, 1, 0) in ``"flat"`` mode.
The per-wave products of bank scalars (s·a·dx, ω·t, ...) are rounded in
f32 once, in that left-to-right order, by both versions.

On a CUDA tensor ``gerstner_bank`` launches the hand-written kernel
(``csrc/gerstner_bank.cu``) and nothing else; on a CPU tensor it runs the
plain version below. The TPU kernel's row blocking (``_pick_rows``) came
from VMEM and is not carried over: any [M, N] grid works. The kernel
takes no gradient (the JAX package gives it no VJP): with autograd
recording, ``gerstner_bank`` raises NotImplementedError on either device;
``gerstner.gerstner_eval`` is the differentiable plain-torch bank.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ocean_torch import _build
from tpu_ocean_torch.fft.planes import on_cpu, refuse_grad

#: the bank's rows, as gerstner_pallas.py:95-97 packs them
BANK_ROWS = ("amps", "steeps", "dirs_x", "dirs_z", "freqs", "omegas")
#: waves the kernel stages in shared memory (csrc/gerstner_bank.cu
#: kMaxWaves: 10 f32 constants each, 40 KB)
MAX_WAVES = 1024
NORMAL_MODES = ("analytic", "flat")


def pack_bank(bank, device) -> torch.Tensor:
    """A WaveBank as the [6, W] f32 tensor the kernel reads, on ``device``."""
    arrs = bank.as_arrays()
    packed = np.stack([arrs[k] for k in BANK_ROWS]).astype(np.float32)
    return torch.from_numpy(packed).to(device)


def _as_packed(bank, device) -> torch.Tensor:
    return bank if isinstance(bank, torch.Tensor) else pack_bank(bank, device)


def gerstner_bank_plain(bank, x, z, t, normal_mode: str = "analytic"):
    """Plain version of gerstner_bank, the kernel's arithmetic in torch."""
    packed = _as_packed(bank, x.device)
    t32 = torch.tensor(float(np.float32(t)), dtype=torch.float32, device=x.device)
    ox, oy, oz, nx, ny, nz = (torch.zeros_like(x) for _ in range(6))
    for amp, steep, dx, dz, freq, omega in packed.unbind(1):
        phase = freq * (x * dx + z * dz) + omega * t32
        c, s = torch.cos(phase), torch.sin(phase)
        ox = ox + steep * amp * dx * c
        oz = oz + steep * amp * dz * c
        oy = oy + amp * s
        if normal_mode == "analytic":
            nx = nx - dx * freq * amp * c
            nz = nz - dz * freq * amp * c
            ny = ny - steep * freq * amp * s
    if normal_mode == "analytic":
        ny1 = 1.0 + ny
        inv = torch.reciprocal(torch.sqrt(nx * nx + ny1 * ny1 + nz * nz))
        normal = torch.stack([nx * inv, ny1 * inv, nz * inv], dim=-1)
    else:
        normal = torch.stack([nx, torch.ones_like(x), nz], dim=-1)
    return ox, oy, oz, normal


def _check(packed, x, z, normal_mode) -> None:
    if normal_mode not in NORMAL_MODES:
        raise ValueError(f"bad normal_mode {normal_mode!r}")
    for name, a in (("x", x), ("z", z), ("bank", packed)):
        if a.dtype != torch.float32:
            raise TypeError(f"gerstner_bank takes float32 {name}, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or z.shape != x.shape or x.numel() == 0:
        raise ValueError(f"gerstner_bank takes non-empty [M, N] x and z of "
                         f"one shape, got {tuple(x.shape)}, {tuple(z.shape)}")
    if packed.dim() != 2 or packed.shape[0] != 6 or not 0 < packed.shape[1] <= MAX_WAVES:
        raise ValueError(f"the bank is [6, W] with 0 < W <= {MAX_WAVES}, "
                         f"got {tuple(packed.shape)}")


def gerstner_bank(bank, x: torch.Tensor, z: torch.Tensor, t: float,
                  normal_mode: str = "analytic"):
    """(offset_x, offset_y, offset_z [M, N], normal [M, N, 3]) of the wave
    bank at the f32 coordinate grids x, z and time t (rounded to f32).
    ``bank`` is a WaveBank or its packed [6, W] f32 tensor (pack_bank) on
    x's device."""
    packed = _as_packed(bank, x.device)
    refuse_grad("the Gerstner wave-bank kernel", (packed, x, z), "wave-bank")
    _check(packed, x, z, normal_mode)
    if on_cpu("gerstner_bank", x):
        return gerstner_bank_plain(packed, x, z, t, normal_mode)
    kernels = _build.load()
    m, n = x.shape
    ox, oy, oz = (torch.empty_like(x) for _ in range(3))
    normal = torch.empty((m, n, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernels.lib.tpu_gerstner_bank(
            x.data_ptr(), z.data_ptr(), packed.data_ptr(), ox.data_ptr(),
            oy.data_ptr(), oz.data_ptr(), normal.data_ptr(), m, n,
            packed.shape[1], float(np.float32(t)),
            int(normal_mode == "analytic"), stream)
    kernels.check(err, "gerstner_bank")
    gerstner_bank.launches += 1
    return ox, oy, oz, normal


#: kernel launches since the last reset (CPU calls do not count)
gerstner_bank.launches = 0
