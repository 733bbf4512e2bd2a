"""Radix-2 Stockham FFT in plain torch, the ``stockham`` backend.

JAX counterpart: ``tpu_ocean/fft/stockham.py`` (the reference's
Stockham.shader stage loop, OceanRenderer.cs:216-316, as one loop over
precomputed gather indices and twiddles). Per stage with sub-transform size
S (S = 2, 4, ..., N), each output element i combines (Stockham.shader:42-51):

    even_idx(i) = floor(i/S)·(S/2) + (i mod S/2)
    out[i]      = in[even_idx(i)] + W(i) · in[even_idx(i) + N/2]
    W(i)        = e^{±2πi·(i mod S)/S}

so after log2 N stages the result is the unnormalized DFT in natural order.
Complex data is carried as (re, im) f32 planes inside the loop. No Pallas
kernel stands behind it in the JAX package, so none stands behind it here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _stage_tables_np(n: int, inverse: bool):
    """Per-stage (even_idx int64[n], twiddle complex128[n])."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"stockham needs a power-of-two N, got {n}")
    stages = []
    idx = np.arange(n)
    sign = 1.0 if inverse else -1.0
    s = 2
    while s <= n:
        even = (idx // s) * (s // 2) + (idx % (s // 2))
        stages.append((even, np.exp(1j * sign * 2.0 * np.pi * (idx % s) / s)))
        s *= 2
    return tuple(stages)


@functools.lru_cache(maxsize=32)
def _stage_tables(n: int, inverse: bool, device: torch.device):
    """_stage_tables_np on ``device``: (even, odd, twiddle re, twiddle im)
    a stage, the twiddles cast once to f32."""
    return tuple((torch.from_numpy(even).to(device),
                  torch.from_numpy(even + n // 2).to(device),
                  torch.from_numpy(tw.real.astype(np.float32)).to(device),
                  torch.from_numpy(tw.imag.astype(np.float32)).to(device))
                 for even, tw in _stage_tables_np(n, bool(inverse)))


def fft_stockham_1d(x: torch.Tensor, inverse: bool = True) -> torch.Tensor:
    """Unnormalized (i)DFT of complex x [..., N] along the last axis, N a
    power of two."""
    n = x.shape[-1]
    re, im = x.real.float(), x.imag.float()
    for even, odd, twr, twi in _stage_tables(n, bool(inverse), x.device):
        er, ei = re[..., even], im[..., even]
        orr, oi = re[..., odd], im[..., odd]
        # out = even + W·odd, the complex product in split form
        re = er + twr * orr - twi * oi
        im = ei + twr * oi + twi * orr
    return torch.complex(re, im)


def ifft2_stockham(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized inverse FFT over the last two axes (as
    fft.reference.ifft2_unnorm): a row pass, the axes swapped, a row pass,
    swapped back (the shader's _HORIZONTAL → _VERTICAL keyword flip)."""
    x = fft_stockham_1d(x, inverse=True)
    x = fft_stockham_1d(x.transpose(-1, -2), inverse=True)
    return x.transpose(-1, -2)
