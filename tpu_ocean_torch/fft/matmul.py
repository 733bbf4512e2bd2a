"""The DFT as matrix products, the ``matmul`` backend.

JAX counterpart: ``tpu_ocean/fft/matmul.py`` (``fft_matmul_1d``,
``ifft2_matmul``, and ``ifft1d_planes_lastaxis``, which here runs the row
kernels), which the JAX package computes as ``jnp.matmul`` and
``jnp.einsum`` outside any Pallas kernel. Two forms of the unnormalized
inverse DFT along an axis:

* ``direct``    — Y = X @ Fᵀ with F[k, n] = e^{+2πi kn/N}: any N;
* ``four_step`` — Bailey's split N = N1·N2 (N1 ≥ N2, ``_split_n``): view x
  as A[n2, n1], B = F_{N2} @ A, C = B ⊙ T with T[k2, n1] = e^{+2πi n1 k2/N},
  D = C @ F_{N1}ᵀ, X[k2 + N2·k1] = D[k2, k1].

Each complex product takes four real ones at the solver's precision, as
``fft/matrix.py`` runs them: "float32" in f32 (TF32 is refused on the
card), "bfloat16" with both operands rounded to bfloat16 and f32
accumulation, the JAX package's DEFAULT dots. Tables are float64 numpy cast
once to f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ocean_torch.fft import matrix

#: OceanConfig.precision → the tier of fft/matrix.py's products
_TIERS = {"float32": "f32", "bfloat16": "bf16"}


def _split_n(n: int):
    """Balanced factorization n = n1·n2 with n1 ≥ n2 (powers of two split
    exactly; otherwise the largest divisor ≤ sqrt(n))."""
    n2 = int(np.sqrt(n))
    while n2 > 1 and n % n2 != 0:
        n2 -= 1
    return n // n2, n2


def _dft_np(n: int, inverse: bool) -> np.ndarray:
    sign = 1.0 if inverse else -1.0
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def _planes(z: np.ndarray, device: torch.device):
    return (torch.from_numpy(z.real.astype(np.float32)).to(device),
            torch.from_numpy(z.imag.astype(np.float32)).to(device))


@functools.lru_cache(maxsize=32)
def _direct_tables(n: int, inverse: bool, device: torch.device):
    """Fᵀ as f32 (re, im)."""
    return _planes(_dft_np(n, inverse).T, device)


@functools.lru_cache(maxsize=32)
def _four_step_tables(n: int, inverse: bool, device: torch.device):
    """(n1, n2, F2, T, F1ᵀ), each an f32 (re, im) pair."""
    n1, n2 = _split_n(n)
    sign = 1.0 if inverse else -1.0
    tw = np.exp(sign * 2j * np.pi * np.arange(n2)[:, None]
                * np.arange(n1)[None, :] / n)
    return (n1, n2, _planes(_dft_np(n2, inverse), device),
            _planes(tw, device), _planes(_dft_np(n1, inverse).T, device))


def _cmatmul(ar, ai, br, bi, tier):
    """(ar + i·ai) @ (br + i·bi) as four real products at ``tier``."""
    mm = matrix._matmul
    return (mm(ar, br, tier) - mm(ai, bi, tier),
            mm(ar, bi, tier) + mm(ai, br, tier))


def fft_matmul_1d(x: torch.Tensor, inverse: bool = True,
                  mode: str = "four_step",
                  precision: str = "float32") -> torch.Tensor:
    """Unnormalized (i)DFT of complex x [..., N] along the last axis."""
    if precision not in _TIERS:
        raise ValueError(f"precision must be one of {tuple(_TIERS)}, "
                         f"got {precision!r}")
    if mode not in ("four_step", "direct"):
        raise ValueError(f"bad mode {mode!r}")
    tier = _TIERS[precision]
    n = x.shape[-1]
    re, im = x.real.float(), x.imag.float()
    if mode == "direct" or n < 16 or _split_n(n)[1] == 1:
        fr, fi = _direct_tables(n, bool(inverse), x.device)
        return torch.complex(*_cmatmul(re, im, fr, fi, tier))
    n1, n2, (f2r, f2i), (twr, twi), (f1r, f1i) = _four_step_tables(
        n, bool(inverse), x.device)
    batch = x.shape[:-1]
    # B = F_{N2} @ A, contracting n2
    br, bi = _cmatmul(f2r, f2i, re.reshape(batch + (n2, n1)),
                      im.reshape(batch + (n2, n1)), tier)
    # C = B ⊙ T, then D = C @ F_{N1}ᵀ, contracting n1
    dr, di = _cmatmul(br * twr - bi * twi, br * twi + bi * twr, f1r, f1i,
                      tier)
    # X[k2 + N2·k1] = D[k2, k1]
    return torch.complex(dr.transpose(-1, -2).reshape(batch + (n,)),
                         di.transpose(-1, -2).reshape(batch + (n,)))


def ifft2_matmul(x: torch.Tensor, mode: str = "four_step",
                 precision: str = "float32") -> torch.Tensor:
    """Unnormalized inverse FFT over the last two axes."""
    x = fft_matmul_1d(x, True, mode, precision)
    x = fft_matmul_1d(x.transpose(-1, -2), True, mode, precision)
    return x.transpose(-1, -2)


def ifft1d_planes_lastaxis(re: torch.Tensor, im: torch.Tensor,
                           inverse: bool = True, precision: str = "float32"):
    """Unnormalized DFT along the last axis of (re, im) f32 [C, M, N] →
    [C, M, N], the sharded half route's Nyquist row pass. The JAX package
    runs it as an einsum four-step outside Pallas; here it is the row
    kernel of the regime, as the single-card half route's Nyquist row
    (planes.c2r_fold_columns): the natural store beyond
    MAX_TRANSPOSED_N, else the transposed store (whose [C, N, 1] output is
    the [C, 1, N] row with no copy). On a CPU tensor each runs its plain
    version."""
    from tpu_ocean_torch.fft import planes
    if re.shape[-1] > planes.MAX_TRANSPOSED_N:
        return planes.fft1d_natural_large(re, im, inverse, precision)
    yr, yi = planes.fft1d_transposed(re, im, inverse, precision)
    if re.shape[-2] == 1:
        return yr.reshape(re.shape), yi.reshape(im.shape)
    return (yr.transpose(-1, -2).contiguous(),
            yi.transpose(-1, -2).contiguous())
