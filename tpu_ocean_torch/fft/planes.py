"""Inverse 2-D DFTs on (re, im) f32 planes: the full transform and the
half-spectrum (C2R) route.

JAX counterpart: ``tpu_ocean/fft/pallas_fft.py`` (``_fft1d_transposed``,
``ifft2_planes_auto``, ``ifft2_planes_half``, ``_c2r_combine``). Every pass
is ``fft1d_transposed``: a row DFT whose output is stored transposed, so a
second call transforms the columns and restores the orientation.

On a CUDA tensor ``fft1d_transposed`` launches the hand-written kernel
(``csrc/fft_rows.cu``) and nothing else; on a CPU tensor it runs its plain
version (``torch.fft``). The TPU package's size gates (Mosaic lane rules,
VMEM caps) have no counterpart here: the kernel covers every power-of-two
N in [MIN_N, MAX_N], and the wrapper refuses any other N.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ocean_torch import _build

#: transform lengths the row kernel takes: powers of two in this range. The
#: upper end is where two shared-memory buffers of one row plus the twiddle
#: table still fit one block (the card's 227 KB).
MIN_N = 16
MAX_N = 8192


def check_size(n: int) -> None:
    """Raise ValueError unless ``n`` is a transform length the kernel takes."""
    if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0):
        raise ValueError(f"fft1d_transposed needs a power-of-two length in "
                         f"[{MIN_N}, {MAX_N}], got {n}")


def rows_per_block(c: int, m: int, n: int, sms: int) -> int:
    """Rows one kernel block transforms: the power of two that gives about
    one block per SM for a [c, m, n] batch, at most 8 (32-byte transposed-
    store runs) and at most what fits two buffers in shared memory. A block
    takes about as long whatever its row count, so a batch that fills fewer
    SMs takes fewer rows per block (measured on the H100: the [1, 512, 1024]
    half-row pass runs faster at 4, the one-row Nyquist pass at 1)."""
    cap = 8 if n <= 1024 else 8192 // n
    target = -(-c * m // sms)
    rows = 1
    while rows < target and rows < cap:
        rows *= 2
    return rows


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=32)
def _twiddles(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """[N − 1, 2] f32 (cos, sin): the Stockham stage with span ns uses
    e^{±2πi k/(2ns)}, k < ns, stored at rows ns − 1 + k; built in float64."""
    sign = 1.0 if inverse else -1.0
    spans = 1 << np.arange(int(np.log2(n)))
    w = np.concatenate([np.exp(sign * 1j * np.pi * np.arange(ns) / ns)
                        for ns in spans])
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _check_planes(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"planes must be float32, got {re.dtype}, {im.dtype}")
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"planes must be two [C, M, N] tensors of one shape, "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    if re.device != im.device:
        raise ValueError(f"planes on two devices: {re.device}, {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    if re.numel() == 0:
        raise ValueError("planes are empty")


def fft1d_transposed_plain(re: torch.Tensor, im: torch.Tensor,
                           inverse: bool = True):
    """Plain version of fft1d_transposed: torch.fft along the last axis,
    unnormalized, transposed and split into planes."""
    z = torch.complex(re, im)
    if inverse:
        f = torch.fft.ifft(z, dim=-1, norm="forward")   # no 1/N on the inverse
    else:
        f = torch.fft.fft(z, dim=-1)
    f = f.transpose(-1, -2)
    return f.real.contiguous(), f.imag.contiguous()


def fft1d_transposed(re: torch.Tensor, im: torch.Tensor, inverse: bool = True):
    """Batched 1-D unnormalized DFT along the last axis of (re, im) f32
    [C, M, N], sign + for the inverse; returns (re, im) [C, N, M]:
    out[c, k, m] = Σ_n x[c, m, n]·e^{±2πi·nk/N}."""
    _check_planes(re, im)
    c, m, n = re.shape
    check_size(n)
    if re.device.type == "cpu":
        return fft1d_transposed_plain(re, im, inverse)
    if re.device.type != "cuda":
        raise ValueError(f"fft1d_transposed runs on cpu or cuda, not "
                         f"{re.device}")
    kernels = _build.load()
    out_re = torch.empty((c, n, m), dtype=torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    tw = _twiddles(n, bool(inverse), re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernels.lib.tpu_fft_rows_transposed(
            re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            tw.data_ptr(), c, m, n,
            rows_per_block(c, m, n, _sm_count(re.device)), stream)
    kernels.check(err, "fft_rows_transposed")
    fft1d_transposed.launches += 1
    return out_re, out_im


#: kernel launches since the last reset (CPU calls do not count)
fft1d_transposed.launches = 0


def ifft2_planes_auto(re: torch.Tensor, im: torch.Tensor, inverse: bool = True):
    """Full 2-D unnormalized transform of (re, im) [C, N, N] → [C, N, N]:
    two transposed row passes."""
    re, im = fft1d_transposed(re, im, inverse)
    return fft1d_transposed(re, im, inverse)


@functools.lru_cache(maxsize=32)
def _c2r_twiddles(m: int, inverse: bool, device: torch.device):
    """w[k] = e^{±2πi k/(2m)} for the C2R even/odd fold, f32 from float64."""
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.arange(m) / (2 * m))
    return (torch.from_numpy(w.real.astype(np.float32)).to(device),
            torch.from_numpy(w.imag.astype(np.float32)).to(device))


def _c2r_combine(yr, yi, nyqr, nyqi, inverse: bool):
    """V[k] = (Y + conj(G)) + i·w·(Y − conj(G)) along the LAST axis, with
    G[0] = the Nyquist planes (a size-1 last axis) and G[k] = Y[M − k]."""
    wc, ws = _c2r_twiddles(yr.shape[-1], bool(inverse), yr.device)
    gr = torch.cat([nyqr, torch.flip(yr[..., 1:], (-1,))], dim=-1)
    gi = torch.cat([nyqi, torch.flip(yi[..., 1:], (-1,))], dim=-1)
    pr, pi = yr + gr, yi - gi
    qr, qi = yr - gr, yi + gi
    return (pr - wc * qi - ws * qr,
            pi + wc * qr - ws * qi)


def ifft2_planes_half(re: torch.Tensor, im: torch.Tensor, inverse: bool = True):
    """Half-spectrum 2-D inverse transform: (re, im) [C, N/2+1, N], rows
    k1 = 0..N/2 of a Hermitian spectrum → the real field [C, N, N].

    With M = N/2 and Y[k] the row-transformed spectral row k:
        v[m] = x[2m] + i·x[2m+1] = Σ_{k<M} V[k]·e^{+2πi mk/M},
        V[k] = P[k] + i·w[k]·Q[k], w[k] = e^{+2πi k/N},
        P = Y + conj(G), Q = Y − conj(G), G[k] = Y[M−k], G[0] = Y[M].
    After the first (transposed) pass k1 is the LAST axis, so the fold runs
    on axis −1; the Nyquist row's [C, 1, N] pass yields [C, N, 1], which is
    its transposed form with no copy. The column pass has length M, and the
    even and odd output rows interleave."""
    if not inverse:
        raise NotImplementedError("the C2R fold is derived for the inverse "
                                  "transform (the solver's only direction)")
    c, mp1, n = re.shape
    m = mp1 - 1
    if 2 * m != n:
        raise ValueError(f"half-spectrum input must carry N/2+1 rows; "
                         f"got {mp1} for N={n}")
    nyr, nyi = fft1d_transposed(re[:, m:].contiguous(), im[:, m:].contiguous(),
                                inverse)                          # [C, N, 1]
    yr, yi = fft1d_transposed(re[:, :m].contiguous(), im[:, :m].contiguous(),
                              inverse)                            # [C, N, M]
    vr, vi = _c2r_combine(yr, yi, nyr, nyi, inverse)
    xr, xi = fft1d_transposed(vr, vi, inverse)                    # [C, M, N]
    # x[2m] = Re v[m], x[2m+1] = Im v[m]
    return torch.stack([xr, xi], dim=2).reshape(c, n, n)
