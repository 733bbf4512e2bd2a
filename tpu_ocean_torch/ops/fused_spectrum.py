"""Fused spectrum assembly + row DFT, and the 2-D routes built on it.

JAX counterpart: ``tpu_ocean/ops/fused_spectrum_fft.py``
(``assemble_rowfft``, ``assemble_rowfft_natural``, ``ifft2_fused_planes``,
``ifft2_fused_planes_half``). The evolved spectrum channel is assembled from
the h0 pair and the phase inside the row-DFT kernel, so it never makes a
round trip through device memory:

- ``assemble_rowfft``: assembly + row DFT, transposed store → [ch, N, M];
- ``assemble_rowfft_natural``: the same, natural store → [ch, M, N], the
  row pass of the natural regime (N > ``planes.MAX_TRANSPOSED_N``).

Three channel sets, as the JAX kernels' ``packed`` and ``nch_live``: the
Hermitian-packed channels with 3 live fields (stencil normals, 2 channels)
or 5 (spectral normals, 3 channels), and the 5 per-channel spectra
(``packed=False``: height, disp_x, disp_z, slope_x, slope_z).

On a CUDA tensor each launches its hand-written kernel
(``csrc/fused_rows.cu``; at f32 in the direct form the natural store
``csrc/fused_rows_natural_f32.cuh`` and the transposed store
``csrc/fused_rows_transposed_f32.cuh``, every channel of a launch from
one read of the inputs; the bf16 natural store
``csrc/fused_rows_natural_bf16.cuh``, the bf16 row kernel's stages behind
the assembly) and nothing else; on a CPU tensor it runs its
plain version: ``_assemble_plain`` (the kernel's f32 arithmetic in torch,
in the order of the JAX ``_assemble_block``; it does not use the float64
``pack`` or ``coeffs`` tables, which differ in the last bits) followed by
the row DFT's plain version (``planes.rows_plain``). ``precision`` picks
the row DFT's tier and form as in fft/planes.py (``planes.engine``): the
transposed store takes the three-factor form of ``_fused_kernel_split3``
(#5b) where ``planes.use_split3`` says so; the assembly is the same at
every tier. The JAX package's TPU-only reroutes (the ``n % 256`` and
``HALF_MIN_PALLAS_N`` guards) are Mosaic rules and have no counterpart
here.

The fused kernels take no gradient: the JAX package gives them no VJP
(``jax.grad`` through ``fft_backend="pallas_fused"`` fails), so both
entries raise NotImplementedError on either device when autograd would
record them (``planes.refuse_grad``), rather than hand back a graph cut at
the kernel. ``fft_backend="pallas"`` is the differentiable backend.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ocean_torch import _build
from tpu_ocean_torch.evolve import assemble_spectra_packed_real
from tpu_ocean_torch.fft import planes

#: the per-channel spectra (``packed=False``)
NUM_CHANNELS = 5


def channel_count(packed: bool, nch_live: int) -> int:
    """Channels of a set: packed with 3 live fields 2, with 5 live fields
    3; per-channel 5."""
    if nch_live not in (3, 5):
        raise ValueError(f"nch_live must be 3 or 5, got {nch_live}")
    if not packed:
        return NUM_CHANNELS
    return 2 if nch_live == 3 else 3


def channel_set(packed: bool, nch_live: int) -> str:
    """The set's tag in a launch's count name (planes.kernel_name): "" for
    packed with 3 live fields, "packed5", or "per_channel"."""
    if not packed:
        return "per_channel"
    return "" if nch_live == 3 else f"packed{nch_live}"


@functools.lru_cache(maxsize=16)
def _kz_table(n: int, length: float, device: torch.device) -> torch.Tensor:
    """kz along a row, [N] f32: 2π·wrapped(j)/L built in float64 and cast
    once (fused_spectrum_fft.py:327-331)."""
    idx = np.arange(n, dtype=np.float64)
    wrapped = np.where(idx < n / 2.0, idx, idx - n)
    return torch.from_numpy((2.0 * np.pi * wrapped / length)
                            .astype(np.float32)).to(device)


def _check_inputs(h0_planes, phase, ch_start, ch_count, packed, nch_live):
    planes.refuse_grad(
        "the fused assembly + row DFT (fft_backend=\"pallas_fused\")",
        (*h0_planes, phase), "fused")
    channels = channel_count(packed, nch_live)
    if not (0 <= ch_start and ch_count >= 1
            and ch_start + ch_count <= channels):
        raise ValueError(f"channels {ch_start}..{ch_start + ch_count - 1} "
                         f"outside the {channels} channels of packed="
                         f"{packed}, nch_live={nch_live}")
    inputs = (*h0_planes, phase)
    if len(inputs) != 5:
        raise ValueError("h0_planes must be the 4 planes (h0r, h0i, h0cr, h0ci)")
    for p in inputs:
        if p.dtype != torch.float32:
            raise TypeError(f"inputs must be float32, got {p.dtype}")
        if p.dim() != 2 or p.shape != phase.shape or p.numel() == 0:
            raise ValueError(f"inputs must be five non-empty [M, N] planes of "
                             f"one shape, got {[tuple(q.shape) for q in inputs]}")
        if p.device != phase.device:
            raise ValueError(f"inputs on two devices: {phase.device}, {p.device}")
        if not p.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if phase.shape[1] % 2:
        raise ValueError(f"N must be even, got {phase.shape[1]}")


def _assemble_plain(h0_planes, phase, length: float, dz_sign: float, *,
                    epsilon: float, row_offset: int, ch: int,
                    packed: bool = True, nch_live: int = 3):
    """Channel ``ch`` of the set (packed: P = (A − iB)·h̃; per-channel:
    K_ch·h̃) over the rows of ``phase`` ([M, N], global rows
    row_offset..), computed as the kernel computes it: (re, im) f32 [M, N]."""
    h0r, h0i, h0cr, h0ci = h0_planes
    m, n = phase.shape
    dev = phase.device
    c, s = torch.cos(phase), torch.sin(phase)
    htr = (h0r + h0cr) * c + (h0ci - h0i) * s
    hti = (h0i + h0ci) * c + (h0r - h0cr) * s
    row = np.arange(m) + int(row_offset)
    wrapped = np.where(row < n // 2, row, row - n)
    # f32(2π/L)·f32(wrapped), one f32 rounding, as in the kernel
    kx = np.float32(2.0 * np.pi / length) * wrapped.astype(np.float32)
    kx = torch.from_numpy(kx[:, None]).to(dev)
    kz = _kz_table(n, float(length), dev)[None, :]
    kmag2 = kx * kx + kz * kz
    eps = np.float32(epsilon)
    invk = torch.where(kmag2 < float(eps * eps), 0.0, torch.rsqrt(kmag2))
    dz = float(np.float32(dz_sign))
    w = [float(ch == i) for i in range(NUM_CHANNELS)]
    if not packed:
        k = (w[0] * 1.0 + w[1] * kx * invk + w[2] * dz * kz * invk
             + w[3] * (-kx) + w[4] * (-kz))
        return k * htr, k * hti
    rowmask = torch.from_numpy(
        (wrapped != -(n // 2)).astype(np.float32)[:, None]).to(dev)
    colmask = (torch.arange(n, device=dev) != n // 2).to(torch.float32)[None, :]
    rx = kx * invk * rowmask
    rz = dz * kz * invk * colmask
    if nch_live == 5:
        a = w[0] * (1.0 + rx) + w[1] * (-kx) * rowmask
        b = w[1] * rz + w[2] * (-kz) * colmask
    else:
        a = w[0] * (1.0 + rx)
        b = w[1] * rz
    return a * htr + b * hti, a * hti - b * htr


def _fused_plain(natural: bool, h0_planes, phase, length, dz_sign, *,
                 inverse, epsilon, row_offset, ch_start, ch_count, packed,
                 nch_live, precision):
    row_fft = (planes.fft1d_natural_large_plain if natural
               else planes.fft1d_transposed_plain)
    outs = [row_fft(*(p[None] for p in _assemble_plain(
                h0_planes, phase, length, dz_sign, epsilon=epsilon,
                row_offset=row_offset, ch=ch, packed=packed,
                nch_live=nch_live)), inverse, precision)
            for ch in range(ch_start, ch_start + ch_count)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def assemble_rowfft_plain(h0_planes, phase, length: float, dz_sign: float, *,
                          epsilon: float, ch_count: int, inverse: bool = True,
                          row_offset: int = 0, ch_start: int = 0,
                          packed: bool = True, nch_live: int = 3,
                          precision: str = "float32"):
    """Plain version of assemble_rowfft."""
    _check_inputs(h0_planes, phase, ch_start, ch_count, packed, nch_live)
    return _fused_plain(False, h0_planes, phase, length, dz_sign,
                        inverse=inverse, epsilon=epsilon,
                        row_offset=row_offset, ch_start=ch_start,
                        ch_count=ch_count, packed=packed, nch_live=nch_live,
                        precision=precision)


def assemble_rowfft_natural_plain(h0_planes, phase, length: float,
                                  dz_sign: float, *, epsilon: float,
                                  ch_count: int, inverse: bool = True,
                                  row_offset: int = 0, ch_start: int = 0,
                                  packed: bool = True, nch_live: int = 3,
                                  precision: str = "float32"):
    """Plain version of assemble_rowfft_natural."""
    _check_inputs(h0_planes, phase, ch_start, ch_count, packed, nch_live)
    return _fused_plain(True, h0_planes, phase, length, dz_sign,
                        inverse=inverse, epsilon=epsilon,
                        row_offset=row_offset, ch_start=ch_start,
                        ch_count=ch_count, packed=packed, nch_live=nch_live,
                        precision=precision)


def _launch(natural: bool, h0_planes, phase, length, dz_sign, *,
            inverse, epsilon, row_offset, ch_start, ch_count, packed,
            nch_live, precision):
    """Launches the natural or the transposed fused entry at the tier and
    form of its pass, and counts the launch."""
    store = "natural" if natural else "transposed"
    entry = f"tpu_fused_rows_{store}"
    m, n = phase.shape
    dev = phase.device
    tier, split3 = planes.engine(n, precision, transposed=not natural)
    planes.require_card_kernel(n, tier, split3, fused=True)
    kernels = _build.load()
    out_shape = (ch_count, m, n) if natural else (ch_count, n, m)
    out_re = torch.empty(out_shape, dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    kz = _kz_table(n, float(length), dev)
    tables = planes.fused_tables(n, inverse, tier, split3, natural, dev)
    rows = planes.fused_rows(ch_count, m, n, planes.sm_count(dev), natural,
                             tier, split3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(kernels.lib, entry)(
            *(p.data_ptr() for p in (*h0_planes, phase)), kz.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), tables.data_ptr(),
            ch_count, ch_start, m, n, rows, int(row_offset), int(packed),
            int(nch_live), planes.TIERS[tier], int(split3),
            float(np.float32(2.0 * np.pi / length)),
            float(np.float32(dz_sign)), float(np.float32(epsilon)), stream)
    kernels.check(err, entry)
    planes.count_launch(assemble_rowfft_natural if natural else assemble_rowfft,
                        f"fused_{store}", tier, split3,
                        channel_set(packed, nch_live))
    return out_re, out_im


def assemble_rowfft(h0_planes, phase, length: float, dz_sign: float, *,
                    epsilon: float, ch_count: int, inverse: bool = True,
                    row_offset: int = 0, ch_start: int = 0,
                    packed: bool = True, nch_live: int = 3,
                    precision: str = "float32"):
    """(h0r, h0i, h0cr, h0ci) f32 [M, N] + phase [M, N] → channels
    ch_start .. ch_start + ch_count − 1 of the set (``packed``,
    ``nch_live``; see channel_count), assembled and row-transformed,
    stored TRANSPOSED: (re, im) f32 [ch_count, N, M]. ``row_offset`` is the
    global row of the batch's first row; wavevectors come from ``length``
    (fft layout); ``dz_sign`` = −1 with the oracle's sign quirk."""
    _check_inputs(h0_planes, phase, ch_start, ch_count, packed, nch_live)
    kw = dict(inverse=inverse, epsilon=epsilon, row_offset=row_offset,
              ch_start=ch_start, ch_count=ch_count, packed=packed,
              nch_live=nch_live, precision=precision)
    if planes.on_cpu("assemble_rowfft", phase):
        return _fused_plain(False, h0_planes, phase, length, dz_sign, **kw)
    return _launch(False, h0_planes, phase, length, dz_sign, **kw)


def assemble_rowfft_natural(h0_planes, phase, length: float, dz_sign: float,
                            *, epsilon: float, ch_count: int,
                            inverse: bool = True, row_offset: int = 0,
                            ch_start: int = 0, packed: bool = True,
                            nch_live: int = 3, precision: str = "float32"):
    """assemble_rowfft with a NATURAL-order store: (re, im) f32
    [ch_count, M, N], for the natural regime's column pass along axis −2."""
    _check_inputs(h0_planes, phase, ch_start, ch_count, packed, nch_live)
    kw = dict(inverse=inverse, epsilon=epsilon, row_offset=row_offset,
              ch_start=ch_start, ch_count=ch_count, packed=packed,
              nch_live=nch_live, precision=precision)
    if planes.on_cpu("assemble_rowfft_natural", phase):
        return _fused_plain(True, h0_planes, phase, length, dz_sign, **kw)
    return _launch(True, h0_planes, phase, length, dz_sign, **kw)


#: f32 direct-form launches in the packed set with 3 live fields since the
#: last reset (the other sets count in planes.named_launches; CPU calls do
#: not count)
assemble_rowfft.launches = 0
assemble_rowfft_natural.launches = 0


def ifft2_fused_planes(h0_planes, phase, length: float, dz_sign: float, *,
                       epsilon: float, row_offset: int = 0,
                       ch_count: int | None = None, packed: bool = True,
                       nch_live: int = 3, precision: str = "float32"):
    """Fused 2-D unnormalized inverse transform of the first ``ch_count``
    channels of the set (default: all of them, channel_count): (re, im)
    f32 [ch_count, N, N]. Transposed regime: the fused transposed-store row
    pass and a transposed column pass; natural regime (N >
    MAX_TRANSPOSED_N): the fused natural-store row pass and the column pass
    along axis −2. One launch of each for all the channels."""
    if ch_count is None:
        ch_count = channel_count(packed, nch_live)
    kw = dict(epsilon=epsilon, row_offset=row_offset, ch_count=ch_count,
              packed=packed, nch_live=nch_live, precision=precision)
    if phase.shape[-1] > planes.MAX_TRANSPOSED_N:
        re, im = assemble_rowfft_natural(h0_planes, phase, length, dz_sign, **kw)
        return planes.ifft1d_planes_axis2(re, im, True, precision)
    re, im = assemble_rowfft(h0_planes, phase, length, dz_sign, **kw)
    return planes.fft1d_transposed(re, im, True, precision)


def ifft2_fused(h0_planes, phase, length: float, dz_sign: float, *,
                epsilon: float = 1e-4, ch_count: int = NUM_CHANNELS,
                packed: bool = False, nch_live: int = 3,
                precision: str = "float32") -> torch.Tensor:
    """ifft2_fused_planes joined into complex64 [ch_count, N, N]: the
    complex state's fused transform (fused_spectrum_fft.ifft2_fused, whose
    defaults it takes: the per-channel set, all five channels)."""
    re, im = ifft2_fused_planes(h0_planes, phase, length, dz_sign,
                                epsilon=epsilon, ch_count=ch_count,
                                packed=packed, nch_live=nch_live,
                                precision=precision)
    return torch.complex(re, im)


def ifft2_fused_planes_half(h0_planes, phase, length: float, dz_sign: float,
                            pack_nyq, *, epsilon: float,
                            ch_count: int | None = None, nch_live: int = 3,
                            precision: str = "float32"):
    """Fused-assembly twin of planes.ifft2_planes_half for the packed
    channel set with ``nch_live`` live fields: returns (re_full, im_full)
    f32 [ch_count − 1, N, N] and ``last`` f32 [N, N], the real field of the
    last packed channel (``ch_count`` defaults to all the packed channels:
    2 with 3 live fields, 3 with 5).

    The first ch_count − 1 channels take the full fused pipeline. The last
    channel's spectrum is exactly Hermitian (A = 0 in the packed
    coefficients, after symmetrize), so its fused row pass covers spectral
    rows 0..N/2−1 only (the first N/2 rows of the inputs, row_offset 0);
    the Nyquist spectral row N/2 is assembled in torch from ``pack_nyq``
    (row N/2 of the float64-built packed table for ``nch_live``,
    [2P, 1, N]); then the C2R fold, the length-N/2 column pass and the
    interleave (planes.c2r_fold_columns). Both regimes, as
    ifft2_fused_planes."""
    if ch_count is None:
        ch_count = channel_count(True, nch_live)
    n = phase.shape[-1]
    if phase.shape != (n, n):
        raise ValueError(f"phase must be [N, N], got {tuple(phase.shape)}")
    mh = n // 2
    natural = n > planes.MAX_TRANSPOSED_N
    row_pass = assemble_rowfft_natural if natural else assemble_rowfft
    kw = dict(epsilon=epsilon, nch_live=nch_live, precision=precision)

    re_f, im_f = ifft2_fused_planes(h0_planes, phase, length, dz_sign,
                                    ch_count=ch_count - 1, **kw)
    # half channel: fused row pass over the Hermitian half 0..N/2−1 (the
    # leading rows of contiguous planes are contiguous views)
    yr, yi = row_pass(tuple(p[:mh] for p in h0_planes), phase[:mh], length,
                      dz_sign, ch_start=ch_count - 1, ch_count=1, **kw)
    # Nyquist spectral row (global row N/2): one-row torch assembly of every
    # packed channel, of which the last is kept
    nr, ni = assemble_spectra_packed_real(
        tuple(p[mh:mh + 1] for p in h0_planes), phase[mh:mh + 1], pack_nyq)
    last = planes.c2r_fold_columns(yr, yi, nr[-1:].contiguous(),
                                   ni[-1:].contiguous(), natural,
                                   precision=precision)
    return re_f, im_f, last[0]
