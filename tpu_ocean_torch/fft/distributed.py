"""The domain-decomposed 2-D inverse DFT: local row passes, an all_to_all
transpose, local column passes.

JAX counterpart: ``tpu_ocean/fft/distributed.py``, function for function,
with a process group (``group``) in place of a shard_map axis name. The
decomposition over D ranks of ``group``:

    input  [C, X, Z] split on X (each rank holds N/D contiguous rows)
    1. local 1-D inverse DFT along Z (rows are whole);
    2. all_to_all: Z split into D tiles, exchanged, concatenated along X
       → [C, X, Z] split on Z (each rank holds N/D columns, every row);
    3. local 1-D inverse DFT along X (columns are whole);
    output split on Z, the layout the fields and their halo ring take.

On the plane backends the passes are the row-DFT kernels of fft/planes.py
(#1 transposed store, #2 natural store beyond ``planes.MAX_TRANSPOSED_N``)
at the shard's shapes; each launches its kernel on a CUDA tensor and runs
its plain version on a CPU one. The collectives are
``parallel/collectives.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.fft.matmul import fft_matmul_1d, ifft1d_planes_lastaxis
from tpu_ocean_torch.fft.stockham import fft_stockham_1d
from tpu_ocean_torch.parallel.collectives import all_gather, all_to_all


def _ifft1d_local(x: torch.Tensor, backend: str,
                  precision: str = "float32") -> torch.Tensor:
    """Unnormalized inverse DFT of complex ``x`` along the last axis with a
    local backend; ``precision`` reaches ``matmul`` only (reference and
    stockham are full precision)."""
    if backend == "reference":
        return torch.fft.ifft(x, dim=-1, norm="forward")
    if backend == "stockham":
        return fft_stockham_1d(x, inverse=True)
    if backend == "matmul":
        return fft_matmul_1d(x, inverse=True, precision=precision)
    raise ValueError(f"unknown local backend {backend!r}")


def _in_chunks(fn, re, im, overlap_chunks: int):
    """``fn`` on each of ``overlap_chunks`` channel ranges of (re, im), the
    results concatenated; ``overlap_chunks`` must divide the channels."""
    c = re.shape[0]
    if overlap_chunks > 1 and c % overlap_chunks != 0:
        raise ValueError(f"overlap_chunks={overlap_chunks} must divide the "
                         f"channel batch ({c})")
    if overlap_chunks <= 1:
        return fn(re, im)
    parts = [fn(r, i) for r, i in zip(re.chunk(overlap_chunks),
                                      im.chunk(overlap_chunks))]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _ifft2_x_sharded_pallas(x: torch.Tensor, group, overlap_chunks: int = 1,
                            precision: str = "float32") -> torch.Tensor:
    """ifft2_x_sharded_planes on a complex tensor [..., X/D, N] → [..., X,
    N/D]: split into (re, im) f32 planes and joined again."""
    lead = x.shape[:-2]
    m, n = x.shape[-2], x.shape[-1]
    re = x.real.float().reshape(-1, m, n).contiguous()
    im = x.imag.float().reshape(-1, m, n).contiguous()
    re, im = ifft2_x_sharded_planes(re, im, group, overlap_chunks, precision)
    return torch.complex(re, im).reshape(lead + re.shape[-2:])


def ifft2_x_sharded_planes(re: torch.Tensor, im: torch.Tensor, group,
                           overlap_chunks: int = 1,
                           precision: str = "float32"):
    """(re, im) f32 [C, X/D, N] row-split spectra → [C, X, N/D] column-split
    spatial planes, in two regimes:

      N ≤ MAX_TRANSPOSED_N: #1 (transposed store) → [C, N, X/D], the
        all_to_all with split −2, concat −1 → [C, N/D, X], #1 again
        → [C, X, N/D]; no transposing copy anywhere;
      beyond: #2 (natural store) → [C, X/D, N], the all_to_all with split
        −1, concat −2 → [C, X, N/D], then the column pass along axis −2
        (planes.ifft1d_planes_axis2).

    ``overlap_chunks`` > 1 transforms and exchanges the channels in that
    many ranges (one collective each); the result is the same."""
    natural = re.shape[-1] > planes.MAX_TRANSPOSED_N
    d = dist.get_world_size(group)

    def row_pass_and_transpose(re_c, im_c):
        if natural:
            re_c, im_c = planes.fft1d_natural_large(re_c, im_c, True,
                                                    precision)
        else:
            re_c, im_c = planes.fft1d_transposed(re_c, im_c, True, precision)
        if d > 1:
            # one collective for both planes
            both = all_to_all(torch.stack([re_c, im_c]), group,
                              3 if natural else 2, 2 if natural else 3)
            re_c, im_c = both[0], both[1]
        return re_c, im_c

    re, im = _in_chunks(row_pass_and_transpose, re, im, overlap_chunks)
    if natural:
        return planes.ifft1d_planes_axis2(re, im, True, precision)
    return planes.fft1d_transposed(re, im, True, precision)


def _half_row_perm(d: int, b: int) -> np.ndarray:
    """The inverse permutation that restores natural k1 order after the
    mirror-balanced all_to_all (``d`` ranks, ``b`` rows a rank): rank
    i < d/2 contributes global rows [i·b, i·b + b/2), rank i ≥ d/2 (mirror
    e = d − 1 − i) rows [e·b + b/2, (e + 1)·b); together a disjoint cover
    of [0, d·b/2)."""
    perm = []
    for i in range(d):
        if i < d // 2:
            perm.extend(range(i * b, i * b + b // 2))
        else:
            e = d - 1 - i
            perm.extend(range(e * b + b // 2, (e + 1) * b))
    return np.argsort(np.asarray(perm))


def _negflip_z(x: torch.Tensor) -> torch.Tensor:
    """x at (−j) mod N along the last axis."""
    return torch.roll(torch.flip(x, (-1,)), 1, -1)


def ifft2_x_sharded_half(re: torch.Tensor, im: torch.Tensor, group,
                         precision: str = "float32") -> torch.Tensor:
    """Mirror-balanced sharded half-spectrum (C2R) transform, the sharded
    twin of planes.ifft2_planes_half.

    Input: (re, im) f32 [1, N/D, N], the row-split last packed channel,
    exactly Hermitian (S[k1, k2] = conj(S[−k1, −k2])). Output: [1, N, N/D],
    the column-split real plane, the layout ifft2_x_sharded_planes gives.

    Spectral rows 0..N/2 carry the information but lie on the lower half
    of the ranks. Each upper rank builds the partner rows it can from the
    symmetry, S[N − r, j] = conj(S[r, (−j) mod N]), a conj and z-flip of
    rows it holds: rank i < D/2 row-transforms its rows [0, B/2) directly,
    rank i ≥ D/2 the partners of its rows [1, B/2] in reversed order, so
    every rank runs B/2 = N/(2D) rows and the all_to_all moves half the
    full channel's volume. After it the k1 axis is whole: the inverse
    permutation (_half_row_perm) restores natural row order, then the C2R
    fold (planes._c2r_combine), the length-N/2 column pass and the even/odd
    interleave. The Nyquist row (global row N/2, row 0 of rank D/2) is
    all-gathered and row-transformed on every rank (ifft1d_planes_lastaxis),
    and each rank keeps its columns of it. JAX selects a rank's rows with
    ``jnp.where`` for SPMD uniformity; here each rank takes its own branch.
    At D = 1 this is planes.ifft2_planes_half. D must be 1 or even (the
    solver checks)."""
    c, b, n = re.shape
    d = dist.get_world_size(group)
    mh = n // 2
    nloc = n // d
    if d == 1:
        return planes.ifft2_planes_half(re[:, :mh + 1], im[:, :mh + 1], True,
                                        precision)
    rank = dist.get_rank(group)
    h = b // 2
    # the Nyquist spectral row to every rank: [D, 2, 1, 1, N]
    rows = all_gather(torch.stack([re[:, :1], im[:, :1]]), group)
    nyr, nyi = ifft1d_planes_lastaxis(rows[d // 2, 0].contiguous(),
                                      rows[d // 2, 1].contiguous(), True,
                                      precision)                 # [1, 1, N]
    z0 = rank * nloc
    nyr, nyi = nyr[..., z0:z0 + nloc], nyi[..., z0:z0 + nloc]
    if rank < d // 2:
        sel_re, sel_im = re[:, :h].contiguous(), im[:, :h].contiguous()
    else:
        # partners of local rows 1..B/2: conj + z-negflip, reversed so the
        # batch ascends in global k1
        sel_re = torch.flip(_negflip_z(re[:, 1:h + 1]), (1,)).contiguous()
        sel_im = (-torch.flip(_negflip_z(im[:, 1:h + 1]), (1,))).contiguous()
    inv = torch.as_tensor(_half_row_perm(d, b), device=re.device)
    if n > planes.MAX_TRANSPOSED_N:
        yr, yi = planes.fft1d_natural_large(sel_re, sel_im, True,
                                            precision)          # [1, B/2, N]
        both = all_to_all(torch.stack([yr, yi]), group, 3, 2)   # [2, 1, M, N/D]
        yr = both[0].index_select(-2, inv)
        yi = both[1].index_select(-2, inv)
        vr, vi = planes._c2r_combine(yr, yi, nyr, nyi, True, axis=-2)
        xr, xi = planes.half_column_pass(vr, vi, mh, True, precision)
    else:
        yr, yi = planes.fft1d_transposed(sel_re, sel_im, True,
                                         precision)             # [1, N, B/2]
        both = all_to_all(torch.stack([yr, yi]), group, 2, 3)   # [2, 1, N/D, M]
        yr = both[0].index_select(-1, inv)
        yi = both[1].index_select(-1, inv)
        vr, vi = planes._c2r_combine(yr, yi, nyr.transpose(-1, -2),
                                     nyi.transpose(-1, -2), True, axis=-1)
        xr, xi = planes.fft1d_transposed(vr.contiguous(), vi.contiguous(),
                                         True, precision)       # [1, M, N/D]
    # x[2m] = Re v[m], x[2m+1] = Im v[m]: the even/odd row interleave
    return torch.stack([xr, xi], dim=2).reshape(c, n, nloc)


def ifft2_x_sharded(x: torch.Tensor, group, backend: str = "reference",
                    overlap_chunks: int = 1,
                    precision: str = "float32") -> torch.Tensor:
    """Complex [..., X/D, N] row-split spectra → [..., X, N/D] column-split
    spatial fields. ``backend`` "pallas" takes the planes route
    (ifft2_x_sharded_planes); "reference", "stockham" and "matmul" run
    their 1-D transform on each rank around the all_to_all.
    ``overlap_chunks`` > 1 splits the leading channel axis into that many
    ranges, each transformed and exchanged before the column passes; the
    result is the same."""
    if backend == "pallas":
        return _ifft2_x_sharded_pallas(x, group, overlap_chunks, precision)
    if overlap_chunks > 1 and (x.dim() < 3
                               or x.shape[0] % overlap_chunks != 0):
        raise ValueError(f"overlap_chunks={overlap_chunks} must divide the "
                         f"leading channel axis (shape {tuple(x.shape)})")
    parts = x.chunk(overlap_chunks) if overlap_chunks > 1 else [x]
    # every range's row pass and transpose before any column pass
    transposed = [_transpose_x_to_z(_ifft1d_local(p, backend, precision),
                                    group) for p in parts]
    outs = [_ifft1d_local(p.transpose(-1, -2), backend,
                          precision).transpose(-1, -2) for p in transposed]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _transpose_x_to_z(x: torch.Tensor, group) -> torch.Tensor:
    """[..., X/D, N] → [..., X, N/D] by the all_to_all (x at D = 1)."""
    return all_to_all(x, group, x.dim() - 1, x.dim() - 2)


def ifft2_channel_sharded(x: torch.Tensor, group, backend: str = "reference",
                          precision: str = "float32") -> torch.Tensor:
    """The channel-sharded variant: each rank holds C/D whole channels
    [C/D, N, N], transforms them with a local backend, and an all_gather
    rebuilds the channel stack [C, N, N] on every rank. No transpose
    collective."""
    x = _ifft1d_local(x, backend, precision)
    x = _ifft1d_local(x.transpose(-1, -2), backend, precision).transpose(-1, -2)
    if dist.get_world_size(group) > 1:
        x = all_gather(x, group, tiled=True)
    return x
