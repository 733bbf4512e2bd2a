"""Plain PyTorch versions of the matrix-form DFT engine
(``csrc/dft_matrix.cuh``), of the bf16 row kernel
(``csrc/dft_bf16_rows.cuh``) and of the f32 three-factor row kernel
(``csrc/dft_split3_f32.cuh``): the row DFT as Bailey's four-step N = n2·n1,
two complex matrix products with the f32 twiddle between them, at a
precision tier, in the direct or the three-factor form.

JAX counterparts: ``tpu_ocean/fft/pallas_fft.py`` ``_gauss_cmul`` /
``_dot_mid`` (the products at DEFAULT or at the bf16x3 tier B3),
``_stage2_split3`` (stage 2 as 128 = 8·16) and ``_rowfft_core``. The tiers:

- ``f32``: operands as they are, products in float32;
- ``bf16``: each operand rounded to bfloat16 (round to nearest even, as
  XLA rounds), products accumulated in float32: a DEFAULT dot on the MXU;
- ``bf16x3``: each operand split into hi + lo bfloat16 parts, keeping
  hi·hi + hi·lo + lo·hi (``_split_bf16``, ``_dot_mid``), on the stage-2
  contractions only; stage 1 (F2, depth n2) runs at f32, as the TPU
  kernels run it at B3 (``p1 = HIGHEST``).

The complex products take four real products (re = Fr·xr − Fi·xi, im =
Fi·xr + Fr·xi), as the kernel's real-form ``mma`` does, not Gauss's three,
whose (Fr + Fi)·(xr + xi) would round other sums to bf16. Products run in
float32 with TF32 off (on the card they refuse to run otherwise). The
fft/planes.py and ops/fused_spectrum.py wrappers call these for CPU
tensors; the card's main path never does.
"""

from __future__ import annotations

import torch

_SPLIT_W, _SPLIT_U = 8, 16           # 128 = W·U; t = w·U + u, k1 = a·W + b


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 → nearest bfloat16 (ties to even) → f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """x (f32) → (hi, lo) as f32 values of bfloat16s, hi + lo ≈ x to
    ~2⁻¹⁶ relative (pallas_fft._split_bf16)."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def require_f32_matmul(t: torch.Tensor, what: str) -> None:
    """Raise if a matmul on ``t``'s device could take TF32 products."""
    if t.is_cuda and (torch.get_float32_matmul_precision() != "highest"
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(f"{what} need f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False "
                           "and the float32 matmul precision to 'highest'")


def _matmul(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """Real a [m, k] · b [..., k, n] at ``tier``, accumulated in f32."""
    # TF32 would round away the bf16x3 lo parts and the f32 products
    require_f32_matmul(a, "the matrix engine's plain versions")
    if tier == "f32":
        return a @ b
    if tier == "bf16":
        return round_bf16(a) @ round_bf16(b)
    if tier == "bf16x3":
        ah, al = split_bf16(a)
        bh, bl = split_bf16(b)
        return ah @ bh + ah @ bl + al @ bh
    raise ValueError(f"unknown tier {tier!r}")


def _cmatmul(fr, fi, xr, xi, tier: str):
    """Complex (fr + i·fi) [m, k] · (xr + i·xi) [..., k, n]."""
    return (_matmul(fr, xr, tier) - _matmul(fi, xi, tier),
            _matmul(fi, xr, tier) + _matmul(fr, xi, tier))


def _twiddle(cr, ci, wr, wi):
    return cr * wr - ci * wi, cr * wi + ci * wr


def rows_dft(re: torch.Tensor, im: torch.Tensor, tables, split3_tables,
             tier: str):
    """Row DFT of (re, im) f32 [C, M, N] → natural order [C, M, N].

    ``tables``: (n1, n2, F2r, F2i, Tr, Ti, F1r, F1i), numpy f32
    (planes._tables_np); ``split3_tables``: None for the direct form, else
    (F_Wr, F_Wi, TWr, TWi, F_Ur, F_Ui) (planes._split3_tables_np), the
    three-factor stage 2."""
    n1, n2, *mats = tables
    dev = re.device
    f2r, f2i, twr, twi, f1r, f1i = (torch.from_numpy(a).to(dev) for a in mats)
    c, m, n = re.shape
    # stage 1: C[k2, t] = Σ_s F2[k2, s] x[s·n1 + t], then C ⊙ T; at f32
    # in the bf16x3 tier, as the TPU kernels keep it
    cr, ci = _cmatmul(f2r, f2i, re.reshape(c, m, n2, n1),
                      im.reshape(c, m, n2, n1),
                      "f32" if tier == "bf16x3" else tier)
    cr, ci = _twiddle(cr, ci, twr, twi)                 # [c, m, k2, t]
    if split3_tables is None:
        # stage 2: X[k1, k2] = Σ_t F1[k1, t] C[k2, t]
        dr, di = _cmatmul(f1r, f1i, cr.transpose(-1, -2),
                          ci.transpose(-1, -2), tier)   # [c, m, k1, k2]
        return dr.reshape(c, m, n), di.reshape(c, m, n)
    fwr, fwi, t3r, t3i, fur, fui = (torch.from_numpy(a).to(dev)
                                    for a in split3_tables)
    w, u = _SPLIT_W, _SPLIT_U
    # B[b, u] = Σ_w F_W[b, w] C[k2, w·U + u], then B ⊙ TW
    br, bi = _cmatmul(fwr, fwi, cr.reshape(c, m, n2, w, u),
                      ci.reshape(c, m, n2, w, u), tier)  # [c, m, k2, b, u]
    br, bi = _twiddle(br, bi, t3r, t3i)
    # X[a·W + b, k2] = Σ_u F_U[a, u] B[b, u]
    dr, di = _cmatmul(fur, fui, br.transpose(-1, -2), bi.transpose(-1, -2),
                      tier)                              # [c, m, k2, a, b]
    return (dr.permute(0, 1, 3, 4, 2).reshape(c, m, n),
            di.permute(0, 1, 3, 4, 2).reshape(c, m, n))
