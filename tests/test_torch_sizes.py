"""The sizes slice on the CPU: lengths that are not powers of two.

- The port against the JAX package (Pallas in interpret mode) from one
  injected h0: path (i)'s switches at N = 96 and 192 and in the natural
  regime at 96 (both packages' transposed-store cap forced to 32),
  ``pallas_fused`` at 96 with and without the half spectrum, the complex
  state on ``pallas`` at N = 106 = 2·53, and a CascadeSolver at 96; all
  10 steps (the cascade 3) within tests/test_packing.py's bands.
- The mixed-radix kernel's plan and table (fft.planes.mixed_plan,
  mixed_table, mixed_twiddles_np), emulated stage by stage in float64
  numpy as csrc/rows_mixed_f32.cuh indexes them, against np.fft at every
  length chip_smoke.py's phase 3 checks on the card, both directions:
  within 1e-12·max from the float64 table, 5e-7·max from the f32 one;
  and the same stages in complex64 with the generic stage's accumulators
  and folds, the model of the kernel's f32 sums that chose them.
  The kernel itself runs only on the card (tests/test_torch_sizes_cuda.py).
- The size rule on the card (fft.planes.require_card_kernel,
  check_card_sizes): every even length in [16, 8192] at every tier and
  form, fused or not (other lengths than powers of two at f32 direct on
  the mixed-radix kernels, at the rest on the matrix engine behind their
  loads and stores, tests/test_torch_sizes_matrix.py); odd lengths and
  those outside the range refused with ValueError at construction, before
  anything is allocated on the device.
"""

import numpy as np
import pytest
import torch

from tpu_ocean.fft import pallas_fft
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (OCEAN_DEMO, CascadeSolver, OceanSolver,
                             fields_to_numpy, state_from_numpy)
from tpu_ocean_torch.cascade import default_cascade
from tpu_ocean_torch.fft import planes
from tests.test_packing import _assert_fields_close
from tests.test_torch_cascade import pair, run_both
from tests.test_torch_solver import (SLICE, _h0_pair, _jax_config,
                                     _steps_against_jax,
                                     _ten_steps_against_jax)

#: the lengths chip_smoke.py's phase 3 holds the kernel to on the card:
#: the transposed store's, then the natural store's
PHASE3_LENGTHS = [48, 96, 106, 160, 224, 384, 768, 1536, 2042, 3072, 6144,
                  8186, 8190]
TIERS = [("f32", False), ("f32", True), ("bf16", False), ("bf16", True),
         ("bf16x3", False), ("bf16x3", True)]


# ------------------------------------------------------ against the JAX solver

@pytest.mark.parametrize("n", [96, 192])
def test_slice_steps_at_lengths_that_are_not_powers_of_two(n):
    """Path (i)'s switches step on the CPU (the size check no longer stands
    before the plain version) and match the JAX solver."""
    _, jf, ts, tf = _ten_steps_against_jax(n)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)
    assert int(ts.step) == 10


def test_natural_regime_at_96(monkeypatch):
    """N = 96 with both packages' transposed-store cap at 32: natural-store
    row passes of length 96, the axis −2 column pass, the half channel's
    length-48 columns."""
    monkeypatch.setattr(planes, "MAX_TRANSPOSED_N", 32)
    with pallas_fft.transposed_store_cap(32):
        _, jf, _, tf = _ten_steps_against_jax(96)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


@pytest.mark.parametrize("half", [True, False], ids=["half", "packed"])
def test_fused_at_96(half):
    """``pallas_fused`` runs its plain versions on the CPU at N = 96, as
    JAX runs its fused kernels there."""
    cfg = OCEAN_DEMO.replace(resolution=96)
    switches = dict(SLICE, fft_backend="pallas_fused", half_spectrum=half)
    del switches["real_state"]
    *_, jf, _, tf = _steps_against_jax(cfg, switches, 10, seed=96)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_complex_state_on_pallas_at_106():
    """N = 106 = 2·53 (the generic stage of a prime radix on the card):
    the complex state's ``pallas`` transform, the fields in torch (106 is
    not divisible by 8, so no fields kernel)."""
    cfg = OCEAN_DEMO.replace(resolution=106)
    ref = JaxSolver(_jax_config(cfg), fft_backend="pallas")
    port = OceanSolver(cfg, device="cpu", fft_backend="pallas")
    assert port.fft_backend == "pallas" and not port.real_state
    h0, h0c = _h0_pair(cfg, seed=106)
    js = ref.init(h0=h0, h0_conj=h0c)
    ts = state_from_numpy(js, "cpu")
    for _ in range(10):
        js, jf = ref.step(js, 1 / 60)
        ts, tf = port.step(ts, 1 / 60)
    _assert_fields_close(fields_to_numpy(tf), jf, 1e-5)


def test_cascade_at_96():
    """default_cascade's three bands at N = 96 on path (i)'s switches."""
    cfgs = default_cascade(n=96)
    ref, port, js, ts = pair(cfgs, **SLICE)
    run_both(ref, port, js, ts)


# ---------------------------------------------------- the plan and the table

def _pairwise(a):
    while len(a) > 1:
        a = a[0::2] + a[1::2]
    return a[0]


def _emulate(x, n, table, accumulators=1, rounds=0):
    """The kernel's stages on rows x [R, n] in x's dtype (complex128, or
    complex64 for the kernel's f32), reading ``table`` at the kernel's
    offsets: input r of butterfly j at j + r·n/P, twiddled (where ns > 1)
    by the entry at ns + (r − 1)·ns + k, k = j mod ns, output q at
    (j − k)·P + k + q·ns; radix 4 with ±i from entry 0; an odd prime p as
    Σ_t x_t·root[(t·q) mod p], term t in accumulator t mod K, the K summed
    pairwise into a total every ``rounds`` rounds of K terms (0: at the
    end only), as the kernel's generic stage sums."""
    sign = table[0].imag
    for (radix, ns), off in zip(planes.mixed_plan(n), planes.mixed_roots(n)):
        lanes = n // radix
        j = np.arange(lanes)
        k = j % ns
        v = [x[:, j + r * lanes] for r in range(radix)]
        if ns > 1:
            v = [v[0]] + [v[r] * table[ns + (r - 1) * ns + k]
                          for r in range(1, radix)]
        d = (j - k) * radix + k
        y = np.empty_like(x)
        if radix == 2:
            y[:, d], y[:, d + ns] = v[0] + v[1], v[0] - v[1]
        elif radix == 4:
            t0, t1, t2, t3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
            u = (sign * 1j * t3).astype(x.dtype)
            y[:, d], y[:, d + ns] = t0 + t2, t1 + u
            y[:, d + 2 * ns], y[:, d + 3 * ns] = t0 - t2, t1 - u
        else:
            q = np.arange(radix)
            roots = table[off:off + radix]
            acc = np.zeros((accumulators, radix) + v[0].shape, x.dtype)
            total = np.zeros_like(acc[0])
            for t in range(radix):
                acc[t % accumulators] += roots[(t * q) % radix][:, None, None] \
                    * v[t]
                if rounds and (t + 1) % (accumulators * rounds) == 0:
                    total += _pairwise(acc)
                    acc[:] = 0
            # [q, row, j]: output q of butterfly j
            out = total + _pairwise(acc)
            y[:, (d + q[:, None] * ns).ravel()] = \
                out.transpose(1, 0, 2).reshape(len(x), -1)
        x = y
    return x


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", PHASE3_LENGTHS)
def test_mixed_plan_and_table_emulated_against_numpy(n, inverse):
    rng = np.random.default_rng(n + inverse)
    x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    want = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
    scale = np.abs(want).max()
    exact = planes.mixed_table(n, inverse)
    assert np.abs(_emulate(x, n, exact) - want).max() <= 1e-12 * scale
    f32 = planes.mixed_twiddles_np(n, inverse).astype(np.float64)
    rounded = f32[:, 0] + 1j * f32[:, 1]
    assert np.abs(rounded - exact).max() <= 2 ** -24
    assert np.abs(_emulate(x, n, rounded) - want).max() <= 5e-7 * scale


@pytest.mark.parametrize("n,rows", [(2042, 256), (8186, 16)])
def test_the_generic_stage_needs_its_accumulators_in_f32(n, rows):
    """The kernel's f32 sums modelled in complex64 with the f32 table it
    reads (numpy rounds each product and sum where the kernel fuses them,
    so the model's error is of the kernel's order, not equal to it; its
    max over a few rows reads lower than the card's over thousands), the
    inverse row DFT against float64: at N = 2·1021 and 2·4093 one
    accumulator puts the rows beyond 1e-6·max (chip_smoke.py's
    MIXED_F64_MAX for the kernel on the card); the kernel's 8, folded
    into a total every 8 rounds, keep them within 4e-7·max, and below 8
    without the fold. Prints the three readings."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(rows, n))
         + 1j * rng.normal(size=(rows, n))).astype(np.complex64)
    want = np.fft.ifft(x.astype(np.complex128), axis=-1) * n
    f32 = planes.mixed_twiddles_np(n, True)
    table = (f32[:, 0] + 1j * f32[:, 1]).astype(np.complex64)
    err = {sums: np.abs(_emulate(x, n, table, *sums) - want).max()
           / np.abs(want).max() for sums in ((1, 0), (8, 0), (8, 8))}
    print(f"N = {n}, {rows} rows: max err against float64 "
          f"{err[1, 0]:.3e} x max with 1 accumulator, {err[8, 0]:.3e} with "
          f"8, {err[8, 8]:.3e} with 8 folded every 8 rounds (the kernel's)")
    assert err[8, 8] <= 4e-7 and err[8, 8] < err[8, 0] and err[1, 0] > 1e-6


def test_every_even_length_has_a_plan_and_a_block():
    """Every even N in [16, 8192] that is not a power of two: the radices
    multiply to N (radix 2 at most once, first; radix 4; odd primes in
    order), at most 16 stages (the kernel's kMaxStages), the table's
    length is N + Σ odd p, and a block of one row fits the card's shared
    memory."""
    for n in range(18, planes.MAX_N + 1, 2):
        if planes.is_power_of_two(n):
            continue
        plan = planes.mixed_plan(n)
        radices = [r for r, _ in plan]
        assert np.prod(radices) == n and len(plan) <= 16
        assert [s for _, s in plan] == list(np.cumprod([1] + radices[:-1]))
        odd = [r for r in radices if r % 2]
        assert odd == sorted(odd) and all(
            all(p % f for f in range(3, int(p ** 0.5) + 1, 2)) for p in odd)
        assert radices[:len(radices) - len(odd)] == (
            [2] * (radices.count(2)) + [4] * radices.count(4))
        assert len(planes.mixed_table(n, True)) == n + sum(odd)
        assert planes.mixed_shared_bytes(1, n) <= planes.SMEM_LIMIT
    planes.mixed_table.cache_clear()
    planes.mixed_twiddles_np.cache_clear()


def test_rows_per_block_of_the_mixed_kernel():
    """Powers of two within the store's cap and the card's shared memory:
    8 rows of 1536 transposed, 4 of 2042 (8 do not fit), 4 natural rows of
    768 (4096 // 768 = 5, rounded down), one at 3072 and beyond."""
    sms = 132

    def rows(m, n, natural):
        return planes.rows_per_block(1, m, n, sms,
                                     planes.mixed_max_rows(n, natural),
                                     planes.mixed_shared_bytes)
    assert rows(1536, 1536, False) == 8
    assert rows(2042, 2042, False) == 4
    assert rows(1, 1536, False) == 1
    assert rows(3072, 3072, True) == 1 and rows(8190, 8190, True) == 1
    assert rows(768, 768, True) == 4
    for n in (1536, 2042, 3072, 6144, 8190):
        for natural in (False, True):
            r = rows(n, n, natural)
            assert r & (r - 1) == 0
            assert planes.mixed_shared_bytes(r, n) <= planes.SMEM_LIMIT


# ------------------------------------------------------------ the size rule

@pytest.mark.parametrize("tier,split3", TIERS)
def test_card_size_rule(tier, split3):
    """require_card_kernel returns for every even length in [16, 8192] at
    every tier and form, fused or not (the three-factor form where n1 is
    128, the only n1 use_split3 gives it, powers of two or not), and
    raises ValueError for odd lengths and lengths outside that range."""
    for fused in (False, True):
        for n in (8, 15, 47, 1021, 16384, 8194):
            with pytest.raises(ValueError, match="even lengths"):
                planes.require_card_kernel(n, tier, split3, fused)
        for n in (16, 1024, 8192, 18, 96, 106, 1536, 2042, 3072, 8186,
                  8190):
            if split3 and planes._split_lanes(n)[0] != 128:
                with pytest.raises(ValueError, match="three-factor"):
                    planes.require_card_kernel(n, tier, split3, fused)
            else:
                planes.require_card_kernel(n, tier, split3, fused)


@pytest.mark.parametrize("change", [
    dict(kw={"fft_backend": "pallas_fused"}),
    dict(cfg={"precision": "bfloat16"}),
    dict(switch={"KERNEL_B3_THRESHOLD": 512}),
    dict(switch={"THREE_FACTOR_THRESHOLD": 512}),
    dict(kw={"fft_backend": "pallas_fused", "real_state": False,
             "pack_channels": False, "half_spectrum": False,
             "pallas_fields": False}),
], ids=["fused", "bf16", "bf16x3", "split3", "complex_fused"])
def test_card_refuses_what_has_no_kernel_at_construction(change,
                                                         monkeypatch):
    """At N = 1536 (and its half length 768) on ``cuda``: f32, bf16,
    bf16x3 and the three-factor form, fused or not, pass the size rule for
    OceanSolver and CascadeSolver, where they were once refused (without a
    card the constructor then fails on the device, not on the size); at
    N = 8320 (above 8192) the same configurations raise ValueError at
    construction, before anything touches the device. They step on the
    CPU, as the JAX package runs them."""
    for name, value in change.get("switch", {}).items():
        monkeypatch.setattr(planes, name, value)
    kw = dict(SLICE, **change.get("kw", {}))
    fused = kw["fft_backend"] == "pallas_fused"
    for precision in ("float32", "bfloat16"):
        cfg = OCEAN_DEMO.replace(
            resolution=1536, **{"precision": precision, **change.get("cfg", {})})
        planes.check_card_sizes(1536, cfg.precision, fused=fused,
                                half=kw["half_spectrum"])
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                OceanSolver(cfg, device="cuda", **kw)
            if not fused:
                with pytest.raises((AssertionError, RuntimeError)):
                    CascadeSolver([c.replace(precision=cfg.precision)
                                   for c in default_cascade(n=1536)],
                                  device="cuda", **kw)
        with pytest.raises(ValueError, match="even lengths"):
            OceanSolver(cfg.replace(resolution=8320), device="cuda", **kw)
    OceanSolver(cfg.replace(resolution=96), device="cpu", **kw)


def test_check_card_sizes_takes_f32_direct_at_every_even_length():
    """path (i)'s switches, the complex state and a cascade at N = 96,
    1536, 3072 pass the size rule on ``cuda``, on ``pallas`` and on
    ``pallas_fused``; without a card the constructor then fails on the
    device, not on the size. The passes at bf16 there, once refused, pass
    it too, fused or not; N = 8194 is refused at either precision."""
    fused_slice = dict(SLICE, fft_backend="pallas_fused")
    for n in (96, 1536, 3072):
        for fused in (False, True):
            planes.check_card_sizes(n, "float32", fused=fused, half=True)
        if torch.cuda.is_available():
            continue
        for kw in (SLICE, {"fft_backend": "pallas"}, fused_slice,
                   {"fft_backend": "pallas_fused"}):
            with pytest.raises((AssertionError, RuntimeError)):
                OceanSolver(OCEAN_DEMO.replace(resolution=n), device="cuda",
                            **kw)
    planes.check_card_sizes(96, "bfloat16", fused=True)
    planes.check_card_sizes(1024, "bfloat16", fused=True, half=True)
    planes.check_card_sizes(96, "bfloat16")
    for precision in ("float32", "bfloat16"):
        with pytest.raises(ValueError, match="even lengths"):
            planes.check_card_sizes(8194, precision)


@pytest.mark.parametrize("n", [47, 96, 106, 16384])
def test_the_wrappers_run_their_plain_version_at_any_length_on_the_cpu(n):
    """A CPU tensor takes the plain version whatever its length, as the
    JAX package's kernels take every length they are given; only a CUDA
    tensor reaches the size rule."""
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(rng.normal(size=(2, 3, n)).astype(np.float32))
              for _ in range(2))
    want = torch.fft.ifft(torch.complex(re, im).to(torch.complex128), dim=-1,
                          norm="forward")
    tr = planes.fft1d_transposed(re, im)
    nat = planes.fft1d_natural_large(re, im)
    scale = want.abs().max().item()
    for got, w in ((nat, want), (tr, want.transpose(-1, -2))):
        assert max((got[0].double() - w.real).abs().max().item(),
                   (got[1].double() - w.imag).abs().max().item()) \
            <= 1e-5 * scale
