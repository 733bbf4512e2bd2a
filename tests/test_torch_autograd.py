"""Gradients through the port against the JAX package (Pallas in interpret
mode, as tests/test_autodiff.py runs it): the autograd.Functions of the
row-DFT kernels (fft/planes.py) and of the fields kernels
(ops/fields_stencil.py), the production step, the complex state, the
cascade, the refusals of the fused and wave-bank kernels, and the
inversion (tpu_ocean_torch/invert_sea_state.py).

Bands (max abs error over max |reference| unless said):
- the FFT Functions' VJP against jax.vjp: 1e-5 at f32 (also the
  three-factor form), 3e-2 at bf16 (XLA's DEFAULT dot on the CPU is plain
  f32 while the port rounds to bf16: tests/test_torch_precision.py's band);
  the adjoint identity ⟨F(x), y⟩ = ⟨x, Fᵀ(y)⟩ in float64 within
  tests/test_autodiff.py:226's 2e-5 at f32, and at bf16 within 2e-3 of
  ‖F(x)‖‖y‖ + ‖x‖‖Fᵀ(y)‖ (Cauchy–Schwarz on a 2e-3 error of either side);
- the fields Function against jax.grad of fields_pallas: 1e-5; against
  torch.autograd.grad of its twins on the same cotangents: bit-equal;
- one production step at N = 64 against jax.grad: 1e-5; a central finite
  difference (eps 1e-3, the loss summed in float64) within rtol 1e-2;
  packed + half against unpacked under the Hermitian parameterization:
  1e-5 (tests/test_autodiff.py:144, :166);
- the complex state and the cascade on ``reference``: torch's gradient of
  a real loss in a complex tensor is the conjugate of JAX's, within 1e-5;
  finite differences on the real part within rtol 2e-2 (:26, :92);
- the inversion's first loss and gradient against JAX's: 1e-5."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg
from tpu_ocean.cascade import CascadeSolver as JaxCascade
from tpu_ocean.fft import pallas_fft as pf
from tpu_ocean.ops import fields_pallas as jfields
from tpu_ocean.solver import OceanSolver as JaxSolver
from tpu_ocean_torch import (FFT_MESH_DEMO, CascadeSolver, OceanConfig,
                             OceanSolver,
                             POND_DEMO, PondSolver, WaveBank,
                             default_cascade, invert_sea_state as inv)
from tpu_ocean_torch.evolve import negflip
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.ops import fields_stencil as fs
from tpu_ocean_torch.ops import fused_spectrum as fused
from tpu_ocean_torch.ops import gerstner_bank as gb
from tests.test_torch_solver import SLICE, _h0_pair

JAX_PRECISION = {"float32": jax.lax.Precision.HIGHEST,
                 "bfloat16": jax.lax.Precision.DEFAULT}
TO_JAX = {"float32": 1e-5, "bfloat16": 3e-2}
DT = 1.0 / 60.0


def _assert_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{err:.3e} > {rel:g} x {scale:.3e}"


def _dot64(a, b):
    return float(np.asarray(a, np.float64).ravel()
                 @ np.asarray(b, np.float64).ravel())


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=requires_grad)


# ---- 1. the FFT Functions

# (kernel, precision, three-factor form): the three-factor form is a
# transposed-store form, run at f32 (JAX cannot run it at bf16x3)
FFT_CASES = [("transposed", "float32", False), ("transposed", "bfloat16", False),
             ("natural", "float32", False), ("natural", "bfloat16", False),
             ("transposed", "float32", True)]


@pytest.mark.parametrize("kernel,precision,split3", FFT_CASES)
def test_fft_function_vjp_matches_jax_and_is_the_adjoint(monkeypatch, kernel,
                                                         precision, split3):
    if split3:
        for mod in (pf, planes):
            monkeypatch.setattr(mod, "THREE_FACTOR_THRESHOLD", 64)
    port_fn, jax_fn = {"transposed": (planes.fft1d_transposed,
                                      pf._fft1d_transposed),
                       "natural": (planes.fft1d_natural_large,
                                   pf.fft1d_natural_large)}[kernel]
    c, m, n = 2, 16, 128
    assert planes.engine(n, precision, kernel == "transposed")[1] == split3
    rng = np.random.default_rng(5)
    xr, xi = (rng.standard_normal((c, m, n)).astype(np.float32)
              for _ in range(2))
    out_shape = (c, n, m) if kernel == "transposed" else (c, m, n)
    ctr, cti = (rng.standard_normal(out_shape).astype(np.float32)
                for _ in range(2))

    x = [_t(xr, True), _t(xi, True)]
    yr, yi = port_fn(x[0], x[1], True, precision)
    assert yr.grad_fn is not None
    gr, gi = torch.autograd.grad((yr, yi), x, (_t(ctr), _t(cti)))

    (jyr, jyi), pull = jax.vjp(
        lambda r, i: jax_fn(r, i, True, JAX_PRECISION[precision]),
        jnp.asarray(xr), jnp.asarray(xi))
    jgr, jgi = pull((jnp.asarray(ctr), jnp.asarray(cti)))
    for got, want in ((gr, jgr), (gi, jgi)):
        _assert_rel(got.numpy(), want, TO_JAX[precision])

    yr, yi, gr, gi = (a.detach().numpy() for a in (yr, yi, gr, gi))
    lhs = _dot64(yr, ctr) + _dot64(yi, cti)
    rhs = _dot64(xr, gr) + _dot64(xi, gi)
    if precision == "float32":
        scale = max(abs(_dot64(yr, yr)), abs(_dot64(xr, gr)), 1.0) ** 0.5
        np.testing.assert_allclose(lhs, rhs, atol=2e-5 * scale, rtol=2e-5)
    else:
        def norm(*a):
            return np.sqrt(sum(_dot64(p, p) for p in a))
        bound = 2e-3 * (norm(yr, yi) * norm(ctr, cti)
                        + norm(xr, xi) * norm(gr, gi))
        assert abs(lhs - rhs) <= bound


def test_fft_function_backward_is_the_opposite_direction_at_the_same_tier():
    """At bf16 the backward is the bf16 transform in the other direction on
    the swapped cotangents (JAX's rule), bit for bit, not the derivative
    of the plain version's rounding; a sum()'s stride-0 cotangent and a
    single-row batch (the half route's Nyquist row) go through."""
    rng = np.random.default_rng(1)
    xr, xi = (_t(rng.standard_normal((1, 8, 64)), True) for _ in range(2))
    ct = _t(rng.standard_normal((1, 64, 8)))
    yr, yi = planes.fft1d_transposed(xr, xi, True, "bfloat16")
    gr, gi = torch.autograd.grad((yr, yi), (xr, xi), (ct, torch.zeros_like(ct)))
    want = planes.fft1d_transposed_plain(
        ct.transpose(-1, -2).contiguous(), torch.zeros(1, 8, 64), False,
        "bfloat16")
    assert torch.equal(gr, want[0].transpose(-1, -2))
    assert torch.equal(gi, want[1].transpose(-1, -2))

    row = [_t(rng.standard_normal((1, 1, 64)), True) for _ in range(2)]
    yr, yi = planes.fft1d_transposed(*row, True)
    (yr.sum() + 2 * yi.sum()).backward()
    ones = torch.ones(1, 1, 64)
    want = planes.fft1d_transposed_plain(ones, 2 * ones, False)
    for got, w in zip((row[0].grad, row[1].grad), want):
        assert torch.allclose(got, w.transpose(-1, -2), atol=1e-4)


# ---- 2. the fields Function

@pytest.mark.parametrize("v2", [True, False])
def test_fields_function_matches_jax_grad_and_the_twins(monkeypatch, v2):
    monkeypatch.setattr(jfields, "FIELDS_KERNEL_V2", v2)
    monkeypatch.setattr(fs, "FIELDS_KERNEL_V2", v2)
    n = 32
    rng = np.random.default_rng(7)
    dx, h, dz = ((rng.standard_normal((n, n)) * 0.1).astype(np.float32)
                 for _ in range(3))

    def loss(fields):
        nrm, foam, jac = fields
        return (nrm[..., 0] ** 2).sum() + foam.sum() + (jac ** 2).sum()

    want = jax.grad(lambda a, b, c: loss(jfields.fields_pallas(a, b, c, 0.5)),
                    argnums=(0, 1, 2))(*(jnp.asarray(p) for p in (dx, h, dz)))
    inputs = [_t(p, True) for p in (dx, h, dz)]
    out = fs.fields_stencil(*inputs, 0.5)
    assert type(out[0].grad_fn).__name__ == "_FieldsStencilDiffBackward"
    got = torch.autograd.grad(loss(out), inputs, retain_graph=True)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, 1e-5)

    # the same cotangents through the twins: bit-equal
    cts = [torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
           for o in out]
    got = torch.autograd.grad(out, inputs, cts)
    twin = torch.autograd.grad(fs.fields_twin(*inputs, 0.5), inputs, cts)
    assert all(torch.equal(g, w) for g, w in zip(got, twin))


# ---- 3. the production step at N = 64

def _shipping_cfg(n=64):
    return OceanConfig(resolution=n, length=float(n), wind=(6.0, 4.0),
                       amplitude=0.05, evolution_mode="phase",
                       dispersion_mode="capillary", spectrum_layout="fft",
                       normals_mode="stencil")


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _loss64(f):
    """Σ height² + Σ foam, summed in float64."""
    return (f.height.double() ** 2).sum() + f.foam.double().sum()


@pytest.fixture(scope="module")
def shipping():
    """The slice's port and JAX solvers at N = 64 from one injected h0."""
    cfg = _shipping_cfg()
    h0, h0c = _h0_pair(cfg, seed=3)
    port = OceanSolver(cfg, device="cpu", **SLICE)
    ref = JaxSolver(_jax_cfg(cfg), **SLICE)
    return cfg, port, port.init(h0=h0, h0_conj=h0c), ref, ref.init(h0=h0, h0_conj=h0c)


def test_grad_through_the_slice_step_matches_jax_and_finite_difference(shipping):
    cfg, port, st, ref, js = shipping

    def jloss(h0_re):
        _, f = ref._step_impl(js._replace(h0_re=h0_re), jnp.float32(DT),
                              ref._consts)
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    want = np.asarray(jax.jit(jax.grad(jloss))(js.h0_re))

    def loss(h0_re):
        return _loss64(port.step(st._replace(h0_re=h0_re), DT)[1])

    h0_re = st.h0_re.clone().requires_grad_()
    got = torch.autograd.grad(loss(h0_re), h0_re)[0].numpy()
    assert np.isfinite(got).all()
    _assert_rel(got, want, 1e-5)

    idx = np.unravel_index(np.argmax(np.abs(got)), got.shape)
    eps = 1e-3
    e = torch.zeros_like(st.h0_re)
    e[idx] = eps
    with torch.no_grad():
        fd = (float(loss(st.h0_re + e)) - float(loss(st.h0_re - e))) / (2 * eps)
    np.testing.assert_allclose(fd, got[idx], rtol=1e-2)


def test_grad_packed_half_equals_unpacked_under_hermitian_parameterization():
    cfg = _shipping_cfg()
    h0, h0c = _h0_pair(cfg, seed=4)
    unpacked = dict(pack_channels=False, half_spectrum=False)
    st = OceanSolver(cfg, device="cpu", **{**SLICE, **unpacked}).init(
        h0=h0, h0_conj=h0c)

    def grads(**switches):
        solver = OceanSolver(cfg, device="cpu", **{**SLICE, **switches})
        leaves = [st.h0_re.clone().requires_grad_(),
                  st.h0_im.clone().requires_grad_()]
        s = st._replace(h0_re=leaves[0], h0_im=leaves[1],
                        h0c_re=negflip(leaves[0]), h0c_im=-negflip(leaves[1]))
        _, f = solver.step(s, DT)
        loss = _loss64(f) + (f.normal[..., 0].double() ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    ref = grads(**unpacked)
    got = grads()
    for g, w in zip(got, ref):
        _assert_rel(g.numpy(), w.numpy(), 1e-5)


def test_grad_through_fields_at_and_velocity_matches_jax():
    """The real state in absolute time: fields_at (the step's transforms
    and the fields kernel) and velocity (the half route), one loss."""
    cfg = _shipping_cfg().replace(evolution_mode="absolute")
    h0, h0c = _h0_pair(cfg, seed=5)
    port = OceanSolver(cfg, device="cpu", **SLICE)
    ref = JaxSolver(_jax_cfg(cfg), **SLICE)
    st, js = port.init(h0=h0, h0_conj=h0c), ref.init(h0=h0, h0_conj=h0c)
    t = 0.75

    def jloss(h0_im):
        s = js._replace(h0_im=h0_im)
        f = ref.fields_at(s, t)
        return (jnp.sum(f.height ** 2) + jnp.sum(f.jacobian)
                + jnp.sum(ref.velocity(s, t) ** 2))

    want = np.asarray(jax.jit(jax.grad(jloss))(js.h0_im))
    h0_im = st.h0_im.clone().requires_grad_()
    s = st._replace(h0_im=h0_im)
    f = port.fields_at(s, t)
    loss = ((f.height.double() ** 2).sum() + f.jacobian.double().sum()
            + (port.velocity(s, t).double() ** 2).sum())
    got = torch.autograd.grad(loss, h0_im)[0].numpy()
    _assert_rel(got, want, 1e-5)


# ---- 4. the complex state and the cascade on reference

def test_grad_complex_state_is_the_conjugate_of_jax_and_finite_difference():
    cfg = _shipping_cfg(32)
    ref = JaxSolver(_jax_cfg(cfg))
    base = ref.init(jax.random.PRNGKey(0))

    def jloss(h0):
        s = base._replace(h0=h0, h0_conj=jnp.conj(h0[::-1, ::-1]))
        _, f = ref._step_impl(s, jnp.float32(DT))
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    want = np.asarray(jax.jit(jax.grad(jloss))(base.h0))
    port = OceanSolver(cfg, device="cpu")
    st = port.init(h0=np.asarray(base.h0), h0_conj=np.asarray(base.h0_conj))

    def loss(h0):
        s = st._replace(h0=h0, h0_conj=torch.flip(h0, (0, 1)).conj())
        return _loss64(port.step(s, DT)[1])

    h0 = st.h0.clone().requires_grad_()
    got = torch.autograd.grad(loss(h0), h0)[0].numpy()
    _assert_rel(got, np.conj(want), 1e-5)

    idx = np.unravel_index(np.argmax(np.abs(got)), got.shape)
    eps = 1e-3
    e = torch.zeros_like(st.h0)
    e[idx] = eps
    with torch.no_grad():
        fd = (float(loss(st.h0 + e)) - float(loss(st.h0 - e))) / (2 * eps)
    np.testing.assert_allclose(fd, got[idx].real, rtol=2e-2)


def test_grad_cascade_on_reference_is_the_conjugate_of_jax():
    from tpu_ocean.cascade import default_cascade as jax_default_cascade
    jcfgs = jax_default_cascade(n=32, lengths=(100.0, 13.0))
    ref = JaxCascade(jcfgs, fft_backend="reference")
    base = ref.init(jax.random.PRNGKey(1))

    def jloss(h0):
        s = base._replace(h0=h0, h0_conj=jnp.conj(h0[:, ::-1, ::-1]))
        _, f = ref._step_impl(s, jnp.float32(DT))
        return jnp.sum(f.height ** 2) + jnp.sum(f.foam)

    want = np.asarray(jax.jit(jax.grad(jloss))(base.h0))
    port = CascadeSolver(default_cascade(n=32, lengths=(100.0, 13.0)),
                         fft_backend="reference", device="cpu")
    st = port.init(h0=np.asarray(base.h0), h0_conj=np.asarray(base.h0_conj))

    def loss(h0):
        s = st._replace(h0=h0, h0_conj=torch.flip(h0, (1, 2)).conj())
        return _loss64(port.step(s, DT)[1])

    h0 = st.h0.clone().requires_grad_()
    got = torch.autograd.grad(loss(h0), h0)[0].numpy()
    assert all(np.abs(got[b]).max() > 0 for b in range(got.shape[0]))
    _assert_rel(got, np.conj(want), 1e-5)

    idx = np.unravel_index(np.argmax(np.abs(got)), got.shape)
    eps = 1e-3
    e = torch.zeros_like(st.h0)
    e[idx] = eps
    with torch.no_grad():
        fd = (float(loss(st.h0 + e)) - float(loss(st.h0 - e))) / (2 * eps)
    np.testing.assert_allclose(fd, got[idx].real, rtol=2e-2)


@pytest.mark.parametrize("backend", ["matmul", "direct"])
def test_grad_complex_backends_without_kernels_match_jax(backend):
    """The complex state's transforms outside the hand kernels: ``matmul``,
    and eval_mode="direct" with its blocked in-place accumulation (the
    centered layout, N = 12 at L = 12.39 as FFT_MESH_DEMO)."""
    if backend == "direct":
        cfg, kw = FFT_MESH_DEMO, dict(eval_mode="direct")
    else:
        cfg, kw = _shipping_cfg(32), dict(fft_backend="matmul")
    ref = JaxSolver(_jax_cfg(cfg), **kw)
    base = ref.init(jax.random.PRNGKey(2))

    def jloss(h0):
        _, f = ref._step_impl(base._replace(h0=h0), jnp.float32(DT))
        return jnp.sum(f.height ** 2) + jnp.sum(f.disp_x ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(base.h0))
    port = OceanSolver(cfg, device="cpu", **kw)
    st = port.init(h0=np.asarray(base.h0), h0_conj=np.asarray(base.h0_conj))
    h0 = st.h0.clone().requires_grad_()
    _, f = port.step(st._replace(h0=h0), DT)
    loss = (f.height.double() ** 2).sum() + (f.disp_x.double() ** 2).sum()
    got = torch.autograd.grad(loss, h0)[0].numpy()
    _assert_rel(got, np.conj(want), 1e-5)


# ---- 5. the kernels with no gradient, and the forward without one

def test_pallas_fused_and_the_wave_bank_refuse_a_gradient():
    cfg = _shipping_cfg()
    for state_kind in ("real", "complex"):
        kw = SLICE if state_kind == "real" else {}
        solver = OceanSolver(cfg, device="cpu",
                             **{**kw, "fft_backend": "pallas_fused"})
        st = solver.init(torch.Generator().manual_seed(0))
        name = "h0_re" if state_kind == "real" else "h0"
        leaf = getattr(st, name).clone().requires_grad_()
        with pytest.raises(NotImplementedError, match='fft_backend="pallas"'):
            solver.step(st._replace(**{name: leaf}), DT)
        with torch.no_grad():
            _, f = solver.step(st._replace(**{name: leaf}), DT)
        assert f.height.grad_fn is None and torch.isfinite(f.height).all()

    n = 16
    h = [torch.randn(n, n) for _ in range(5)]
    h[4] = h[4].abs()
    h[0].requires_grad_()
    for fn in (fused.assemble_rowfft, fused.assemble_rowfft_natural):
        with pytest.raises(NotImplementedError, match="no VJP"):
            fn(tuple(h[:4]), h[4], 16.0, 1.0, epsilon=1e-4, ch_count=1)

    x = torch.linspace(0, 1, 16 * 16).reshape(16, 16).requires_grad_()
    z = torch.zeros(16, 16)
    with pytest.raises(NotImplementedError, match="wave-bank"):
        gb.gerstner_bank(WaveBank.random(0, 4), x, z, 0.5)
    with torch.no_grad():
        out = gb.gerstner_bank(WaveBank.random(0, 4), x, z, 0.5)
    assert out[0].grad_fn is None
    pond = PondSolver(dataclasses.replace(POND_DEMO, resolution=16),
                      use_pallas=True, device="cpu")
    assert pond.fields(0.5).offset_y.grad_fn is None


def test_a_step_without_gradient_enters_no_function(monkeypatch, shipping):
    """Grad mode on but no input requiring grad: the wrappers run their
    dispatch alone; with a leaf that requires grad every pass enters its
    Function (5 row passes and the fields kernel on the slice)."""
    entered = []
    for cls in (planes._Fft1dTransposedDiff, planes._Fft1dNaturalLargeDiff,
                fs._FieldsStencilDiff):
        original = cls.apply

        def spy(*args, _original=original, _name=cls.__name__):
            entered.append(_name)
            return _original(*args)
        monkeypatch.setattr(cls, "apply", spy)
    _, port, st, _, _ = shipping
    _, f = port.step(st, DT)
    assert entered == []
    assert all(getattr(f, k).grad_fn is None for k in f._fields)
    _, f = port.step(st._replace(h0_re=st.h0_re.clone().requires_grad_()), DT)
    assert collections.Counter(entered) == {"_Fft1dTransposedDiff": 5,
                                            "_FieldsStencilDiff": 1}
    assert all(getattr(f, k).grad_fn is not None for k in f._fields)


# ---- 6. the inversion

def _jax_packed_loss(n, js, ref, snapshots=4):
    """examples/invert_sea_state.py run_packed's loss, on ``js``."""
    dt = jnp.float32(inv.PACKED_DT)

    def observe(planes_):
        h0_re, h0_im = planes_
        st = js._replace(
            h0_re=h0_re, h0_im=h0_im,
            h0c_re=jnp.roll(jnp.flip(h0_re, (0, 1)), (1, 1), (0, 1)),
            h0c_im=-jnp.roll(jnp.flip(h0_im, (0, 1)), (1, 1), (0, 1)),
            phase=jnp.zeros_like(js.phase))
        hs = []
        for _ in range(snapshots):
            for _ in range(inv.PACKED_INNER):
                st, f = ref._step_impl(st, dt, ref._consts)
            hs.append(f.height)
        return hs

    obs = jax.jit(observe)((js.h0_re, js.h0_im))

    def loss(planes_):
        err = 0.0
        for h, o in zip(observe(planes_), obs):
            err = err + jnp.mean((h - o) ** 2)
        return err / len(obs)
    return loss


def test_inversion_first_loss_and_gradient_match_jax():
    # the packed problem (the production step), N = 64
    n = 64
    cfg = inv._config(n, evolution_mode="phase", normals_mode="stencil")
    h0, h0c = _h0_pair(cfg, seed=6)
    ref = JaxSolver(_jax_cfg(cfg), **SLICE)
    js = ref.init(h0=h0, h0_conj=h0c)
    zeros = (jnp.zeros_like(js.h0_re), jnp.zeros_like(js.h0_im))
    val, want = jax.jit(jax.value_and_grad(_jax_packed_loss(n, js, ref, 2)))(
        zeros)
    problem = inv.packed_problem(n, 2, device="cpu", h0=h0, h0_conj=h0c)
    got_val, got = inv.value_and_grad(problem, problem.start)
    np.testing.assert_allclose(float(got_val), float(val), rtol=1e-5)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, 1e-5)

    # the complex problem (reference, absolute time, spectral normals), N = 48
    n = 48
    cfg = inv._config(n, evolution_mode="absolute", normals_mode="spectral")
    ref = JaxSolver(_jax_cfg(cfg))
    truth = ref.init(jax.random.PRNGKey(0))
    times = [0.5 + 0.37 * i for i in range(4)]
    obs = [ref.fields_at(truth, t).height for t in times]
    base = truth._replace(h0=jnp.zeros_like(truth.h0),
                          h0_conj=jnp.zeros_like(truth.h0_conj))

    def jloss(h0):
        partner = jnp.conj(jnp.roll(jnp.flip(h0, (0, 1)), (1, 1), (0, 1)))
        st = base._replace(h0=h0, h0_conj=partner)
        err = 0.0
        for t, o in zip(times, obs):
            err = err + jnp.mean((ref.fields_at(st, t).height - o) ** 2)
        return err / len(times)

    val, want = jax.jit(jax.value_and_grad(jloss))(jnp.zeros_like(truth.h0))
    problem = inv.complex_problem(n, device="cpu", h0=np.asarray(truth.h0),
                                  h0_conj=np.asarray(truth.h0_conj))
    got_val, (got,) = inv.value_and_grad(problem, problem.start)
    np.testing.assert_allclose(float(got_val), float(val), rtol=1e-5)
    # torch's convention: the conjugate of JAX's, which the example undoes
    _assert_rel(got.numpy(), np.conj(np.asarray(want)), 1e-5)


def test_inversion_reduces_the_loss_and_the_cli_keeps_the_jax_rules(
        capsys, monkeypatch):
    """40 iterations of the packed inversion at N = 64 from the JAX
    example's truth (its PRNGKey(0) h0, injected): JAX read 363 → 74.7 at
    iteration 25 and 18.4 at 50."""
    cfg = inv._config(64, evolution_mode="phase", normals_mode="stencil")
    truth = JaxSolver(_jax_cfg(cfg), **SLICE).init(jax.random.PRNGKey(0))
    problem = inv.packed_problem(
        64, device="cpu",
        h0=np.asarray(truth.h0_re) + 1j * np.asarray(truth.h0_im),
        h0_conj=np.asarray(truth.h0c_re) + 1j * np.asarray(truth.h0c_im))
    params, losses = inv.invert(problem, 40, 5e-2)
    with torch.no_grad():
        final = float(problem.loss(params))
    assert np.isfinite(losses).all() and final * 5 <= losses[0]

    assert inv.main(["--packed", "--n", "64", "--steps", "2",
                     "--device", "cpu"]) == 1
    assert "loss reduced" in capsys.readouterr().out
    # the JAX example's default N (48) passes its own n % 16 check, and
    # its solver refuses it for the half spectrum; the port's script
    # defaults to N = 64 under --packed and refuses 48 itself, with the
    # solver's reason (ROADMAP Queue 3, a deliberate difference)
    built = []
    packed_problem = inv.packed_problem
    monkeypatch.setattr(inv, "packed_problem", lambda n, *a, **k: (
        built.append(n), packed_problem(n, *a, **k))[1])
    assert inv.main(["--packed", "--steps", "2", "--device", "cpu"]) == 1
    assert built == [64] and "loss reduced" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="half_spectrum"):
        inv.main(["--packed", "--n", "48", "--device", "cpu"])
    with pytest.raises(ValueError, match="half_spectrum"):
        JaxSolver(_jax_cfg(inv._config(48, evolution_mode="phase",
                                       normals_mode="stencil")), **SLICE)
    with pytest.raises(SystemExit):
        inv.main(["--packed", "--n", "72", "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        inv.main(["--help"])
    assert done.value.code == 0 and "n % 16" in capsys.readouterr().out
