"""tpu_ocean_torch's sharded slice against the JAX package's, on the CPU:
``parallel.halo`` (roll_sharded, make_roll_fn), ``fft.distributed``
(ifft2_x_sharded on the four local backends with and without
overlap_chunks, in both regimes of the plane route; ifft2_channel_sharded)
and ``DistributedOceanSolver.step`` over every backend, both states,
packed or not, half or not, with the fields kernel or in torch, both
layouts and both normals modes.

The port runs in D real processes under gloo (tests/torch_dist_worker.py:
a ``file://`` rendezvous in a temporary directory, one spawn a D for the
whole module, its own 120 s timeout); the JAX package runs here on the
fake CPU devices of tests/conftest.py, ``make_mesh(shard=D, devices=
jax.devices()[:D])``, Pallas in interpret mode. Both take one numpy h0
pair (or spectrum) made from a seed. Each case at D = 2 and D = 4 is held
to JAX's sharded result and to the port's single-device OceanSolver (or
numpy's float64 transform) with JAX's own bands: 2e-6·max on
``reference`` (tests/test_distributed.py:140), 2e-5·max for the smooth
fields on the others (:208-211), the foam 1e-4, the normals through
tests/test_torch_complex_backends.py's widened band (check_fields).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chip_smoke
from tpu_ocean import config as jcfg
from tpu_ocean.fft import pallas_fft
from tpu_ocean.fft.distributed import ifft2_channel_sharded, ifft2_x_sharded
from tpu_ocean.parallel import make_mesh as jax_make_mesh
from tpu_ocean.solver_dist import DistributedOceanSolver as JaxDistSolver
from tests.torch_dist_worker import start_ranks
from tpu_ocean_torch import OceanConfig, OceanSolver, fields_to_numpy
from tpu_ocean_torch.fft import planes

N = 64
DS = (2, 4)
FIELDS = ("height", "disp_x", "disp_z", "pos_x", "pos_z", "normal", "foam",
          "jacobian")
#: tests/test_distributed.py _fft_cfg: phase time, capillary, fft layout,
#: stencil normals, no sign quirk
BASE = dict(resolution=N, length=float(N), unit_width=1.0, wind=[9.0, 4.0],
            amplitude=0.15, choppiness=1.1, dispersion_mode="capillary",
            evolution_mode="phase", spectrum_layout="fft",
            normals_mode="stencil", oracle_sign_quirk=False)
#: test_sharded_step_matches_unsharded's centered case
CENTERED = {**BASE, "dispersion_mode": "quantized",
            "evolution_mode": "absolute", "spectrum_layout": "centered",
            "normals_mode": "spectral", "oracle_sign_quirk": True}
SLICE = dict(fft_backend="pallas", real_state=True, pack_channels=True,
             half_spectrum=True, pallas_fields=True)


def pair(seed: int, n: int = N):
    """test_distributed.py's injected h0 pair: 0.05·(ξ₁ + iξ₂) each."""
    rng = np.random.default_rng(seed)
    h0 = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return h0, h0c


def port_config(cfg: dict) -> OceanConfig:
    return OceanConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()})


def jax_config(cfg: dict):
    return jcfg.OceanConfig(**dataclasses.asdict(port_config(cfg)))


def jax_mesh(d: int):
    return jax_make_mesh(shard=d, devices=jax.devices()[:d])


def _cap(cap):
    """The JAX package's natural regime forced at a small N."""
    return (pallas_fft.transposed_store_cap(cap) if cap
            else contextlib.nullcontext())


def jax_steps(cfg: dict, solver: dict, d: int, h0, h0c, steps: int = 2,
              cap=None, velocity=False):
    """JAX's DistributedOceanSolver at D from the injected pair: (fields,
    state, velocity or None) as numpy; ``velocity`` is False or the t to
    pass (None: the state's)."""
    with _cap(cap):
        s = JaxDistSolver(jax_config(cfg), jax_mesh(d), **solver)
        st = s.init(h0=h0, h0_conj=h0c)
        for _ in range(steps):
            st, f = s.step(st, 1 / 60)
        v = (None if velocity is False else
             np.asarray(s.velocity(st, velocity)))
    return (type(f)(*(np.asarray(x) for x in f)),
            type(st)(*(np.asarray(x) for x in st)), v)


def port_single(cfg: dict, solver: dict, h0, h0c, steps: int = 2, cap=None,
                velocity=False):
    """The port's single-device OceanSolver with the same switches (no
    overlap_chunks: it has none) from the same pair."""
    kw = {k: v for k, v in solver.items() if k != "overlap_chunks"}
    old = planes.MAX_TRANSPOSED_N
    planes.MAX_TRANSPOSED_N = cap or old
    try:
        s = OceanSolver(port_config(cfg), device="cpu", **kw)
        st = s.init(h0=h0, h0_conj=h0c)
        for _ in range(steps):
            st, f = s.step(st, 1 / 60)
        v = (None if velocity is False else
             s.velocity(st, velocity).numpy())
    finally:
        planes.MAX_TRANSPOSED_N = old
    return fields_to_numpy(f), st, v


def got_fields(result: dict, name: str) -> dict:
    """A case's gathered fields, by name."""
    return {k: result[f"{name}/fields/{k}"] for k in FIELDS}


def check_fields(got: dict, want, cfg: dict, rel: float, what: str):
    """The 8 fields of ``got`` (a dict) against ``want`` (OceanFields of
    numpy): height, displacements, positions and Jacobian within
    rel·max|want|; the foam within 1e-4 (JAX's band) plus, as
    tests/test_torch_complex_backends.py's assert_fields_match, 1.5 ×
    (|δJ| + 0.3·|δn|) where its inputs differ (smoothstep's slope ≤ 1.5);
    the normals within 2e-4, widened for stencil normals by their
    sensitivity to the measured input differences
    (chip_smoke.normal_sensitivity)."""
    pc = port_config(cfg)
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(
            got[name], w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-9),
            err_msg=f"{what}: {name}")
    w_n = np.asarray(want.normal)
    n_err = np.abs(got["normal"] - w_n).max(-1)
    band = max(2e-4, rel)
    if pc.normals_mode == "stencil":
        delta = max(np.abs(got["height"] - want.height).max(),
                    pc.choppiness * np.abs(got["disp_x"] - want.disp_x).max(),
                    pc.choppiness * np.abs(got["disp_z"] - want.disp_z).max())
        band = band + chip_smoke.normal_sensitivity(want, pc, delta)
    assert (n_err <= band).all(), (
        f"{what}: normal {n_err.max():.3e}, worst err/band "
        f"{(n_err / band).max():.3f}")
    f_band = (max(1e-4, rel) + 1.5 * (np.abs(got["jacobian"] - want.jacobian)
                                      + 0.3 * n_err))
    f_err = np.abs(got["foam"] - want.foam)
    assert (f_err <= f_band).all(), (
        f"{what}: foam {f_err.max():.3e}, worst err/band "
        f"{(f_err / f_band).max():.3f}")


# ----------------------------------------------------------------- inputs

H0, H0C = pair(7)
RNG = np.random.default_rng(1)
INPUTS = {
    "a_h0": H0, "a_h0c": H0C,
    # ifft2_x_sharded's spectra, C = 3 (overlap_chunks 3 divides them)
    "spectra": (RNG.normal(size=(3, N, N))
                + 1j * RNG.normal(size=(3, N, N))).astype(np.complex64),
    # ifft2_channel_sharded's, C = 4 at N = 16 (test_distributed.py:168)
    "channels": (RNG.standard_normal((4, 16, 16))
                 + 1j * RNG.standard_normal((4, 16, 16))).astype(np.complex64),
    "roll_x": RNG.normal(size=(16, 16, 3)).astype(np.float32),
}

ROLLS = [(1, 0), (-1, 0), (1, 1), (-3, 1)]
#: (backend, overlap_chunks, natural-regime cap)
TRANSFORMS = {"reference": ("reference", 1, None),
              "reference_overlap3": ("reference", 3, None),
              "stockham": ("stockham", 1, None),
              "matmul": ("matmul", 1, None),
              "pallas": ("pallas", 1, None),
              "pallas_overlap3": ("pallas", 3, None),
              "pallas_natural_overlap3": ("pallas", 3, 16)}
#: the step: (config, switches, band of the smooth fields); every backend,
#: both states, per-channel / packed / packed + half, the fields kernel or
#: torch, both layouts and normals modes, overlap_chunks 1, 2, 3
STEPS = {
    "reference_centered": (CENTERED, {}, 2e-6),
    "reference_packed_foam_decay": ({**BASE, "foam_decay": 0.5},
                                    dict(pack_channels=True), 2e-6),
    "stockham": (BASE, dict(fft_backend="stockham"), 2e-5),
    "matmul_overlap3": (BASE, dict(fft_backend="matmul", overlap_chunks=3),
                        2e-5),
    "pallas_complex_centered": (CENTERED, dict(fft_backend="pallas"), 2e-5),
    "fused_complex_overlap3": (BASE, dict(fft_backend="pallas_fused",
                                          overlap_chunks=3), 2e-5),
    "pallas_real_per_channel_overlap3": (
        BASE, dict(fft_backend="pallas", real_state=True, overlap_chunks=3),
        2e-5),
    "pallas_real_packed_fields": (
        BASE, dict(fft_backend="pallas", real_state=True, pack_channels=True,
                   pallas_fields=True), 2e-5),
    "slice": (BASE, SLICE, 2e-5),
    "fused_real_packed_fields_overlap2": (
        BASE, dict(fft_backend="pallas_fused", real_state=True,
                   pack_channels=True, pallas_fields=True, overlap_chunks=2),
        2e-5),
}


def _cases(d: int):
    cases = [dict(name=f"roll_{s}_{a}", kind="roll", shape=[32, 24], shift=s,
                  axis=a) for s, a in ROLLS]
    cases.append(dict(name="roll_fn", kind="roll_fn", input="roll_x"))
    cases += [dict(name=name, kind="ifft2", input="spectra", backend=b,
                   overlap=o, **({"cap": cap} if cap else {}))
              for name, (b, o, cap) in TRANSFORMS.items()]
    cases.append(dict(name="channel", kind="channel", input="channels",
                      backend="reference"))
    cases += [dict(name=name, kind="step", cfg=cfg, solver=solver, h0="a",
                   steps=2) for name, (cfg, solver, _) in STEPS.items()]
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn a D for the module, started at once; each test waits for
    its D's results."""
    started = {d: start_ranks(_cases(d), INPUTS, d,
                              tmp_path_factory.mktemp(f"ranks{d}"))
               for d in DS}
    yield started
    for r in started.values():
        for p in r.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


# ------------------------------------------------------------------ halo

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("shift,axis", ROLLS)
def test_roll_sharded_matches_torch_roll(ranks, d, shift, axis):
    x = np.arange(32 * 24, dtype=np.float32).reshape(32, 24)
    np.testing.assert_array_equal(ranks[d].result()[f"roll_{shift}_{axis}/y"],
                                  np.roll(x, shift, axis))


@pytest.mark.parametrize("d", DS)
def test_make_roll_fn_mixed_axes(ranks, d):
    x = INPUTS["roll_x"]
    np.testing.assert_array_equal(ranks[d].result()["roll_fn/y"],
                                  np.roll(np.roll(x, -1, 0), 2, 1))


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", TRANSFORMS)
def test_ifft2_x_sharded_matches_jax(ranks, d, name):
    backend, overlap, cap = TRANSFORMS[name]
    x = INPUTS["spectra"]
    fn = shard_map(lambda a: ifft2_x_sharded(a, "shard", backend,
                                             overlap_chunks=overlap),
                   mesh=jax_mesh(d), in_specs=(P(None, "shard", None),),
                   out_specs=P(None, None, "shard"), check_vma=False)
    old = pallas_fft.MAX_PALLAS_N
    pallas_fft.MAX_PALLAS_N = cap or old
    try:
        want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    finally:
        pallas_fft.MAX_PALLAS_N = old
    got = ranks[d].result()[f"{name}/y"]
    f64 = np.fft.ifft2(x.astype(np.complex128)) * N * N
    scale = np.abs(f64).max()
    # the transpose's layout: a wrong split or concat axis gives a
    # transposed field, far outside any band
    assert np.abs(got - f64).max() <= 2e-6 * scale
    assert np.abs(got - want).max() <= 2e-6 * scale


@pytest.mark.parametrize("d", DS)
def test_ifft2_channel_sharded_matches_jax(ranks, d):
    x = INPUTS["channels"]
    fn = shard_map(lambda a: ifft2_channel_sharded(a, "shard"),
                   mesh=jax_mesh(d), in_specs=(P("shard", None, None),),
                   out_specs=P(None, None, None), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = ranks[d].result()["channel/y"]
    f64 = np.fft.ifft2(x.astype(np.complex128)) * 16 * 16
    assert np.abs(got - f64).max() <= 2e-6 * np.abs(f64).max()
    assert np.abs(got - want).max() <= 2e-6 * np.abs(f64).max()


# ------------------------------------------------------------------ step

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", STEPS)
def test_step_matches_jax_and_single_device(ranks, d, name):
    cfg, solver, rel = STEPS[name]
    want, jstate, _ = jax_steps(cfg, solver, d, H0, H0C)
    single, _, _ = port_single(cfg, solver, H0, H0C)
    res = ranks[d].result()
    got = got_fields(res, name)
    check_fields(got, want, cfg, rel, f"{name} D={d} vs JAX")
    check_fields(got, single, cfg, rel, f"{name} D={d} vs OceanSolver")
    # the state: phase and clock as JAX's, two steps counted
    np.testing.assert_allclose(res[f"{name}/state/phase"], jstate.phase,
                               rtol=0, atol=1e-6)
    assert float(res[f"{name}/state/t"]) == float(jstate.t)
    assert int(res[f"{name}/state/step"]) == int(jstate.step) == 2
    np.testing.assert_allclose(res[f"{name}/state/foam_accum"],
                               jstate.foam_accum, rtol=0, atol=1e-4)
