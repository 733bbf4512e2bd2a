"""tpu_ocean_torch's sharded slice against the JAX package's, on the CPU,
continued: the mirror-balanced half-spectrum route
(``fft.distributed.ifft2_x_sharded_half``, both regimes, its row
permutation, D = 1), the natural regime of the sharded step, ``velocity``,
``reconfigure``, ``shard_state`` ∘ ``gather``, ``precision="bfloat16"``
and every ValueError the JAX DistributedOceanSolver and make_mesh raise on
the CPU.

As tests/test_torch_distributed.py (whose helpers this file takes): the
port in D processes under gloo, one spawn a D (1, 2, 4) with its own
120 s timeout, the JAX package here on the fake CPU devices, one numpy
input from a seed for both, the natural regime forced at small N by
lowering ``fft.planes.MAX_TRANSPOSED_N`` in the ranks and entering
``pallas_fft.transposed_store_cap`` in JAX, as JAX's own half tests do.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import tpu_ocean.fft.distributed as jax_fd
from tpu_ocean.parallel import make_mesh as jax_make_mesh
from tpu_ocean.solver import OceanState as JaxState
from tpu_ocean.solver import OceanStateReal as JaxStateReal
from tpu_ocean.solver_dist import DistributedOceanSolver as JaxDistSolver
import torch
from tests.test_half_spectrum import _hermitian_spectrum
from tests.test_torch_distributed import (
    BASE, CENTERED, H0, H0C, N, SLICE, check_fields, got_fields, jax_config,
    jax_mesh, jax_steps, port_config, port_single, _cap)
from tests.torch_dist_worker import start_ranks
from tpu_ocean_torch import OceanSolver, fields_to_numpy
from tpu_ocean_torch.fft import planes
from tpu_ocean_torch.fft.distributed import _half_row_perm

DS = (2, 4)
#: chip_smoke's bf16 bands: two bf16 row passes in sequence, each within
#: 2e-3 of another order of the same sums; and the JAX package's envelope
#: of its bf16 mode against f32 (tests/test_switch_matrix.py:93), the band
#: between two bf16 implementations
BF16_REL, BF16_VS_F32_REL = 4e-3, 3e-2
HALF_N = 128         # tests/test_distributed_half.py's N
SPECTRUM = _hermitian_spectrum(HALF_N, c=1, seed=11)
#: the natural regime's cap, at N = 64 and at HALF_N
NATURAL_CAP = 32
REGIMES = {"transposed": None, "natural": NATURAL_CAP}
FUSED_PACKED = dict(fft_backend="pallas_fused", real_state=True,
                    pack_channels=True, pallas_fields=True)
#: the step in the natural regime (the row passes on #2, the columns along
#: axis −2, the natural half route)
NATURAL = {"slice": (BASE, SLICE), "fused_packed": (BASE, FUSED_PACKED)}
#: velocity: (config, switches, t for an absolute-time config or None)
VELOCITY = {
    "slice_half": (BASE, SLICE, None),
    "pallas_packed_absolute": ({**BASE, "evolution_mode": "absolute"},
                               dict(fft_backend="pallas", real_state=True,
                                    pack_channels=True), 0.75),
    "matmul_centered_absolute": (CENTERED, dict(fft_backend="matmul"), 0.5),
    "fused_complex": (BASE, dict(fft_backend="pallas_fused"), None),
}
#: reconfigure: the changed config field — an init-only one keeps the
#: tables, any other builds a new solver
RECONFIGURE = {"init_only": {"wind": [6.0, 7.0]},
               "rebuild": {"choppiness": 0.8}}
ROUNDTRIP = {"slice": (BASE, SLICE), "complex_centered": (CENTERED, {})}
BF16 = {"slice": (BASE, SLICE), "matmul": (BASE, dict(fft_backend="matmul"))}
#: DistributedOceanSolver's ValueErrors on the CPU, in JAX's order:
#: (config changes, switches), at D = 2
ERRORS = {
    "backend": ({}, dict(fft_backend="cufft")),
    "real_state_backend": ({}, dict(fft_backend="matmul", real_state=True)),
    "real_state_layout": ({"spectrum_layout": "centered"},
                          dict(fft_backend="pallas", real_state=True)),
    "fused_layout": ({"spectrum_layout": "centered"},
                     dict(fft_backend="pallas_fused")),
    "fields_normals": ({"normals_mode": "spectral"},
                       dict(fft_backend="pallas", pallas_fields=True)),
    "divisible": ({"resolution": 63}, {}),
    "pack_layout": ({"spectrum_layout": "centered"},
                    dict(pack_channels=True)),
    "half_unpacked": ({}, dict(fft_backend="pallas", real_state=True,
                               half_spectrum=True)),
    "half_fused": ({}, dict(fft_backend="pallas_fused", real_state=True,
                            pack_channels=True, half_spectrum=True)),
    "half_complex": ({}, dict(fft_backend="pallas", pack_channels=True,
                              half_spectrum=True)),
    "half_small": ({"resolution": 48}, SLICE),
    "half_mirror_rows": ({"resolution": 80}, SLICE),
    "overlap": ({}, dict(fft_backend="pallas", real_state=True,
                         overlap_chunks=2)),
}
INPUTS = {"a_h0": H0, "a_h0c": H0C, "spectrum": SPECTRUM}


def _cases(d: int):
    if d == 1:
        return [dict(name="half", kind="half", input="spectrum"),
                dict(name="slice", kind="step", cfg=BASE, solver=SLICE,
                     h0="a", steps=2)]
    cases = [dict(name=f"half_{r}", kind="half", input="spectrum",
                  **({"cap": cap} if cap else {}))
             for r, cap in REGIMES.items()]
    cases += [dict(name=f"natural_{k}", kind="step", cfg=cfg, solver=sw,
                   h0="a", steps=2, cap=NATURAL_CAP)
              for k, (cfg, sw) in NATURAL.items()]
    cases += [dict(name=f"velocity_{k}", kind="step", cfg=cfg, solver=sw,
                   h0="a", steps=2, velocity=t)
              for k, (cfg, sw, t) in VELOCITY.items()]
    cases += [dict(name=f"reconfigure_{k}", kind="reconfigure", cfg=BASE,
                   solver=SLICE, h0="a", steps=2, new=new, seed2=5)
              for k, new in RECONFIGURE.items()]
    cases += [dict(name=f"roundtrip_{k}", kind="roundtrip", cfg=cfg,
                   solver=sw, seed=3) for k, (cfg, sw) in ROUNDTRIP.items()]
    cases += [dict(name=f"bf16_{k}_{p}", kind="step",
                   cfg={**cfg, "precision": p}, solver=sw, h0="a", steps=2)
              for k, (cfg, sw) in BF16.items()
              for p in ("bfloat16", "float32")]
    if d == 2:
        cases.append(dict(name="errors", kind="errors", configs=[
            [label, {**BASE, **change}, sw]
            for label, (change, sw) in ERRORS.items()]))
        cases.append(dict(name="mesh", kind="mesh", cfg=BASE,
                          path="unused-rendezvous"))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = {d: start_ranks(_cases(d), INPUTS, d,
                              tmp_path_factory.mktemp(f"ranks{d}"))
               for d in (1, *DS)}
    yield started
    for r in started.values():
        for p in r.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _jax_error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


# ------------------------------------------------------------ the half route

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("regime", REGIMES)
def test_sharded_half_matches_jax_and_full_transform(ranks, d, regime):
    """Both regimes on an exactly Hermitian spectrum: the port's
    mirror-balanced route against JAX's (test_distributed_half.py:60) and
    against Re of numpy's float64 full transform. D = 4 runs the
    non-identity mirror permutation."""
    re = jnp.asarray(SPECTRUM.real, jnp.float32)
    im = jnp.asarray(SPECTRUM.imag, jnp.float32)
    fn = shard_map(lambda r, i: jax_fd.ifft2_x_sharded_half(r, i, "shard"),
                   mesh=jax_mesh(d),
                   in_specs=(P(None, "shard", None), P(None, "shard", None)),
                   out_specs=P(None, None, "shard"), check_vma=False)
    with _cap(REGIMES[regime]):
        want = np.asarray(fn(re, im))
    got = ranks[d].result()[f"half_{regime}/y"]
    f64 = (np.fft.ifft2(SPECTRUM) * HALF_N * HALF_N).real
    scale = np.abs(f64).max()
    assert np.abs(got - f64).max() <= 3e-5 * scale
    assert np.abs(got - want).max() <= 3e-5 * scale


def test_sharded_half_d1_is_the_single_route(ranks):
    """At D = 1 the sharded half route is planes.ifft2_planes_half, and the
    sharded step the single-device step, to f32 rounding."""
    res = ranks[1].result()
    s = SPECTRUM[:, :HALF_N // 2 + 1]
    want = planes.ifft2_planes_half(
        torch.from_numpy(np.ascontiguousarray(s.real, np.float32)),
        torch.from_numpy(np.ascontiguousarray(s.imag, np.float32))).numpy()
    np.testing.assert_allclose(res["half/y"], want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    single, _, _ = port_single(BASE, SLICE, H0, H0C)
    check_fields(got_fields(res, "slice"), single, BASE, 1e-6,
                 "slice D=1 vs OceanSolver")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_half_row_perm_is_a_bijection_as_jax(d):
    b = HALF_N // d
    perm = _half_row_perm(d, b)
    assert sorted(perm.tolist()) == list(range(d * b // 2))
    np.testing.assert_array_equal(perm, jax_fd._half_row_perm(d, b))


# ------------------------------------------------------- the natural regime

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", NATURAL)
def test_natural_regime_step_matches_jax_and_single_device(ranks, d, name):
    cfg, sw = NATURAL[name]
    want, _, _ = jax_steps(cfg, sw, d, H0, H0C, cap=NATURAL_CAP)
    single, _, _ = port_single(cfg, sw, H0, H0C, cap=NATURAL_CAP)
    got = got_fields(ranks[d].result(), f"natural_{name}")
    check_fields(got, want, cfg, 3e-5, f"natural {name} D={d} vs JAX")
    check_fields(got, single, cfg, 2e-5, f"natural {name} D={d} vs single")


# ------------------------------------------------------------------ velocity

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", VELOCITY)
def test_velocity_matches_jax_and_single_device(ranks, d, name):
    cfg, sw, t = VELOCITY[name]
    _, _, want = jax_steps(cfg, sw, d, H0, H0C, velocity=t)
    _, _, single = port_single(cfg, sw, H0, H0C, velocity=t)
    got = ranks[d].result()[f"velocity_{name}/velocity"]
    scale = np.abs(want).max()
    assert got.shape == (N, N)
    assert np.abs(got - want).max() <= 2e-5 * scale
    assert np.abs(got - single).max() <= 2e-5 * scale


# --------------------------------------------------------------- reconfigure

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", RECONFIGURE)
def test_reconfigure_matches_the_single_device_solver(ranks, d, mode):
    """An init-only change shares the tables and keeps phase, clock, step
    and foam; any other builds a new solver. Held to the port's
    OceanSolver.reconfigure from the same state and generator (the h0
    planes and phase bit for bit), then one step of each."""
    res = ranks[d].result()
    new = port_config({**BASE, **RECONFIGURE[mode]})
    _, state, _ = port_single(BASE, SLICE, H0, H0C)
    solver = OceanSolver(port_config(BASE), device="cpu", **SLICE)
    solver2, state2 = solver.reconfigure(state, new,
                                         torch.Generator().manual_seed(5))
    assert bool(res[f"reconfigure_{mode}/shared"]) == (mode == "init_only")
    assert (solver2.omega is solver.omega) == (mode == "init_only")
    for k, v in state2._asdict().items():
        np.testing.assert_array_equal(res[f"reconfigure_{mode}/reconfigured/{k}"],
                                      v.numpy(), err_msg=k)
    _, fields = solver2.step(state2, 1 / 60)
    check_fields(got_fields(res, f"reconfigure_{mode}"),
                 fields_to_numpy(fields), {**BASE, **RECONFIGURE[mode]},
                 2e-5, f"reconfigure {mode} D={d}")


# --------------------------------------------------------------- round trip

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", ROUNDTRIP)
def test_shard_state_gather_round_trip(ranks, d, name):
    """gather ∘ init is OceanSolver.init's global state from the same
    generator, bit for bit; shard_state ∘ gather gives the shards back
    (from tensors and from numpy); symmetrize leaves the projected pair
    bit for bit; a state of the other kind raises JAX's ValueError."""
    cfg, sw = ROUNDTRIP[name]
    res = ranks[d].result()
    assert bool(res[f"roundtrip_{name}/equal"])
    assert bool(res[f"roundtrip_{name}/idempotent"])
    want = OceanSolver(port_config(cfg), device="cpu", **sw).init(
        torch.Generator().manual_seed(3))
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(res[f"roundtrip_{name}/state/{k}"],
                                      v.numpy(), err_msg=k)
    js = JaxDistSolver(jax_config(cfg), jax_mesh(d), **sw)
    z = np.zeros((N, N), np.float32)
    other = (JaxState(z + 0j, z + 0j, z, np.float32(0), np.int32(0), z)
             if sw.get("real_state") else
             JaxStateReal(z, z, z, z, z, np.float32(0), np.int32(0), z))
    assert str(res[f"roundtrip_{name}/mismatch"]) == _jax_error(
        lambda: js.shard_state(other))


# -------------------------------------------------------------------- bf16

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", BF16)
def test_bf16_reaches_the_sharded_transforms(ranks, d, name):
    """precision="bfloat16" reaches the sharded passes (JAX checks the
    lowered dots, test_distributed.py:91): the port's bf16 step differs
    from its f32 step by far more than f32 rounding, and stays within the
    bf16 band of its single-device bf16 step (the same rounding) and
    within JAX's bf16 envelope of JAX's bf16 step (another bf16
    implementation)."""
    cfg, sw = BF16[name]
    res = ranks[d].result()
    bf16 = {**cfg, "precision": "bfloat16"}
    got = got_fields(res, f"bf16_{name}_bfloat16")
    f32 = got_fields(res, f"bf16_{name}_float32")
    scale = np.abs(f32["height"]).max()
    assert np.abs(got["height"] - f32["height"]).max() > 1e-4 * scale
    single, _, _ = port_single(bf16, sw, H0, H0C)
    want, _, _ = jax_steps(bf16, sw, d, H0, H0C)
    for other, rel, what in ((single, BF16_REL, "single"),
                             (want, BF16_VS_F32_REL, "JAX")):
        for k in ("height", "disp_x", "disp_z"):
            w = getattr(other, k)
            assert np.abs(got[k] - w).max() <= rel * np.abs(w).max(), (
                f"bf16 {name} D={d} vs {what}: {k}")


# ------------------------------------------------------------ the ValueErrors

@pytest.mark.parametrize("label", ERRORS)
def test_constructor_raises_as_jax(ranks, label):
    change, sw = ERRORS[label]
    want = _jax_error(lambda: JaxDistSolver(jax_config({**BASE, **change}),
                                            jax_mesh(2), **sw))
    assert want.startswith("ValueError")
    assert str(ranks[2].result()[f"errors/{label}"]) == want


def test_mesh_errors_as_jax(ranks):
    """make_mesh's two ValueErrors and the mesh without a 'shard' axis,
    with JAX's messages; initialize_distributed is a no-op where a group
    exists and for one process."""
    res = ranks[2].result()
    devs = jax.devices()[:2]
    assert str(res["mesh/batch"]) == _jax_error(
        lambda: jax_make_mesh(batch=3, devices=devs))
    assert str(res["mesh/shard"]) == _jax_error(
        lambda: jax_make_mesh(shard=4, devices=devs))
    no_shard = jax.sharding.Mesh(np.asarray(devs).reshape(1, 2),
                                 axis_names=("batch", "data"))
    assert str(res["mesh/no_shard_axis"]) == _jax_error(
        lambda: JaxDistSolver(jax_config(BASE), no_shard))
    assert int(res["mesh/ranks"]) == 2
