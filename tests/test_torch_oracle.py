"""tpu_ocean_torch.oracle against the JAX package's oracle: both are float64
numpy, so the same config and the same numpy generator give the same h0
pair and the same fields(t), bit for bit — the fft and centered layouts of
the config (the oracle itself is the centered direct sum), odd and even
N, injected and drawn h0."""

import dataclasses

import numpy as np
import pytest

from tpu_ocean import config as jcfg
from tpu_ocean.oracle import Oracle as JaxOracle
from tpu_ocean_torch import FFT_MESH_DEMO, OceanConfig
from tpu_ocean_torch.oracle import Oracle, OracleFields

CONFIGS = {
    "fft_mesh_demo": FFT_MESH_DEMO,
    "odd9_centered": OceanConfig(resolution=9, length=9.7, wind=(6.0, 2.5),
                                 amplitude=0.3, choppiness=1.3),
    "even16_fft": OceanConfig(resolution=16, length=16.0, wind=(8.0, 5.0),
                              amplitude=0.5, spectrum_layout="fft",
                              normals_mode="stencil"),
    "odd9_fft": OceanConfig(resolution=9, length=9.0, wind=(4.0, 7.0),
                            amplitude=0.2, spectrum_layout="fft",
                            unit_width=0.8),
    "even24_centered": OceanConfig(resolution=24, length=30.0,
                                   wind=(12.0, -3.0), amplitude=0.05,
                                   unit_width=1.25, damping=0.01),
}


def _jax_cfg(cfg):
    return jcfg.OceanConfig(**dataclasses.asdict(cfg))


def _assert_bit_equal(got, want):
    for name in OracleFields.__dataclass_fields__:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float64, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_oracle_draw_and_fields_bit_equal(name, seed):
    cfg = CONFIGS[name]
    port = Oracle(cfg, rng=np.random.default_rng(seed))
    ref = JaxOracle(_jax_cfg(cfg), rng=np.random.default_rng(seed))
    for attr in ("h0", "h0_conj", "k1d", "kx", "kz", "k_mag", "omega",
                 "x1d", "ex"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr),
                                      err_msg=attr)
    for t in (0.0, 0.37, 12.5):
        np.testing.assert_array_equal(port.htilde(t), ref.htilde(t))
        _assert_bit_equal(port.fields(t), ref.fields(t))


@pytest.mark.parametrize("name", ["odd9_centered", "even16_fft"])
def test_oracle_injected_h0_and_default_rng_bit_equal(name):
    """An injected pair is taken as it is; with neither rng nor h0, both
    draw from default_rng(cfg.seed)."""
    cfg = CONFIGS[name]
    n = cfg.resolution
    rng = np.random.default_rng(11)
    h0 = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h0c = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    port = Oracle(cfg, h0=h0, h0_conj=h0c)
    ref = JaxOracle(_jax_cfg(cfg), h0=h0, h0_conj=h0c)
    np.testing.assert_array_equal(port.h0, h0)
    _assert_bit_equal(port.fields(1.5), ref.fields(1.5))
    np.testing.assert_array_equal(Oracle(cfg).h0, JaxOracle(_jax_cfg(cfg)).h0)


def test_cli_modules_import_no_jax_pil_or_matplotlib():
    import subprocess
    import sys
    code = ("import sys, tpu_ocean_torch.oracle, tpu_ocean_torch.demo, "
            "tpu_ocean_torch.viz, tpu_ocean_torch.sample; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpu_ocean', 'PIL', 'matplotlib')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
