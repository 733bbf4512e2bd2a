"""Frozen configuration dataclasses and demo presets.

JAX counterpart: ``tpu_ocean/config.py``, copied verbatim. It is a copy and
not an import because ``import tpu_ocean.config`` runs ``tpu_ocean/__init__``,
which imports jax; the tests hold the two presets equal field by field.

The reference's "config system" is (a) serialized MonoBehaviour public fields
(OceanRenderer.cs:10-28, FFTMesh.cs:9-24) with live change-detection re-init
(OceanRenderer.cs:98-109), and (b) compile-time shader keyword variants
(MistralWaterBasic.shader:89-92, Stockham.shader:25).  Here both collapse into
frozen dataclasses whose enum-like string fields become static arguments to jit
(SURVEY.md §5.6).

Presets encode the reference demo scenes exactly (SURVEY.md §2.4):
  * OCEAN_DEMO     — Ocean Demo.unity:296-302 (GPU FFT ocean)
  * FFT_MESH_DEMO  — FFT Mesh.unity:145-152   (CPU direct-DFT oracle scene)
  * POND_DEMO      — Pond Water Mat.mat:90-136 (Gerstner pond)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

G = 9.81          # gravity, FFTMesh.cs:52 / FFTCommon.cginc:9
PI = 3.1415926536  # float32 pi used throughout the reference (FFTMesh.cs:50)
EPSILON = 1e-4    # wavenumber cutoff, FFTMesh.cs:54 / FFTCommon.cginc:8

# The reference has two Phillips damping constants: the HLSL path uses 0.01
# (FFTCommon.cginc:82) and the C# oracle uses 0.001 (FFTMesh.cs:163).
DAMPING_GPU = 0.01
DAMPING_CPU = 0.001


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Full configuration of the spectral ocean solver.

    Mirrors the union of OceanRenderer.cs:10-28 and FFTMesh.cs:9-24 public
    fields, plus the implicit mode switches identified in SURVEY.md §3.5.
    """

    # --- physics (shared by both reference paths) ---
    resolution: int = 256            # FFT grid side N (power of two for FFT paths)
    length: float = 256.0            # patch size L in world units
    wind: Tuple[float, float] = (1.0, 1.0)
    amplitude: float = 1.0           # Phillips A (pre-scale; see amplitude_scale)
    choppiness: float = 1.0          # horizontal displacement multiplier
    unit_width: float = 1.0          # mesh cell size (FFTMesh.cs:15)

    # The GPU path feeds `amplitude / 10000` to the Phillips uniform
    # (OceanRenderer.cs:100,149); the CPU oracle uses `amplitude` raw.
    amplitude_scale: float = 1.0

    # --- mode switches (static jit args) ---
    # 'quantized': ω = floor(sqrt(g|k|)/ω0)·ω0 for exact time-periodicity
    #              (FFTMesh.cs:141-147);
    # 'capillary': ω = sqrt(g|k|(1+|k|²/370²)) continuous (FFTCommon.cginc:106-114).
    dispersion_mode: str = "quantized"
    # 'absolute': stateless h̃(k,t) from absolute time (FFTMesh.cs:178-190);
    # 'phase':    recurrent φ += ω·dt mod 2π (Dispersion.shader:32-41).
    evolution_mode: str = "absolute"
    # 'centered': k = 2π(n−N/2)/L, oracle convention (FFTMesh.cs:201,204);
    # 'fft':      k = 2π·wrap(n)/L FFT-ordered, GPU convention (FFTCommon.cginc:58-67).
    spectrum_layout: str = "centered"
    # 'spectral': exact slopes from i·k·h̃ spectra (oracle path, FFTMesh.cs:212);
    # 'stencil':  finite-difference of displaced neighbors (OceanNormal.shader:39-56).
    normals_mode: str = "spectral"
    damping: float = DAMPING_CPU
    # 'phillips' (the reference's spectrum) or 'jonswap' (beyond-reference
    # fetch-limited sea states; see spectra.jonswap)
    spectrum_model: str = "phillips"
    jonswap_fetch: float = 100e3     # fetch F in meters
    jonswap_gamma: float = 3.3       # peak-enhancement factor
    jonswap_spreading: float = 2.0   # cos^s directional exponent
    jonswap_depth: float = 0.0       # TMA water depth in m (0 = deep water)
    # Temporal foam persistence (beyond the reference, docs/roadmap.md #7):
    # 0 disables (instantaneous foam, reference behavior); >0 is the e-fold
    # DECAY RATE in 1/s — foam' = max(instantaneous, foam·exp(−rate·dt)).
    foam_decay: float = 0.0

    # Replicate the oracle's sign quirk: displacement z accumulates
    # −kz/|k|·Im (FFTMesh.cs:215) while x accumulates +kx/|k|·Im. Both are then
    # subtracted from the rest position (FFTMesh.cs:244-245).
    oracle_sign_quirk: bool = True

    # --- time stepping ---
    dt_multiplier: float = 1.0       # OceanRenderer 'mult' (OceanRenderer.cs:11)
    t_division: float = 1.0          # FFTMesh 'tDivision' (FFTMesh.cs:11)

    # --- numerics ---
    seed: int = 0
    # 'float32': parity-grade — MXU dots run bf16x3 (Precision.HIGHEST).
    # 'bfloat16': fast mode — single-pass bf16 MXU dots, ~4e-3 relative field
    #   error at 1024² (measured): fine for visualization/game workloads,
    #   outside oracle-parity tolerance. Honored by the matmul/pallas FFT
    #   backends; 'reference' (jnp.fft) is always full precision.
    precision: str = "float32"

    def __post_init__(self):
        if self.resolution < 2:
            raise ValueError(f"resolution must be >= 2, got {self.resolution}")
        if self.dispersion_mode not in ("quantized", "capillary"):
            raise ValueError(f"bad dispersion_mode {self.dispersion_mode!r}")
        if self.evolution_mode not in ("absolute", "phase"):
            raise ValueError(f"bad evolution_mode {self.evolution_mode!r}")
        if self.spectrum_layout not in ("centered", "fft"):
            raise ValueError(f"bad spectrum_layout {self.spectrum_layout!r}")
        if self.normals_mode not in ("spectral", "stencil"):
            raise ValueError(f"bad normals_mode {self.normals_mode!r}")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"bad precision {self.precision!r}")
        if self.spectrum_model not in ("phillips", "jonswap"):
            raise ValueError(f"bad spectrum_model {self.spectrum_model!r}")

    @property
    def phillips_amplitude(self) -> float:
        return self.amplitude * self.amplitude_scale

    @property
    def jonswap_kw(self) -> dict:
        """Keyword bundle for spectra.jonswap (deep water when depth == 0)."""
        return {"fetch": self.jonswap_fetch, "gamma": self.jonswap_gamma,
                "spreading": self.jonswap_spreading,
                "depth": self.jonswap_depth if self.jonswap_depth > 0
                         else None}

    def replace(self, **kw) -> "OceanConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PondConfig:
    """Gerstner / sinusoid pond solver configuration.

    Mirrors the material-property block of the pond über-shader
    (MistralWaterLib.cginc:53-64) plus the wave-bank constants. The reference
    hard-codes a 4-wave packed bank (Gerstner, MistralWaterLib.cginc:71-99) and
    a 5-wave bank (GerstnerLevelOne, :101-125); here the bank is an arbitrary-W
    array so BASELINE config 3 (16 waves) is just W=16.
    """

    resolution: int = 512            # evaluation grid side
    unit_width: float = 1.0
    amplitude: float = 10.0          # Pond Water Mat.mat:96 (_Amplitude)
    frequency: float = 2.58          # Pond Water Mat.mat:108 (_Frequency)
    steepness: float = 0.99          # Pond Water Mat.mat:127 (_Steepness)
    speed: float = 1.0               # sinusoid-mode speed (_Speed)
    smoothing: float = 1.0           # _Smoothing (MistralWaterLib.cginc:66)
    # 'gerstner' | 'wave' | 'off' — the _DISPLACEMENTMODE keyword matrix
    # (MistralWaterBasic.shader:89-92) minus 'fft' (that is OceanConfig's job).
    displacement_mode: str = "gerstner"
    # Gerstner applies amplitude * 0.01 at the call site
    # (MistralWaterLib.cginc:172); Wave applies *0.01 inside (:134).
    amplitude_scale: float = 0.01

    # Packed 4-wave bank parameters (Pond Water Mat.mat:90-136).
    w_speed: Tuple[float, ...] = (1.2, 0.71, 1.1, 0.73)
    w_direction_ab: Tuple[float, ...] = (0.3, 0.73, 0.85, 0.25)
    w_direction_cd: Tuple[float, ...] = (-0.25, 1.11, 0.5, 0.5)

    def __post_init__(self):
        if self.displacement_mode not in ("gerstner", "wave", "off"):
            raise ValueError(f"bad displacement_mode {self.displacement_mode!r}")


# ---------------------------------------------------------------------------
# Presets — exact reference demo-scene parameter sets (SURVEY.md §2.4).
# ---------------------------------------------------------------------------

# Ocean Demo.unity:296-302; GPU path divides amplitude by 1e4
# (OceanRenderer.cs:149) and runs 8× the mesh res (OceanRenderer.cs:136).
OCEAN_DEMO = OceanConfig(
    resolution=1024,
    length=434.48,
    wind=(14.45, 12.0),
    amplitude=0.41,
    amplitude_scale=1e-4,
    choppiness=0.46,
    unit_width=1.0,
    dt_multiplier=1.5,
    dispersion_mode="capillary",
    evolution_mode="phase",
    spectrum_layout="fft",
    normals_mode="stencil",
    damping=DAMPING_GPU,
    # The GPU path has no z sign flip: hz = −i·h̃·kz/|k| (Spectrum.shader:49).
    oracle_sign_quirk=False,
)

# FFT Mesh.unity:145-152 (the CPU oracle scene).
FFT_MESH_DEMO = OceanConfig(
    resolution=12,
    length=12.39,
    wind=(5.0, 3.0),
    amplitude=0.01,
    choppiness=1.0,
    unit_width=1.0,
    t_division=1.0,
    dispersion_mode="quantized",
    evolution_mode="absolute",
    spectrum_layout="centered",
    normals_mode="spectral",
    damping=DAMPING_CPU,
)

# Pond Water Mat.mat:90-136 (keywords _DISPLACEMENTMODE_GERSTNER _FOAM_ON ...).
POND_DEMO = PondConfig()
