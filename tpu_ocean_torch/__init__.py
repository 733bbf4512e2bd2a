"""tpu_ocean_torch: the PyTorch/CUDA port of tpu_ocean's main path.

The port runs ``OCEAN_DEMO``'s packed + half-spectrum step (JAX:
``OceanSolver(cfg, fft_backend="pallas", real_state=True,
pack_channels=True, half_spectrum=True, pallas_fields=True)``) on an
NVIDIA H100, with ``fft_backend="pallas"`` or ``"pallas_fused"``, through
hand-written CUDA kernels built with nvcc on first use: the row DFT with a
transposed or a natural store (``csrc/fft_rows.cu``), the fused spectrum
assembly + row DFT with either store (``csrc/fused_rows.cu``) and the
fields stencil (``csrc/fields_stencil.cu``). ``OceanSolver`` runs on the
card unless it is given ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain torch version. This package imports
torch and numpy, never jax; the JAX package ``tpu_ocean`` is its reference.
"""

from tpu_ocean_torch.config import (
    OceanConfig, PondConfig, OCEAN_DEMO, FFT_MESH_DEMO, POND_DEMO)
from tpu_ocean_torch.solver import OceanSolver, OceanStateReal, OceanFields
from tpu_ocean_torch.convert import state_from_numpy, fields_to_numpy
from tpu_ocean_torch.fft.planes import (
    fft1d_transposed, fft1d_transposed_plain, fft1d_natural_large,
    fft1d_natural_large_plain, ifft1d_planes_axis2, ifft2_planes_auto,
    ifft2_planes_half)
from tpu_ocean_torch.ops.fields_stencil import fields_stencil, fields_stencil_plain
from tpu_ocean_torch.ops.fused_spectrum import (
    assemble_rowfft, assemble_rowfft_plain, assemble_rowfft_natural,
    assemble_rowfft_natural_plain, ifft2_fused_planes, ifft2_fused_planes_half)

__all__ = [
    "OceanConfig", "PondConfig", "OCEAN_DEMO", "FFT_MESH_DEMO", "POND_DEMO",
    "OceanSolver", "OceanStateReal", "OceanFields",
    "state_from_numpy", "fields_to_numpy",
    "fft1d_transposed", "fft1d_transposed_plain", "fft1d_natural_large",
    "fft1d_natural_large_plain", "ifft1d_planes_axis2", "ifft2_planes_auto",
    "ifft2_planes_half", "fields_stencil", "fields_stencil_plain",
    "assemble_rowfft", "assemble_rowfft_plain", "assemble_rowfft_natural",
    "assemble_rowfft_natural_plain", "ifft2_fused_planes",
    "ifft2_fused_planes_half",
]
