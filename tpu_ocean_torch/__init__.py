"""tpu_ocean_torch: the PyTorch/CUDA port of tpu_ocean.

``OceanSolver`` takes the JAX ``OceanSolver``'s defaults: the complex state
on the ``reference`` backend (torch.fft), so ``OceanSolver(OceanConfig())``
steps the oracle's configuration (the centered layout, absolute time,
spectral normals). The complex state runs every backend of the JAX
package: ``reference``, ``stockham``, ``matmul``, ``pallas`` (the row-DFT
kernels on planes) and ``pallas_fused`` (the fused kernels). The real
state (``real_state=True``, the fft layout) runs the JAX package's
``OceanSolver(cfg, real_state=True)`` on an NVIDIA
H100, with ``fft_backend="pallas"`` or ``"pallas_fused"``, per-channel,
packed or packed + half-spectrum channels, stencil or spectral normals,
the fields kernel on or off, and phase or absolute time (``fields_at``,
``velocity``), through hand-written CUDA kernels built with nvcc on first
use: the row DFT with a transposed or a natural store
(``csrc/fft_rows.cu``), the fused spectrum assembly + row DFT with either
store in every channel set (``csrc/fused_rows.cu``) and the fields stencil
(``csrc/fields_stencil.cu``, or the v1 halo form
``csrc/fields_stencil_v1.cu`` when ``ops.fields_stencil.FIELDS_KERNEL_V2``
is False). It also runs the Gerstner pond family: ``PondSolver`` and its
serving runtime ``PondSimulation``, whose ``"gerstner"`` mode with
``use_pallas=True`` goes through the wave-bank kernel
(``csrc/gerstner_bank.cu``). The ocean's runtime ``Simulation`` runs a
solver with JSONL metrics (``observe.Metrics``), periodic npz checkpoints
that resume by themselves (``checkpoint``, the JAX package's file format,
so either package resumes the other's files) and the asynchronous .npy
export (``native.AsyncExporter``, built from ``native/exporter.cpp`` with
g++ on first use); ``OceanSolver.reconfigure`` changes the config live,
``eval_mode="direct"`` takes the oracle's direct sum (the centered layout
at any length) and ``init(gpu_hash_seeds=...)`` the shader's hash
spectrum; ``diagnostics`` holds the sea-state statistics. The multi-band
cascade ``CascadeSolver`` (``default_cascade``: three bands of one N)
steps B patches together, every band on the channel axis of the same
kernel launches, and sums them; ``LODCascadeSolver`` refreshes each band
at its own period, and ``CascadeSimulation`` runs either with metrics,
cascade checkpoints (``checkpoint.save_cascade_checkpoint``, the JAX
format) and export. ``serve.FrameServer`` streams a runtime's fields to
TCP clients in real time (``serve.stream_frames``, ``stream_client``).
The demo scenes run as ``python -m tpu_ocean_torch
ocean|fftmesh|pond|cascade|serve`` (``demo``),
with the consumers ``viz`` (PNG heatmaps without PIL or matplotlib,
renders, OBJ meshes), ``sample`` (bilinear probes) and ``oracle`` (the
float64 direct-DFT oracle). The solvers and
runtimes run on the card unless given ``device="cpu"``; on CPU tensors
each kernel wrapper runs its plain torch version. ``OceanConfig.precision="bfloat16"`` and the bf16x3 and
three-factor switches of ``fft.planes`` run the row and fused kernels on
a matrix-form DFT engine (``csrc/dft_matrix.cuh``, bf16 tensor cores).
Gradients follow the JAX package's VJPs: with ``fft_backend="pallas"`` a
step is differentiable in the state's planes (the row-DFT kernels'
backward is the same kernels in the opposite direction, the fields
kernel's the torch twins), and ``invert_sea_state`` fits h0 to observed
heights through it; the fused and wave-bank kernels, which JAX gives no
VJP, raise NotImplementedError on a gradient. ``DistributedOceanSolver``
steps one patch with its rows split over the ranks of a
``torch.distributed`` group (``parallel.make_mesh``, one process a rank):
the row and fused kernels at the shard's shapes around an all_to_all
transpose, the mirror-balanced half route, and the fields kernel with a
ring-halo splice (``fft/distributed.py``, ``parallel/``).
This package imports torch and numpy, never jax; the JAX package
``tpu_ocean`` is its reference.
"""

from tpu_ocean_torch.config import (
    OceanConfig, PondConfig, OCEAN_DEMO, FFT_MESH_DEMO, POND_DEMO)
from tpu_ocean_torch.solver import (
    OceanSolver, OceanState, OceanStateReal, OceanFields)
from tpu_ocean_torch.gerstner import (
    WaveBank, PondFields, PondSolver, gerstner_eval, sinusoid_eval,
    gerstner_velocity, sinusoid_velocity)
from tpu_ocean_torch.cascade import (
    CascadeSolver, CascadeState, CascadeStateReal, default_cascade)
from tpu_ocean_torch.lod import LODCascadeSolver, LODState
from tpu_ocean_torch.runtime import CascadeSimulation, PondSimulation, Simulation
from tpu_ocean_torch.observe import Metrics, StepRecord
from tpu_ocean_torch.checkpoint import (
    CheckpointManager, cascade_checkpoint_periods, load_cascade_checkpoint,
    load_checkpoint, save_cascade_checkpoint, save_checkpoint)
from tpu_ocean_torch.convert import (
    cascade_state_from_numpy, cascade_state_to_numpy, state_from_numpy,
    state_to_numpy, fields_to_numpy, wavebank_from_numpy,
    pond_fields_to_numpy, shard_cols, shard_rows)
from tpu_ocean_torch.parallel import (
    initialize_distributed, make_mesh, roll_sharded)
from tpu_ocean_torch.solver_dist import DistributedOceanSolver
from tpu_ocean_torch.fft.planes import (
    fft1d_transposed, fft1d_transposed_plain, fft1d_natural_large,
    fft1d_natural_large_plain, ifft1d_planes_axis2, ifft2_pallas,
    ifft2_planes_auto, ifft2_planes_half)
from tpu_ocean_torch.ops.fields_stencil import (
    fields_stencil, fields_stencil_plain, fields_stencil_v1,
    fields_stencil_v1_plain)
from tpu_ocean_torch.ops.fused_spectrum import (
    assemble_rowfft, assemble_rowfft_plain, assemble_rowfft_natural,
    assemble_rowfft_natural_plain, ifft2_fused, ifft2_fused_planes,
    ifft2_fused_planes_half)
from tpu_ocean_torch.ops.gerstner_bank import gerstner_bank, gerstner_bank_plain

__all__ = [
    "OceanConfig", "PondConfig", "OCEAN_DEMO", "FFT_MESH_DEMO", "POND_DEMO",
    "OceanSolver", "OceanState", "OceanStateReal", "OceanFields",
    "WaveBank", "PondFields", "PondSolver", "PondSimulation",
    "Simulation", "Metrics", "StepRecord", "CheckpointManager",
    "load_checkpoint", "save_checkpoint",
    "CascadeSolver", "CascadeState", "CascadeStateReal", "default_cascade",
    "LODCascadeSolver", "LODState", "CascadeSimulation",
    "save_cascade_checkpoint", "load_cascade_checkpoint",
    "cascade_checkpoint_periods", "cascade_state_from_numpy",
    "cascade_state_to_numpy",
    "gerstner_eval", "sinusoid_eval", "gerstner_velocity", "sinusoid_velocity",
    "state_from_numpy", "state_to_numpy", "fields_to_numpy",
    "wavebank_from_numpy",
    "pond_fields_to_numpy", "shard_rows", "shard_cols",
    "DistributedOceanSolver", "make_mesh", "initialize_distributed",
    "roll_sharded",
    "fft1d_transposed", "fft1d_transposed_plain", "fft1d_natural_large",
    "fft1d_natural_large_plain", "ifft1d_planes_axis2", "ifft2_pallas",
    "ifft2_planes_auto",
    "ifft2_planes_half", "fields_stencil", "fields_stencil_plain",
    "fields_stencil_v1", "fields_stencil_v1_plain",
    "assemble_rowfft", "assemble_rowfft_plain", "assemble_rowfft_natural",
    "assemble_rowfft_natural_plain", "ifft2_fused", "ifft2_fused_planes",
    "ifft2_fused_planes_half", "gerstner_bank", "gerstner_bank_plain",
]
