#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py [--sweep-rows]

Phases, each printing its own lines:
  1. device  — nvidia-smi's name and power limit, torch's device name;
  2. build   — tpu_ocean_torch/csrc/*.cu, one nvcc per file, all started
               together, linked into one library;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the paths below give it, each launch counted
               under its own name and each channel of a multi-channel
               launch on its own scale (the wave bank also at
               4096², a timing shape); each row-DFT kernel also against
               float64 (torch.fft in complex128), and the transposed row
               pass at every tier and form and the natural one at f32 and
               bf16, at 1024² and 4096² (at bf16, both stores at
               [1,1024,1024] within 10% of the bf16 plain version's error
               on the same rows and at most 1.1 × its PERF.md §6 figure;
               the f32 three-factor pass there at most 5e-7, the bf16x3
               one at most 5e-5 and 1.1 × the bf16x3 plain version's
               error on the same rows, the f32
               direct passes, both stores, at most 1.1 × its PERF.md
               figure; at [1,4096,4096] the f32 natural pass's RMS error
               at most 1.1 × the f32 transposed pass's on the same rows);
               the two f32 direct row kernels, the transposed one (the
               cluster store, radix-2 stages) and the natural one
               (radix-16 passes), on the same inputs at every shape the
               paths give the transposed one: within 1e-6·max of each
               other, and each one's RMS error against float64 within
               1.1 × the other's; the f32 fused natural kernel (radix-16
               passes, every channel of a block from one read of the
               inputs) at every shape and channel set the paths give it,
               channel by channel: within 1e-6·max of the radix-16 row
               kernel applied to the plain assembly on the card, and its
               RMS error against the float64 DFT of the float64 assembly
               at most 1.1 × that row kernel's; the f32 fused transposed
               kernel (the same load and passes, stored through a tile)
               at every shape and channel set the paths give it, channel
               by channel: within 1e-6·max of the f32 fused natural
               kernel's output transposed on the same inputs (bit-equality
               reported), and its RMS error against the float64 DFT of the
               float64 assembly at most 1.1 × that of the radix-2 stages
               it replaces (the f32 transposed row kernel's) over the
               plain assembly; the bf16 fused natural
               kernel (the bf16 row kernel's stages behind the assembly)
               likewise against the bf16 natural row kernel: bit-equal on
               a channel with no 1/|k| term, else within 2e-3·max, RMS
               error at most 1.1 × the row kernel's; the autograd
               Functions: each row-DFT Function's backward (#1 at f32 at
               [1,1024,1024], [1,512,1024], [1,1024,512], [1,1,1024],
               [1,4096,4096], at bf16 at [1,1024,1024]; #2 at f32 and bf16
               at [1,4096,4096]) against the plain version in the opposite
               direction on the same seeded cotangents (the transposed
               store's swapped) at the forward's band, and the adjoint
               identity ⟨F x, y⟩ = ⟨x, Fᵀ y⟩ in float64 (f32: within 2e-5,
               tests/test_autodiff.py:226; bf16: 2e-3 × (‖Fx‖‖y‖ +
               ‖x‖‖Fᵀy‖)); the fields Function's gradient at 1024² and
               4096² bit-equal to torch.autograd.grad of its twins; the f32
               mixed-radix row kernel (#1 and #2 at lengths that are not
               powers of two) at every shape of MIXED_SHAPES (the paths'
               and each N of 48 … 2042 transposed, 3072 … 8190 natural, at
               M = N, N/2 and 1, and 8186 = 2·4093 natural at M = N and
               1), both directions: one launch under its
               name, within 2e-6·max of the plain version and 1e-6·max of
               float64; its autograd backward at [1,1536,1536] transposed
               and [1,3072,3072] natural as the other Functions';
  4. slice   — forty-three paths on the card, each from a seeded init,
               with every launch count set to 0 just before and read just
               after it; (i)-(xv) run the real state with OCEAN_DEMO's
               slice switches (packed + half with the fields kernel) unless
               they say otherwise, (xvi)-(xxi) the complex state with the
               JAX package's defaults (no packing, no half spectrum, the
               fields in torch):
                 (i)   OCEAN_DEMO 1024², fft_backend="pallas", 60 steps
                 (ii)  OCEAN_DEMO 1024², fft_backend="pallas_fused", 60 steps
                 (iii) OCEAN_DEMO at 4096², "pallas", 10 steps
                 (iv)  OCEAN_DEMO at 4096², "pallas_fused", 10 steps
                 (v)   OCEAN_DEMO 1024², "pallas", with
                       fields_stencil.FIELDS_KERNEL_V2 = False (the v1
                       fields kernel), 20 steps
                 (vi)  OCEAN_DEMO 1024², "pallas", precision="bfloat16",
                       60 steps: every pass on the bf16 row kernel
                 (vii) OCEAN_DEMO at 4096², "pallas_fused", "bfloat16",
                       10 steps
                 (viii) OCEAN_DEMO 1024², "pallas", with
                       fft.planes.THREE_FACTOR_THRESHOLD = 512, 20 steps:
                       the three-factor form (#1b) at f32
                 (ix)  OCEAN_DEMO 1024², "pallas_fused", with
                       THREE_FACTOR_THRESHOLD = KERNEL_B3_THRESHOLD = 512,
                       20 steps: #5b and #1b at bf16x3
                 (x)   OCEAN_DEMO 1024², "pallas_fused", per-channel
                       (pack_channels=False, half_spectrum=False) with the
                       fields kernel, 20 steps: #5 per-channel, channels 0..2
                 (xi)  OCEAN_DEMO with normals_mode="spectral" at 1024²,
                       "pallas_fused", packed + half, pallas_fields=False,
                       20 steps: #5 packed with 5 live fields
                 (xii) the spectral config at 4096², "pallas_fused",
                       per-channel, pallas_fields=False, 5 steps: #6
                       per-channel, channels 0..4
                 (xiii) the spectral config with evolution_mode="absolute"
                       at 4096², "pallas_fused", packed without half, 5
                       steps: #6 packed with 5 live fields, channels 0..2;
                       then fields_at(state, t) and velocity(state) once
                 (xiv) OCEAN_DEMO 1024², "pallas", per-channel,
                       pallas_fields=False, 20 steps: the torch assembly,
                       #1 on 3 channels and the stencil in torch; then
                       velocity on (i)'s solver (the half route)
                 (xv)  OCEAN_DEMO at 4096², "pallas", "bfloat16", 10
                       steps: the bf16 row kernel's natural store at its
                       full shapes
                 (xvi) OceanSolver(OceanConfig()): 256², "reference"
                       (torch.fft, cuFFT), the centered layout, absolute
                       time, spectral normals, 100 steps (BASELINE config
                       2's shape): no hand kernel
                 (xvii) the centered config of tests/test_parity.py at
                       1024² (L = N), "pallas", 20 steps: #1 on all 5
                       channels, two launches a step; then fields_at and
                       velocity
                 (xviii) (xvii) at 4096², 5 steps: #2, then #1, at C = 5
                 (xix) (xvii) at 1024² on "matmul" and on "stockham", 10
                       steps each (tags xix-matmul, xix-stockham): no hand
                       kernel
                 (xx)  OCEAN_DEMO 1024², "pallas_fused", the complex state,
                       20 steps: #5 per-channel (C = 3), then #1
                 (xxi) (xvii) at "bfloat16", 20 steps: the bf16 row kernel
                       (#1 at DEFAULT) on all 5 channels
                 (xxxviii) OCEAN_DEMO at 1536², "pallas", 20 steps: every
                       row pass on the f32 mixed-radix kernel's transposed
                       store (5 a step), nothing of the power-of-two kernels
                 (xxxix) OCEAN_DEMO at 3072², "pallas", 10 steps (the
                       natural regime): 3 natural and 2 transposed launches
                       of the mixed-radix kernel a step
                 (xl)  OCEAN_DEMO at 106² (2·53), "pallas", the complex
                       state, 20 steps: the mixed-radix kernel on C = 3
                       channels, two launches a step, its generic stage of
                       radix 53
                 (xxii) Simulation(OCEAN_DEMO, path (i)'s switches) at
                       1024², checkpoints and export every 20 steps, 60
                       steps: path (i)'s launches, 60 JSONL lines, the
                       exported height and foam of steps 20, 40, 60
                       bit-equal to those steps' fields; a second
                       Simulation resumes the directory at step 60 and runs
                       20 more, bit-equal (state and fields) to 80
                       uninterrupted steps from the same generator; then a
                       live reconfigure of the wind: phase, clock, step and
                       foam bit-equal, the tables the same tensors, 20 more
                       steps at the same launches; one save_checkpoint
                       timed
                 (xxiii) Simulation(OceanConfig()): matmul, the complex
                       state, 256², 100 steps, against the same run on the
                       CPU; then reconfigure to 1024² (L = 1024: the
                       centered FFT needs L = N·unit_width): the step count
                       restarts, the switches are kept, 20 steps
                 (xxiv) eval_mode="direct": FFT_MESH_DEMO (N = 12, L =
                       12.39), 100 steps, against the CPU and against a
                       float64 direct sum in numpy (direct_fields_f64);
                       then (xvii)'s config at 1024², 10 steps, against the
                       reference backend on the card, its ms/step beside
                       (xvii)'s
                 (xxv) OceanSolver(OCEAN_DEMO, path (i)'s switches)
                       .init(gpu_hash_seeds=(0.37, 0.81)) at 1024²: the h0
                       planes on the card bit-equal to numpy's
                       h0_pair_gpu_hash (and its Hermitian projection,
                       packed), 20 steps against the CPU
                 (p1)  PondSimulation(POND_DEMO, use_pallas=True): 512², the
                       packed 4-wave bank, analytic normals, 600 steps
                 (p2)  BASELINE config 3: PondConfig(resolution=512) with
                       WaveBank.random(0, 16), use_pallas=True, 600 steps
                 (xxvi) the demo CLI, tpu_ocean_torch.demo.main(["ocean",
                       "--production", "--steps", "60", "--dump-every",
                       "20", "--checkpoint-every", "20", "--save-mesh",
                       "--save-clipmap", ...]) at OCEAN_DEMO 1024²: path
                       (i)'s launches, 60 JSONL metrics lines on its
                       stderr, checkpoints at steps 20, 40, 60, the final
                       .npy files bit-equal to an OceanSolver with path
                       (i)'s switches stepped 60 times from the same
                       generator seed, each field PNG read back (zlib,
                       filter 0) equal to the viridis mapping of its .npy,
                       ocean_render.png equal to viz.shade_ocean of the
                       fields, an OBJ of 256² vertices (decimate 4) and a
                       clipmap; sample.buoy_heights and surface_at on the
                       card's final fields within 1e-6·max of the CPU copy,
                       and a finite gradient through sample_bilinear
                 (xxvii) demo.main(["pond", "--pallas", "--waves", "16",
                       "--steps", "600", ...]): (p2)'s bank at 512², one
                       wave-bank launch a step, the final fields within
                       (p2)'s band of the CPU plain path at the same t,
                       three render PNGs
                 (xxviii) demo.main(["fftmesh", ...]): rc 0, the printed
                       oracle-vs-solver error under 1e-3, no hand kernel
                 (xxix) CascadeSolver(default_cascade(1024), path (i)'s
                       switches), 60 steps: every row-DFT pass one launch
                       for the three bands (5 a step, each at C = 3), the
                       last step against the CPU plain path and against
                       the sum of three single-patch OceanSolvers (one
                       band's h0, length, choppiness and dt_multiplier
                       each) within 1e-6·max; velocity (3 launches at
                       C = 3) against the CPU
                 (xxx) the same at 4096², 10 steps: 3 natural and 2
                       transposed launches a step, each at C = 3
                 (xxxi) LODCascadeSolver(periods [8, 4, 1]) on (xxix)'s
                       switches, 64 frames: 5 launches a frame at C = the
                       bands it refreshes, held bands' planes bit-equal,
                       at frames 8-64 the height within 1e-4 and the phases
                       within 1e-5 of (xxix)'s solver stepped every frame;
                       velocity against the CPU; the out-of-place scatter
                       timed
                 (xxxii) CascadeSimulation on (xxxi)'s schedule,
                       checkpoints and export every 20 frames, 60 frames;
                       a checkpoint read on the CPU; a resume of 20 frames
                       bit-equal to 80 uninterrupted; a resume under
                       periods [4, 4, 1] refused; a live wind change
                       keeping the frame, schedule, phases and tables
                 (xxxiii) demo.main(["cascade", "--production", "--res",
                       "1024", "--camera", "3000", "--steps", "60", ...]):
                       the launches of the schedule it prints, the final
                       .npy files bit-equal to an LODCascadeSolver from
                       the same seed
                 (xxxiv) gradients: one step of path (i)'s switches from
                       a seeded init at 1024², loss Σ height² + Σ foam
                       (float64 sums), loss.backward() to h0_re: 10 row-DFT
                       launches (5 forward, 5 backward) and the fields
                       kernel once; the gradient within 1e-5·max of the
                       CPU's from the same state (the worst texel printed),
                       a central difference (eps 1e-3) at the dominant
                       element within rtol 1e-2, the adjoint identity of
                       the linear map h0 planes → height within 2e-5;
                       forward + backward timed; then pallas_fused with a
                       gradient must raise NotImplementedError, no launch
                 (xxxv) (xxxiv) at 4096²: 6 natural and 4 transposed
                       launches, the finite difference and the adjoint
                       identity (no CPU run); peak memory
                 (xxxvi) (xxxiv) at precision="bfloat16": 10 bf16 row
                       launches, the gradient within 2e-3·max of the
                       CPU's, the adjoint identity within BF16_REL ×
                       (‖Jv‖‖w‖ + ‖v‖‖Jᵀw‖)
                 (xxxvii) the inversion (invert_sea_state): the
                       packed problem at N = 64 and the complex state at
                       N = 48 (cuFFT, no hand kernel), 150 iterations of
                       Adam each, the loss below 1e-2 of its start (the
                       example's criterion) with exact launch counts; the
                       packed problem at 1024² for 30 iterations, its loss
                       curve, ms/iteration and device busy, the loss
                       falling; python -m tpu_ocean_torch.invert_sea_state
                       --packed --n 64 in a process of its own, exit 0
                 then python -m tpu_ocean_torch ocean (and cascade)
                       --production --res 256 --steps 5, each in a process
                       of its own: exit 0, its files written, the kernel
                       build loaded as it is
               every kernel must have launched exactly its per-step count
               (PATHS, POND_PATHS below; the launches at other tiers and
               forms by kernel × tier × form, fft.planes.named_launches).
               Ocean paths: the fields must be finite, the normals unit and
               the foam in [0, 1]; the last steps are replayed on the CPU plain
               path from a snapshot of the card's state and the two are
               compared (compare_fields), except (vii) and (xv), whose last
               step is compared with the card's f32 step from the same
               state; (xvii)-(xix)'s last step also with the reference
               backend's on the card from the same state within 1e-5·max,
               and (xxi)'s with the card's f32 step within 3e-2; (v)'s
               last step is also compared with the v2 kernel's from the
               same state; the spectral-normal paths' last step, run again
               at bf16, must fall outside their normals' band (a control
               of the band, where the backend honors the precision);
               fields_at and velocity are called on the card
               and on the CPU from the same state, with their own launch
               counts (EXTRA_CALLS). Pond paths: finite fields, unit normals, and
               the CPU plain path at the last step's t within atol 2e-5,
               rtol 1e-5; then the plain-torch "wave" mode and both
               velocities at 512², card against CPU, with the same band;
  5. timing  — per path ((xxii)-(xxv) at the end of their phase-4 part,
               (xxii) through Simulation.step, which synchronizes and
               checkpoints and exports every 20 steps; (xxvi) and (xxvii)
               by the CLI's own Metrics.summary(), beside (i)'s and
               (xxii)'s and beside (p2)'s): ms/step (CUDA
               events), the host's enqueue time
               per step, device busy time per step and per layer
               (torch.profiler) and the idle share, and up to 2048² the
               host's time by function (cProfile); for the pond
               PondSolver.fields in a loop and PondSimulation.step (which
               synchronizes) apart; 4096² also
               with MAX_TRANSPOSED_N = 8192 (the transposed regime); each
               kernel's device time beside its plain version's, its library
               call's where one PyTorch call computes the same function, and
               its bound; each redesigned row kernel beside its time
               before its redesign (BEFORE_REDESIGN_MS) and cuFFT's at
               each shape: the two f32 direct kernels beside each other on
               the same inputs (the cluster store's radix-2 stages against
               the natural store's radix-16 passes), the bf16x3
               three-factor kernel beside the f32 three-factor one, the
               f32 fused natural kernel's launches of C > 1 channels
               beside C launches of one channel on the same inputs (one
               read of the inputs against C) and its one-channel launches
               beside the radix-16 row kernel at [1, M, N], the f32 fused
               transposed kernel beside the f32 fused natural kernel on
               the same inputs and its launches of C > 1 channels beside C
               launches of one channel, the bf16
               fused natural kernel beside the f32 one at the same shape
               and the bf16 row kernel at [1, M, N] (and at C = 5, on no
               path, beside five of its one-channel launches), the
               others beside the f32 kernel with their store; the complex
               state's full 2-D transforms at C = 5 ((xvii), (xviii),
               (xxi)), the hand kernels' two passes beside cuFFT's
               torch.fft.ifft2;
               warm L2, nothing
               asserted. Device times come
               from torch.profiler; where it records none, from CUDA
               events, and the line says so ("timed_by" in the JSON).
Then one JSON line of kernel results, the card's name and power limit, and
last {"ok": true, "device": ...}.

With --sweep-rows, phases 4 and 5 give way to a sweep of the rows per
block: each f32 row-DFT and fused case of phase 3 (the f32 fused
kernels, both stores, in every channel set), and the cases of the bf16
fused natural kernel, the bf16 row kernel (both stores) and the f32 and
bf16x3 three-factor row kernels, at every power of two up to 16 that fits
shared memory (and, for the f32 natural row kernel and the f32 fused
kernels, 512 threads), checked against its
plain version and timed (device time, torch.profiler); the f32
transposed kernel at every such rows and every cluster size (1, 2, 4, 8);
the wrappers' choice is marked "*". No result line follows.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Without a CUDA device it stops at once. Imports no jax.
"""

import argparse
import ast
import collections
import contextlib
import cProfile
import dataclasses
import io
import json
import pstats
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
DT = 1.0 / 60.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# f32 instructions of sincosf's fast path (|x| < 105615) in the SASS of
# gerstner_bank_kernel for sm_90a (cuobjdump -sass of the built library):
# 11 FFMA, 2 FMUL, 4 FSEL, FSETP, F2I, I2FP
SINCOSF_OPS = 20
# (ok, atol, rtol) of a card-vs-CPU comparison of the pond's fields: the
# JAX package's Pallas-vs-jnp band (tests/test_pallas_kernels.py:58)
POND_ATOL, POND_RTOL = 2e-5, 1e-5

# One ocean path: fft_backend, N, steps, replay steps (the last steps
# again on the CPU plain path from a snapshot of the card's state; 0: none),
# FIELDS_KERNEL_V2, precision, the fft.planes switches set for the path,
# kernel launches per step, the band of compare_fields, the fields of the
# base config the path replaces, the solver's switches, the base config
# ("demo": OCEAN_DEMO; "default": OceanConfig(); "parity": the centered
# config of tests/test_parity.py _make_case at L = N, unit width 1) and
# the card runs the last step is held to from the same state ({label:
# band}; "f32": the path's solver at float32, "reference": the
# JAX-default complex solver on torch.fft, cuFFT). Paths (i)-(xv) run the
# real state with OCEAN_DEMO's slice switches (SLICE) unless they override
# them; (xvi)-(xxi) the complex state with the JAX defaults (no switches:
# fft_backend "reference", no packing, no half spectrum, the fields in
# torch). A fused launch outside the packed set with 3 live fields counts
# under its set (fft.planes.named_launches: "fused_transposed[per_channel]",
# "fused_natural[packed5]"). Unpacked or without half, each 2-D transform
# is one launch a pass for all its C channels. Row DFT
# passes: transposed regime (N ≤ 2048) — 2 for the full channel, and the
# half channel's Nyquist row, half rows and columns; natural regime
# (N > 2048) — the full channel's natural row pass and its column pass (a
# transposed pass on swapped axes), the half channel's natural Nyquist row
# and half rows and its transposed column pass. The fused backend
# assembles each channel inside its first row pass. Each pass runs at the
# tier and form of its length (fft.planes.engine): at 1024² the half
# channel's column pass is 512 long, so thresholds of 512 leave it on the
# f32 Stockham kernel. The complex state's ``pallas`` transform is
# fft.planes.ifft2_pallas: its 5 spectral channels (centered, spectral
# normals) ride one launch a pass; ``reference``, ``stockham`` and
# ``matmul`` launch no hand kernel.
SLICE = {"real_state": True, "pack_channels": True, "half_spectrum": True,
         "pallas_fields": True}
OceanPath = collections.namedtuple(
    "OceanPath", "tag backend size steps replay v2 precision switches "
    "per_step rel config solver base against",
    defaults=({}, SLICE, "demo", {}))
SPECTRAL = {"normals_mode": "spectral"}
PER_CHANNEL = {**SLICE, "pack_channels": False, "half_spectrum": False}
SPLIT3 = {"THREE_FACTOR_THRESHOLD": 512}
B3_SPLIT3 = {"THREE_FACTOR_THRESHOLD": 512, "KERNEL_B3_THRESHOLD": 512}
B3 = {"KERNEL_B3_THRESHOLD": 512}
# compare_fields' bands at bf16 (max abs err over max |reference|): card
# against the CPU plain path 4e-3, two row passes in sequence of 2e-3 each
# (the kernel-vs-plain band: one bf16 ulp of an intermediate flips where
# the two accumulate in other orders); against the card's f32 path 3e-2,
# the JAX package's envelope of its bf16 mode (tests/test_switch_matrix.py:93).
# At bf16x3, card against CPU 5e-5, the tier's band against float64
# (tests/test_pallas_kernels.py:232): a one-ulp f32 difference of a stage-1
# output can flip the bf16 rounding of its lo part, which moves a pass by up
# to the tier's own error (~5e-6·max), and a 2-D field takes two passes
BF16_REL, BF16_VS_F32_REL, B3_REL = 4e-3, 3e-2, 5e-5
# the complex state's ``pallas`` transform at 1024²: #1 on all 5 channels,
# two passes a step
COMPLEX_1024 = {"fft_rows_transposed": 2}
PATHS = [
    OceanPath("i", "pallas", 1024, 60, 10, True, "float32", {},
              {"fft_rows_transposed": 5, "fields_stencil": 1}, 1e-5),
    OceanPath("ii", "pallas_fused", 1024, 60, 10, True, "float32", {},
              {"fused_rows_transposed": 2, "fft_rows_transposed": 3,
               "fields_stencil": 1}, 1e-5),
    OceanPath("iii", "pallas", 4096, 10, 2, True, "float32", {},
              {"fft_rows_natural": 3, "fft_rows_transposed": 2,
               "fields_stencil": 1}, 1e-5),
    OceanPath("iv", "pallas_fused", 4096, 10, 2, True, "float32", {},
              {"fused_rows_natural": 2, "fft_rows_natural": 1,
               "fft_rows_transposed": 2, "fields_stencil": 1}, 1e-5),
    OceanPath("v", "pallas", 1024, 20, 2, False, "float32", {},
              {"fft_rows_transposed": 5, "fields_stencil_v1": 1}, 1e-5),
    OceanPath("vi", "pallas", 1024, 60, 2, True, "bfloat16", {},
              {"matrix_rows_transposed[bf16]": 5, "fields_stencil": 1},
              BF16_REL),
    OceanPath("vii", "pallas_fused", 4096, 10, 0, True, "bfloat16", {},
              {"matrix_fused_natural[bf16]": 2,
               "matrix_rows_natural[bf16]": 1,
               "matrix_rows_transposed[bf16]": 2, "fields_stencil": 1},
              BF16_VS_F32_REL, against={"f32": BF16_VS_F32_REL}),
    OceanPath("viii", "pallas", 1024, 20, 2, True, "float32", SPLIT3,
              {"matrix_rows_transposed[f32,split3]": 4,
               "fft_rows_transposed": 1, "fields_stencil": 1}, 1e-5),
    OceanPath("ix", "pallas_fused", 1024, 20, 2, True, "float32", B3_SPLIT3,
              {"matrix_fused_transposed[bf16x3,split3]": 2,
               "matrix_rows_transposed[bf16x3,split3]": 2,
               "fft_rows_transposed": 1, "fields_stencil": 1}, B3_REL),
    OceanPath("x", "pallas_fused", 1024, 20, 2, True, "float32", {},
              {"fused_transposed[per_channel]": 1,
               "fft_rows_transposed": 1, "fields_stencil": 1}, 1e-5,
              solver=PER_CHANNEL),
    OceanPath("xi", "pallas_fused", 1024, 20, 2, True, "float32", {},
              {"fused_transposed[packed5]": 2,
               "fft_rows_transposed": 3}, 1e-5,
              config=SPECTRAL, solver={**SLICE, "pallas_fields": False}),
    OceanPath("xii", "pallas_fused", 4096, 5, 1, True, "float32", {},
              {"fused_natural[per_channel]": 1,
               "fft_rows_transposed": 1}, 1e-5,
              config=SPECTRAL, solver={**PER_CHANNEL, "pallas_fields": False}),
    OceanPath("xiii", "pallas_fused", 4096, 5, 1, True, "float32", {},
              {"fused_natural[packed5]": 1,
               "fft_rows_transposed": 1}, 1e-5,
              config={**SPECTRAL, "evolution_mode": "absolute"},
              solver={**SLICE, "half_spectrum": False,
                      "pallas_fields": False}),
    OceanPath("xiv", "pallas", 1024, 20, 2, True, "float32", {},
              {"fft_rows_transposed": 2}, 1e-5,
              solver={**PER_CHANNEL, "pallas_fields": False}),
    OceanPath("xv", "pallas", 4096, 10, 0, True, "bfloat16", {},
              {"matrix_rows_natural[bf16]": 3,
               "matrix_rows_transposed[bf16]": 2, "fields_stencil": 1},
              BF16_VS_F32_REL, against={"f32": BF16_VS_F32_REL}),
    # OceanSolver(OceanConfig()): BASELINE config 2's shape on torch.fft
    OceanPath("xvi", "reference", 256, 100, 2, True, "float32", {}, {},
              1e-5, solver={}, base="default"),
    OceanPath("xvii", "pallas", 1024, 20, 2, True, "float32", {},
              COMPLEX_1024, 1e-5, solver={}, base="parity",
              against={"reference": 1e-5}),
    OceanPath("xviii", "pallas", 4096, 5, 1, True, "float32", {},
              {"fft_rows_natural": 1, "fft_rows_transposed": 1}, 1e-5,
              solver={}, base="parity", against={"reference": 1e-5}),
    OceanPath("xix-matmul", "matmul", 1024, 10, 2, True, "float32", {}, {},
              1e-5, solver={}, base="parity", against={"reference": 1e-5}),
    OceanPath("xix-stockham", "stockham", 1024, 10, 2, True, "float32", {},
              {}, 1e-5, solver={}, base="parity",
              against={"reference": 1e-5}),
    OceanPath("xx", "pallas_fused", 1024, 20, 2, True, "float32", {},
              {"fused_transposed[per_channel]": 1,
               "fft_rows_transposed": 1}, 1e-5, solver={}),
    OceanPath("xxi", "pallas", 1024, 20, 2, True, "bfloat16", {},
              {"matrix_rows_transposed[bf16]": 2}, BF16_REL, solver={},
              base="parity", against={"f32": BF16_VS_F32_REL}),
    # the sizes slice: lengths that are not powers of two, every row pass
    # on the f32 mixed-radix kernel (csrc/rows_mixed_f32.cuh): path (i)'s
    # switches at 1536² (transposed regime) and 3072² (natural regime), and
    # the complex state at 106² = (2·53)², the generic stage of a prime
    # radix inside the solver (C = 3 channels, the fields in torch)
    OceanPath("xxxviii", "pallas", 1536, 20, 2, True, "float32", {},
              {"fft_rows_mixed_transposed": 5, "fields_stencil": 1}, 1e-5),
    OceanPath("xxxix", "pallas", 3072, 10, 2, True, "float32", {},
              {"fft_rows_mixed_natural": 3, "fft_rows_mixed_transposed": 2,
               "fields_stencil": 1}, 1e-5),
    OceanPath("xl", "pallas", 106, 20, 2, True, "float32", {},
              {"fft_rows_mixed_transposed": 2}, 1e-5, solver={}),
]
# (path, solver method, launches of one call): fields_at(state, t) at the
# path's clock + 1/60 and velocity(state), on the card and on the CPU from
# the card's last state. (xiii) is unpacked without half: fields_at is its
# step's transform; velocity is one full 2-D transform in the natural
# regime. (i) is packed + half: velocity takes the half route (its rows,
# the Nyquist row and the length-512 columns). (xvii), the complex state:
# fields_at is its step's transform, velocity one channel's (C = 1).
EXTRA_CALLS = [
    ("xiii", "fields_at", {"fused_natural[packed5]": 1,
                           "fft_rows_transposed": 1}),
    ("xiii", "velocity", {"fft_rows_natural": 1, "fft_rows_transposed": 1}),
    ("i", "velocity", {"fft_rows_transposed": 3}),
    ("xvii", "fields_at", COMPLEX_1024),
    ("xvii", "velocity", COMPLEX_1024),
]
# (label, what, WaveBank.random arguments or None for the config's packed
# 4-wave bank, steps): POND_DEMO (512²) through PondSimulation with
# use_pallas=True, analytic normals; gerstner_bank launches once a step
POND_PATHS = [
    ("p1", "POND_DEMO 512², packed 4-wave bank", None, 600),
    ("p2", "BASELINE config 3, 512², WaveBank.random(0, 16)", (0, 16), 600),
]
# the cascade paths (xxix)-(xxxiii): default_cascade's three bands at
# CASCADE_N (and CASCADE_NATURAL_N, the natural regime) with path (i)'s
# switches; the LOD schedule of (xxxi) and (xxxii), and the camera distance
# of the CLI's (xxxiii). A packed + half refresh transforms its bands in 5
# row-DFT launches at C = the bands refreshed (the full channel's 2 passes;
# the half channel's rows, Nyquist row and columns; at CASCADE_NATURAL_N 3
# natural and 2 transposed)
CASCADE_N, CASCADE_NATURAL_N = 1024, 4096
LOD_PERIODS = [8, 4, 1]
CLI_CAMERA = 3000.0
# name: (source, the TPU kernel it replaces); a fused kernel in the
# per-channel set or the packed set with 5 live fields is its own entry,
# named as it counts (fft.planes.kernel_name)
KERNEL_INFO = {
    "fft_rows_transposed": ("tpu_ocean_torch/csrc/stockham_rows_cluster.cuh",
                            "tpu_ocean/fft/pallas_fft.py:235"),
    "fields_stencil": ("tpu_ocean_torch/csrc/fields_stencil.cu",
                       "tpu_ocean/ops/fields_pallas.py:255"),
    "fft_rows_natural": ("tpu_ocean_torch/csrc/rows_natural_f32.cuh",
                         "tpu_ocean/fft/pallas_fft.py:677"),
    "fused_rows_transposed": (
        "tpu_ocean_torch/csrc/fused_rows_transposed_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:127"),
    "fused_rows_natural": (
        "tpu_ocean_torch/csrc/fused_rows_natural_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:196"),
    "fused_transposed[per_channel]": (
        "tpu_ocean_torch/csrc/fused_rows_transposed_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:127"),
    "fused_transposed[packed5]": (
        "tpu_ocean_torch/csrc/fused_rows_transposed_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:127"),
    "fused_natural[per_channel]": (
        "tpu_ocean_torch/csrc/fused_rows_natural_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:196"),
    "fused_natural[packed5]": (
        "tpu_ocean_torch/csrc/fused_rows_natural_f32.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:196"),
    "fields_stencil_v1": ("tpu_ocean_torch/csrc/fields_stencil_v1.cu",
                          "tpu_ocean/ops/fields_pallas.py:45"),
    # #1 and #2 at f32, direct form, at lengths that are not powers of two
    "fft_rows_mixed_transposed": (
        "tpu_ocean_torch/csrc/rows_mixed_f32.cuh",
        "tpu_ocean/fft/pallas_fft.py:235 at non-power-of-two N"),
    "fft_rows_mixed_natural": (
        "tpu_ocean_torch/csrc/rows_mixed_f32.cuh",
        "tpu_ocean/fft/pallas_fft.py:677 at non-power-of-two N"),
    "gerstner_bank": ("tpu_ocean_torch/csrc/gerstner_bank.cu",
                      "tpu_ocean/ops/gerstner_pallas.py:30"),
    # the row and fused entries at the other tiers and forms, by tier and
    # form: the bf16 direct row passes (both stores), the bf16 direct
    # natural fused pass and the three-factor row passes have kernels of
    # their own; the rest run the matrix-form engine (csrc/dft_matrix.cuh)
    "matrix_rows_transposed[bf16]": ("tpu_ocean_torch/csrc/dft_bf16_rows.cuh",
                                     "tpu_ocean/fft/pallas_fft.py:235"),
    "matrix_rows_natural[bf16]": ("tpu_ocean_torch/csrc/dft_bf16_rows.cuh",
                                  "tpu_ocean/fft/pallas_fft.py:677"),
    "matrix_fused_natural[bf16]": (
        "tpu_ocean_torch/csrc/fused_rows_natural_bf16.cuh",
        "tpu_ocean/ops/fused_spectrum_fft.py:196"),
    "matrix_rows_transposed[f32,split3]": (
        "tpu_ocean_torch/csrc/dft_split3_f32.cuh",
        "tpu_ocean/fft/pallas_fft.py:273"),
    "matrix_rows_transposed[bf16x3,split3]": (
        "tpu_ocean_torch/csrc/dft_split3_bf16x3.cuh",
        "tpu_ocean/fft/pallas_fft.py:273"),
    # on no path: timed for PERF.md §6 (#1b and #5 at DEFAULT; #1, #2, #5
    # and #6 at B3 in the direct form, on the matrix engine)
    "matrix_rows_transposed[bf16,split3]": (
        "tpu_ocean_torch/csrc/fft_rows.cu", "tpu_ocean/fft/pallas_fft.py:273"),
    "matrix_fused_transposed[bf16]": ("tpu_ocean_torch/csrc/fused_rows.cu",
                                      "tpu_ocean/ops/fused_spectrum_fft.py:127"),
    "matrix_rows_transposed[bf16x3]": ("tpu_ocean_torch/csrc/fft_rows.cu",
                                       "tpu_ocean/fft/pallas_fft.py:235"),
    "matrix_rows_natural[bf16x3]": ("tpu_ocean_torch/csrc/fft_rows.cu",
                                    "tpu_ocean/fft/pallas_fft.py:677"),
    "matrix_fused_transposed[bf16x3]": (
        "tpu_ocean_torch/csrc/fused_rows.cu",
        "tpu_ocean/ops/fused_spectrum_fft.py:127"),
    "matrix_fused_natural[bf16x3]": ("tpu_ocean_torch/csrc/fused_rows.cu",
                                     "tpu_ocean/ops/fused_spectrum_fft.py:196"),
    "matrix_fused_transposed[bf16x3,split3]": (
        "tpu_ocean_torch/csrc/fused_rows.cu",
        "tpu_ocean/ops/fused_spectrum_fft.py:161"),
}
# kernel-vs-plain band of each tier (tests/test_torch_cuda_kernels.py)
TIER_BAND = {"f32": 1e-5, "bf16": 2e-3, "bf16x3": 1e-5}
# the f32 mixed-radix row kernel (csrc/rows_mixed_f32.cuh) by store: its
# phase-3 shapes, the paths' first ((xxxviii): 1536² rows and the half
# channel's 768-long columns; (xxxix): its 3072- and 1536-long columns on
# the transposed store, its rows on the natural one; (xl): 106 at C = 3),
# then each N at M = N, N/2 and 1 (106 = 2·53 and 2042 = 2·1021 run the
# generic stage of a prime radix); the natural store also at C = 3, and at
# 8186 = 2·4093 (the largest prime radix the kernel meets, N·p operations
# a row) at M = N and 1. Each
# shape in both directions within MIXED_BAND·max of the plain version
# (torch.fft in complex64) and MIXED_F64_MAX·max of float64
MIXED_SHAPES = {
    "fft_rows_mixed_transposed": (
        [(1, 1536, 1536), (1, 768, 1536), (1, 1, 1536), (1, 1536, 768),
         (1, 3072, 3072), (1, 3072, 1536), (3, 106, 106)]
        + [(1, m, n) for n in (48, 96, 106, 160, 224, 384, 768, 2042)
           for m in (n, n // 2, 1)]),
    "fft_rows_mixed_natural": (
        [(1, 3072, 3072), (1, 1536, 3072), (1, 1, 3072), (3, 3072, 3072)]
        + [(1, m, n) for n in (6144, 8190) for m in (n, n // 2, 1)]
        + [(1, 8186, 8186), (1, 1, 8186)])}
MIXED_BAND, MIXED_F64_MAX = 2e-6, 1e-6
# those timed in phase 5: the paths' shapes and each N at M = N
MIXED_TIMED = {(1, 768, 1536), (1, 1, 1536), (1, 1536, 768), (1, 3072, 1536),
               (3, 106, 106), (1, 1536, 3072), (1, 1, 3072),
               (3, 3072, 3072)} | {
    (1, n, n) for n in (48, 96, 106, 160, 224, 384, 768, 1536, 2042, 3072,
                        6144, 8186, 8190)}
# of those, the ones of more than ~100 ms a launch, timed over 10 calls,
# not 50 (at 8186 the generic stage sums 4093 terms an output)
MIXED_SLOW = {(1, 8186, 8186)}
# the row-DFT Functions' backward in phase 3 (store, [C, M, N], precision):
# #1 at every shape path (xxxiv) gives it (the half route's too) and at
# 4096², at bf16 at 1024²; #2 at 4096², f32 and bf16
AUTOGRAD_ROWS = [("transposed", (1, 1024, 1024), "float32"),
                 ("transposed", (1, 512, 1024), "float32"),
                 ("transposed", (1, 1024, 512), "float32"),
                 ("transposed", (1, 1, 1024), "float32"),
                 ("transposed", (1, 4096, 4096), "float32"),
                 ("transposed", (1, 1024, 1024), "bfloat16"),
                 ("natural", (1, 4096, 4096), "float32"),
                 ("natural", (1, 4096, 4096), "bfloat16"),
                 # the mixed-radix kernel, paths (xxxviii) and (xxxix)
                 ("transposed", (1, 1536, 1536), "float32"),
                 ("natural", (1, 3072, 3072), "float32")]
# the gradient paths (xxxiv)-(xxxvi): one step of path (i)'s switches from a
# seeded init, d(Σ height² + Σ foam)/d(h0_re) (tests/test_autodiff.py's
# shipping loss, summed in float64): tag, N, precision, the launches of the
# forward and the backward (each row pass again in the opposite direction;
# the fields kernel in the forward only, its backward being the twins in
# torch), and the band of the card's gradient against the CPU's (None: no
# CPU comparison, at 4096²)
GradPath = collections.namedtuple("GradPath", "tag size precision per_step cpu_rel")
GRAD_PATHS = [
    GradPath("xxxiv", 1024, "float32",
             {"fft_rows_transposed": 10, "fields_stencil": 1}, 1e-5),
    GradPath("xxxv", 4096, "float32",
             {"fft_rows_natural": 6, "fft_rows_transposed": 4,
              "fields_stencil": 1}, None),
    GradPath("xxxvi", 1024, "bfloat16",
             {"matrix_rows_transposed[bf16]": 10, "fields_stencil": 1}, 2e-3),
]
# the adjoint identity ⟨F x, y⟩ = ⟨x, Fᵀ y⟩ in float64: at f32 within
# tests/test_autodiff.py:226's 2e-5; at bf16 within the tier's band times
# ‖F x‖‖y‖ + ‖x‖‖Fᵀ y‖ (Cauchy–Schwarz on a relative error of either side):
# 2e-3 for one row pass, BF16_REL for a step's two passes in sequence
ADJOINT_F32 = 2e-5
# the inversion (xxxvii): the example's criterion, 100x in 150
# iterations at its defaults; at OCEAN_DEMO's width 30 iterations
INVERT_STEPS, INVERT_WIDE_N, INVERT_WIDE_STEPS, INVERT_LR = 150, 1024, 30, 5e-2
# the bf16 fused natural kernel (csrc/fused_rows_natural_bf16.cuh)
FUSED_NATURAL_BF16 = "matrix_fused_natural[bf16]"
# each redesigned row or fused kernel before its redesign (the matrix
# engine; for the f32 kernels the block-per-R-rows store and radix-2
# stages, and for the f32 fused kernels a block per channel),
# device ms a launch at each shape it is timed at: PERF.md §6, NVIDIA
# H100 80GB HBM3, 700 W, torch.profiler, the chip run before each
# redesign; printed beside this run's times, not measured here
BEFORE_REDESIGN_MS = {
    "fft_rows_transposed": {
        (1, 1024, 1024): 0.0148, (1, 512, 1024): 0.0111,
        (1, 1024, 512): 0.0080, (1, 1, 1024): 0.0040,
        (1, 4096, 4096): 0.4708, (1, 4096, 2048): 0.1744,
        (3, 1024, 1024): 0.0496, (2, 1024, 1024): 0.0282,
        (3, 4096, 4096): 1.3922, (5, 4096, 4096): 2.3091},
    "fft_rows_natural": {
        (1, 4096, 4096): 0.1958, (1, 2048, 4096): 0.1062,
        (1, 1, 4096): 0.0090, (1, 1024, 1024): 0.0126},
    "matrix_rows_transposed[bf16]": {
        (1, 1024, 1024): 0.0769, (1, 512, 1024): 0.0452,
        (1, 1024, 512): 0.0481, (1, 1, 1024): 0.0139,
        (1, 4096, 4096): 1.5660, (1, 4096, 2048): 0.7424},
    "matrix_rows_natural[bf16]": {
        (1, 4096, 4096): 1.1609, (1, 2048, 4096): 0.5911,
        (1, 1, 4096): 0.0508},
    "matrix_rows_transposed[f32,split3]": {
        (1, 1024, 1024): 0.0684, (1, 512, 1024): 0.0384,
        (1, 1, 1024): 0.0116},
    "matrix_rows_transposed[bf16x3,split3]": {
        (1, 1024, 1024): 0.0382, (1, 1, 1024): 0.0075},
    "fused_rows_natural": {
        (4096, 4096, "ch 0"): 0.2965, (2048, 4096, "ch 1"): 0.1576},
    "fused_rows_transposed": {
        (1024, 1024, "ch 0"): 0.0229, (512, 1024, "ch 1"): 0.0146},
    "fused_transposed[per_channel]": {
        (1024, 1024, "ch 0-2", "per_channel"): 0.0617},
    "fused_transposed[packed5]": {
        (1024, 1024, "ch 0-1", "packed5"): 0.0428,
        (512, 1024, "ch 2", "packed5"): 0.0146},
    "fused_natural[per_channel]": {
        (4096, 4096, "ch 0-4", "per_channel"): 1.3820},
    "fused_natural[packed5]": {
        (4096, 4096, "ch 0-2", "packed5"): 0.8519,
        (2048, 4096, "ch 2", "packed5"): 0.1575},
    FUSED_NATURAL_BF16: {
        (4096, 4096, "ch 0"): 1.2213, (2048, 4096, "ch 1"): 0.6303,
        (2048, 4096, "ch 2", "packed5"): 0.6202}}
# the f32 fused natural kernel (csrc/fused_rows_natural_f32.cuh) under
# each name it counts under, one per channel set
FUSED_NATURAL_F32 = ("fused_rows_natural", "fused_natural[per_channel]",
                     "fused_natural[packed5]")
# the f32 fused transposed kernel (csrc/fused_rows_transposed_f32.cuh)
# likewise
FUSED_TRANSPOSED_F32 = ("fused_rows_transposed",
                        "fused_transposed[per_channel]",
                        "fused_transposed[packed5]")
# one bf16 row pass against float64 at [1,1024,1024] (max abs error over
# max |float64|) on the matrix engine (PERF.md §6). The kernels round the
# same operands as the bf16 plain version, so on the same rows their error
# is the plain version's within 10%; the error itself depends on the rows
# more than that from one input to another, so the PERF.md figure bounds it
# from above only
BF16_ROWS_F64_ERR, BF16_ROWS_F64_SPREAD = 2.86e-3, 0.1
# one f32 three-factor row pass against float64 at [1,1024,1024]: at most
# 5e-7 x max (the matrix engine read 2.48e-7, PERF.md §6)
SPLIT3_F64_MAX = 5e-7
# one bf16x3 three-factor row pass against float64 at [1,1024,1024]: at
# most the tier's band 5e-5 x max, and at most 1.1 x the bf16x3 plain
# version's error on the same rows (the kernel splits the same operands)
B3_SPLIT3_F64_MAX, B3_SPLIT3_F64_SPREAD = 5e-5, 1.1
# one f32 direct row pass against float64 at [1,1024,1024] (PERF.md §6,
# the radix-2 stages): each store's max error at most 1.1 x. The f32
# natural pass's RMS error at [1,4096,4096] at most F32_F64_SPREAD x the
# transposed pass's on the same rows, and the two f32 direct kernels' RMS
# errors within F32_F64_SPREAD x of each other on the same rows at every
# path shape. Between the two kernels the RMS error is the statistic that
# holds still: on the H100 their max errors over one seed's rows differ by
# up to 16% either way, their RMS errors by 3-6% (PERF.md §6).
F32_ROWS_F64_ERR = 1.67e-7
F32_F64_SPREAD = 1.1
TIER_CODE = {"0": "f32", "1": "bf16", "2": "bf16x3"}
OCEAN_NOTE = ("torch ops: phase, assembly where unfused, C2R fold, "
              "interleave, transposing copies, positions, fields where "
              "pallas_fields=False")
POND_NOTE = "torch ops: none expected, the pond step is one kernel"


def log(*parts):
    print(*parts, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def fused_mode(name):
    """The channel set of a fused kernel's entry, for the kernels line, or
    None for a kernel that is not fused."""
    if "fused" not in name:
        return None
    if "per_channel" in name:
        return "per-channel (packed=False)"
    return "packed, nch_live=5" if "packed5" in name else "packed, nch_live=3"


def spectral_normal_band(ref, packed, rel):
    """(band, scale) of spectral normals n = normalize((−sx, 1, −sz)),
    card against ``ref``: |v| ≥ 1 and the normalization's Jacobian is (I − nnᵀ)/|v|, so
    |δn| ≤ |δ(sx, sz)| ≤ √2·δs. A slope's transform error δs is held to
    rel × the largest value of the channel that carries it, as
    compare_fields holds each transformed field: packed, slope_x shares a
    channel with disp_z, so the scale is max(|disp_z|, |slopes|);
    per-channel each slope has a channel of its own. Plus 4 f32 ulps of 1
    for the normalization's rounding."""
    n = ref.normal.astype(np.float64)
    slopes = np.abs(n[..., [0, 2]] / n[..., 1:2]).max()
    scale = max(slopes, np.abs(ref.disp_z).max()) if packed else slopes
    return np.sqrt(2) * rel * scale + 4 * 2.0 ** -24, scale


def kernel_group(key):
    """The port's kernel a profiler key names, or "torch ops"."""
    # the bf16 fused natural kernel first: its name must not fall to the
    # rules for the row kernels or the matrix engine below
    if "bf16_fused_natural_kernel" in key:
        return "matrix_fused_natural[bf16]"
    if "mixed_rows_kernel" in key:
        natural = "<true>" in key or "ILb1E" in key
        return f"fft_rows_mixed_{'natural' if natural else 'transposed'}"
    if "stockham_rows_cluster_kernel" in key:
        return "fft_rows_transposed"
    if "radix16_rows_natural_kernel" in key:
        return "fft_rows_natural"
    if "radix16_fused_rows_natural_kernel" in key:
        return "fused_rows_natural"
    # the f32 fused transposed kernel ahead of the generic fused_rows_kernel
    # rule below
    if "radix16_fused_rows_transposed_kernel" in key:
        return "fused_rows_transposed"
    m = (re.search(r"bf16_rows_kernel<\d+, (true|false)>", key)
         or re.search(r"bf16_rows_kernelILi\d+ELb([01])E", key))
    if m is not None:
        natural = m.group(1) in ("true", "1")
        return f"matrix_rows_{'natural' if natural else 'transposed'}[bf16]"
    if "split3_f32_rows_kernel" in key:
        return "matrix_rows_transposed[f32,split3]"
    if "split3_bf16x3_rows_kernel" in key:
        return "matrix_rows_transposed[bf16x3,split3]"
    natural = "<true," in key or "ILb1E" in key
    store = "natural" if natural else "transposed"
    for stem, kind in (("fft_rows_kernel", "rows"),
                       ("fused_rows_kernel", "fused")):
        if stem not in key:
            continue
        # MatrixEngine<tier, split3>, demangled or mangled
        m = (re.search(r"MatrixEngine<(\d), (true|false)>", key)
             or re.search(r"MatrixEngineILi(\d)ELb([01])E", key))
        if m is None:
            return f"{'fft_rows' if kind == 'rows' else 'fused_rows'}_{store}"
        split3 = m.group(2) in ("true", "1")
        tier = TIER_CODE[m.group(1)]
        return f"matrix_{kind}_{store}[{tier}{',split3' if split3 else ''}]"
    if "fields_stencil_v1_kernel" in key:
        return "fields_stencil_v1"
    if "gerstner_bank_kernel" in key:
        return "gerstner_bank"
    if "fields_stencil_kernel" in key:
        return "fields_stencil"
    return "torch ops"


@contextlib.contextmanager
def dft_switches(planes, switches):
    """fft.planes' module switches (THREE_FACTOR_THRESHOLD,
    KERNEL_B3_THRESHOLD) set to ``switches`` for the duration."""
    saved = {k: getattr(planes, k) for k in switches}
    for k, v in switches.items():
        setattr(planes, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(planes, k, v)


@contextlib.contextmanager
def recorded_rows(planes):
    """Every row-DFT kernel launch while inside, as (entry, C): the list
    fft.planes' launch function appends to."""
    rows = []
    launch = planes._launch_rows

    def recorded(entry, real_part, *args):
        rows.append((entry, real_part.shape[0]))
        return launch(entry, real_part, *args)

    planes._launch_rows = recorded
    try:
        yield rows
    finally:
        planes._launch_rows = launch


def lod_row_launches(periods, first, last, per_refresh=5):
    """C of each row-DFT launch of LOD frames ``first``..``last``: a frame
    refreshes the bands whose period divides it, in ``per_refresh``
    launches at C = their number (none when no band refreshes)."""
    sizes = []
    for frame in range(first, last + 1):
        refreshed = sum(frame % p == 0 for p in periods)
        sizes += [refreshed] * (per_refresh if refreshed else 0)
    return sizes


def cli_lod_periods(text):
    """The LOD schedule the cascade scene prints on stderr."""
    return ast.literal_eval(re.search(r"^# LOD periods (\[[\d, ]*\])", text,
                                      re.M).group(1))


def cuda_ms(fn, iters=100, warmup=10):
    """(mean milliseconds per call of ``fn`` on the device's timeline, by
    CUDA events; mean host milliseconds per call to enqueue it, by the host
    clock). Where the two are close, the host sets the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms(fn, iters=50, attempts=3):
    """(device ms per call, {kernel name: device ms per call}, how it was
    timed) of ``fn``: the CUDA kernel time torch.profiler records over
    ``iters`` calls after one warm-up. Unlike CUDA events around the calls,
    it leaves out the gaps in which the device waits for the host. The
    profiler now and then records no device time for a window (seen once
    on the H100, for one cuFFT call); such a window is profiled again, and
    after ``attempts`` empty windows the CUDA-event time stands in, under
    the key "(CUDA events)", and the third item says "cuda_events" instead
    of "profiler": around calls of under ~50 µs of device work that time is
    the host's launch rate, not the device's."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_kernel = {e.key: e.self_device_time_total / 1e3 / iters
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0}
        if per_kernel:
            return sum(per_kernel.values()), per_kernel, "profiler"
    ms = cuda_ms(fn, iters)[0]
    log(f"[timing] torch.profiler recorded no device time in {attempts} "
        f"windows; CUDA events instead: {ms:.4f} ms a call")
    return ms, {"(CUDA events)": ms}, "cuda_events"


def host_profile(fn, steps=50, top=10):
    """The host's time per call of ``fn`` by function, from cProfile over
    ``steps`` calls (cProfile's own cost inflates every Python call, so the
    shares, not the sums, are what to read): [(function, µs per call)]."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tottime / steps * 1e6, f"{Path(file).name}:{line}({name})")
                   for (file, line, name), (_, _, tottime, _, _) in stats.items()),
                  reverse=True)
    return [(name, us) for us, name in rows[:top]]


def matrix_ops(tier, split3, n1, n2):
    """(f32, bf16 tensor-core) operations a point of a matrix-form row DFT
    at (tier, split3), n = n2·n1: stage 1 (8·n2) and stage 2 (8·n1, or
    8·(8 + 16) in the three-factor form) on the tensor cores, three times
    at bf16x3, where stage 1 runs in f32 instead (the TPU kernel's p1 =
    HIGHEST); 6 f32 for each twiddle (T, and TW in the three-factor
    form)."""
    stage2 = 8 * (24 if split3 else n1)
    f32_ops = 6 + (6 if split3 else 0)
    if tier == "bf16x3":
        return f32_ops + 8 * n2, 3 * stage2
    return f32_ops, 8 * n2 + stage2


def bound(nbytes, f32_ops, tensor_ops=0):
    """(least ms the card could take, what bounds it): bytes over the HBM
    rate against f32 operations over the f32 peak plus bf16 tensor-core
    operations over the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_FLOPS_PER_S + tensor_ops / BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def normal_sensitivity(fields, cfg, delta):
    """Per texel, how far the normal can move when the stencil's inputs
    (height, chop·disp) move by at most ``delta``. Each component of
    u, v is a difference of two inputs, so |δu|, |δv| ≤ 2√3·δ; to first
    order c = u×v moves by |δu||v| + |u||δv| and c/|c| by twice that over
    |c|: |δn| ≤ 4√3·δ·(|u| + |v|)/|u×v|. Large where u and v are nearly
    parallel or short (folds)."""
    chop, texel = cfg.choppiness, cfg.length / cfg.resolution
    dx, h, dz = (chop * fields.disp_x.astype(np.float64),
                 fields.height.astype(np.float64),
                 chop * fields.disp_z.astype(np.float64))

    def xd(a):
        return np.roll(a, -1, 0) - np.roll(a, 1, 0)

    def zd(a):
        return np.roll(a, 1, 1) - np.roll(a, -1, 1)

    u = np.stack([xd(dx) + 2 * texel, xd(h), xd(dz)], -1)
    v = np.stack([zd(dx), zd(h), zd(dz) - 2 * texel], -1)
    lu, lv = np.linalg.norm(u, axis=-1), np.linalg.norm(v, axis=-1)
    return 4 * np.sqrt(3) * delta * (lu + lv) / np.linalg.norm(np.cross(u, v), axis=-1)


def compare_fields(card, cpu, cfg, tag, against="cpu", rel=1e-5, packed=True):
    """Hold the card's fields to the CPU plain path's (or to ``against``,
    another card run from the same state), with the bands of
    tests/test_packing.py at ``rel``: rel·max|cpu| for height,
    displacements, positions and Jacobian; 2e-4 for normals and
    25·rel·max|foam| for foam, each plus the first-order effect of the
    measured input differences (normal_sensitivity; spectral normals
    spectral_normal_band, of the slopes' channels, ``packed`` or not, as
    they are well conditioned): at 1024² a few texels
    sit on folds where any two f32 transforms give normals up to ~1e-3
    apart (the CPU plain path alone is that far from float64 there). Foam
    follows J and n: |δfoam| ≤ 1.5·(|δJ| + 0.3·|δn|), smoothstep's slope
    being ≤ 1.5. ``rel`` is 1e-5 for f32 (the bands of
    tests/test_packing.py) and wider for bf16 and bf16x3 (PATHS)."""
    chop = cfg.choppiness
    err = {name: np.abs(getattr(card, name) - getattr(cpu, name))
           for name in cpu._fields}
    for name in ("height", "disp_x", "disp_z", "pos_x", "pos_z", "jacobian"):
        band = rel * np.abs(getattr(cpu, name)).max()
        log(f"[slice {tag}] card vs {against} {name}: max abs err "
            f"{err[name].max():.3e} <= {band:.3e} ({rel:g} x max|{against}|)")
        require(err[name].max() <= band,
                f"path {tag}: card and {against} disagree on {name}")
    delta = max(err["height"].max(), chop * err["disp_x"].max(),
                chop * err["disp_z"].max())
    n_err = err["normal"].max(-1)
    if cfg.normals_mode == "spectral":
        band, scale = spectral_normal_band(cpu, packed, rel)
        n_band = np.full_like(n_err, band)
        log(f"[slice {tag}] card vs {against} spectral normal: max abs err "
            f"{n_err.max():.3e} <= {band:.3e} (sqrt(2) x {rel:g} x {scale:.4g}, "
            f"the max of the slopes' channels{', packed' if packed else ''}): "
            f"{bool((n_err <= n_band).all())} (err/band {n_err.max() / band:.3f})")
    else:
        n_band = 2e-4 + normal_sensitivity(cpu, cfg, delta)
        log(f"[slice {tag}] card vs {against} normal: max abs err "
            f"{n_err.max():.3e}; {int((n_err > 2e-4).sum())} texels beyond "
            f"2e-4, all within 2e-4 + sensitivity to the input error "
            f"{delta:.3e}: {bool((n_err <= n_band).all())} (worst err/band "
            f"{(n_err / n_band).max():.3f})")
    require((n_err <= n_band).all(),
            f"path {tag}: card and {against} disagree on normal")
    f_raw = 25 * rel * np.abs(cpu.foam).max()
    f_band = f_raw + 1.5 * (err["jacobian"] + 0.3 * n_err)
    log(f"[slice {tag}] card vs {against} foam: max abs err {err['foam'].max():.3e}; "
        f"{int((err['foam'] > f_raw).sum())} texels beyond {f_raw:.3e} "
        f"(25 x {rel:g} x max), all within that + 1.5(|dJ| + 0.3|dn|): "
        f"{bool((err['foam'] <= f_band).all())} (worst err/band "
        f"{(err['foam'] / f_band).max():.3f})")
    require((err["foam"] <= f_band).all(),
            f"path {tag}: card and {against} disagree on foam")


def rms_rel_err(got, ref):
    """RMS error of the (re, im) planes ``got`` against the float64 (re,
    im) ``ref``, over the RMS of ``ref``."""
    err = sum(((g.double() - r) ** 2).mean() for g, r in zip(got, ref))
    return torch.sqrt(err / sum((r ** 2).mean() for r in ref)).item()


def invk_free(packed, nch_live, ch):
    """True for a channel whose assembly takes no 1/|k| term: per-channel
    channels 0 (h̃), 3 (−kx·h̃) and 4 (−kz·h̃), and the packed set's third
    channel with 5 live fields (−kz·h̃ alone); the other packed channels
    take one."""
    return ch in (0, 3, 4) if not packed else (nch_live, ch) == (5, 2)


def assembly_f64(h0_planes, phase, length, dz_sign, *, epsilon, ch,
                 packed, nch_live, row_offset=0):
    """Channel ``ch`` of the set (fused_spectrum's assembly) in float64
    from the f32 inputs, kx and kz from 2π/L in float64: the values the
    fused kernels' f32 arithmetic rounds. (re, im) float64 [M, N] on the
    inputs' device."""
    h0r, h0i, h0cr, h0ci = (q.double() for q in h0_planes)
    c, s = torch.cos(phase.double()), torch.sin(phase.double())
    htr = (h0r + h0cr) * c + (h0ci - h0i) * s
    hti = (h0i + h0ci) * c + (h0r - h0cr) * s
    m, n = phase.shape
    kw = dict(device=phase.device, dtype=torch.float64)
    row = torch.arange(m, **kw)[:, None] + row_offset
    col = torch.arange(n, **kw)[None, :]
    kx = 2 * np.pi / length * torch.where(row < n // 2, row, row - n)
    kz = 2 * np.pi / length * torch.where(col < n // 2, col, col - n)
    kmag2 = kx * kx + kz * kz
    invk = torch.where(kmag2 < float(epsilon) ** 2, 0.0, 1.0 / kmag2.sqrt())
    w = [float(ch == i) for i in range(5)]
    if not packed:
        k = (w[0] + w[1] * kx * invk + w[2] * dz_sign * kz * invk
             - w[3] * kx - w[4] * kz)
        return k * htr, k * hti
    rowmask, colmask = (row != n // 2).double(), (col != n // 2).double()
    a = w[0] * (1 + kx * invk * rowmask)
    b = w[1] * dz_sign * kz * invk * colmask
    if nch_live == 5:
        a = a - w[1] * kx * rowmask
        b = b - w[2] * kz * colmask
    return a * htr + b * hti, a * hti - b * htr


def check_kernel(name, shape, got, want, band=1e-5, channels=1):
    """Max abs error of a kernel's (re, im) against its plain version's;
    raises beyond band·max|plain|. With ``channels`` > 1 each channel of
    the [C, ...] outputs is held to its own max (the slope channels are
    smaller than the height's); returns the worst channel's (err, scale)."""
    torch.cuda.synchronize()
    require(all(g.shape == w.shape for g, w in zip(got, want)),
            f"{name} {shape}: shape {got[0].shape}")
    worst = None
    for c in range(channels):
        gc, wc = ((got, want) if channels == 1 else
                  (tuple(g[c] for g in got), tuple(w[c] for w in want)))
        scale = max(w.abs().max().item() for w in wc)
        err = max((g - w).abs().max().item() for g, w in zip(gc, wc))
        require(err <= band * scale, f"{name} {shape} channel {c} disagrees "
                f"({err:.3e} = {err / scale:.3e} x max|plain|, band {band:g})")
        if worst is None or err / scale > worst[0] / worst[1]:
            worst = (err, scale)
    return worst


@dataclasses.dataclass
class Case:
    """One kernel at one shape: its call, its plain version's, a library
    call computing the same function (or None), the float64 reference
    (or None), the bytes and operations of its bound, its band against
    the plain version, the fft.planes switches it runs under, its channels
    (each checked on its own scale), the name its launch counts under
    where that is not ``name`` (a slope channel of the matrix engine) and
    the (tier, split3) it runs at."""
    name: str
    shape: list
    run: object
    plain: object
    library: object
    nbytes: int
    f32_ops: int
    tensor_ops: int = 0
    band: float = 1e-5
    f64: object = None
    switches: dict = dataclasses.field(default_factory=dict)
    channels: int = 1
    counted: str = ""
    engine: tuple = ("f32", False)


# the kernels --sweep-rows sweeps (by name): the f32 direct row kernels
# (both stores) and fused kernels (both stores, in every channel set),
# the bf16 fused natural kernel, the bf16 row kernel (both stores) and the
# f32 and bf16x3 three-factor row kernels
SWEPT = ("fft_rows_transposed", "fft_rows_natural", *FUSED_TRANSPOSED_F32,
         *FUSED_NATURAL_F32, FUSED_NATURAL_BF16,
         "matrix_rows_transposed[bf16]",
         "matrix_rows_natural[bf16]", "matrix_rows_transposed[f32,split3]",
         "matrix_rows_transposed[bf16x3,split3]")


def sweep_rows(cases, planes):
    """Time each row-DFT and fused case at every power-of-two rows per
    block up to 16 that fits shared memory, each checked against its plain
    version first (the f32 natural row kernel and the f32 fused kernels,
    16 points a thread, up to 512 threads a block); the f32 transposed kernel (the cluster store) at
    every such rows and every cluster size; the wrappers' own choice
    marked "*"."""
    chosen_fn, cluster_fn = planes.rows_per_block, planes.transposed_cluster
    sms = planes.sm_count(torch.device("cuda"))
    for case in cases:
        name, shape, run, plain = case.name, case.shape, case.run, case.plain
        if name not in SWEPT:
            continue
        fused_case = "fused" in name
        c, m, n = (case.channels, *shape[:2]) if fused_case else shape
        natural = "natural" in name
        tier, split3 = case.engine
        if fused_case:
            shared = planes.fused_block_shared_bytes(tier, split3, natural)
            chosen = planes.fused_rows(c, m, n, sms, natural, tier, split3)
        else:
            shared = planes.block_shared_bytes(tier, split3, natural)
            chosen = chosen_fn(c, m, n, sms, planes.row_pass_max_rows(
                n, natural, tier, split3), shared)
        clustered = name == "fft_rows_transposed"
        k_chosen = cluster_fn(m, n, chosen) if clustered else 1
        # the f32 natural row kernel and the f32 fused kernels hold 16
        # points a thread
        threads = (16 * planes.RADIX16_MAX_THREADS
                   if (natural or fused_case) and tier == "f32"
                   and not split3 else 1 << 30)
        points = [(1 << i, k) for i in range(5)
                  if shared(1 << i, n) <= planes.SMEM_LIMIT
                  and (1 << i) * n <= threads
                  for k in (planes.CLUSTER_SIZES if clustered else (1,))]
        want = plain()
        for rows, k in points:
            planes.rows_per_block = lambda *_, r=rows, **__: r
            planes.transposed_cluster = lambda *_, k=k, **__: k
            try:
                err, scale = check_kernel(name, shape, run(), want,
                                          case.band, case.channels)
                ms, _, how = device_ms(run)
            finally:
                planes.rows_per_block = chosen_fn
                planes.transposed_cluster = cluster_fn
            mark = "*" if (rows, k) == (chosen, k_chosen) else " "
            log(f"[sweep] {name} {shape} rows {rows:2d}"
                + (f" cluster {k}" if clustered else "")
                + f"{mark} {ms * 1e3:8.2f} µs ({how}), "
                f"err {err / scale:.1e} x max|plain|")


def check_fields(card, n, tag):
    for name in card._fields:
        a = getattr(card, name)
        want_shape = (n, n, 3) if name == "normal" else (n, n)
        require(a.shape == want_shape, f"path {tag}: {name} has shape {a.shape}")
        require(np.isfinite(a).all(), f"path {tag}: {name} is not finite")
    norm_err = np.abs(np.linalg.norm(card.normal, axis=-1) - 1.0).max()
    require(norm_err <= 1e-5, f"path {tag}: |normal| - 1 reaches {norm_err}")
    require(card.foam.min() >= 0.0 and card.foam.max() <= 1.0,
            f"path {tag}: foam outside [0, 1]")
    log(f"[slice {tag}] fields finite, shapes ok, max ||normal| - 1| "
        f"{norm_err:.2e}, foam in [{card.foam.min():.3f}, "
        f"{card.foam.max():.3f}], height max |.| {np.abs(card.height).max():.4f}")


def compare_pond(card, cpu, tag, what):
    """Hold the card's pond outputs (numpy) to the CPU's within atol
    POND_ATOL + rtol POND_RTOL · |cpu| per element."""
    for name, g, w in zip(what, card, cpu):
        err = np.abs(g - w)
        band = POND_ATOL + POND_RTOL * np.abs(w)
        log(f"[slice {tag}] card vs cpu {name}: max abs err {err.max():.3e}, "
            f"worst err/band {(err / band).max():.3f} (atol {POND_ATOL:g}, "
            f"rtol {POND_RTOL:g})")
        require((err <= band).all(), f"path {tag}: card and cpu disagree on {name}")


def cli_metrics(text, steps, what):
    """The demo CLI's stderr: require one JSONL metrics line for each of
    ``steps`` steps; return its closing Metrics.summary() dict."""
    records = [json.loads(line) for line in text.splitlines()
               if line.startswith("{")]
    require([r["step"] for r in records] == list(range(1, steps + 1)),
            f"path {what}: {len(records)} metrics lines, not {steps}")
    return ast.literal_eval(
        re.search(r"^# \d+ .*: (\{.*\})$", text, re.M).group(1))


def cli_fftmesh_error(text):
    """The oracle-vs-solver error the fftmesh scene prints on stderr."""
    return float(re.search(r"max rel height error at t=[\d.]+: (\S+)",
                           text).group(1))


def check_pond_fields(card, n, tag):
    for name in card._fields:
        a = getattr(card, name)
        want_shape = (n, n, 3) if name == "normal" else (n, n)
        require(a.shape == want_shape, f"path {tag}: {name} has shape {a.shape}")
        require(np.isfinite(a).all(), f"path {tag}: {name} is not finite")
    norm_err = np.abs(np.linalg.norm(card.normal, axis=-1) - 1.0).max()
    require(norm_err <= 1e-5, f"path {tag}: |normal| - 1 reaches {norm_err}")
    log(f"[slice {tag}] fields finite, shapes ok, max ||normal| - 1| "
        f"{norm_err:.2e}, height max |.| {np.abs(card.height).max():.4f}, "
        f"offset_x max |.| {np.abs(card.offset_x).max():.4f}")


def direct_fields_f64(cfg, h0, h0_conj, t):
    """The fields at absolute time ``t`` from the oracle's direct sum
    (FFTMesh.cs:178-276), in float64 numpy: the port's float64 host tables
    (ω, the channel coefficients, the centered wavenumbers and the mesh
    coordinates), h̃ = h0·e^{iωt} + h0*·e^{−iωt}, each channel C_c = c_c·h̃
    summed as F_c = Eᵀ·C_c·E with E[n, i] = e^{i·k_n·x_i}; the spectral
    normals and the oracle's foam (one-sided differences, zero on the last
    row and column) on top. Centered layout, spectral normals."""
    from tpu_ocean_torch import OceanFields, evolve, grids
    require(cfg.spectrum_layout == "centered"
            and cfg.normals_mode == "spectral",
            "direct_fields_f64 takes the centered layout, spectral normals")
    n = cfg.resolution
    phase = evolve.omega_grid(cfg) * t
    pv = np.exp(1j * phase)
    h = (np.asarray(h0, np.complex128) * pv
         + np.asarray(h0_conj, np.complex128) * np.conj(pv))
    x1d = grids.coordinate_1d(n, cfg.unit_width)
    e = np.exp(1j * np.outer(grids.wavenumbers_1d(n, cfg.length, "centered"),
                             x1d))
    f = [e.T @ (c * h) @ e for c in evolve.spectrum_coefficients(cfg)]
    height, disp_x, disp_z = f[0].real, f[1].imag, f[2].imag
    normal = np.stack([-f[3].imag, np.ones((n, n)), -f[4].imag], -1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)

    def one_sided(d, axis):
        g = 0.5 * (d - np.roll(d, -1, axis))
        g[(slice(None),) * axis + (-1,)] = 0.0
        return g

    jac = ((1 + one_sided(disp_x, 0)) * (1 + one_sided(disp_z, 1))
           - one_sided(disp_z, 0) * one_sided(disp_x, 1))
    turb = np.clip(1 - jac + 0.3 * np.hypot(normal[..., 0], normal[..., 2]),
                   0.0, 1.0)
    x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
    chop = cfg.choppiness
    return OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                       pos_x=x0 - chop * disp_x, pos_z=z0 - chop * disp_z,
                       normal=normal, foam=turb * turb * (3 - 2 * turb),
                       jacobian=jac)


BASE_NAMES = {"demo": "OCEAN_DEMO", "default": "OceanConfig()",
              "parity": "tests/test_parity.py's centered config"}


def path_switches(path):
    """The path's config fields and the solver switches off SLICE."""
    return {**path.config, **{k: v for k, v in path.solver.items()
                              if SLICE.get(k) != v}}


def path_label(path):
    """The path's base config, backend, precision, state and switches."""
    state = "real" if path.solver.get("real_state") else "complex"
    return (f"{BASE_NAMES[path.base]} fft_backend={path.backend!r}, "
            f"precision={path.precision!r}, {state} state"
            + "".join(f", {k}={v!r}" for k, v in path_switches(path).items()))


@contextlib.contextmanager
def fields_switch(fs, v2):
    """fields_stencil's kernel for the duration: v2, or v1 when False."""
    saved = fs.FIELDS_KERNEL_V2
    fs.FIELDS_KERNEL_V2 = v2
    try:
        yield
    finally:
        fs.FIELDS_KERNEL_V2 = saved


def dot64(a, b):
    """⟨a, b⟩ accumulated in float64."""
    return torch.sum(a.double() * b.double()).item()


def adjoint_check(what, lhs, rhs, yy, xg, band, cauchy):
    """Require |lhs − rhs| within the adjoint identity's bound: at f32
    (``band`` None) atol ADJOINT_F32·√max(⟨Fx, Fx⟩, |⟨x, Fᵀy⟩|, 1) + rtol
    ADJOINT_F32·|⟨x, Fᵀy⟩| (tests/test_autodiff.py:226, with ``xg`` =
    ⟨x, Fᵀy⟩), else ``band`` × ``cauchy`` (‖F x‖‖y‖ + ‖x‖‖Fᵀ y‖)."""
    if band is None:
        bound = ADJOINT_F32 * (max(abs(yy), abs(xg), 1.0) ** 0.5 + abs(rhs))
    else:
        bound = band * cauchy
    log(f"[autograd] {what}: adjoint identity <F x, y> {lhs:.10e}, "
        f"<x, F^T y> {rhs:.10e}, gap {abs(lhs - rhs):.3e} <= {bound:.3e} "
        f"({abs(lhs - rhs) / abs(lhs):.3e} relative)")
    require(abs(lhs - rhs) <= bound, f"{what}: the adjoint identity fails")


def grad_loss(fields):
    """Σ height² + Σ foam, summed in float64 (at 1024² an f32 sum over 1 M
    texels loses a central difference to cancellation)."""
    return (fields.height.double() ** 2).sum() + fields.foam.double().sum()


def slice_gradient(solver, state):
    """(loss, d loss/d h0_re) of one step from ``state``."""
    leaf = state.h0_re.detach().clone().requires_grad_()
    _, fields = solver.step(state._replace(h0_re=leaf), DT)
    loss = grad_loss(fields)
    return loss.detach(), torch.autograd.grad(loss, leaf)[0]


def finite_difference(solver, state, grad, eps=1e-3):
    """(index, central difference, gradient) at the dominant element of
    ``grad``, the loss in float64."""
    idx = tuple(int(i) for i in np.unravel_index(int(grad.abs().argmax()),
                                                 tuple(grad.shape)))
    bump = torch.zeros_like(state.h0_re)
    bump[idx] = eps
    with torch.no_grad():
        up, down = (grad_loss(solver.step(state._replace(h0_re=state.h0_re + d),
                                          DT)[1]).item()
                    for d in (bump, -bump))
    return idx, (up - down) / (2 * eps), grad[idx].item()


def height_adjoint(solver, state, seed):
    """The step's map from the four h0 planes to the height at the step's
    phase is linear: (⟨J v, w⟩, ⟨v, Jᵀ w⟩, ⟨J v, J v⟩, ‖J v‖‖w‖ + ‖v‖‖Jᵀ w‖)
    with v the state's planes and w a seeded cotangent, all in float64."""
    keys = ("h0_re", "h0_im", "h0c_re", "h0c_im")
    leaves = [getattr(state, k).detach().clone().requires_grad_() for k in keys]
    _, fields = solver.step(state._replace(**dict(zip(keys, leaves))), DT)
    w = torch.randn(tuple(fields.height.shape),
                    generator=torch.Generator().manual_seed(seed)).to(
                        fields.height.device)
    grads = torch.autograd.grad(fields.height, leaves, w)
    lhs = dot64(fields.height, w)
    rhs = sum(dot64(v, g) for v, g in zip(leaves, grads))
    norm = lambda *ts: sum(dot64(t, t) for t in ts) ** 0.5  # noqa: E731
    return (lhs, rhs, dot64(fields.height, fields.height),
            norm(fields.height) * norm(w) + norm(*leaves) * norm(*grads))


def inversion_launches(iters, evals, snapshots=4):
    """Launches of a packed inversion at N ≤ MAX_TRANSPOSED_N: the
    observations, ``iters`` value-and-gradient passes and ``evals`` more
    losses, every forward step 5 row passes and the fields kernel; the
    backward reaches only each snapshot's height, so 2 row passes (the full
    channel's) a snapshot."""
    from tpu_ocean_torch.invert_sea_state import PACKED_INNER
    forward = snapshots * PACKED_INNER * (1 + iters + evals)
    return {"fft_rows_transposed": 5 * forward + 2 * snapshots * iters,
            "fields_stencil": forward}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep-rows", action="store_true",
                        help="sweep rows per block instead of phases 4-5")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on an NVIDIA GPU only")
    if not (HERE / "tpu_ocean_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(tpu_ocean_torch/csrc is missing)")
    import tpu_ocean_torch
    from tpu_ocean_torch import (OCEAN_DEMO, POND_DEMO, OceanConfig,
                                 OceanSolver, PondSimulation, PondSolver,
                                 WaveBank,
                                 fields_to_numpy, pond_fields_to_numpy,
                                 state_from_numpy, _build, grids)
    from tpu_ocean_torch.fft import planes
    from tpu_ocean_torch.ops import fields_stencil as fs
    from tpu_ocean_torch.ops import fused_spectrum as fused
    from tpu_ocean_torch.ops import gerstner_bank as gb
    require(Path(tpu_ocean_torch.__file__).resolve().parent.parent == HERE,
            f"tpu_ocean_torch imported from {tpu_ocean_torch.__file__}, "
            f"not from this checkout")
    # TF32 is off so no plain version can use it (the matrix engine's
    # plain versions assert it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {"fft_rows_transposed": planes.fft1d_transposed,
                "fft_rows_natural": planes.fft1d_natural_large,
                "fused_rows_transposed": fused.assemble_rowfft,
                "fused_rows_natural": fused.assemble_rowfft_natural,
                "fields_stencil": fs.fields_stencil,
                "fields_stencil_v1": fs.fields_stencil_v1,
                "gerstner_bank": gb.gerstner_bank}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        planes.named_launches.clear()

    def read_counts():
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        counts.update(planes.named_launches)
        return counts

    def require_counts(counts, want, what):
        require(set(counts) <= set(KERNEL_INFO),
                f"{what}: launched kernels outside KERNEL_INFO")
        for name in KERNEL_INFO:
            require(counts.get(name, 0) == want.get(name, 0),
                    f"{what}: {name} launched {counts.get(name, 0)} times, "
                    f"not {want.get(name, 0)}")

    t_start = time.perf_counter()

    def phase_done(name):
        log(f"[phase] {name} done at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {kind} | "
        f"count {torch.cuda.device_count()} | tf32 off")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels = _build.load()
    log(f"[build] {kernels.path.relative_to(HERE)}: nvcc "
        f"{kernels.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill" in line and " 0 bytes spill stores" not in line):
            log(f"[build] {line.strip()}")

    # ---- 3. kernels vs plain, at the paths' shapes. Each case: (kernel,
    # shape label, kernel call, plain call, library call or None, bytes,
    # flops); timed again in phase 5.
    rng = np.random.default_rng(0)

    def plane(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def f64_rows(re, im, transposed):
        """float64 row DFT (torch.fft in complex128), in the kernel's
        output layout."""
        def ref():
            z = torch.fft.ifft(torch.complex(re.double(), im.double()), dim=-1,
                               norm="forward")
            if transposed:
                z = z.transpose(-1, -2)
            return z.real, z.imag
        return ref

    def switched(switches, fn):
        def call():
            with dft_switches(planes, switches):
                return fn()
        return call

    # (kernel, wrapper, plain, precision, switches, shapes); the row DFTs'
    # operations: 5·log2(N) a point for the Stockham stages, and for the
    # mixed-radix kernel at any N (what a length-N DFT needs, not the N·p
    # of its generic stage's direct sums at a large prime p); for the matrix
    # engine 8·(n1 + n2) a point of bf16 tensor-core products and the
    # twiddle's 6 f32; at bf16x3 stage 1 (8·n2) in f32 and stage 2 (8·n1)
    # three times on the tensor cores; in the three-factor form 8 + 16 in
    # place of n1 and 12 f32 for the twiddles, all on FFMA at f32
    cases = []
    # shape: (the f32 transposed pass, the f32 natural pass, float64 in the
    # natural layout), all on the same inputs, at each shape either pass
    # is timed at
    f32_pairs = {}
    # (name, shape) of the mixed-radix kernel: its inputs
    mixed_inputs = {}
    for name, fn, plain, precision, switches, shapes in (
            ("fft_rows_transposed", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "float32", {},
             [(1, 1024, 1024), (1, 512, 1024), (1, 1024, 512), (1, 1, 1024),
              (1, 4096, 4096), (1, 4096, 2048), (3, 1024, 1024),
              (2, 1024, 1024), (3, 4096, 4096), (5, 4096, 4096),
              (5, 1024, 1024),
              # the cascade's bands (xxix), LOD's subsets (xxxi) and the
              # natural regime's columns (xxx)
              (3, 512, 1024), (3, 1, 1024), (3, 1024, 512), (2, 512, 1024),
              (2, 1, 1024), (2, 1024, 512), (3, 4096, 2048)]),
            ("fft_rows_natural", planes.fft1d_natural_large,
             planes.fft1d_natural_large_plain, "float32", {},
             [(1, 4096, 4096), (1, 2048, 4096), (1, 1, 4096),
              (1, 1024, 1024), (5, 4096, 4096), (3, 4096, 4096),
              (3, 2048, 4096), (3, 1, 4096)]),
            ("matrix_rows_transposed[bf16]", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "bfloat16", {},
             [(1, 1024, 1024), (1, 512, 1024), (1, 1024, 512), (1, 1, 1024),
              (1, 4096, 4096), (1, 4096, 2048), (5, 1024, 1024)]),
            ("matrix_rows_natural[bf16]", planes.fft1d_natural_large,
             planes.fft1d_natural_large_plain, "bfloat16", {},
             [(1, 4096, 4096), (1, 2048, 4096), (1, 1, 4096),
              (1, 1024, 1024), (1, 2048, 2048)]),
            ("matrix_rows_transposed[f32,split3]", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "float32", SPLIT3,
             [(1, 1024, 1024), (1, 512, 1024), (1, 1, 1024)]),
            ("matrix_rows_transposed[bf16x3,split3]", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "float32", B3_SPLIT3,
             [(1, 1024, 1024), (1, 1, 1024)]),
            ("matrix_rows_transposed[bf16,split3]", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "bfloat16", SPLIT3,
             [(1, 1024, 1024)]),
            ("matrix_rows_transposed[bf16x3]", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "float32", B3,
             [(1, 1024, 1024), (1, 4096, 4096)]),
            ("matrix_rows_natural[bf16x3]", planes.fft1d_natural_large,
             planes.fft1d_natural_large_plain, "float32", B3,
             [(1, 1024, 1024), (1, 4096, 4096)]),
            ("fft_rows_mixed_transposed", planes.fft1d_transposed,
             planes.fft1d_transposed_plain, "float32", {},
             MIXED_SHAPES["fft_rows_mixed_transposed"]),
            ("fft_rows_mixed_natural", planes.fft1d_natural_large,
             planes.fft1d_natural_large_plain, "float32", {},
             MIXED_SHAPES["fft_rows_mixed_natural"])):
        for shape in shapes:
            re, im = plane(shape), plane(shape)
            z = torch.complex(re, im)
            points = shape[0] * shape[1] * shape[2]
            n1, n2 = planes._split_lanes(shape[2])
            with dft_switches(planes, switches):
                tier, split3 = planes.engine(
                    shape[2], precision, fn is planes.fft1d_transposed)
            if name in MIXED_SHAPES:
                mixed_inputs[name, shape] = (re, im)
            if not name.startswith("matrix"):
                f32_ops, tensor_ops = 5 * float(np.log2(shape[2])), 0
            elif split3 and tier == "f32":
                f32_ops, tensor_ops = 8 * (n2 + 24) + 12, 0
            else:
                f32_ops, tensor_ops = matrix_ops(tier, split3, n1, n2)
            cases.append(Case(
                name, list(shape),
                switched(switches, lambda fn=fn, re=re, im=im, p=precision:
                         fn(re, im, True, p)),
                switched(switches, lambda fn=plain, re=re, im=im, p=precision:
                         fn(re, im, True, p)),
                lambda z=z: torch.fft.ifft(z, dim=-1, norm="forward"),
                16 * points, f32_ops * points, tensor_ops * points,
                MIXED_BAND if name in MIXED_SHAPES else TIER_BAND[tier],
                f64_rows(re, im, fn is planes.fft1d_transposed), switches,
                shape[0], engine=(tier, split3)))
            if name in ("fft_rows_transposed", "fft_rows_natural"):
                f32_pairs[shape] = (
                    lambda re=re, im=im: planes.fft1d_transposed(re, im, True),
                    lambda re=re, im=im: planes.fft1d_natural_large(re, im,
                                                                    True),
                    f64_rows(re, im, False))
    # (M, N, first channel, channels, set): the shapes the paths give each
    # entry; a set is (packed, nch_live)
    sets = {"packed3": (True, 3), "packed5": (True, 5),
            "per_channel": (False, 3)}
    # (name, shape) of the f32 and bf16 fused natural cases and of the f32
    # fused transposed cases: (inputs, keywords)
    fused_natural_calls, fused_transposed_calls = {}, {}
    for name, fn, plain, precision, switches, shapes in (
            ("fused_rows_transposed", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "float32", {},
             [(1024, 1024, 0, 1, "packed3"), (512, 1024, 1, 1, "packed3")]),
            ("fused_rows_natural", fused.assemble_rowfft_natural,
             fused.assemble_rowfft_natural_plain, "float32", {},
             [(4096, 4096, 0, 1, "packed3"), (2048, 4096, 1, 1, "packed3")]),
            ("fused_transposed[per_channel]", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "float32", {},
             [(1024, 1024, 0, 3, "per_channel")]),
            ("fused_transposed[packed5]", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "float32", {},
             [(1024, 1024, 0, 2, "packed5"), (512, 1024, 2, 1, "packed5")]),
            ("fused_natural[per_channel]", fused.assemble_rowfft_natural,
             fused.assemble_rowfft_natural_plain, "float32", {},
             [(4096, 4096, 0, 5, "per_channel")]),
            ("fused_natural[packed5]", fused.assemble_rowfft_natural,
             fused.assemble_rowfft_natural_plain, "float32", {},
             [(4096, 4096, 0, 3, "packed5"), (2048, 4096, 2, 1, "packed5")]),
            (FUSED_NATURAL_BF16, fused.assemble_rowfft_natural,
             fused.assemble_rowfft_natural_plain, "bfloat16", {},
             [(4096, 4096, 0, 1, "packed3"), (2048, 4096, 1, 1, "packed3"),
              (2048, 4096, 2, 1, "packed5"),
              (4096, 4096, 0, 5, "per_channel")]),
            ("matrix_fused_transposed[bf16x3,split3]", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "float32", B3_SPLIT3,
             [(1024, 1024, 0, 1, "packed3"), (512, 1024, 1, 1, "packed3"),
              (512, 1024, 2, 1, "packed5")]),
            ("matrix_fused_transposed[bf16]", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "bfloat16", {},
             [(1024, 1024, 0, 1, "packed3")]),
            ("matrix_fused_transposed[bf16x3]", fused.assemble_rowfft,
             fused.assemble_rowfft_plain, "float32", B3,
             [(1024, 1024, 0, 1, "packed3")]),
            ("matrix_fused_natural[bf16x3]", fused.assemble_rowfft_natural,
             fused.assemble_rowfft_natural_plain, "float32", B3,
             [(4096, 4096, 0, 1, "packed3")])):
        for m, n, ch, count, channel_set in shapes:
            h0 = tuple(plane((m, n)) for _ in range(4))
            phase = torch.from_numpy(rng.uniform(0, 2 * np.pi, size=(m, n))
                                     .astype(np.float32)).to(dev)
            packed, nch_live = sets[channel_set]
            kw = dict(epsilon=1e-4, ch_start=ch, ch_count=count,
                      packed=packed, nch_live=nch_live, precision=precision)
            args = (h0, phase, OCEAN_DEMO.length, -1.0)
            n1, n2 = planes._split_lanes(n)
            with dft_switches(planes, switches):
                tier, split3 = planes.engine(
                    n, precision, fn is fused.assemble_rowfft)
            # 5 f32 planes in (read once), one complex channel out per
            # channel, the kz row; per channel the assembly's ~30
            # operations and the transform's
            if not name.startswith("matrix"):
                f32_ops, tensor_ops = 30 + 5 * int(np.log2(n)), 0
            else:
                f32_ops, tensor_ops = matrix_ops(tier, split3, n1, n2)
                f32_ops += 30
            label = f"ch {ch}" if count == 1 else f"ch {ch}-{ch + count - 1}"
            store = "natural" if fn is fused.assemble_rowfft_natural else "transposed"
            tag = fused.channel_set(packed, nch_live)
            counted = (f"fused_rows_{store}" if tier == "f32" and not split3
                       and not tag else
                       planes.kernel_name(f"fused_{store}", tier, split3, tag))
            shape = [m, n, label] + ([] if channel_set == "packed3"
                                     else [channel_set])
            if name in (*FUSED_NATURAL_F32, FUSED_NATURAL_BF16):
                fused_natural_calls[name, tuple(shape)] = (args, kw)
            if name in FUSED_TRANSPOSED_F32:
                fused_transposed_calls[name, tuple(shape)] = (args, kw)
            cases.append(Case(
                name, shape,
                switched(switches, lambda fn=fn, a=args, kw=kw: fn(*a, **kw)),
                switched(switches, lambda fn=plain, a=args, kw=kw: fn(*a, **kw)),
                None, (20 + 8 * count) * m * n + 4 * n,
                count * f32_ops * m * n, count * tensor_ops * m * n,
                TIER_BAND[tier], None, switches, count,
                "" if counted == name else counted, (tier, split3)))

    # the wave bank at the pond paths' grid and last step's t, both banks
    # and both normal modes, and at 4096² (W = 16); operations: the TPU
    # kernel's cost estimate (20 a wave, 14 without the normal's sums) and
    # one sincosf, per wave per point
    pond_t = POND_PATHS[0][3] * DT
    for n, waves, mode in ((512, 16, "analytic"), (512, 16, "flat"),
                           (512, 4, "analytic"), (512, 4, "flat"),
                           (4096, 16, "analytic")):
        bank = (WaveBank.from_packed4(POND_DEMO) if waves == 4
                else WaveBank.random(0, 16))
        x, z = (torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in grids.coordinate_grid(n, POND_DEMO.unit_width))
        args = (gb.pack_bank(bank, dev), x, z, pond_t, mode)
        cases.append(Case("gerstner_bank", [n, n, f"W {waves}", mode],
                          lambda a=args: gb.gerstner_bank(*a),
                          lambda a=args: gb.gerstner_bank_plain(*a), None,
                          32 * n * n,
                          ((20 if mode == "analytic" else 14) + SINCOSF_OPS)
                          * waves * n * n))

    errs = {k: 0.0 for k in KERNEL_INFO}
    f64_errs = {}
    for case in cases:
        name, shape, run, plain = case.name, case.shape, case.run, case.plain
        if name in MIXED_SHAPES:
            continue          # both directions below
        if name == "gerstner_bank":
            # each output against its own scale: offsets ~0.1, normal ~1
            got, want = run(), plain()
            torch.cuda.synchronize()
            for out, g, w in zip(("offset_x", "offset_y", "offset_z", "normal"),
                                 got, want):
                scale = w.abs().max().item()
                err = (g - w).abs().max().item()
                errs[name] = max(errs[name], err)
                log(f"[kernels] {name} {shape} {out}: max abs err {err:.3e} = "
                    f"{err / scale:.3e} x max|plain| (limit 1e-5)")
                require(g.shape == w.shape and err <= 1e-5 * scale,
                        f"{name} {shape} {out} disagrees")
            continue
        reset_counts()
        got = run()
        counted = {k: v for k, v in read_counts().items() if v}
        require(counted == {case.counted or name: 1},
                f"{name} {shape} launched {counted}")
        err, scale = check_kernel(name, shape, got, plain(), case.band,
                                  case.channels)
        errs[name] = max(errs[name], err)
        line = (f"[kernels] {name} {shape} inverse: max abs err {err:.3e} = "
                f"{err / scale:.3e} x max|plain| (limit {case.band:g})")
        if case.f64 is not None:
            ref = case.f64()
            rel64 = (max((g.double() - r).abs().max().item()
                         for g, r in zip(got, ref))
                     / max(r.abs().max().item() for r in ref))
            f64_errs[name] = max(f64_errs.get(name, 0.0), rel64)
            line += f"; vs float64 {rel64:.3e} x max"
        log(line)
        del got

    # the mixed-radix kernel at every shape of MIXED_SHAPES in both
    # directions: one launch under its name, within MIXED_BAND·max of the
    # plain version and MIXED_F64_MAX·max of float64
    for (name, shape), (re, im) in mixed_inputs.items():
        transposed = name == "fft_rows_mixed_transposed"
        fn, plain = ((planes.fft1d_transposed, planes.fft1d_transposed_plain)
                     if transposed else
                     (planes.fft1d_natural_large,
                      planes.fft1d_natural_large_plain))
        rows = planes.rows_per_block(
            shape[0], shape[1], shape[2], planes.sm_count(dev),
            planes.mixed_max_rows(shape[2], not transposed),
            planes.mixed_shared_bytes)
        for inverse in (True, False):
            reset_counts()
            got = fn(re, im, inverse)
            counted = {k: v for k, v in read_counts().items() if v}
            require(counted == {name: 1}, f"{name} {shape} launched {counted}")
            err, scale = check_kernel(name, list(shape), got,
                                      plain(re, im, inverse), MIXED_BAND)
            z = torch.complex(re.double(), im.double())
            ref = (torch.fft.ifft(z, dim=-1, norm="forward") if inverse
                   else torch.fft.fft(z, dim=-1))
            if transposed:
                ref = ref.transpose(-1, -2)
            ref = (ref.real, ref.imag)
            rel64 = (max((g.double() - r).abs().max().item()
                         for g, r in zip(got, ref))
                     / max(r.abs().max().item() for r in ref))
            errs[name] = max(errs[name], err)
            f64_errs[name] = max(f64_errs.get(name, 0.0), rel64)
            log(f"[kernels] {name} {list(shape)} "
                f"{'inverse' if inverse else 'forward'}, plan "
                f"{[p for p, _ in planes.mixed_plan(shape[2])]}, R {rows}: "
                f"max abs err {err:.3e} = {err / scale:.3e} x max|plain| "
                f"(limit {MIXED_BAND:g}); vs float64 {rel64:.3e} x max "
                f"(limit {MIXED_F64_MAX:g})")
            require(rel64 <= MIXED_F64_MAX, f"{name} {shape}: {rel64:.3e} "
                    f"x max against float64 > {MIXED_F64_MAX:g}")
            del got, z, ref

    # the two f32 direct kernels on the same inputs at every shape the
    # paths give the transposed one: the cluster store (radix-2 stages) and
    # the natural store (radix-16 passes), transposed, within 1e-6·max of
    # each other; each one's RMS error against float64 within
    # F32_F64_SPREAD x the other's
    for shape in [c.shape for c in cases if c.name == "fft_rows_transposed"]:
        transposed, natural, ref64 = f32_pairs[tuple(shape)]
        got = tuple(g.transpose(-1, -2) for g in transposed())
        nat = natural()
        ref = ref64()
        torch.cuda.synchronize()
        scale = max(r.abs().max().item() for r in ref)
        err = max((g - w).abs().max().item() for g, w in zip(got, nat))
        e_tr, e_nat = rms_rel_err(got, ref), rms_rel_err(nat, ref)
        m_tr, m_nat = (max((o.double() - r).abs().max().item()
                           for o, r in zip(out, ref)) / scale
                       for out in (got, nat))
        log(f"[kernels] fft_rows_transposed {shape} against fft_rows_natural "
            f"transposed on the same inputs: max abs err {err:.3e} = "
            f"{err / scale:.3e} x max (limit 1e-6); RMS error vs float64 "
            f"{e_tr:.4e} (transposed) and {e_nat:.4e} (natural), ratio "
            f"{e_nat / e_tr:.3f} (limits {1 / F32_F64_SPREAD:.3f}-"
            f"{F32_F64_SPREAD:g}); max error vs float64 {m_tr:.4e} and "
            f"{m_nat:.4e}, ratio {m_nat / m_tr:.3f}")
        require(err <= 1e-6 * scale, f"the f32 row kernels disagree at "
                f"{shape} ({err / scale:.3e} x max)")
        require(e_nat <= F32_F64_SPREAD * e_tr
                and e_tr <= F32_F64_SPREAD * e_nat,
                f"the f32 row kernels' RMS errors against float64 at {shape} "
                f"differ: {e_tr:.4e} and {e_nat:.4e}")
        del got, nat, ref

    # the fused natural kernels at every shape and channel set the paths
    # give them, channel by channel, against the natural row kernel of
    # their tier applied to the plain assembly on the card: the f32 one
    # within 1e-6·max; the bf16 one bit-equal where no 1/|k| term enters
    # the channel (invk_free: the card's 1/sqrt and torch's rsqrt differ by
    # an ulp now and then, which can flip a bf16 rounding of the staged
    # value), else within the bf16 band. Each one's RMS error against the
    # float64 DFT of the float64 assembly at most F32_F64_SPREAD x the row
    # kernel's on the plain assembly
    for (name, shape), (args, kw) in fused_natural_calls.items():
        precision = kw["precision"]
        got = fused.assemble_rowfft_natural(*args, **kw)
        for c in range(kw["ch_count"]):
            ch = kw["ch_start"] + c
            asm_kw = dict(epsilon=kw["epsilon"], ch=ch, packed=kw["packed"],
                          nch_live=kw["nch_live"])
            plain_re, plain_im = fused._assemble_plain(*args, row_offset=0,
                                                       **asm_kw)
            row = planes.fft1d_natural_large(plain_re[None], plain_im[None],
                                             True, precision)
            ref = torch.fft.ifft(torch.complex(*assembly_f64(*args, **asm_kw)),
                                 dim=-1, norm="forward")
            ref = (ref.real[None], ref.imag[None])
            gc = (got[0][c:c + 1], got[1][c:c + 1])
            torch.cuda.synchronize()
            scale = max(r.abs().max().item() for r in row)
            err = max((g - r).abs().max().item() for g, r in zip(gc, row))
            e_fused, e_row = rms_rel_err(gc, ref), rms_rel_err(row, ref)
            if precision == "float32":
                band, limit = 1e-6, "1e-6"
            elif invk_free(kw["packed"], kw["nch_live"], ch):
                band, limit = 0.0, "bit-equal, no 1/|k| term"
            else:
                band = TIER_BAND["bf16"]
                limit = f"{band:g}"
            log(f"[kernels] {name} {list(shape)} channel {ch} against the "
                f"{precision} natural row kernel over the plain assembly: max "
                f"abs err {err:.3e} = {err / scale:.3e} x max (limit {limit}); "
                f"RMS error vs float64 of the float64 assembly {e_fused:.4e} "
                f"(fused) and {e_row:.4e} (row kernel), ratio "
                f"{e_fused / e_row:.3f} (limit {F32_F64_SPREAD:g})")
            require(err <= band * scale,
                    f"{name} {list(shape)} channel {ch} and the row kernel "
                    f"over the plain assembly disagree ({err / scale:.3e} x "
                    f"max, limit {limit})")
            require(e_fused <= F32_F64_SPREAD * e_row,
                    f"{name} {list(shape)} channel {ch}: RMS error against "
                    f"float64 {e_fused:.4e} > {F32_F64_SPREAD:g} x the row "
                    f"kernel's {e_row:.4e}")
            del plain_re, plain_im, row, ref, gc
        del got

    # the f32 fused transposed kernel at every shape and channel set the
    # paths give it, channel by channel, against the f32 fused natural
    # kernel on the same inputs, transposed: both run one load, assembly
    # and set of radix-16 passes (bit-equal expected), held within
    # 1e-6·max. Its RMS error against the float64 DFT of the float64
    # assembly at most F32_F64_SPREAD x the old kernel's: the radix-2
    # stages of stockham.cuh, which the f32 transposed row kernel still
    # runs, over the plain assembly
    for (name, shape), (args, kw) in fused_transposed_calls.items():
        got = fused.assemble_rowfft(*args, **kw)
        nat = fused.assemble_rowfft_natural(*args, **kw)
        for c in range(kw["ch_count"]):
            ch = kw["ch_start"] + c
            asm_kw = dict(epsilon=kw["epsilon"], ch=ch, packed=kw["packed"],
                          nch_live=kw["nch_live"])
            plain_re, plain_im = fused._assemble_plain(*args, row_offset=0,
                                                       **asm_kw)
            old = planes.fft1d_transposed(plain_re[None], plain_im[None],
                                          True)
            ref = torch.fft.ifft(torch.complex(*assembly_f64(*args, **asm_kw)),
                                 dim=-1, norm="forward").transpose(0, 1)
            ref = (ref.real[None], ref.imag[None])
            gc = (got[0][c:c + 1], got[1][c:c + 1])
            nc = tuple(x[c:c + 1].transpose(1, 2) for x in nat)
            torch.cuda.synchronize()
            scale = max(r.abs().max().item() for r in nc)
            err = max((g - r).abs().max().item() for g, r in zip(gc, nc))
            bits = all(torch.equal(g, r) for g, r in zip(gc, nc))
            e_new, e_old = rms_rel_err(gc, ref), rms_rel_err(old, ref)
            log(f"[kernels] {name} {list(shape)} channel {ch} against the "
                f"f32 fused natural kernel transposed: max abs err "
                f"{err:.3e} = {err / scale:.3e} x max (limit 1e-6), "
                f"bit-equal {bits}; RMS error vs float64 of the float64 "
                f"assembly {e_new:.4e} (fused) and {e_old:.4e} (the radix-2 "
                f"stages over the plain assembly), ratio {e_new / e_old:.3f} "
                f"(limit {F32_F64_SPREAD:g})")
            require(err <= 1e-6 * scale,
                    f"{name} {list(shape)} channel {ch} and the f32 fused "
                    f"natural kernel disagree ({err / scale:.3e} x max)")
            require(e_new <= F32_F64_SPREAD * e_old,
                    f"{name} {list(shape)} channel {ch}: RMS error against "
                    f"float64 {e_new:.4e} > {F32_F64_SPREAD:g} x the radix-2 "
                    f"stages' {e_old:.4e}")
            del plain_re, plain_im, old, ref, gc, nc
        del got, nat

    # both stencils on the fields of one step at each size the paths run
    # them
    for n in sorted({path.size for path in PATHS
                     if path.solver.get("pallas_fields")}):
        cfg = OCEAN_DEMO.replace(resolution=n)
        solver = OceanSolver(cfg, fft_backend="pallas", **SLICE)
        _, f = solver.step(solver.init(torch.Generator().manual_seed(1)), DT)
        chop = cfg.choppiness
        fields_in = (chop * f.disp_x, f.height, chop * f.disp_z, cfg.length / n)
        got = fs.fields_stencil(*fields_in)
        want = fs.fields_stencil_plain(*fields_in)
        torch.cuda.synchronize()
        for name, g, w, tol in zip(("normal", "foam", "jacobian"), got, want,
                                   (1e-5, 1e-4, 1e-5)):
            err = (g - w).abs().max().item()
            errs["fields_stencil"] = max(errs["fields_stencil"], err)
            log(f"[kernels] fields_stencil [{n}, {n}] {name}: max abs err "
                f"{err:.3e} (limit {tol:g})")
            require(err <= tol, f"fields_stencil [{n}, {n}] {name} disagrees")
        cases.append(Case("fields_stencil", [n, n],
                          lambda a=fields_in: fs.fields_stencil(*a),
                          lambda a=fields_in: fs.fields_stencil_plain(*a),
                          None, 32 * n * n, 60 * n * n))
        # v1 rounds every operation as its plain version does
        got = fs.fields_stencil_v1(*fields_in)
        want = fs.fields_stencil_v1_plain(*fields_in)
        torch.cuda.synchronize()
        for name, g, w in zip(("normal", "foam", "jacobian"), got, want):
            err = (g - w).abs().max().item()
            errs["fields_stencil_v1"] = max(errs["fields_stencil_v1"], err)
            log(f"[kernels] fields_stencil_v1 [{n}, {n}] {name}: max abs err "
                f"{err:.3e} (limit 1e-5)")
            require(err <= 1e-5, f"fields_stencil_v1 [{n}, {n}] {name} disagrees")
        # ~105 operations a point: 4 edges, 4 cross products and their
        # sums, the normalization, the whitecap
        cases.append(Case("fields_stencil_v1", [n, n],
                          lambda a=fields_in: fs.fields_stencil_v1(*a),
                          lambda a=fields_in: fs.fields_stencil_v1_plain(*a),
                          None, 32 * n * n, 105 * n * n))
        del solver, f, got, want
    if opts.sweep_rows:
        sweep_rows(cases, planes)
        return

    # the flat normal is checked above, timed only in analytic mode (the
    # paths' mode)
    cases = [c for c in cases if c.shape[-1] != "flat"]
    # each tier and form of the transposed row pass, and the natural one at
    # f32 and bf16, against float64 at the paths' sizes (the launches here
    # are not counted)
    for n in (1024, 4096):
        re, im = plane((1, n, n)), plane((1, n, n))
        refs = {store: f64_rows(re, im, store == "transposed")()
                for store in ("transposed", "natural")}
        scale = max(r.abs().max().item() for r in refs["transposed"])

        def f64_err(got, store):
            return max((g.double() - r).abs().max().item()
                       for g, r in zip(got, refs[store])) / scale

        f32_rms = {}

        for label, store, precision, switches in (
                ("f32", "transposed", "float32", {}),
                ("bf16", "transposed", "bfloat16", {}),
                ("bf16x3", "transposed", "float32", {"KERNEL_B3_THRESHOLD": 0}),
                ("f32,split3", "transposed", "float32",
                 {"THREE_FACTOR_THRESHOLD": 0}),
                ("bf16,split3", "transposed", "bfloat16",
                 {"THREE_FACTOR_THRESHOLD": 0}),
                ("bf16x3,split3", "transposed", "float32",
                 {"THREE_FACTOR_THRESHOLD": 0, "KERNEL_B3_THRESHOLD": 0}),
                ("f32", "natural", "float32", {}),
                ("bf16", "natural", "bfloat16", {})):
            fn, plain = ((planes.fft1d_transposed,
                          planes.fft1d_transposed_plain)
                         if store == "transposed" else
                         (planes.fft1d_natural_large,
                          planes.fft1d_natural_large_plain))
            with dft_switches(planes, switches):
                got = fn(re, im, True, precision)
            err = f64_err(got, store)
            log(f"[accuracy] row pass [1,{n},{n}] {store} at {label}: max "
                f"abs err vs float64 {err:.3e} x max")
            if label == "f32":
                f32_rms[store] = rms_rel_err(got, refs[store])
                log(f"[accuracy] row pass [1,{n},{n}] {store} at f32: RMS "
                    f"err vs float64 {f32_rms[store]:.4e} x RMS")
            del got
            if n == 1024 and label == "bf16":
                # the bf16 plain version on the same rows: the kernel rounds
                # the same operands, so its error must be the plain
                # version's within 10%, and at most the PERF.md figure
                ref_err = f64_err(plain(re, im, True, precision), store)
                log(f"[accuracy] row pass [1,1024,1024] {store} at bf16, the "
                    f"plain version on the same rows: {ref_err:.3e} x max; "
                    f"PERF.md §6 (other rows): {BF16_ROWS_F64_ERR:.2e}")
                require(abs(err - ref_err) <= BF16_ROWS_F64_SPREAD * ref_err
                        and err <= (1 + BF16_ROWS_F64_SPREAD)
                        * BF16_ROWS_F64_ERR,
                        f"the bf16 {store} row pass at [1,1024,1024] moved: "
                        f"{err:.3e} against float64, the plain version "
                        f"{ref_err:.3e}, PERF.md {BF16_ROWS_F64_ERR:.2e}")
            if n == 1024 and label == "f32":
                require(err <= 1.1 * F32_ROWS_F64_ERR,
                        f"the f32 {store} row pass at [1,1024,1024]: "
                        f"{err:.3e} against float64 > 1.1 x "
                        f"{F32_ROWS_F64_ERR:g}")
            if n == 4096 and label == "f32" and store == "natural":
                ratio = f32_rms["natural"] / f32_rms["transposed"]
                log(f"[accuracy] row pass [1,4096,4096] at f32: the natural "
                    f"pass's RMS error {ratio:.3f} x the transposed pass's "
                    f"on the same rows (limit {F32_F64_SPREAD:g})")
                require(ratio <= F32_F64_SPREAD,
                        f"the f32 natural row pass at [1,4096,4096]: RMS "
                        f"error against float64 {ratio:.3f} x the transposed "
                        f"pass's on the same rows > {F32_F64_SPREAD:g}")
            if n == 1024 and label == "f32,split3":
                require(err <= SPLIT3_F64_MAX,
                        f"the f32 three-factor row pass at [1,1024,1024]: "
                        f"{err:.3e} against float64 > {SPLIT3_F64_MAX:g}")
            if n == 1024 and label == "bf16x3,split3":
                # the bf16x3 plain version on the same rows
                with dft_switches(planes, switches):
                    ref_err = f64_err(plain(re, im, True, precision), store)
                log(f"[accuracy] row pass [1,1024,1024] {store} at "
                    f"bf16x3,split3, the plain version on the same rows: "
                    f"{ref_err:.3e} x max (limits {B3_SPLIT3_F64_MAX:g} and "
                    f"{B3_SPLIT3_F64_SPREAD:g} x the plain version's)")
                require(err <= B3_SPLIT3_F64_MAX
                        and err <= B3_SPLIT3_F64_SPREAD * ref_err,
                        f"the bf16x3 three-factor row pass at [1,1024,1024]: "
                        f"{err:.3e} against float64, the plain version "
                        f"{ref_err:.3e}")
        del re, im, refs

    # the autograd Functions: each row-DFT Function's backward (the kernel
    # in the opposite direction, the transposed store on the swapped
    # cotangents) against the plain version in the opposite direction on
    # the same seeded cotangents, at the forward's band, and the adjoint
    # identity in float64; the fields Function's gradient bit-equal to
    # torch.autograd.grad of the twins on the same inputs and cotangents
    for store, shape, precision in AUTOGRAD_ROWS:
        transposed = store == "transposed"
        fn, plain = ((planes.fft1d_transposed, planes.fft1d_transposed_plain)
                     if transposed else
                     (planes.fft1d_natural_large,
                      planes.fft1d_natural_large_plain))
        tier = planes.engine(shape[-1], precision, transposed)[0]
        what = f"row DFT {store} {list(shape)} {tier} backward"
        x = [plane(shape).requires_grad_() for _ in range(2)]
        yr, yi = fn(*x, True, precision)
        cts = [plane(tuple(yr.shape)) for _ in range(2)]
        gr, gi = torch.autograd.grad((yr, yi), x, cts)

        def swap(t, transposed=transposed):
            return t.transpose(-1, -2).contiguous() if transposed else t
        want = [swap(w) for w in plain(*(swap(c) for c in cts), False,
                                       precision)]
        err, scale = check_kernel(what, list(shape), (gr, gi), want,
                                  TIER_BAND[tier])
        log(f"[autograd] {what}: vs the plain version in the opposite "
            f"direction, max abs err {err:.3e} = {err / scale:.3e} x max "
            f"(band {TIER_BAND[tier]:g})")
        with torch.no_grad():
            lhs = dot64(yr, cts[0]) + dot64(yi, cts[1])
            rhs = dot64(x[0], gr) + dot64(x[1], gi)
            norm = lambda *ts: sum(dot64(t, t) for t in ts) ** 0.5  # noqa: E731
            adjoint_check(what, lhs, rhs, dot64(yr, yr) + dot64(yi, yi), rhs,
                          None if tier == "f32" else TIER_BAND[tier],
                          norm(yr, yi) * norm(*cts) + norm(*x) * norm(gr, gi))
        del x, yr, yi, cts, gr, gi, want
    for n in (1024, 4096):
        texel = OCEAN_DEMO.length / n
        inputs = [(0.1 * plane((n, n))).requires_grad_() for _ in range(3)]
        out = fs.fields_stencil(*inputs, texel)
        cts = [plane(tuple(o.shape)) for o in out]
        got = torch.autograd.grad(out, inputs, cts)
        want = torch.autograd.grad(fs.fields_twin(*inputs, texel), inputs, cts)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[autograd] fields_stencil [{n},{n}] backward: bit-equal to "
            f"torch.autograd.grad of the twins (normals_stencil + "
            f"whitecap_gpu) on the same inputs and cotangents: {same}")
        require(same, f"the fields Function's gradient at {n}² differs from "
                f"the twins'")
        del inputs, out, cts, got, want
    phase_done("3 kernels")

    # timing of a path (phase 5; the runtime paths of phase 4 inline): each
    # step by CUDA events (its device timeline, gaps included); device time
    # by torch.profiler; warm L2 throughout
    def time_path(label, size, one_step, iters, note):
        step_ms, host_ms = cuda_ms(one_step, iters=iters)
        busy_ms, per_kernel, how = device_ms(one_step, iters=max(iters // 4, 10))
        groups = {}
        for key, ms in per_kernel.items():
            g = kernel_group(key)
            groups[g] = groups.get(g, 0.0) + ms
        log(f"[timing] {kind} ({smi}): {label} {size}x{size} {step_ms:.4f} "
            f"ms/step, {size * size / step_ms * 1e3:.4e} grid points/s; device "
            f"busy {busy_ms:.4f} ms/step ({how}), idle share "
            f"{1 - busy_ms / step_ms:.3f}; host enqueue {host_ms:.4f} ms/step")
        log(f"[timing] {label} device ms/step by layer: " + ", ".join(
            f"{g} {ms:.4f}" for g, ms in sorted(groups.items()))
            + f" ({note})")
        if size <= 2048:     # host-bound: where the host's time goes
            log(f"[timing] {label} host µs/step by function (cProfile "
                f"tottime, top 10): " + "; ".join(
                    f"{name} {us:.1f}" for name, us in host_profile(one_step)))
        return step_ms

    def ocean_step(psolver, state):
        step_state = [state]

        def one_step():
            step_state[0], _ = psolver.step(step_state[0], DT)
        return one_step

    # ---- 4. the ocean paths through the solver, then the pond paths
    launches = {k: {} for k in KERNEL_INFO}

    parity_base = OceanConfig(
        unit_width=1.0, wind=(8.0, 5.0), amplitude=0.05, choppiness=1.2,
        dispersion_mode="quantized", evolution_mode="absolute",
        spectrum_layout="centered", normals_mode="spectral")

    def path_config(path):
        """The path's config: its base at the path's N and precision (the
        parity base at L = N), with the path's fields."""
        if path.base == "parity":
            base = parity_base.replace(length=float(path.size))
        else:
            base = OCEAN_DEMO if path.base == "demo" else OceanConfig()
        return base.replace(resolution=path.size, precision=path.precision,
                            **path.config)

    def card_solver(pcfg, against, path):
        """The card solver a path's last step is held to: the path's own
        solver at f32, or the JAX-default complex solver on torch.fft."""
        if against == "f32":
            return OceanSolver(pcfg.replace(precision="float32"),
                               fft_backend=path.backend, **path.solver)
        return OceanSolver(pcfg, fft_backend="reference")

    solvers = {}
    for path in PATHS:
        tag, size, steps, replay = path.tag, path.size, path.steps, path.replay
        packed = bool(path.solver.get("pack_channels"))
        with fields_switch(fs, path.v2), dft_switches(planes, path.switches):
            pcfg = path_config(path)
            psolver = OceanSolver(pcfg, fft_backend=path.backend, **path.solver)
            state = psolver.init(torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            reset_counts()
            for step in range(1, steps + 1):
                prev = state
                state, fields = psolver.step(state, DT)
                if replay and step == steps - replay:
                    snapshot = state_from_numpy(state, "cpu")
            counts = read_counts()
            log(f"[slice {tag}] {path_label(path)} {size}x{size}"
                f"{'' if path.v2 else ', FIELDS_KERNEL_V2 = False'}"
                + "".join(f", {k} = {v}" for k, v in path.switches.items())
                + f", {steps} steps of dt 1/60: launches {counts} (expected "
                f"{steps} x {path.per_step})")
            require_counts(counts, {k: steps * v for k, v in path.per_step.items()},
                           f"path {tag}")
            for name, count in counts.items():
                if count:
                    launches[name][tag] = count
            card = fields_to_numpy(fields)
            require(int(state.step) == steps, f"path {tag}: step counter")
            check_fields(card, size, tag)
            if replay:
                # the last steps again on the CPU plain path from the
                # card's state
                cpu_solver = OceanSolver(pcfg, device="cpu",
                                         fft_backend=path.backend,
                                         **path.solver)
                cpu_state = snapshot
                for _ in range(replay):
                    cpu_state, cpu_fields = cpu_solver.step(cpu_state, DT)
                require(np.array_equal(cpu_state.phase.numpy(),
                                       state.phase.cpu().numpy())
                        and float(cpu_state.t) == float(state.t),
                        f"path {tag}: phase or clock differs between the "
                        f"card and the CPU")
                log(f"[slice {tag}] steps {steps - replay + 1}-{steps} "
                    f"replayed on the CPU plain path from the card's "
                    f"step-{steps - replay} state")
                compare_fields(card, fields_to_numpy(cpu_fields), pcfg, tag,
                               rel=path.rel, packed=packed)
                del cpu_solver, cpu_state, cpu_fields, snapshot
            for against, rel in path.against.items():
                # the last step again from the same state on the card, at
                # f32 or on the reference backend
                other = card_solver(pcfg, against, path)
                _, other_fields = other.step(prev, DT)
                compare_fields(card, fields_to_numpy(other_fields), pcfg, tag,
                               against=against, rel=rel, packed=packed)
                del other, other_fields
            if (pcfg.normals_mode == "spectral"
                    and pcfg.precision == "float32"
                    and path.backend not in ("reference", "stockham")):
                # a lower-precision control: the last step at bf16 from the
                # same state must fall outside the spectral normals' band
                # around the card's f32 step (reference and stockham are
                # full precision at any precision)
                bf16_solver = OceanSolver(pcfg.replace(precision="bfloat16"),
                                          fft_backend=path.backend,
                                          **path.solver)
                _, bf16_fields = bf16_solver.step(prev, DT)
                band, _ = spectral_normal_band(card, packed, path.rel)
                worst = np.abs(bf16_fields.normal.cpu().numpy()
                               - card.normal).max()
                log(f"[slice {tag}] control: bf16 step vs the card's f32 step, "
                    f"spectral normal max abs err {worst:.3e} = "
                    f"{worst / band:.1f} x the band {band:.3e}")
                require(worst > band, f"path {tag}: the spectral normals' "
                        f"band does not tell bf16 from f32")
                del bf16_solver, bf16_fields
            if not path.v2:
                # the last step again from the same state, through v2
                with fields_switch(fs, True):
                    _, v2_fields = psolver.step(prev, DT)
                compare_fields(card, fields_to_numpy(v2_fields), pcfg, tag,
                               against="v2")
                del v2_fields
            solvers[tag] = (pcfg, psolver, state)
            del fields, card, prev
        phase_done(f"4 path ({tag})")

    # fields_at and velocity on the card, each call counted alone, against
    # the CPU plain path from the same state
    for tag, method, per_call in EXTRA_CALLS:
        path = next(p for p in PATHS if p.tag == tag)
        pcfg, psolver, state = solvers[tag]
        cpu_solver = OceanSolver(pcfg, device="cpu", fft_backend=path.backend,
                                 **path.solver)
        cpu_state = state_from_numpy(state, "cpu")
        args = (float(state.t) + DT,) if method == "fields_at" else ()
        torch.cuda.synchronize()
        reset_counts()
        got = getattr(psolver, method)(state, *args)
        counts = read_counts()
        log(f"[slice {tag}] {method}(state{', t' if args else ''}) on the "
            f"card: launches {counts} (expected {per_call})")
        require_counts(counts, per_call, f"path {tag} {method}")
        for name, count in counts.items():
            if count:
                launches[name][f"{tag} {method}"] = count
        want = getattr(cpu_solver, method)(cpu_state, *args)
        if method == "fields_at":
            card = fields_to_numpy(got)
            check_fields(card, pcfg.resolution, f"{tag} {method}")
            compare_fields(card, fields_to_numpy(want), pcfg, f"{tag} {method}",
                           rel=path.rel,
                           packed=bool(path.solver.get("pack_channels")))
        else:
            got, want = got.cpu().numpy(), want.numpy()
            err, scale = np.abs(got - want).max(), np.abs(want).max()
            log(f"[slice {tag}] {method} card vs cpu: max abs err {err:.3e} "
                f"= {err / scale:.3e} x max|cpu| (limit {path.rel:g})")
            require(got.shape == (pcfg.resolution,) * 2
                    and np.isfinite(got).all() and err <= path.rel * scale,
                    f"path {tag}: {method} disagrees")
        del cpu_solver, cpu_state, got, want
    phase_done("4 fields_at and velocity")

    pond_names = ("offset_x", "offset_y", "offset_z", "normal")
    ponds = {}
    for tag, what, bank_args, steps in POND_PATHS:
        bank = WaveBank.random(*bank_args) if bank_args else None
        sim = PondSimulation(POND_DEMO, bank=bank, use_pallas=True)
        torch.cuda.synchronize()
        reset_counts()
        sim.run(steps)
        counts = read_counts()
        log(f"[slice {tag}] {what}, PondSimulation(use_pallas=True), "
            f"{steps} steps of dt 1/60: launches {counts} (expected {steps} x "
            f"{{'gerstner_bank': 1}})")
        require_counts(counts, {"gerstner_bank": steps}, f"path {tag}")
        launches["gerstner_bank"][tag] = steps
        require(sim.step_count == steps, f"path {tag}: step counter")
        n = POND_DEMO.resolution
        card = pond_fields_to_numpy(sim.fields)
        check_pond_fields(card, n, tag)
        cpu = PondSolver(POND_DEMO, bank=bank, use_pallas=True, device="cpu")
        log(f"[slice {tag}] t = {sim.state:.6f} on the CPU plain path "
            f"(device='cpu', use_pallas=True)")
        compare_pond(card, pond_fields_to_numpy(cpu.fields(sim.state)), tag,
                     pond_names)
        ponds[tag] = (sim, cpu)
        phase_done(f"4 path ({tag})")
    # the plain-torch pond functions on the card against the CPU: one
    # "wave" step and both velocities, no kernel launched
    wave_cfg = dataclasses.replace(POND_DEMO, displacement_mode="wave")
    gb.gerstner_bank.launches = 0
    for what, card_fn, cpu_fn in (
            ("wave mode", PondSolver(wave_cfg).fields,
             PondSolver(wave_cfg, device="cpu").fields),
            ("wave velocity", PondSolver(wave_cfg).velocity,
             PondSolver(wave_cfg, device="cpu").velocity),
            ("gerstner velocity (p2's bank)", ponds["p2"][0].solver.velocity,
             ponds["p2"][1].velocity)):
        got, want = card_fn(pond_t), cpu_fn(pond_t)
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        compare_pond([g.cpu().numpy() for g in got],
                     [w.numpy() for w in want], what,
                     pond_names if len(got) == 4 else ("velocity",))
    torch.cuda.synchronize()
    require(gb.gerstner_bank.launches == 0, "plain pond functions launched a kernel")

    # ---- the runtime (xxii, xxiii), eval_mode="direct" (xxiv) and the
    # shader-hash h0 (xxv), each from a fixed seed with its launches counted
    from tpu_ocean_torch import FFT_MESH_DEMO, Simulation, save_checkpoint
    from tpu_ocean_torch.evolve import hermitize_planes
    from tpu_ocean_torch.spectra import h0_pair_gpu_hash
    main_kw = {"fft_backend": "pallas", **SLICE}
    main_per_step = PATHS[0].per_step       # (i): rows transposed 5, fields 1

    def counted(what, want, run):
        """Run ``run()`` with every count set to 0 just before; require
        exactly ``want`` launches after it and record them."""
        torch.cuda.synchronize()
        reset_counts()
        out = run()
        counts = read_counts()
        log(f"[slice {what}] launches {counts} (expected {want})")
        require_counts(counts, want, f"path {what}")
        for name, count in counts.items():
            if count:
                launches[name][what] = count
        return out

    def seeded():
        return torch.Generator().manual_seed(0)

    (HERE / "build").mkdir(exist_ok=True)
    scratch = tempfile.TemporaryDirectory(dir=HERE / "build")
    work = Path(scratch.name)

    # (xxii) Simulation on the main path at full width: metrics, checkpoints
    # and export every 20 steps, resume, live reconfigure
    tag = "xxii"
    stream, kept = io.StringIO(), {}
    sim_kw = dict(out_dir=str(work / "sim"), checkpoint_every=20,
                  export_every=20, **main_kw)

    def keep(sim):
        if sim.step_count % 20 == 0:
            kept[sim.step_count] = (sim.fields.height.cpu().numpy(),
                                    sim.fields.foam.cpu().numpy())

    sim = Simulation(OCEAN_DEMO, metrics_stream=stream, generator=seeded(),
                     **sim_kw)
    counted(tag, {k: 60 * v for k, v in main_per_step.items()},
            lambda: sim.run(60, callback=keep))
    records = [json.loads(line) for line in stream.getvalue().splitlines()]
    require([r["step"] for r in records] == list(range(1, 61)),
            f"path {tag}: {len(records)} metrics lines, not 60")
    require(sim._exporter.errors() == 0, f"path {tag}: exporter errors")
    for k, fields in kept.items():
        for name, want in zip(("height", "foam"), fields):
            got = np.load(work / "sim" / "fields" / f"{name}_{k:08d}.npy")
            require(got.dtype == np.float64
                    and np.array_equal(got, want.astype(np.float64)),
                    f"path {tag}: exported {name} at step {k} differs")
    require(sorted(kept) == [20, 40, 60], f"path {tag}: exported steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(work / "one"), sim.state, OCEAN_DEMO)
    save_ms = (time.perf_counter() - t0) * 1e3
    summary = sim_summary = sim.metrics.summary()
    log(f"[slice {tag}] Simulation(OCEAN_DEMO, {main_kw}), 60 steps: 60 "
        f"JSONL lines, metrics mean {summary['mean_ms']:.4f} ms p50 "
        f"{summary['p50_ms']:.4f} p95 {summary['p95_ms']:.4f}; height and "
        f"foam exported at steps 20, 40, 60 bit-equal to the fields of those "
        f"steps, exporter errors 0; one save_checkpoint at 1024² "
        f"{save_ms:.1f} ms ({kind}, {smi})")
    sim.close()
    resumed = Simulation(OCEAN_DEMO, **sim_kw)
    require(resumed.step_count == 60, f"path {tag}: resumed at step "
            f"{resumed.step_count}, not 60")
    got = counted(f"{tag} resumed", {k: 20 * v for k, v in main_per_step.items()},
                  lambda: resumed.run(20))
    whole = Simulation(OCEAN_DEMO, generator=seeded(), **main_kw)
    want = whole.run(80)
    differ = [name for name in resumed.state._fields
              if not torch.equal(getattr(resumed.state, name),
                                 getattr(whole.state, name))]
    differ += [name for name in got._fields
               if not torch.equal(getattr(got, name), getattr(want, name))]
    log(f"[slice {tag}] resumed at step 60, 20 steps, against 80 "
        f"uninterrupted steps from the same generator: state and fields "
        f"bit-equal: {not differ} {differ or ''}")
    require(not differ, f"path {tag}: the resumed run differs in {differ}")
    check_fields(fields_to_numpy(got), OCEAN_DEMO.resolution, tag)
    before, old = resumed.state, resumed.solver
    resumed.reconfigure(OCEAN_DEMO.replace(wind=(10.0, 6.0)))
    after, new = resumed.state, resumed.solver
    require(all(torch.equal(getattr(after, k), getattr(before, k))
                for k in ("phase", "t", "step", "foam_accum"))
            and not torch.equal(after.h0_re, before.h0_re)
            and resumed.step_count == 80,
            f"path {tag}: reconfigure changed the phase, clock, step or "
            f"foam, or kept h0")
    require(new is not old and all(getattr(new, k) is getattr(old, k)
                                   for k in ("omega", "pack", "x0", "z0")),
            f"path {tag}: reconfigure rebuilt a table")
    log(f"[slice {tag}] reconfigure(wind=(10, 6)): phase, t, step, foam "
        f"bit-equal, h0 drawn afresh, omega, pack, x0, z0 the same tensors")
    counted(f"{tag} reconfigured", {k: 20 * v for k, v in main_per_step.items()},
            lambda: resumed.run(20))
    check_fields(fields_to_numpy(resumed.fields), OCEAN_DEMO.resolution, tag)
    time_path(f"path ({tag}) Simulation.step, checkpoint and export every 20",
              OCEAN_DEMO.resolution, resumed.step, 200, OCEAN_NOTE)
    resumed.close()
    del sim, resumed, whole, got, want, kept
    phase_done(f"4 path ({tag})")

    # (xxiii) Simulation's own defaults: OceanConfig() on matmul, the
    # complex state, against the CPU; then a resolution change
    tag = "xxiii"
    sim = Simulation(OceanConfig(), generator=seeded())
    require((sim.solver.fft_backend, sim.solver.real_state) == ("matmul", False),
            f"path {tag}: Simulation's defaults")
    counted(tag, {}, lambda: sim.run(100))
    cpu_sim = Simulation(OceanConfig(), generator=seeded(), device="cpu")
    cpu_sim.run(100)
    card = fields_to_numpy(sim.fields)
    check_fields(card, 256, tag)
    compare_fields(card, fields_to_numpy(cpu_sim.fields), OceanConfig(), tag,
                   packed=False)
    time_path(f"path ({tag}) Simulation(OceanConfig()).step matmul complex",
              256, sim.step, 200, OCEAN_NOTE)
    # the centered FFT needs L = N·unit_width, so the length follows N
    sim.reconfigure(OceanConfig(resolution=1024, length=1024.0))
    switches = {k: getattr(sim.solver, k) for k in (
        "fft_backend", "eval_mode", "real_state", "pack_channels",
        "half_spectrum", "pallas_fields")}
    require(sim.step_count == 0 and switches == {
        "fft_backend": "matmul", "eval_mode": "fft", "real_state": False,
        "pack_channels": False, "half_spectrum": False,
        "pallas_fields": False}, f"path {tag}: reconfigure to 1024²")
    counted(f"{tag} 1024", {}, lambda: sim.run(20))
    require(sim.step_count == 20, f"path {tag}: step count")
    check_fields(fields_to_numpy(sim.fields), 1024, f"{tag} 1024")
    log(f"[slice {tag}] reconfigure to 1024² (L 1024): step count restarted "
        f"at 0, 20 steps; switches {switches}")
    del sim, cpu_sim, card
    phase_done(f"4 path ({tag})")

    # (xxiv) eval_mode="direct": FFT_MESH_DEMO (L = 12.39, which only the
    # direct sum takes) against the CPU and float64, then (xvii)'s config
    # at 1024² against its reference route on the card
    tag = "xxiv"
    dsolver = OceanSolver(FFT_MESH_DEMO, eval_mode="direct")
    state = dsolver.init(seeded())
    cpu_solver = OceanSolver(FFT_MESH_DEMO, device="cpu", eval_mode="direct")
    cpu_state = state_from_numpy(state, "cpu")

    def direct_steps():
        nonlocal state
        for _ in range(100):
            state, fields = dsolver.step(state, DT)
        return fields

    card = fields_to_numpy(counted(tag, {}, direct_steps))
    for _ in range(100):
        cpu_state, cpu_fields = cpu_solver.step(cpu_state, DT)
    check_fields(card, FFT_MESH_DEMO.resolution, tag)
    compare_fields(card, fields_to_numpy(cpu_fields), FFT_MESH_DEMO, tag,
                   packed=False)
    f64 = direct_fields_f64(FFT_MESH_DEMO, state.h0.cpu().numpy(),
                            state.h0_conj.cpu().numpy(), float(state.t))
    compare_fields(card, f64, FFT_MESH_DEMO, tag, against="float64",
                   packed=False)
    xvii = next(p for p in PATHS if p.tag == "xvii")
    pcfg = path_config(xvii)
    dsolver = OceanSolver(pcfg, eval_mode="direct")
    ref_solver = OceanSolver(pcfg, fft_backend="reference")
    state = dsolver.init(seeded())
    ref_state = state
    for _ in range(10):
        state, fields = dsolver.step(state, DT)
        ref_state, ref_fields = ref_solver.step(ref_state, DT)
    card = fields_to_numpy(fields)
    check_fields(card, pcfg.resolution, f"{tag} 1024")
    compare_fields(card, fields_to_numpy(ref_fields), pcfg, f"{tag} 1024",
                   against="reference", packed=False)
    # each route's error against the float64 direct sum, for the record
    f64 = direct_fields_f64(pcfg, state.h0.cpu().numpy(),
                            state.h0_conj.cpu().numpy(), float(state.t))
    for route, got in (("direct", card),
                       ("reference", fields_to_numpy(ref_fields))):
        log(f"[slice {tag} 1024] {route} vs float64, max abs err over "
            f"max|float64|: " + ", ".join(
                f"{name} {np.abs(getattr(got, name) - getattr(f64, name)).max() / np.abs(getattr(f64, name)).max():.3e}"
                for name in ("height", "disp_x", "disp_z", "jacobian")))
    direct_ms = cuda_ms(ocean_step(dsolver, state), iters=50)[0]
    _, xsolver, xstate = solvers["xvii"]
    xvii_ms = cuda_ms(ocean_step(xsolver, xstate), iters=50)[0]
    log(f"[timing] {kind} ({smi}): path ({tag}) eval_mode='direct' 1024² "
        f"{direct_ms:.4f} ms/step beside path (xvii)'s pallas step "
        f"{xvii_ms:.4f} ms/step in the same call ({direct_ms / xvii_ms:.1f}x: "
        f"the direct sum is O(N^3) on cuBLAS)")
    time_path(f"path ({tag}) eval_mode=direct complex centered", 1024,
              ocean_step(dsolver, state), 50, OCEAN_NOTE)
    del dsolver, ref_solver, cpu_solver, card, f64
    phase_done(f"4 path ({tag})")

    # (xxv) the shader-hash h0 on the main path at 1024²
    tag = "xxv"
    seeds = (0.37, 0.81)
    hsolver = OceanSolver(OCEAN_DEMO, **main_kw)
    state = hsolver.init(gpu_hash_seeds=seeds)
    h0, h0c = h0_pair_gpu_hash(OCEAN_DEMO.resolution, OCEAN_DEMO.length,
                               OCEAN_DEMO.phillips_amplitude, OCEAN_DEMO.wind,
                               *seeds, OCEAN_DEMO.damping)
    raw = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
           for a in (h0.real, h0.imag, h0c.real, h0c.imag)]
    names = ("h0_re", "h0_im", "h0c_re", "h0c_im")
    unpacked = OceanSolver(OCEAN_DEMO, fft_backend="pallas", real_state=True)
    raw_state = unpacked.init(gpu_hash_seeds=seeds)
    require(all(torch.equal(getattr(raw_state, k).cpu(), r)
                for k, r in zip(names, raw))
            and all(torch.equal(getattr(state, k).cpu(), r)
                    for k, r in zip(names, hermitize_planes(*raw))),
            f"path {tag}: the h0 planes on the card differ from numpy's")
    log(f"[slice {tag}] init(gpu_hash_seeds={seeds}) at 1024²: h0 planes on "
        f"the card bit-equal to numpy's h0_pair_gpu_hash (unpacked) and to "
        f"its Hermitian projection (packed)")
    cpu_solver = OceanSolver(OCEAN_DEMO, device="cpu", **main_kw)
    cpu_state = cpu_solver.init(gpu_hash_seeds=seeds)

    def hash_steps():
        nonlocal state
        for _ in range(20):
            state, fields = hsolver.step(state, DT)
        return fields

    card = fields_to_numpy(counted(tag, {k: 20 * v for k, v in
                                         main_per_step.items()}, hash_steps))
    for _ in range(20):
        cpu_state, cpu_fields = cpu_solver.step(cpu_state, DT)
    check_fields(card, OCEAN_DEMO.resolution, tag)
    compare_fields(card, fields_to_numpy(cpu_fields), OCEAN_DEMO, tag)
    time_path(f"path ({tag}) pallas shader-hash h0", OCEAN_DEMO.resolution,
              ocean_step(hsolver, state), 200, OCEAN_NOTE)
    del hsolver, unpacked, cpu_solver, card, raw_state
    phase_done(f"4 path ({tag})")

    # ---- the demo CLI (xxvi)-(xxviii) through demo.main, as a user runs
    # it, then its module entry point in a process of its own
    from tpu_ocean_torch import _png, demo, sample, viz
    from tpu_ocean_torch.gerstner import PondFields

    def run_cli(what, argv, want):
        """demo.main(argv) with its stderr captured and every count set to
        0 just before; requires rc 0 and exactly ``want`` launches."""
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = counted(what, want, lambda: demo.main(argv))
        text = err.getvalue()
        require(rc == 0,
                f"path {what}: demo.main returned {rc}: {text[-2000:]}")
        return text

    # (xxvi) ocean --production at OCEAN_DEMO 1024²: path (i)'s launches,
    # every output file, bit-equal to the solver it wraps
    tag = "xxvi"
    out = work / "ocean"
    text = run_cli(tag, ["ocean", "--production", "--steps", "60",
                         "--dump-every", "20", "--checkpoint-every", "20",
                         "--save-mesh", "--save-clipmap", "--out", str(out)],
                   {k: 60 * v for k, v in main_per_step.items()})
    cli_summary = {tag: cli_metrics(text, 60, tag)}
    ckpts = sorted(p.name for p in (out / "ckpt").iterdir())
    require(ckpts == [f"state_{k:010d}.npz" for k in (20, 40, 60)],
            f"path {tag}: checkpoints {ckpts}")
    require(all((out / f"ocean_render_{k:06d}.png").is_file()
                for k in (20, 40, 60)), f"path {tag}: dumped renders")
    wsolver = OceanSolver(OCEAN_DEMO, **main_kw)
    wstate = wsolver.init(seeded())
    for _ in range(60):
        wstate, wfields = wsolver.step(wstate, DT)
    host = fields_to_numpy(wfields)
    saved = type(host)(*(np.load(out / f"ocean_{name}_000060.npy")
                         for name in host._fields))
    differ = [name for name in host._fields
              if not np.array_equal(getattr(saved, name), getattr(host, name))]
    log(f"[slice {tag}] ocean --production, 60 steps: the saved fields "
        f"against OceanSolver(OCEAN_DEMO, {main_kw}) stepped 60 times from "
        f"manual_seed(0): bit-equal {not differ} {differ or ''}")
    require(not differ, f"path {tag}: the CLI's fields differ in {differ}")
    check_fields(saved, OCEAN_DEMO.resolution, tag)
    pngs = 0
    for name in host._fields:
        a = getattr(saved, name)
        if a.ndim == 2:
            got = _png.read_png(str(out / f"ocean_{name}_000060.png"))
            require(np.array_equal(got, _png.colormap(
                viz._normalize01(a.astype(np.float64)))),
                f"path {tag}: ocean_{name}_000060.png is not the viridis "
                f"mapping of its .npy")
            pngs += 1
    require(np.array_equal(_png.read_png(str(out / "ocean_render.png")),
                           (viz.shade_ocean(saved) * 255).astype(np.uint8)),
            f"path {tag}: ocean_render.png is not shade_ocean of the fields")
    with open(out / "ocean_mesh.obj") as f:
        counts = collections.Counter(line[:2] for line in f)
    require(counts["v "] == 256 * 256 and counts["f "] == 2 * 255 * 255,
            f"path {tag}: the mesh has {counts['v ']} vertices and "
            f"{counts['f ']} faces")
    with open(out / "ocean_clipmap.obj") as f:
        clip_v = sum(line.startswith("v ") for line in f)
    require(clip_v > 0, f"path {tag}: empty clipmap")
    log(f"[slice {tag}] 60 JSONL lines, checkpoints {ckpts}, {pngs} field "
        f"PNGs read back equal to the viridis mapping of their .npy, "
        f"ocean_render.png equal to shade_ocean, mesh {counts['v ']} "
        f"vertices (decimate 4), clipmap {clip_v} vertices")
    # the consumers on the card's fields against their CPU copy: heights
    # within 1e-6 x the fields' max, world x and z within 1e-6 x their own
    # reach (the probes span [-L, 2L])
    cpu_fields = type(wfields)(*(f.cpu() for f in wfields))
    length, chop = OCEAN_DEMO.length, OCEAN_DEMO.choppiness
    pos = np.random.default_rng(0).uniform(-length, 2 * length, (256, 2))
    scale = max(float(getattr(cpu_fields, k).abs().max())
                for k in ("height", "disp_x", "disp_z"))
    got = sample.buoy_heights(wfields, pos, length)
    require(got.device == wfields.height.device and got.shape == (256,),
            f"path {tag}: buoy heights")
    pairs = [(got, sample.buoy_heights(cpu_fields, pos, length))]
    pairs += zip(*(sample.surface_at(f, pos[:, 0], pos[:, 1], length, chop)
                   for f in (wfields, cpu_fields)))
    sample_errs = [float((g.cpu() - w).abs().max()) for g, w in pairs]
    bands = [1e-6 * scale, 1e-6 * (scale + 2 * length), 1e-6 * scale,
             1e-6 * (scale + 2 * length)]
    x = torch.tensor(pos[:8, 0], dtype=torch.float32, device=dev,
                     requires_grad=True)
    sample.sample_bilinear(wfields.height, x, pos[:8, 1],
                           length).sum().backward()
    log(f"[slice {tag}] sample on the card's final fields against the CPU "
        f"copy, max abs err (band): buoy_heights, surface_at x, height, z "
        + ", ".join(f"{e:.3e} ({b:.1e})" for e, b in zip(sample_errs, bands))
        + f"; gradient in x through sample_bilinear finite: "
        f"{bool(torch.isfinite(x.grad).all())}")
    require(all(e <= b for e, b in zip(sample_errs, bands)),
            f"path {tag}: sample on the card differs from the CPU")
    require(bool(torch.isfinite(x.grad).all()), f"path {tag}: gradient")
    del wsolver, wstate, wfields, host, saved, cpu_fields
    phase_done(f"4 path ({tag})")

    # (xxvii) pond --pallas at BASELINE config 3 (512², the bank of (p2))
    tag = "xxvii"
    out = work / "pond"
    text = run_cli(tag, ["pond", "--pallas", "--waves", "16", "--steps",
                         "600", "--out", str(out)], {"gerstner_bank": 600})
    cli_summary[tag] = cli_metrics(text, 600, tag)
    card = PondFields(*(np.load(out / f"pond_{name}_000600.npy")
                        for name in pond_names))
    check_pond_fields(card, POND_DEMO.resolution, tag)
    cpu = PondSolver(POND_DEMO, bank=WaveBank.random(0, 16), use_pallas=True,
                     device="cpu")
    log(f"[slice {tag}] the CLI's last t = 599/60 on the CPU plain path")
    compare_pond(card, pond_fields_to_numpy(cpu.fields(599 / 60.0)), tag,
                 pond_names)
    for name in ("pond_render", "pond_render_cubemap", "pond_render_realtime"):
        shape = _png.read_png(str(out / f"{name}.png")).shape
        require(shape == (512, 512, 3), f"path {tag}: {name}.png {shape}")
    log(f"[slice {tag}] 600 JSONL lines, three render PNGs 512x512 RGB")
    phase_done(f"4 path ({tag})")

    # (xxviii) fftmesh: the oracle against the direct sum, no hand kernel
    tag = "xxviii"
    text = run_cli(tag, ["fftmesh", "--out", str(work / "fftmesh")], {})
    mesh_err = cli_fftmesh_error(text)
    log(f"[slice {tag}] fftmesh: oracle-vs-solver max rel height error "
        f"{mesh_err:.3e} (rc 1 at 1e-3 or more)")
    require(mesh_err < 1e-3, f"path {tag}: error {mesh_err}")
    phase_done(f"4 path ({tag})")

    # ---- the cascade slice (xxix)-(xxxiii): CascadeSolver,
    # LODCascadeSolver, CascadeSimulation and the CLI's cascade scene, each
    # from a fixed seed; every row-DFT launch recorded with its C
    from tpu_ocean_torch import (CascadeSimulation, CascadeSolver,
                                 LODCascadeSolver, LODState,
                                 cascade_state_from_numpy,
                                 cascade_state_to_numpy, default_cascade,
                                 load_cascade_checkpoint,
                                 save_cascade_checkpoint)
    from tpu_ocean_torch.lod import periods_for_distance
    casc_kw = {"fft_backend": "pallas", **SLICE}
    rows_tr, rows_nat = "tpu_fft_rows_transposed", "tpu_fft_rows_natural"
    casc_ms = {}

    def require_rows(rows, want, what):
        got, want = collections.Counter(rows), collections.Counter(want)
        log(f"[slice {what}] row-DFT launches by (entry, C): {dict(got)}")
        require(got == want, f"path {what}: row-DFT launches {dict(got)}, "
                f"not {dict(want)}")

    def combined(solver):
        """The config compare_fields reads for a cascade's combined
        surface: effective displacements (no further chop), the display
        length's texel."""
        return solver.cfgs[0].replace(choppiness=1.0,
                                      length=solver.display_length)

    def cpu_copy(state):
        return cascade_state_from_numpy(cascade_state_to_numpy(state), "cpu")

    def stepped(solver, state, steps):
        """run() for counted: ``steps`` steps from ``state``; returns (the
        state before the last step, the last state, its fields)."""
        def run():
            st = prev = state
            for _ in range(steps):
                prev = st
                st, fields = solver.step(st, DT)
            return prev, st, fields
        return run

    def replay(solver, prev, card, tag):
        """The last step again on the CPU plain path from the card's state
        before it; returns the CPU solver."""
        cpu_solver = CascadeSolver(solver.cfgs, device="cpu", **casc_kw)
        _, cpu_fields = cpu_solver.step(cpu_copy(prev), DT)
        log(f"[slice {tag}] the last step replayed on the CPU plain path "
            f"from the card's state")
        compare_fields(card, fields_to_numpy(cpu_fields), combined(solver),
                       tag)
        return cpu_solver

    def held_velocity(got, want, tag):
        got, want = got.cpu().numpy(), want.numpy()
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        log(f"[slice {tag}] velocity card vs cpu: max abs err {err:.3e} = "
            f"{err / scale:.3e} x max|cpu| (limit 1e-5)")
        require(np.isfinite(got).all() and err <= 1e-5 * scale,
                f"path {tag}: velocity disagrees")

    # (xxix) the production cascade at CASCADE_N: every pass one launch for
    # the three bands
    tag = "xxix"
    cfgs = default_cascade(n=CASCADE_N)
    csolver = CascadeSolver(cfgs, **casc_kw)
    with recorded_rows(planes) as rows:
        prev, cstate, cfields = counted(
            tag, {"fft_rows_transposed": 5 * 60, "fields_stencil": 60},
            stepped(csolver, csolver.init(seeded()), 60))
    require_rows(rows, [(rows_tr, 3)] * 5 * 60, tag)
    card = fields_to_numpy(cfields)
    require(int(cstate.step) == 60, f"path {tag}: step counter")
    check_fields(card, CASCADE_N, tag)
    cpu_solver = replay(csolver, prev, card, tag)
    # the same last step as three single-patch solvers, one band each
    # (tests/test_cascade.py::test_cascade_equals_sum_of_bands on the card)
    sums = [torch.zeros_like(cfields.height) for _ in range(3)]
    for b, cfg in enumerate(cfgs):
        one = OceanSolver(cfg, **{**casc_kw, "pallas_fields": False})
        st = one.init(h0=torch.complex(prev.h0_re[b], prev.h0_im[b]).cpu(),
                      h0_conj=torch.complex(prev.h0c_re[b],
                                            prev.h0c_im[b]).cpu())
        _, f = one.step(st._replace(phase=prev.phase[b], t=prev.t,
                                    step=prev.step), DT)
        sums[0] += f.height
        sums[1] += cfg.choppiness * f.disp_x
        sums[2] += cfg.choppiness * f.disp_z
    for name, got, want in zip(("height", "chop x disp_x", "chop x disp_z"),
                               (cfields.height, cfields.disp_x,
                                cfields.disp_z), sums):
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        log(f"[slice {tag}] combined {name} against the sum of three "
            f"single-patch OceanSolvers: max abs err {err:.3e} = "
            f"{err / scale:.3e} x max (limit 1e-6)")
        require(err <= 1e-6 * scale,
                f"path {tag}: the cascade is not the sum of its bands")
    with recorded_rows(planes) as rows:
        vel = counted(f"{tag} velocity", {"fft_rows_transposed": 3},
                      lambda: csolver.velocity(cstate))
    require_rows(rows, [(rows_tr, 3)] * 3, f"{tag} velocity")
    held_velocity(vel, cpu_solver.velocity(cpu_copy(cstate)), tag)
    casc_ms[tag] = time_path(
        f"path ({tag}) CascadeSolver.step pallas, 3 bands", CASCADE_N,
        ocean_step(csolver, cstate), 200, OCEAN_NOTE)
    del prev, cfields, card, cpu_solver, sums, vel
    phase_done(f"4 path ({tag})")

    # (xxx) the same at CASCADE_NATURAL_N: the natural regime
    tag = "xxx"
    big = CascadeSolver(default_cascade(n=CASCADE_NATURAL_N), **casc_kw)
    with recorded_rows(planes) as rows:
        prev, bstate, bfields = counted(
            tag, {"fft_rows_natural": 3 * 10, "fft_rows_transposed": 2 * 10,
                  "fields_stencil": 10},
            stepped(big, big.init(seeded()), 10))
    require_rows(rows, [(rows_nat, 3)] * 30 + [(rows_tr, 3)] * 20, tag)
    card = fields_to_numpy(bfields)
    check_fields(card, CASCADE_NATURAL_N, tag)
    replay(big, prev, card, tag)
    casc_ms[tag] = time_path(
        f"path ({tag}) CascadeSolver.step pallas, 3 bands",
        CASCADE_NATURAL_N, ocean_step(big, bstate), 40, OCEAN_NOTE)
    del big, prev, bstate, bfields, card
    phase_done(f"4 path ({tag})")

    # (xxxi) LOD on (xxix)'s switches: each frame transforms only the
    # bands it refreshes; (xxix)'s solver stepped every frame from the
    # same state is the control
    tag = "xxxi"
    lod = LODCascadeSolver(cfgs, periods=LOD_PERIODS, **casc_kw)
    lstate = lod.init(seeded())
    control, every = lstate.cascade, {}
    for frame in range(1, 65):
        control, f = csolver.step(control, DT)
        if frame % 8 == 0:
            every[frame] = (f.height, control.phase)
    at, held = {}, []

    def lod_frames():
        st = lstate
        for frame in range(1, 65):
            prev, (st, f) = st, lod.step(st)
            refreshed = lod._slots[frame % lod.schedule_len]
            held.extend(torch.equal(st.planes[b], prev.planes[b])
                        for b in range(lod.inner.b) if b not in refreshed)
            if frame % 8 == 0:
                at[frame] = (f.height, st.cascade.phase)
        return st

    sizes = lod_row_launches(LOD_PERIODS, 1, 64)
    with recorded_rows(planes) as rows:
        lstate = counted(tag, {"fft_rows_transposed": len(sizes),
                               "fields_stencil": 64}, lod_frames)
    require_rows(rows, [(rows_tr, c) for c in sizes], tag)
    require(held and all(held), f"path {tag}: a held band's planes moved")
    h_err = max((at[k][0] - every[k][0]).abs().max().item() for k in at)
    p_err = max(torch.minimum(d, 2 * np.pi - d).max().item()
                for d in ((at[k][1] - every[k][1]).abs() for k in at))
    log(f"[slice {tag}] periods {LOD_PERIODS}, 64 frames: {len(held)} held "
        f"band-frames, planes bit-equal to their last refresh; at frames "
        f"8-64 against (xxix)'s solver stepped every frame: height max abs "
        f"err {h_err:.3e} (limit 1e-4), phase {p_err:.3e} (limit 1e-5)")
    require(h_err <= 1e-4 and p_err <= 1e-5,
            f"path {tag}: LOD differs from the every-frame cascade")
    check_fields(fields_to_numpy(lod.step(lstate)[1]), CASCADE_N, tag)
    with recorded_rows(planes) as rows:
        vel = counted(f"{tag} velocity", {"fft_rows_transposed": 3},
                      lambda: lod.velocity(lstate))
    require_rows(rows, [(rows_tr, 3)] * 3, f"{tag} velocity")
    cpu_lod = LODCascadeSolver(cfgs, periods=LOD_PERIODS, device="cpu",
                               **casc_kw)
    held_velocity(vel, cpu_lod.velocity(cpu_copy(lstate)), tag)
    # the out-of-place scatters of a one-band and a two-band frame: the
    # plane cache and the phase written anew
    for subset in ((2,), (1, 2)):
        idx = lod._substeps[subset][0]
        fresh = lstate.planes[list(subset)].clone()
        phase = lstate.cascade.phase[list(subset)].clone()
        ms_planes = device_ms(lambda: lstate.planes.index_copy(0, idx,
                                                               fresh))[0]
        ms_phase = device_ms(lambda: lstate.cascade.phase.index_copy(
            0, idx, phase))[0]
        nbytes = 2 * (lstate.planes.numel() + lstate.cascade.phase.numel()) * 4
        log(f"[timing] {kind} ({smi}): path ({tag}) LOD scatter of subset "
            f"{subset}: plane cache {ms_planes:.4f} ms, phase "
            f"{ms_phase:.4f} ms (index_copy, out of place; bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms for "
            f"{nbytes / 1e6:.1f} MB read and written)")
    lod_state = [lstate]

    def lod_step():
        lod_state[0], _ = lod.step(lod_state[0])

    casc_ms[tag] = time_path(
        f"path ({tag}) LODCascadeSolver.step periods {LOD_PERIODS}",
        CASCADE_N, lod_step, 200, OCEAN_NOTE)
    del lod, lstate, lod_state, control, every, at, vel, cpu_lod
    phase_done(f"4 path ({tag})")

    # (xxxii) CascadeSimulation on (xxxi)'s schedule: checkpoints and
    # export every 20 frames, a resume, a refused schedule, a live wind
    # change
    tag = "xxxii"
    casc_dir = work / "cascade"
    sim_kw = dict(out_dir=str(casc_dir), checkpoint_every=20,
                  export_every=20, periods=LOD_PERIODS, **casc_kw)
    kept = {}

    def keep(sim):
        if sim.step_count % 20 == 0:
            kept[sim.step_count] = (sim.fields.height.cpu().numpy(),
                                    sim.fields.foam.cpu().numpy())

    sim = CascadeSimulation(cfgs, generator=seeded(), **sim_kw)
    sizes = lod_row_launches(LOD_PERIODS, 1, 60)
    with recorded_rows(planes) as rows:
        counted(tag, {"fft_rows_transposed": len(sizes), "fields_stencil": 60},
                lambda: sim.run(60, callback=keep))
    require_rows(rows, [(rows_tr, c) for c in sizes], tag)
    require(sim._exporter.errors() == 0 and sorted(kept) == [20, 40, 60],
            f"path {tag}: export")
    for k, fields in kept.items():
        for name, want in zip(("height", "foam"), fields):
            got = np.load(casc_dir / "fields" / f"{name}_{k:08d}.npy")
            require(np.array_equal(got, want.astype(np.float64)),
                    f"path {tag}: exported {name} at frame {k} differs")
    sim.close()
    saved, saved_cfgs = load_cascade_checkpoint(
        str(casc_dir / "ckpt" / "state_0000000060.npz"), real_state=True,
        device="cpu")
    require(isinstance(saved, LODState) and saved.frame == 60
            and saved_cfgs == cfgs
            and torch.equal(saved.planes, sim.state.planes.cpu())
            and torch.equal(saved.cascade.phase,
                            sim.state.cascade.phase.cpu()),
            f"path {tag}: the card's checkpoint read on the CPU differs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_cascade_checkpoint(str(work / "one_cascade"), sim.state, cfgs,
                            periods=LOD_PERIODS)
    save_ms = (time.perf_counter() - t0) * 1e3
    resumed = CascadeSimulation(cfgs, **sim_kw)
    require(resumed.step_count == 60, f"path {tag}: resumed at frame "
            f"{resumed.step_count}, not 60")
    sizes = lod_row_launches(LOD_PERIODS, 61, 80)
    with recorded_rows(planes) as rows:
        got = counted(f"{tag} resumed", {"fft_rows_transposed": len(sizes),
                                         "fields_stencil": 20},
                      lambda: resumed.run(20))
    require_rows(rows, [(rows_tr, c) for c in sizes], f"{tag} resumed")
    whole = CascadeSimulation(cfgs, generator=seeded(), periods=LOD_PERIODS,
                              **casc_kw)
    want = whole.run(80)
    differ = [name for name in got._fields
              if not torch.equal(getattr(got, name), getattr(want, name))]
    differ += [] if torch.equal(resumed.state.planes, whole.state.planes) \
        else ["planes"]
    log(f"[slice {tag}] CascadeSimulation(periods {LOD_PERIODS}), 60 frames, "
        f"checkpoints and export every 20 (exported height and foam "
        f"bit-equal, the frame-60 checkpoint read on the CPU equal to the "
        f"card's state, one save_cascade_checkpoint {save_ms:.1f} ms); "
        f"resumed at frame 60 for 20, against 80 uninterrupted frames: "
        f"fields and plane cache bit-equal: {not differ} {differ or ''}")
    require(not differ, f"path {tag}: the resumed run differs in {differ}")
    try:
        CascadeSimulation(cfgs, **{**sim_kw, "periods": [4, 4, 1]})
    except ValueError as e:
        log(f"[slice {tag}] resume under periods [4, 4, 1] refused: {e}")
    else:
        require(False, f"path {tag}: a resume under another schedule ran")
    before, old = resumed.state, resumed.solver
    resumed.reconfigure([c.replace(wind=(10.0, 6.0)) for c in cfgs])
    after, new = resumed.state, resumed.solver
    require(after.frame == before.frame == 80 and resumed.step_count == 80
            and new.periods == old.periods and new._substeps is old._substeps
            and torch.equal(after.cascade.phase, before.cascade.phase)
            and not torch.equal(after.cascade.h0_re, before.cascade.h0_re)
            and all(getattr(new.inner, k) is getattr(old.inner, k)
                    for k in ("_omega", "_coeffs", "_x0", "_z0")),
            f"path {tag}: reconfigure moved the frame, the schedule or a "
            f"phase, kept h0, or rebuilt a table")
    log(f"[slice {tag}] reconfigure(wind=(10, 6)): frame 80, schedule and "
        f"every band's phase kept, h0 drawn afresh, omega, coeffs, x0, z0 "
        f"and the sub-steps the same objects")
    check_fields(fields_to_numpy(resumed.step()), CASCADE_N, tag)
    casc_ms[tag] = time_path(f"path ({tag}) CascadeSimulation.step LOD, "
                       f"checkpoint and export every 20", CASCADE_N,
                       resumed.step, 60, OCEAN_NOTE)
    resumed.close()
    del sim, resumed, whole, got, want, kept, saved, before, after
    phase_done(f"4 path ({tag})")

    # (xxxiii) the CLI's cascade scene at CASCADE_N under the camera's LOD
    # schedule, bit-equal to the solver it wraps
    tag = "xxxiii"
    out = work / "cascade_cli"
    periods = periods_for_distance(cfgs, DT, camera_distance=CLI_CAMERA)
    # the init primes every band (one refresh of all three), then the frames
    sizes = [3] * 5 + lod_row_launches(periods, 1, 60)
    with recorded_rows(planes) as rows:
        text = run_cli(tag, ["cascade", "--production", "--res",
                             str(CASCADE_N), "--camera", f"{CLI_CAMERA:g}",
                             "--steps", "60", "--dump-every", "20", "--out",
                             str(out)],
                       {"fft_rows_transposed": len(sizes),
                        "fields_stencil": 60})
    require(cli_lod_periods(text) == periods,
            f"path {tag}: printed schedule {cli_lod_periods(text)}")
    require_rows(rows, [(rows_tr, c) for c in sizes], tag)
    cli_summary[tag] = cli_metrics(text, 60, tag)
    wsolver = LODCascadeSolver(cfgs, periods=periods, **casc_kw)
    wstate = wsolver.init(seeded())
    for _ in range(60):
        wstate, wfields = wsolver.step(wstate)
    host = fields_to_numpy(wfields)
    saved = type(host)(*(np.load(out / f"cascade_{name}_000060.npy")
                         for name in host._fields))
    differ = [name for name in host._fields
              if not np.array_equal(getattr(saved, name), getattr(host, name))]
    log(f"[slice {tag}] cascade --production --camera {CLI_CAMERA:g}: "
        f"periods {periods}, 60 frames: the saved fields against "
        f"LODCascadeSolver(default_cascade({CASCADE_N}), {periods}) stepped "
        f"60 times from manual_seed(0): bit-equal {not differ} {differ or ''}")
    require(not differ, f"path {tag}: the CLI's fields differ in {differ}")
    check_fields(saved, CASCADE_N, tag)
    require(all((out / f"cascade_render_{k:06d}.png").is_file()
                for k in (20, 40, 60))
            and np.array_equal(_png.read_png(str(out / "cascade_render.png")),
                               (viz.shade_ocean(saved) * 255).astype(np.uint8)),
            f"path {tag}: the renders")
    del wsolver, wstate, wfields, host, saved, csolver, cstate
    phase_done(f"4 path ({tag})")

    # the autograd slice (xxxiv)-(xxxvii): gradients through path (i)'s
    # step, d(Σ height² + Σ foam)/d(h0_re), at 1024², 4096² and bf16; then
    # the inversion
    from tpu_ocean_torch import invert_sea_state as inv
    for gp in GRAD_PATHS:
        tag = gp.tag
        gcfg = OCEAN_DEMO.replace(resolution=gp.size, precision=gp.precision)
        gsolver = OceanSolver(gcfg, **main_kw)
        gstate = gsolver.init(seeded())
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grad = counted(tag, gp.per_step,
                             lambda: slice_gradient(gsolver, gstate))
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        require(bool(torch.isfinite(grad).all()) and grad.abs().max() > 0,
                f"path {tag}: the gradient is not finite or is zero")
        log(f"[slice {tag}] OCEAN_DEMO {gp.size}x{gp.size} {gp.precision}, "
            f"{main_kw}: one step from manual_seed(0), loss (float64) "
            f"{loss.item():.10e}, d loss/d h0_re max |.| "
            f"{grad.abs().max().item():.4e}; peak memory of the step and its "
            f"backward {peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB "
            f"held before it")
        if gp.cpu_rel is not None:
            # the same step and gradient on the CPU from the card's state
            cpu_solver = OceanSolver(gcfg, device="cpu", **main_kw)
            cpu_state = state_from_numpy(gstate, "cpu")
            _, cpu_grad = slice_gradient(cpu_solver, cpu_state)
            err = (grad.cpu() - cpu_grad).abs()
            scale = cpu_grad.abs().max().item()
            worst = np.unravel_index(int(err.argmax()), tuple(err.shape))
            log(f"[slice {tag}] card vs cpu d loss/d h0_re: max abs err "
                f"{err.max().item():.3e} = {err.max().item() / scale:.3e} x "
                f"max|cpu| (limit {gp.cpu_rel:g}); worst texel {worst}: card "
                f"{grad[worst].item():.6e}, cpu {cpu_grad[worst].item():.6e}")
            require(err.max().item() <= gp.cpu_rel * scale,
                    f"path {tag}: the card's gradient disagrees with the CPU's")
            del cpu_solver, cpu_state, cpu_grad, err
        if gp.precision == "float32":
            # (at bf16 the transforms round h0 to 8 bits: no difference of
            # eps 1e-3 survives)
            idx, fd, an = finite_difference(gsolver, gstate, grad)
            log(f"[slice {tag}] central difference (eps 1e-3, float64 loss) "
                f"at the dominant element {idx}: {fd:.6e} against the "
                f"gradient {an:.6e}, rel err {abs(fd - an) / abs(an):.3e} "
                f"(limit 1e-2)")
            require(abs(fd - an) <= 1e-2 * abs(an),
                    f"path {tag}: the finite difference disagrees")
        lhs, rhs, yy, cauchy = height_adjoint(gsolver, gstate, seed=1)
        adjoint_check(f"path ({tag}) h0 planes -> height", lhs, rhs, yy, rhs,
                      None if gp.precision == "float32" else BF16_REL, cauchy)

        def grad_step(gsolver=gsolver, gstate=gstate):
            slice_gradient(gsolver, gstate)
        time_path(
            f"path ({tag}) forward + backward {gp.precision}", gp.size,
            grad_step, 50 if gp.size <= 2048 else 10,
            OCEAN_NOTE + "; backward: the row kernels in the opposite "
            "direction, the fields twins and the rest in torch")
        # the fields Function alone at the path's size: the kernel forward,
        # then the twins' recompute and backward in torch (data-blind work)
        texel = OCEAN_DEMO.length / gp.size
        fin = [plane((gp.size, gp.size)).requires_grad_() for _ in range(3)]
        fcts = [torch.ones_like(o) for o in fs.fields_stencil(*fin, texel)]
        fields_ms, per_kernel, how = device_ms(lambda: torch.autograd.grad(
            fs.fields_stencil(*fin, texel), fin, fcts))
        kernel_ms = sum(ms for key, ms in per_kernel.items()
                        if kernel_group(key) == "fields_stencil")
        log(f"[timing] {kind} ({smi}): path ({tag}) the fields Function "
            f"alone at {gp.size}x{gp.size}: {fields_ms:.4f} ms device ({how}), "
            f"the kernel's forward {kernel_ms:.4f} of it, the twins' "
            f"recompute and backward in torch {fields_ms - kernel_ms:.4f}")
        del gsolver, gstate, grad, fin, fcts
        phase_done(f"4 path ({tag})")

    # the fused backend refuses a gradient on the card, as JAX's jax.grad
    # fails there; nothing launches
    fsolver = OceanSolver(OCEAN_DEMO, **{**main_kw, "fft_backend": "pallas_fused"})
    fstate = fsolver.init(seeded())
    torch.cuda.synchronize()
    reset_counts()
    try:
        fsolver.step(fstate._replace(h0_re=fstate.h0_re.clone().requires_grad_()),
                     DT)
        refused = ""
    except NotImplementedError as exc:
        refused = str(exc)
    require_counts(read_counts(), {}, "pallas_fused with a gradient")
    log(f"[slice xxxiv] pallas_fused with h0_re.requires_grad_(): "
        f"NotImplementedError: {refused}")
    require('fft_backend="pallas"' in refused,
            "pallas_fused did not refuse a gradient")
    del fsolver, fstate

    # (xxxvii) the inversion: the example's criterion at its
    # defaults, packed at N = 64 (the production step) and the complex
    # state (cuFFT, no hand kernel); OCEAN_DEMO's width for 30 iterations
    tag = "xxxvii"

    def invert_run(make, steps, evals):
        problem = make()
        params, losses = inv.invert(problem, steps, INVERT_LR)
        with torch.no_grad():
            ends = ([float(problem.loss(params)),
                     float(problem.loss(problem.start))] if evals else [])
        return problem, params, losses, ends

    for what, make, want in (
            ("packed N = 64", lambda: inv.packed_problem(64),
             inversion_launches(INVERT_STEPS, 2)),
            ("complex N = 48", lambda: inv.complex_problem(48), {})):
        t0 = time.perf_counter()
        problem, params, losses, (final, init) = counted(
            f"{tag} {what}", want, lambda: invert_run(make, INVERT_STEPS, True))
        secs = time.perf_counter() - t0
        log(f"[slice {tag}] {what}, {INVERT_STEPS} iterations of Adam (lr "
            f"{INVERT_LR:g}): loss {init:.4e} -> {final:.4e} "
            f"({init / final:.1f}x; the criterion 100x), rel |h0 - h0*| "
            f"{problem.error(params):.3f}; every 25th loss "
            f"{[round(x, 4) for x in losses[::25]]}; {secs:.1f} s "
            f"({secs * 1e3 / INVERT_STEPS:.2f} ms/iteration, host clock)")
        require(np.isfinite(losses).all() and final < 1e-2 * init,
                f"path {tag}: {what} reduced the loss {init / final:.1f}x, "
                f"not 100x")
        del problem, params
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    problem, params, losses, _ = counted(
        f"{tag} packed N = {INVERT_WIDE_N}",
        inversion_launches(INVERT_WIDE_STEPS, 0),
        lambda: invert_run(lambda: inv.packed_problem(INVERT_WIDE_N),
                           INVERT_WIDE_STEPS, False))
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / INVERT_WIDE_STEPS
    iter_ms = start.elapsed_time(end) / INVERT_WIDE_STEPS
    busy, per_kernel, how = device_ms(
        lambda: inv.value_and_grad(problem, params), iters=5)
    groups = {}
    for key, ms in per_kernel.items():
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + ms
    log(f"[timing] {kind} ({smi}): path ({tag}) packed inversion at "
        f"{INVERT_WIDE_N}x{INVERT_WIDE_N}, {INVERT_WIDE_STEPS} iterations (12 "
        f"steps forward, 4 snapshots' backward, Adam, and the 12 "
        f"observation steps): {iter_ms:.4f} ms/iteration (CUDA events; host "
        f"clock {wall_ms:.4f}); one value-and-gradient device busy "
        f"{busy:.4f} ms ({how}): " + ", ".join(
            f"{g} {ms:.4f}" for g, ms in sorted(groups.items())))
    log(f"[slice {tag}] packed N = {INVERT_WIDE_N} loss curve: "
        + ", ".join(f"{x:.4e}" for x in losses))
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"path {tag}: the loss at N = {INVERT_WIDE_N} did not fall")
    del problem, params
    # the module in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ocean_torch.invert_sea_state", "--packed",
         "--n", "64"], cwd=HERE, capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"python -m tpu_ocean_torch.invert_sea_state "
            f"--packed --n 64 exited {proc.returncode}: "
            f"{(proc.stdout + proc.stderr)[-2000:]}")
    log(f"[slice {tag}] python -m tpu_ocean_torch.invert_sea_state --packed "
        f"--n 64: exit 0 in {time.perf_counter() - t0:.1f} s; "
        f"{proc.stdout.strip().splitlines()[-1]}")
    phase_done(f"4 path ({tag})")

    # the module entry point in a process of its own, on the cached build:
    # the ocean and the cascade scenes
    builds = sorted(p.name for p in _build.BUILD_ROOT.iterdir())
    for scene in ("ocean", "cascade"):
        out = work / f"entry_{scene}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_ocean_torch", scene, "--production",
             "--res", "256", "--steps", "5", "--out", str(out)],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        entry_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"python -m tpu_ocean_torch {scene} "
                f"exited {proc.returncode}: {proc.stderr[-2000:]}")
        written = sorted(p.name for p in out.iterdir())
        require(len([n for n in written if n.endswith(".npy")]) == 8
                and len([n for n in written if n.endswith(".png")]) == 8
                and sorted(p.name for p in _build.BUILD_ROOT.iterdir())
                == builds,
                f"python -m tpu_ocean_torch {scene}: wrote {written}, or "
                f"built again")
        log(f"[slice entry] python -m tpu_ocean_torch {scene} --production "
            f"--res 256 --steps 5: exit 0 in {entry_s:.1f} s, "
            f"{len(written)} files, no new build; "
            f"{proc.stderr.strip().splitlines()[-1]}")
    scratch.cleanup()
    phase_done("4 path (entry)")

    phase_done("4 slice")

    # ---- 5. timing: each path's step, then each kernel
    path_ms = {}
    for path in PATHS:
        pcfg, psolver, state = solvers[path.tag]
        with fields_switch(fs, path.v2), dft_switches(planes, path.switches):
            path_ms[path.tag] = time_path(f"path ({path.tag}) {path.backend}"
                      + ("" if path.precision == "float32"
                         else f" {path.precision}")
                      + ("" if path.v2 else " fields v1")
                      + ("" if path.solver.get("real_state") else " complex")
                      + "".join(f" {k}={v}" for k, v in
                                {**path.switches,
                                 **path_switches(path)}.items()),
                      path.size, ocean_step(psolver, state),
                      200 if path.size <= 2048 else 40, OCEAN_NOTE)
    for tag, *_ in POND_PATHS:
        sim = ponds[tag][0]
        clock = [sim.state]

        def fields_call(sim=sim, clock=clock):
            clock[0] += sim.dt
            sim.solver.fields(clock[0])

        time_path(f"path ({tag}) PondSolver.fields", POND_DEMO.resolution,
                  fields_call, 200, POND_NOTE)
        path_ms[tag] = time_path(f"path ({tag}) PondSimulation.step",
                                 POND_DEMO.resolution, sim.step, 200,
                                 POND_NOTE)
    # the CLI's own metrics (host clock around each step and its
    # synchronize; the saves lie outside) beside the library paths it wraps
    for tag, beside in (("xxvi", f"path (i)'s OceanSolver.step "
                                 f"{path_ms['i']:.4f} ms/step (CUDA events) "
                                 f"and path (xxii)'s Simulation Metrics mean "
                                 f"{sim_summary['mean_ms']:.4f}"),
                        ("xxvii", f"path (p2)'s PondSimulation.step "
                                  f"{path_ms['p2']:.4f} ms/step (CUDA "
                                  f"events)"),
                        ("xxxiii", f"path (xxxi)'s LODCascadeSolver.step "
                                   f"{casc_ms['xxxi']:.4f}, (xxix)'s "
                                   f"CascadeSolver.step "
                                   f"{casc_ms['xxix']:.4f} and (xxxii)'s "
                                   f"CascadeSimulation.step "
                                   f"{casc_ms['xxxii']:.4f} ms/step (CUDA "
                                   f"events)")):
        m = cli_summary[tag]
        log(f"[timing] {kind} ({smi}): path ({tag}) the CLI's "
            f"Metrics.summary() over {m['steps']} steps: mean "
            f"{m['mean_ms']:.4f} ms/step, p50 {m['p50_ms']:.4f}, p95 "
            f"{m['p95_ms']:.4f}; beside {beside}")
    # 4096² in the transposed regime (the JAX crossover moved past it)
    natural_cap = planes.MAX_TRANSPOSED_N
    for tag in ("iii", "iv"):
        pcfg, psolver, state = solvers[tag]
        _, f_nat = psolver.step(state, DT)
        planes.MAX_TRANSPOSED_N = 8192
        try:
            _, f_tr = psolver.step(state, DT)
            torch.cuda.synchronize()
            scale = f_nat.height.abs().max().item()
            err = (f_tr.height - f_nat.height).abs().max().item()
            log(f"[timing] path ({tag}) with MAX_TRANSPOSED_N = 8192: height "
                f"vs the natural regime's, max abs err {err:.3e} = "
                f"{err / scale:.3e} x max")
            require(err <= 1e-5 * scale, f"path {tag}: the regimes disagree")
            time_path(f"path ({tag}) {psolver.fft_backend} transposed regime",
                      pcfg.resolution, ocean_step(psolver, state), 40,
                      OCEAN_NOTE)
        finally:
            planes.MAX_TRANSPOSED_N = natural_cap
        del f_nat, f_tr

    phase_done("5 timing, paths")
    results = {}
    by_shape = {}
    for case in cases:
        name, shape, library = case.name, case.shape, case.library
        if name in MIXED_SHAPES and tuple(shape) not in MIXED_TIMED:
            continue
        k, _, k_how = device_ms(
            case.run, iters=10 if tuple(shape) in MIXED_SLOW else 50)
        # a plain version runs up to ~300 torch ops a call (the wave bank's
        # per-wave loop), and the profiler's cost grows with the ops it
        # records: 10 calls, not 50
        p, _, p_how = device_ms(case.plain, iters=10)
        lib, _, lib_how = device_ms(library) if library else (None, None, None)
        b_ms, b_by = bound(case.nbytes, case.f32_ops, case.tensor_ops)
        timed_by = {"ms": k_how, "plain_ms": p_how, "library_ms": lib_how}
        log(f"[timing] {name} {shape}: kernel {k:.4f} ms, plain {p:.4f} ms, "
            f"library " + (f"{lib:.4f} ms" if lib is not None else "none")
            + f", bound {b_ms:.4f} ms ({b_by}: {case.nbytes / 1e6:.1f} MB, "
            f"{case.f32_ops / 1e6:.1f} Mflop f32, "
            f"{case.tensor_ops / 1e6:.1f} Mflop bf16), {b_ms / k:.3f} of it; "
            f"timed by {timed_by}")
        results.setdefault(name, (shape, k, p, lib, b_ms, b_by, timed_by))
        by_shape[name, tuple(shape)] = (k, lib, b_ms)

    # each redesigned row kernel beside its time before the redesign and
    # cuFFT at each shape: the two f32 direct kernels beside each other on
    # the same inputs, the others beside the f32 kernel with their store
    for name, before_ms in BEFORE_REDESIGN_MS.items():
        store = "natural" if "natural" in name else "transposed"
        for shape, before in before_ms.items():
            k, lib, b_ms = by_shape[name, shape]
            if name in ("fft_rows_transposed", "fft_rows_natural"):
                # the other f32 direct kernel on the same inputs: the
                # cluster store's radix-2 stages against the natural
                # store's radix-16 passes
                what = ("the radix-16 natural store" if store == "transposed"
                        else "the radix-2 cluster store")
                ref = device_ms(f32_pairs[shape][store == "transposed"])[0]
            elif name == "matrix_rows_transposed[bf16x3,split3]":
                # the f32 three-factor kernel on the same pass: bf16x3 is
                # worth having only where it is the cheaper of the two
                what = "the f32 three-factor kernel"
                ref = by_shape["matrix_rows_transposed[f32,split3]", shape][0]
            elif name == FUSED_NATURAL_BF16:
                # the ceiling of a bf16 kernel, the f32 fused natural kernel
                # at the same shape, and the bf16 natural row kernel at
                # [1, M, N], whose stages it runs
                f32 = next(by_shape[f, shape][0] for f in FUSED_NATURAL_F32
                           if (f, shape) in by_shape)
                rows = by_shape["matrix_rows_natural[bf16]",
                                (1, shape[0], shape[1])][0]
                log(f"[timing] {kind} ({smi}): {name} {list(shape)}: "
                    f"{k:.4f} ms (before the redesign {before:.4f}, PERF.md, "
                    f"not this run), the f32 fused natural kernel {f32:.4f}, "
                    f"the bf16 row kernel at [1, {shape[0]}, {shape[1]}] "
                    f"{rows:.4f}, bound {b_ms:.4f}; {before / k:.2f}x faster "
                    f"than before, {k / f32:.3f} of the f32 kernel, "
                    f"{b_ms / k:.3f} of the bound")
                continue
            elif name in FUSED_TRANSPOSED_F32:
                # beside the f32 fused natural kernel on the same inputs
                # (the same load and passes, another store) and, for C > 1
                # channels, beside C one-channel launches (one read of the
                # inputs against C)
                args, kw = fused_transposed_calls[name, shape]
                count = kw["ch_count"]
                nat = device_ms(lambda: fused.assemble_rowfft_natural(
                    *args, **kw))[0]
                ones = ""
                if count > 1:
                    one = sum(device_ms(
                        lambda ch=ch: fused.assemble_rowfft(
                            *args, **{**kw, "ch_start": ch, "ch_count": 1}))[0]
                        for ch in range(kw["ch_start"],
                                        kw["ch_start"] + count))
                    ones = (f", {count} one-channel launches {one:.4f} "
                            f"({k / one:.3f} of them)")
                log(f"[timing] {kind} ({smi}): {name} {list(shape)}: "
                    f"{k:.4f} ms (before the redesign {before:.4f}, PERF.md, "
                    f"not this run), the f32 fused natural kernel {nat:.4f} "
                    f"({k / nat:.3f} of it){ones}, bound {b_ms:.4f}; "
                    f"{before / k:.2f}x faster than before, "
                    f"{b_ms / k:.3f} of the bound")
                continue
            elif name in FUSED_NATURAL_F32:
                args, kw = fused_natural_calls[name, shape]
                count = kw["ch_count"]
                if count > 1:
                    # one launch of C channels reads the inputs once: C
                    # launches of one channel on the same inputs, each
                    # reading them
                    what = f"{count} one-channel launches"
                    ref = sum(device_ms(
                        lambda ch=ch: fused.assemble_rowfft_natural(
                            *args, **{**kw, "ch_start": ch, "ch_count": 1}))[0]
                        for ch in range(kw["ch_start"],
                                        kw["ch_start"] + count))
                else:
                    what = f"the radix-16 row kernel at [1, {shape[0]}, " \
                           f"{shape[1]}]"
                    ref = by_shape["fft_rows_natural",
                                   (1, shape[0], shape[1])][0]
                log(f"[timing] {kind} ({smi}): {name} {list(shape)}: "
                    f"{k:.4f} ms (before the redesign {before:.4f}, PERF.md, "
                    f"not this run), {what} {ref:.4f}, bound {b_ms:.4f}; "
                    f"{before / k:.2f}x faster than before, {k / ref:.3f} "
                    f"of {what}, {b_ms / k:.3f} of the bound")
                continue
            else:
                what = (f"Stockham f32 {store}"
                        + (" (cluster store)" if store == "transposed" else ""))
                ref = by_shape[f"fft_rows_{store}", shape][0]
            log(f"[timing] {kind} ({smi}): {name} {list(shape)}: {k:.4f} ms "
                f"(before the redesign {before:.4f}, PERF.md, not this run), "
                f"{what} {ref:.4f}, cuFFT {lib:.4f}, bound {b_ms:.4f}; "
                f"{before / k:.2f}x faster than before, {k / ref:.3f} of "
                f"{what}, {k / lib:.2f}x cuFFT")

    # the bf16 fused natural kernel at C = 5 (on no path): a block per
    # channel, so the inputs are read five times; beside the f32 kernel's
    # one read and five of its own one-channel launches
    shape = (4096, 4096, "ch 0-4", "per_channel")
    k, _, b_ms = by_shape[FUSED_NATURAL_BF16, shape]
    f32 = by_shape["fused_natural[per_channel]", shape][0]
    one = by_shape[FUSED_NATURAL_BF16, (4096, 4096, "ch 0")][0]
    log(f"[timing] {kind} ({smi}): {FUSED_NATURAL_BF16} {list(shape)}: "
        f"{k:.4f} ms, the f32 fused natural kernel (one read of the inputs) "
        f"{f32:.4f}, 5 x the bf16 ch 0 launch {5 * one:.4f}, bound "
        f"{b_ms:.4f}; {k / f32:.3f} of the f32 kernel")

    # the complex state's full 2-D transforms on the paths, [C, N, N] at
    # C = 5: the hand kernels' two passes (ifft2_planes_auto, with the
    # natural regime's transposing copies) beside cuFFT's torch.fft.ifft2
    # on the same values; bound: each pass reads and writes 16 B a point
    for tag, shape, precision in (("xvii", (5, 1024, 1024), "float32"),
                                  ("xxi", (5, 1024, 1024), "bfloat16"),
                                  ("xviii", (5, 4096, 4096), "float32")):
        re, im = plane(shape), plane(shape)
        z = torch.complex(re, im)
        hand, per_kernel, how = device_ms(
            lambda: planes.ifft2_planes_auto(re, im, True, precision))
        # the kernels alone (the whole call where the profiler recorded
        # none and CUDA events stood in)
        kernels_ms = sum(ms for key, ms in per_kernel.items()
                         if kernel_group(key) != "torch ops") or hand
        lib, _, lib_how = device_ms(lambda: torch.fft.ifft2(z, norm="forward"))
        b_ms, b_by = bound(32 * re.numel(), 2 * 5 * int(np.log2(shape[2]))
                           * re.numel())
        log(f"[timing] {kind} ({smi}): the 2-D transform of path ({tag}) "
            f"{list(shape)} at {precision}: the hand kernels' two passes "
            f"{kernels_ms:.4f} ms ({hand:.4f} with torch ops, {how}), cuFFT "
            f"torch.fft.ifft2 {lib:.4f} ms ({lib_how}), bound {b_ms:.4f} "
            f"({b_by}); {kernels_ms / lib:.2f}x cuFFT, {b_ms / kernels_ms:.3f} "
            f"of the bound")
        del re, im, z

    phase_done("5 timing, kernels")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(launches[name].values()),
         "launches_by_path": launches[name],
         "max_abs_err": errs[name], "shape": results[name][0],
         "ms": results[name][1], "plain_ms": results[name][2],
         "bound_ms": results[name][4], "bound_by": results[name][5],
         "library_ms": results[name][3], "timed_by": results[name][6],
         **({"mode": fused_mode(name)} if fused_mode(name) else {}),
         **({"f64_rel_err": f64_errs[name]} if name in f64_errs else {})}
        for name, (source, replaces) in KERNEL_INFO.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
