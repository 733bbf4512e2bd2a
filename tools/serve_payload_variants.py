#!/usr/bin/env python3
"""FrameServer.run's time a step against how a frame's payload is built.
Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 tools/serve_payload_variants.py

For chip_smoke.py's serving paths (lvi) 1024² and (lvii) 4096², with
native clients (native/stream_client.cpp, processes of their own, one at
full f32 and one at lod 4 float16, each reading every frame), it prints
run's ms/step by CUDA events and by the wall clock with the port's payload
build (serve.FrameServer._payload_from_pulled: the host planes copied once
into one buffer behind the meta line) and with the JAX package's
(tpu_ocean/serve.py:467-479: a bytes copy of each plane, a join, the meta
line concatenated: three copies of the frame), in turns port, JAX, JAX,
port; then cProfile's top functions by own time, µs a step, over one run
with the port's build (cProfile's own cost inflates each Python call).
"""

import cProfile
import json
import pstats
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from tpu_ocean_torch import _build, serve  # noqa: E402


def jax_form(self, pulled, meta, dtype, codec="none"):
    """tpu_ocean/serve.py:467-479's _payload_from_pulled on the port's
    host planes."""
    wire = "<f2" if dtype == "float16" else "<f4"
    body = b"".join(
        np.ascontiguousarray(pulled[name].numpy(), dtype=wire).tobytes()
        for name in self.fields)
    if codec == "zlib":
        return serve._LazyZlibPayload(meta, body)
    return (json.dumps(meta) + "\n").encode() + body


def profiled_run(server, steps):
    """chip_smoke.timed_run under cProfile; prints the top functions."""
    prof = cProfile.Profile()
    prof.enable()
    out = plain_run(server, steps)
    prof.disable()
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:10]
    print(f"[profile] {server.sim.cfg.resolution}² run({steps}), µs a step "
          f"by own time (cProfile): " + "; ".join(
              f"{fn[2]} ({Path(fn[0]).name}:{fn[1]}) "
              f"{st[2] * 1e6 / steps:.1f}" for fn, st in top), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serve_payload_variants: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    port_form = serve.FrameServer._payload_from_pulled
    forms = {"port": port_form, "jax": jax_form}
    for path in chip_smoke.SERVE_PATHS:
        readings = []
        for name in ("port", "jax", "jax", "port"):
            serve.FrameServer._payload_from_pulled = forms[name]
            try:
                ms, wall, tiers = chip_smoke.serve_native_ms(path)
            finally:
                serve.FrameServer._payload_from_pulled = port_form
            readings.append((name, ms, wall))
            print(f"[variant] {smi}: path ({path.tag}) {path.size}², "
                  f"{path.steps} steps, native clients {tiers}, payload "
                  f"build {name}: {ms:.4f} ms/step by CUDA events, "
                  f"{wall:.4f} by the wall clock", flush=True)
        for name in forms:
            got = [ms for n, ms, _ in readings if n == name]
            print(f"[variant] path ({path.tag}) {name}: mean {np.mean(got):.4f}"
                  f" ms/step over {len(got)} runs", flush=True)
        chip_smoke.timed_run = profiled_run
        try:
            chip_smoke.serve_native_ms(path)
        finally:
            chip_smoke.timed_run = plain_run


plain_run = chip_smoke.timed_run

if __name__ == "__main__":
    main()
