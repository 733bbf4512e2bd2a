"""The serving slice on the card. Every test here needs an NVIDIA GPU with
nvcc: each decides inside the ``cuda`` fixture whether one exists and skips
with a reason when not. This file imports no jax; run it with

    python -m pytest --noconftest tests/test_torch_serve_cuda.py -m cuda -q

- chip_smoke.py path (lvi) at N = 256 (chip_smoke.serve_path): a
  FrameServer on OCEAN_DEMO's production switches, 30 steps, a full f32
  client, an lod 4 f16 zlib client and a stride-2 client with a camera
  distance; every frame bit-equal to an offline replay from the same seed
  on the card (pooled planes to the replay's pooling), f32 pooled planes
  within 1e-6·max of decimate_plane; launches exact: 5 row-DFT and 1
  fields-kernel launch a step, 3 row-DFT launches a frame for velocity.
- The pull: pinned host buffers, copied on a stream of the server's own,
  the frame's bytes equal to the planes pooled on the card and pulled
  synchronously.
- ``python -m tpu_ocean_torch.stream_client`` on the card: 3 frames, a PNG,
  exit 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_ocean_torch import OCEAN_DEMO, Simulation
from tpu_ocean_torch.serve import FrameServer, _pool_on_device

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke.launch_wrappers()


def test_serving_path_lvi_at_256(cuda):
    path = chip_smoke.SERVE_PATHS[0]._replace(size=256)
    out = chip_smoke.serve_path(path, cuda)
    assert out["counts"] == {k: v for k, v in out["expected"].items() if v}
    assert out["expected"] == {"fft_rows_transposed": 30 * 8,
                               "fields_stencil": 30}
    assert {tag: c["frames"] for tag, c in out["checks"].items()} == {
        "full": 30, "lod4": 30, "far": 15}
    assert out["pulled"] == {"1/float32": 256 * 256 * 6 * 4,
                             "4/float16": 64 * 64 * 6 * 2,
                             "2/float32": 128 * 128 * 6 * 4}


def test_pull_is_pinned_and_on_a_stream_of_its_own(cuda):
    sim = Simulation(OCEAN_DEMO.replace(resolution=256), fft_backend="pallas",
                     generator=torch.Generator().manual_seed(3),
                     **chip_smoke.SLICE)
    with FrameServer(sim, fields=("height", "normal")) as server:
        fields = sim.step()
        payload = server.frame_payload(fields, 2, "float16")
        stream = server._copy_stream
        assert stream is not None and stream != torch.cuda.current_stream()
        bufs = server._host_planes[(2, "float16")]
        assert all(b.is_pinned() and b.dtype == torch.float16
                   for b in bufs.values())
    body = b"".join(
        _pool_on_device(2, name == "normal", "float16")(
            getattr(fields, name)).cpu().numpy().astype("<f2").tobytes()
        for name in ("height", "normal"))
    assert payload.endswith(b"\n" + body)
    assert payload.startswith(b'{"step": 1, "t": ')


def test_stream_client_module_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    out = tmp_path / "stream.png"
    r = subprocess.run([sys.executable, "-m", "tpu_ocean_torch.stream_client",
                        "--frames", "3", "--res", "256", "--out", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-1000:]
    assert r.stderr.count("step ") == 3
    assert os.path.getsize(out) > 300
    assert np.isfinite(float(r.stderr.split("h in [")[1].split(",")[0]))
