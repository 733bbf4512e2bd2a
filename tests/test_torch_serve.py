"""Frame serving in the port (tpu_ocean_torch/serve.py) on the CPU.

- Every test of tests/test_serve.py but the two that stream a sharded
  Simulation (ROADMAP item 14b), with the same assertions, on the port's
  Simulation, CascadeSimulation and PondSimulation with ``device="cpu"``:
  the wire bit-equal to the port's offline trajectory at N = 64, the drop
  policy, LOD, stride, f16, zlib, malformed requests, the native C++ client
  (built into build/ by ``native.stream_client()``, not by make).
- The pipeline one frame deep: no frame mislabelled, the last frame the
  final state, a frame in flight at stop() dropped; the production switches
  (path (lvi) of chip_smoke.py at N = 64) against their offline replay.
- Across packages: the JAX client reads the port's server and the port's
  client the JAX server, with headers equal byte for byte for the same
  config, fields and request; on one shared h0 (the JAX Simulation's,
  through convert.state_from_numpy) the decoded planes of both streams at
  full f32, lod 2, f16 and zlib within tests/test_torch_complex_backends.py's
  assert_fields_match (f16: after one f16 ulp a texel); the LOD rules and
  decimate_plane equal to JAX's on a grid of inputs; the device pooling
  within 1e-6·max of JAX's at f32 and one f16 ulp on the f16 wire.
- ``python -m tpu_ocean_torch.stream_client --device cpu`` in a process of
  its own, and the two modules import neither jax nor tpu_ocean.

Every wait is bounded: clients subscribe through ``_wait_for`` (a sleep
loop with a deadline), threads join with a timeout."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ocean import config as jcfg, serve as jserve
from tpu_ocean.runtime import Simulation as JaxSimulation
from tpu_ocean_torch import (OCEAN_DEMO, CascadeSimulation, OceanConfig,
                             PondConfig, PondSimulation, PondSolver,
                             Simulation, default_cascade, native,
                             state_from_numpy)
from tpu_ocean_torch.serve import (PROTO, FrameServer, _clamp_divisor,
                                   _pool_on_device, decimate_plane,
                                   lod_divisor_for_distance, stream_frames)
from tpu_ocean_torch.solver import OceanFields
from tests.test_torch_complex_backends import assert_fields_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0), amplitude=0.5,
                  spectrum_layout="fft", normals_mode="stencil")
JCFG = jcfg.OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0),
                        amplitude=0.5, spectrum_layout="fft",
                        normals_mode="stencil")
#: OCEAN_DEMO's production switches, chip_smoke.py path (lvi)
PRODUCTION = dict(fft_backend="pallas", real_state=True, pack_channels=True,
                  half_spectrum=True, pallas_fields=True)
#: the trajectory tests assert exact steps: a queue deeper than their
#: frames, so a reader slowed by the machine's load drops none
DEEP = 16
TIMEOUT = 60.0


def _sim(**kw):
    return Simulation(CFG, fft_backend="matmul", device="cpu", **kw)


def _wait_for(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _clients(server, clients, reader=stream_frames):
    """Start one reader thread a client ({tag: stream_frames keywords}) and
    wait until every one has subscribed (or ended). Returns (threads,
    frames by tag, errors)."""
    host, port = server.address
    got, errs = {}, []

    def client(tag, kw):
        try:
            got[tag] = list(reader(host, port, **kw))
        except Exception as e:           # surfaced in the main thread
            errs.append((tag, e))

    # clients that read a header and left stay registered until a send
    # to them fails: count the new ones on top
    before = server.client_count
    threads = [threading.Thread(target=client, args=item, daemon=True)
               for item in clients.items()]
    for t in threads:
        t.start()
    _wait_for(lambda: server.client_count >= before + len(threads)
              or not all(t.is_alive() for t in threads), "the clients")
    return threads, got, errs


def _join(threads, errs):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client still reads"
    assert not errs, errs


def _serve(server, steps, clients, stop=False, reader=stream_frames):
    """Subscribe ``clients``, run ``steps``, optionally stop, join; the
    frames by tag."""
    threads, got, errs = _clients(server, clients, reader)
    server.run(steps=steps)
    if stop:
        server.stop()                    # EOF so max_frames never blocks
    _join(threads, errs)
    return got


def _host(tensor):
    return tensor.detach().cpu().numpy()


# ------------------------------------------------ tests/test_serve.py, ported

def test_stream_matches_offline_trajectory():
    fields = ("height", "normal", "foam")
    with FrameServer(_sim(), fields=fields, queue_frames=DEEP) as server:
        frames = _serve(server, 5, {"c": dict(max_frames=3)})["c"]

    assert [m["step"] for m, _ in frames] == [1, 2, 3]
    assert frames[0][1]["height"].shape == (64, 64)
    assert frames[0][1]["normal"].shape == (64, 64, 3)

    # the wire carries exactly the offline trajectory (same seed, same math)
    offline = _sim()
    for meta, planes in frames:
        out = offline.step()
        assert meta["t"] == pytest.approx(meta["step"] * offline.dt)
        for name in fields:
            np.testing.assert_array_equal(planes[name],
                                          _host(getattr(out, name)))


def test_slow_client_drops_frames_not_blocks():
    with FrameServer(_sim(), fields=("height", "foam"),
                     queue_frames=1) as server:
        host, port = server.address
        # subscribe but never read, with a tiny receive window so the
        # kernel cannot absorb the stream: the 1-frame queue overflows →
        # drops, never backpressure on the solver loop
        lazy = socket.socket()
        lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        lazy.connect((host, port))
        try:
            _wait_for(lambda: server.client_count > 0, "the lazy client")
            server.run(steps=64)         # must complete promptly
            assert server.dropped_frames > 0
        finally:
            lazy.close()


def test_serves_cascade_simulation():
    """CascadeSimulation satisfies the same serving contract: the combined
    surface streams like a single patch, and the advertised length is the
    display length (the longest band), not band 0's."""
    def cascade():
        return CascadeSimulation(default_cascade(
            n=32, lengths=(17.0, 130.0, 1000.0)), fft_backend="reference",
            device="cpu")

    with FrameServer(cascade(), fields=("height", "foam")) as server:
        frames = _serve(server, 3, {"c": dict(max_frames=2)})["c"]
    assert len(frames) == 2
    assert frames[0][1]["height"].shape == (32, 32)
    assert np.isfinite(frames[0][1]["height"]).all()

    # header check on the raw wire: the planes span 1000 m, not 17 m
    with FrameServer(cascade(), fields=("height",)) as srv:
        with socket.create_connection(srv.address) as conn:
            header = json.loads(conn.makefile("rb").readline())
    assert header["length"] == 1000.0


def test_rejects_unknown_field_and_foreign_stream():
    with pytest.raises(ValueError, match="stream"):
        FrameServer(_sim(), fields=("height", "vorticity"))

    imposter = socket.create_server(("127.0.0.1", 0))
    host, port = imposter.getsockname()

    def fake():
        conn, _ = imposter.accept()
        conn.sendall(json.dumps({"proto": "nope/9"}).encode() + b"\n")
        conn.close()

    t = threading.Thread(target=fake, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="tpu-ocean"):
        list(stream_frames(host, port, max_frames=1))
    imposter.close()
    t.join(timeout=TIMEOUT)
    assert PROTO == "tpu-ocean/1"


def _native_client(server, steps, args):
    """Run the native client (built into build/) against ``server``."""
    host, port = server.address
    proc = subprocess.Popen([str(native.stream_client()), host, str(port),
                             *args], stdout=subprocess.PIPE, text=True)
    try:
        _wait_for(lambda: server.client_count > 0 or proc.poll() is not None,
                  "the native client")
        server.run(steps=steps)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out


def test_native_cpp_client_consumes_stream():
    """The dependency-free C++ client (native/stream_client.cpp, built by
    the port into build/) reads the header and N intact frames."""
    with FrameServer(_sim(), fields=("height", "normal", "foam"),
                     queue_frames=DEEP) as server:
        rc, out = _native_client(server, 5, ["3"])
    assert rc == 0, out[-800:]
    assert "received 3/3 frames" in out
    assert out.count("height in [") == 3
    assert native.stream_client().parent.parent == native.BUILD_ROOT


def test_streams_computed_velocity_plane():
    """'velocity' is a computed wire field (solver.velocity): the streamed
    plane equals the solver's analytic ∂h/∂t at the same state."""
    with FrameServer(_sim(), fields=("height", "velocity"),
                     queue_frames=DEEP) as server:
        frames = _serve(server, 3, {"c": dict(max_frames=2)})["c"]
    assert frames[-1][1]["velocity"].shape == (64, 64)
    assert np.isfinite(frames[-1][1]["velocity"]).all()
    offline = _sim()
    for meta, planes in frames:
        offline.step()
        want = _host(offline.solver.velocity(offline.state))
        np.testing.assert_array_equal(planes["velocity"], want)


def test_lod_divisor_for_distance_rule():
    # at/below the reference distance: full grid
    assert lod_divisor_for_distance(50.0, 64.0, 64) == 1
    assert lod_divisor_for_distance(100.0, 64.0, 64) == 1
    # each doubling halves the served resolution
    assert lod_divisor_for_distance(200.0, 64.0, 64) == 2
    assert lod_divisor_for_distance(400.0, 64.0, 64) == 4
    # capped, and clamped so the served plane keeps >= 8 texels
    assert lod_divisor_for_distance(1e6, 64.0, 64) == 8
    assert lod_divisor_for_distance(1e6, 64.0, 16) == 2
    # non-dividing divisors fall back to the next dividing power of two
    assert lod_divisor_for_distance(400.0, 64.0, 24) == 2


def test_decimate_plane_pools_and_renormalizes():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = decimate_plane(x, 4, "height")
    assert y.shape == (4, 4)
    np.testing.assert_allclose(y[0, 0], x[:4, :4].mean(), rtol=1e-6)
    nrm = rng.normal(size=(16, 16, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    yn = decimate_plane(nrm, 2, "normal")
    assert yn.shape == (8, 8, 3)
    np.testing.assert_allclose(np.linalg.norm(yn, axis=-1), 1.0, atol=1e-5)


def test_client_lod_request_serves_decimated_planes():
    """A client requesting lod=2 receives (N/2)-planes equal to the
    mean-pooled full planes of the same trajectory."""
    fields = ("height", "normal", "foam")
    with FrameServer(_sim(), fields=fields, queue_frames=DEEP) as server:
        frames = _serve(server, 4, {"c": dict(max_frames=2, lod=2)})["c"]

    assert frames[0][1]["height"].shape == (32, 32)
    assert frames[0][1]["normal"].shape == (32, 32, 3)
    offline = _sim()
    for meta, planes in frames:
        out = offline.step()
        for name in fields:
            want = decimate_plane(_host(getattr(out, name)), 2, name)
            np.testing.assert_allclose(planes[name], want, atol=1e-6)


def test_mixed_lod_clients_each_get_their_resolution():
    """Two concurrent clients at different divisors: payloads are built per
    divisor and routed by client; camera_distance picks the divisor on the
    server."""
    with FrameServer(_sim(), fields=("height",),
                     queue_frames=DEEP) as server:
        got = _serve(server, 5, {"full": dict(max_frames=2),
                                 "far": dict(max_frames=2,
                                             camera_distance=400.0)})

    assert got["full"][0][1]["height"].shape == (64, 64)
    assert got["far"][0][1]["height"].shape == (16, 16)   # 400m → divisor 4
    # same trajectory, coarser sampling: pooled full == far at shared steps
    full_by_step = {m["step"]: p["height"] for m, p in got["full"]}
    for meta, planes in got["far"]:
        if meta["step"] in full_by_step:
            want = decimate_plane(full_by_step[meta["step"]], 4, "height")
            # the device pooling sums in another order than numpy
            np.testing.assert_allclose(planes["height"], want,
                                       atol=1e-6 * max(np.abs(want).max(),
                                                       1.0))


def test_legacy_silent_client_gets_full_resolution():
    """A client that sends nothing still receives the full-resolution
    stream after the negotiation window."""
    with FrameServer(_sim(), fields=("height",)) as server:
        sock = socket.create_connection(server.address, timeout=TIMEOUT)
        try:
            header = json.loads(sock.makefile("rb").readline())
            assert header["proto"] == PROTO
            assert header["resolution"] == 64
            assert header["lod"] == 1
            assert header["full_resolution"] == 64
        finally:
            sock.close()


def test_frame_stride_temporal_lod():
    """{"frame_stride": 2}: the client receives every 2nd broadcast frame
    while a full-rate client sees them all."""
    with FrameServer(_sim(), fields=("height",),
                     queue_frames=DEEP) as server:
        got = _serve(server, 8, {"full": dict(max_frames=3),
                                 "slow": dict(max_frames=3, frame_stride=2)},
                     stop=True)

    full_steps = [m["step"] for m, _ in got["full"]]
    slow_steps = [m["step"] for m, _ in got["slow"]]
    assert full_steps == [1, 2, 3]
    # every 2nd broadcast since subscription: consecutive gaps of 2
    assert len(slow_steps) == 3
    assert all(b - a == 2 for a, b in zip(slow_steps, slow_steps[1:])), \
        slow_steps


@pytest.mark.parametrize("evil,want_lod", [
    (b"5\n", 1),                                   # non-dict JSON
    (b'{"lod": "huge"}\n', 1),                     # non-numeric lod
    (b'{"camera_distance": "far"}\n', 1),          # non-numeric distance
    (b'{"lod": null}\n', 1),
    (b'[1, 2]\n', 1),
    # json parses 1e999 as inf: +inf clamps to the coarsest divisor, -inf
    # and an inf stride to the defaults
    (b'{"camera_distance": 1e999}\n', 8),
    (b'{"lod": 1e999}\n', 8),
    (b'{"frame_stride": 1e999}\n', 1),
    (b'{"camera_distance": -1e999}\n', 1),
])
def test_malformed_lod_request_clamps_and_server_survives(evil, want_lod):
    """A malformed request clamps for that client and does not kill the
    accept path: a second, well-formed client connects and streams."""
    with FrameServer(_sim(), fields=("height",)) as server:
        with socket.create_connection(server.address,
                                      timeout=TIMEOUT) as bad:
            bad.sendall(evil)
            header = json.loads(bad.makefile("rb").readline())
            assert header["proto"] == PROTO
            assert header["lod"] == want_lod
            assert header["frame_stride"] == 1
        frames = _serve(server, 2, {"c": dict(max_frames=1)})["c"]
    assert len(frames) == 1


def test_concurrent_connects_admit_in_parallel():
    """Negotiation runs per client: a silent client that waits out the
    0.25 s window does not delay the admission of others."""
    with FrameServer(_sim(), fields=("height",)) as server:
        silent = socket.create_connection(server.address)  # says nothing
        try:
            t0 = time.monotonic()
            fast = []
            for _ in range(3):
                s = socket.create_connection(server.address, timeout=TIMEOUT)
                s.sendall(b"{}\n")       # ends negotiation at once
                json.loads(s.makefile("rb").readline())
                fast.append(s)
            elapsed = time.monotonic() - t0
            # serialized behind the silent window this would be >= 0.25 s
            assert elapsed < 0.2, elapsed
            for s in fast:
                s.close()
        finally:
            silent.close()


def test_serves_pond_family_with_velocity():
    """PondSimulation streams through the same wire: height/normal aliases
    and the computed velocity plane (gerstner_velocity)."""
    sim = PondSimulation(PondConfig(resolution=64), dt=1 / 60, device="cpu")
    with FrameServer(sim, fields=("height", "normal", "velocity"),
                     queue_frames=DEEP) as server:
        frames = _serve(server, 3, {"c": dict(max_frames=2)})["c"]

    assert frames[0][1]["height"].shape == (64, 64)
    assert frames[0][1]["normal"].shape == (64, 64, 3)
    v = frames[-1][1]["velocity"]
    assert v.shape == (64, 64) and np.isfinite(v).all() and np.abs(v).max() > 0
    # velocity equals the solver's own closed form at the frame's clock
    offline = PondSolver(PondConfig(resolution=64), device="cpu")
    for meta, planes in frames:
        want = _host(offline.velocity(meta["t"]))
        np.testing.assert_allclose(planes["velocity"], want, atol=1e-6)
        np.testing.assert_allclose(
            planes["height"], _host(offline.fields(meta["t"]).offset_y),
            atol=1e-6)


def test_one_field_compute_and_pooled_pulls_with_mixed_lod_clients():
    """The field compute (_device_planes, the velocity derivation included)
    runs at most once a frame however many LOD tiers are subscribed, and
    each tier's pull carries only its pooled (N/d)² planes."""
    with FrameServer(_sim(), fields=("height",)) as server:
        calls = {"n": 0}
        pulled_shapes = []
        orig_dev = server._device_planes
        orig_pull = server._pulled_planes

        def counting(fields):
            calls["n"] += 1
            return orig_dev(fields)

        def recording(dev, divisor, dtype):
            out = orig_pull(dev, divisor, dtype)
            pulled_shapes.append((divisor, tuple(out["height"].shape)))
            return out

        server._device_planes = counting
        server._pulled_planes = recording
        steps = 4
        got = _serve(server, steps, {f"c{d}": dict(max_frames=2, lod=d)
                                     for d in (1, 2, 4)}, stop=True)
    assert calls["n"] <= steps           # once per frame, NOT per tier
    n = CFG.resolution
    for divisor, shape in pulled_shapes:
        assert shape == (n // divisor, n // divisor)   # pooled BEFORE pull
    assert all(len(v) == 2 for v in got.values())


def test_f16_wire_halves_bytes_and_roundtrips():
    """A {"dtype": "float16"} client gets half-size planes, equal to the
    f32 stream within f16 precision; an f32 client on the same server is
    untouched."""
    with FrameServer(_sim(), fields=("height", "normal")) as server:
        got = _serve(server, 4, {"f16": dict(max_frames=2, dtype="float16"),
                                 "f32": dict(max_frames=2)}, stop=True)
    assert len(got["f16"]) == 2 and len(got["f32"]) == 2
    by_step = {m["step"]: p for m, p in got["f32"]}
    for meta, planes in got["f16"]:
        want = by_step.get(meta["step"])
        if want is None:
            continue
        scale = max(np.abs(want["height"]).max(), 1e-6)
        # f16 has a 10-bit mantissa: ~1e-3 relative
        np.testing.assert_allclose(planes["height"], want["height"],
                                   atol=2e-3 * scale)
        assert planes["height"].dtype == np.float32   # client upcasts
    # wire accounting: the f16 bytes per frame are half
    assert server._frame_bytes_for(1, "float16") * 2 == \
        server._frame_bytes_for(1, "float32")


def test_solo_strided_client_still_advances():
    """With only a strided client, the broadcast still runs on its
    off-phase frames (it advances the stride counter)."""
    with FrameServer(_sim(), fields=("height",),
                     queue_frames=DEEP) as server:
        got = _serve(server, 6, {"c": dict(max_frames=2, lod=2,
                                           frame_stride=2)}, stop=True)["c"]
    assert [m["step"] for m, _ in got] == [1, 3]
    assert got[0][1]["height"].shape == (32, 32)   # lod composes with stride


def test_zlib_wire_compresses_and_roundtrips():
    """A {"codec": "zlib"} client receives compressed frames (framed by the
    meta line's nbytes) that decode to the planes the raw client sees;
    smooth ocean planes compress."""
    sim = _sim()
    with FrameServer(sim, fields=("height", "foam"),
                     queue_frames=DEEP) as server:
        got = _serve(server, 4, {"zip": dict(max_frames=2, codec="zlib"),
                                 "raw": dict(max_frames=2)}, stop=True)
        # frame_payload really compresses a field frame
        f = sim.step()
        raw = server.frame_payload(f, 1, "float32", "none")
        zipped = server.frame_payload(f, 1, "float32", "zlib")
        assert len(zipped) < len(raw)
    by_step = {m["step"]: p for m, p in got["raw"]}
    matched = 0
    for meta, planes in got["zip"]:
        want = by_step.get(meta["step"])
        if want is None:
            continue
        np.testing.assert_array_equal(planes["height"], want["height"])
        np.testing.assert_array_equal(planes["foam"], want["foam"])
        matched += 1
    assert matched >= 1


def test_native_cpp_client_f16_lod_wire():
    """The C++ client negotiates lod=2 + float16 planes, widened on the
    host."""
    with FrameServer(_sim(), fields=("height", "foam"),
                     queue_frames=DEEP) as server:
        rc, out = _native_client(server, 4, ["2", "2", "float16"])
    assert rc == 0, out[-800:]
    assert "received 2/2 frames" in out
    assert "f16 wire" in out
    assert "32x32" in out              # lod=2 on the 64 grid


# ------------------------------------------------ the pipeline one frame deep

class _CountingSim:
    """A Simulation whose step() records the step count it starts from,
    and calls ``hook`` after a step."""

    def __init__(self, sim, hook=None):
        self._sim, self.hook, self.started = sim, hook, []

    def __getattr__(self, name):
        return getattr(self._sim, name)

    def step(self):
        self.started.append(self._sim.step_count)
        out = self._sim.step()
        if self.hook is not None:
            self.hook(self._sim.step_count)
        return out


def test_pipeline_labels_each_frame_and_sends_the_final_state():
    """Frame k is sent after step k + 1 has run, labelled k, and run(steps)
    ends with the frame of the final state."""
    sim = _CountingSim(_sim())
    fields = ("height", "velocity")
    with FrameServer(sim, fields=fields, queue_frames=DEEP) as server:
        frames = _serve(server, 5, {"c": dict(max_frames=5)})["c"]
        final = [_host(sim.fields.height),
                 _host(sim.solver.velocity(sim.state))]
    assert sim.started == [0, 1, 2, 3, 4]
    assert [m["step"] for m, _ in frames] == [1, 2, 3, 4, 5]
    assert [m["t"] for m, _ in frames] == [k * sim.dt for k in range(1, 6)]
    np.testing.assert_array_equal(frames[-1][1]["height"], final[0])
    np.testing.assert_array_equal(frames[-1][1]["velocity"], final[1])


def test_stop_drops_the_frame_in_flight():
    """stop() while step k + 1 runs: frame k, then in flight, is not sent,
    and run() returns without error."""
    holder = {}

    def hook(k):
        if k == 3:
            holder["server"].stop()

    sim = _CountingSim(_sim(), hook)
    with FrameServer(sim, fields=("height",), queue_frames=DEEP) as server:
        holder["server"] = server
        frames = _serve(server, 10, {"c": dict()})["c"]
    assert sim.started == [0, 1, 2]
    assert [m["step"] for m, _ in frames] == [1]


def test_production_switches_stream_the_offline_trajectory():
    """chip_smoke.py path (lvi) at N = 64 on the CPU: OCEAN_DEMO's
    production switches served to a full-resolution f32 client (four
    planes and velocity), an lod 4 f16 zlib client and a stride-2 client
    with a camera distance; every frame against an offline replay of the
    same seed: full planes bit-equal, pooled ones bit-equal to the port's
    pooling of the replay's fields and within 1e-6·max of decimate_plane."""
    cfg = OCEAN_DEMO.replace(resolution=64, length=64.0)
    fields = ("height", "normal", "foam", "velocity")

    def sim():
        return Simulation(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7),
                          **PRODUCTION)

    clients = {"full": dict(max_frames=6),
               "lod4": dict(max_frames=6, lod=4, dtype="float16",
                            codec="zlib"),
               "far": dict(max_frames=3, frame_stride=2,
                           camera_distance=250.0)}
    with FrameServer(sim(), fields=fields, queue_frames=DEEP) as server:
        got = _serve(server, 6, clients)
    offline, replay = sim(), {}
    for _ in range(6):
        out = offline.step()
        replay[offline.step_count] = {
            "height": out.height, "normal": out.normal, "foam": out.foam,
            "velocity": offline.solver.velocity(offline.state)}
    assert [m["step"] for m, _ in got["full"]] == [1, 2, 3, 4, 5, 6]
    assert [m["step"] for m, _ in got["lod4"]] == [1, 2, 3, 4, 5, 6]
    assert [m["step"] for m, _ in got["far"]] == [1, 3, 5]
    for tag, divisor, dtype in (("full", 1, "float32"),
                                ("lod4", 4, "float16"),
                                ("far", 2, "float32")):
        for meta, planes in got[tag]:
            for name in fields:
                x = replay[meta["step"]][name]
                pooled = _pool_on_device(divisor, name == "normal", dtype)(x)
                np.testing.assert_array_equal(
                    planes[name], _host(pooled).astype(np.float32))
                if dtype == "float32":
                    _assert_pooled(planes[name],
                                   decimate_plane(_host(x), divisor, name),
                                   _host(x), divisor, name)


# ------------------------------------------------ across packages

#: requests of the header and stream tests
REQUESTS = {"full": {},
            "lod2_f16_zlib": dict(lod=2, dtype="float16", codec="zlib"),
            "camera_stride": dict(camera_distance=400.0, frame_stride=2)}


def _assert_pooled(got, want, full, divisor, name):
    """A plane pooled on the device against decimate_plane of its full
    plane: within 1e-6·max (the means sum in other orders); a normal
    within 1e-6 over the length of its block's mean, which the
    renormalization divides by."""
    tol = 1e-6 * np.abs(want).max()
    if name == "normal" and divisor > 1:
        m = full.shape[0] // divisor
        mean = full.astype(np.float64).reshape(
            m, divisor, m, divisor, 3).mean(axis=(1, 3))
        tol = tol / np.linalg.norm(mean, axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"{name}: {(err / tol).max():.2f} of the band"


def _jax_sim():
    """The JAX Simulation of CFG, its init finished: no XLA work then runs
    beside the port's steps, whose CPU products (MKL) may split their sums
    otherwise and move a plane by ~1e-4 of its largest value."""
    sim = JaxSimulation(JCFG, fft_backend="matmul")
    jax.block_until_ready(sim.state)
    return sim


def _assert_within_f16_ulp(got, want):
    """``got`` within one f16 ulp of ``want`` (f16 values) a texel."""
    want = np.asarray(want, np.float16)
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    err = np.abs(np.asarray(got, np.float32) - want.astype(np.float32))
    assert (err <= ulp).all(), f"{(err / ulp).max():.2f} f16 ulps"


def _raw_header(server, request):
    with socket.create_connection(server.address, timeout=TIMEOUT) as conn:
        conn.sendall((json.dumps(request) + "\n").encode())
        return conn.makefile("rb").readline()


@pytest.mark.parametrize("request_name", REQUESTS)
@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_clients_read_the_other_packages_server(direction, request_name):
    """Each package's stream_frames reads the other's FrameServer, frames
    bit-equal to the serving package's offline trajectory; the headers of
    the two servers are equal byte for byte for the same config, fields and
    request."""
    fields = ("height", "normal", "foam")
    kw = REQUESTS[request_name]
    jsim = _jax_sim()
    port_server = FrameServer(_sim(), fields=fields, queue_frames=DEEP)
    jax_server = jserve.FrameServer(jsim, fields=fields, queue_frames=DEEP)
    with port_server, jax_server:
        header = _raw_header(port_server, kw)
        assert header == _raw_header(jax_server, kw)
        assert list(json.loads(header)) == [
            "proto", "resolution", "length", "lod", "frame_stride",
            "full_resolution", "fields", "dtype", "codec"]
        if direction == "jax_client_port_server":
            server, reader, offline = (port_server, jserve.stream_frames,
                                       _sim())
        else:
            server, reader, offline = jax_server, stream_frames, _jax_sim()
        frames = _serve(server, 5, {"c": dict(max_frames=2, **kw)},
                        reader=reader)["c"]
    divisor = json.loads(header)["lod"]
    stride = kw.get("frame_stride", 1)
    assert [m["step"] for m, _ in frames] == [1, 1 + stride]
    trajectory = {}
    for _ in range(1 + stride):
        out = offline.step()
        trajectory[offline.step_count] = out
    for meta, planes in frames:
        out = trajectory[meta["step"]]
        for name in fields:
            x = getattr(out, name)
            x = _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
            want = decimate_plane(x, divisor, name)
            if kw.get("dtype") == "float16":
                # one f16 ulp: the f32 means sum in other orders
                _assert_within_f16_ulp(planes[name], want)
            elif divisor == 1:
                np.testing.assert_array_equal(planes[name], want)
            else:
                _assert_pooled(planes[name], want, x, divisor, name)


#: the wire tiers held across packages on one shared h0
TIERS = {"f32": {}, "lod2": dict(lod=2), "f16": dict(dtype="float16"),
         "zlib": dict(codec="zlib")}
WIRE_FIELDS = OceanFields._fields + ("velocity",)


@pytest.fixture(scope="module")
def shared_h0_streams():
    """Both packages' servers on the JAX Simulation's h0, four clients each
    (one a tier), 2 frames."""
    jsim = _jax_sim()
    tsim = _sim()
    tsim.state = state_from_numpy(jsim.state, "cpu")
    out = {}
    for pkg, server in (("jax", jserve.FrameServer(jsim, fields=WIRE_FIELDS,
                                                   queue_frames=DEEP)),
                        ("port", FrameServer(tsim, fields=WIRE_FIELDS,
                                             queue_frames=DEEP))):
        with server:
            out[pkg] = _serve(server, 3, {tag: dict(max_frames=2, **kw)
                                          for tag, kw in TIERS.items()})
    return out


def _within_one_f16_ulp(got, want):
    """``got`` moved toward ``want`` by up to one f16 ulp a texel: what
    remains is the difference beyond the f16 wire's rounding."""
    ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    d = got - want
    return want + np.sign(d) * np.maximum(np.abs(d) - ulp, 0)


@pytest.mark.parametrize("tier", TIERS)
def test_shared_h0_streams_agree_across_packages(shared_h0_streams, tier):
    """The decoded planes of both streams, frame by frame, within
    assert_fields_match's bands (the lod tier at its N/2 grid; the f16
    tier after one f16 ulp a texel); velocity within 1e-5·max."""
    port, ref = shared_h0_streams["port"][tier], shared_h0_streams["jax"][tier]
    # a zlib frame's nbytes is its compressed size, which any changed bit
    # moves
    assert ([{k: v for k, v in m.items() if k != "nbytes"} for m, _ in port]
            == [{k: v for k, v in m.items() if k != "nbytes"}
                for m, _ in ref])
    assert [m["step"] for m, _ in port] == [1, 2]
    divisor = TIERS[tier].get("lod", 1)
    cfg = CFG.replace(resolution=CFG.resolution // divisor)
    for (_, got), (_, want) in zip(port, ref):
        assert got["height"].shape == (cfg.resolution, cfg.resolution)
        if tier == "f16":
            got = {k: _within_one_f16_ulp(got[k], want[k]) for k in got}
        assert_fields_match(
            OceanFields(*(torch.from_numpy(got[k])
                          for k in OceanFields._fields)),
            OceanFields(*(want[k] for k in OceanFields._fields)), cfg)
        np.testing.assert_allclose(
            got["velocity"], want["velocity"], rtol=0,
            atol=1e-5 * np.abs(want["velocity"]).max())


_DISTANCES = [-np.inf, -1.0, 0.0, 50.0, 99.9, 100.0, 100.1, 150.0, 199.0,
              200.0, 399.0, 400.0, 800.0, 1e4, 1e6, np.inf, np.nan]
_RESOLUTIONS = [8, 16, 24, 32, 48, 64, 96, 106, 1024, 1536]
_MAX_DIVISORS = [1, 2, 4, 8, 16]


def test_lod_divisor_for_distance_equals_jax_on_a_grid():
    for d in _DISTANCES:
        for n in _RESOLUTIONS:
            for m in _MAX_DIVISORS:
                for ref in (1.0, 100.0):
                    args = (d, 64.0, n, ref, m)
                    assert (lod_divisor_for_distance(*args)
                            == jserve.lod_divisor_for_distance(*args)), args


def test_clamp_divisor_equals_jax_on_a_grid():
    for d in [-5, -1, 0, 1, 2, 2.5, 3, 4, 7, 8, 9, 16, 64, 1e999, -1e999]:
        for n in _RESOLUTIONS:
            for m in _MAX_DIVISORS:
                got = _clamp_divisor(d, n, m)
                assert got == jserve._clamp_divisor(d, n, m), (d, n, m)
                assert got >= 1 and n % got == 0


def test_decimate_plane_equals_jax():
    rng = np.random.default_rng(3)
    for n in (16, 48, 64):
        for divisor in (1, 2, 4, 8):
            if n % divisor:
                continue
            x = rng.normal(size=(n, n)).astype(np.float32)
            nrm = rng.normal(size=(n, n, 3)).astype(np.float32)
            for plane, name in ((x, "height"), (nrm, "normal")):
                np.testing.assert_array_equal(
                    decimate_plane(plane, divisor, name),
                    jserve.decimate_plane(plane, divisor, name))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("is_normal", [False, True])
@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_device_pooling_matches_jax(divisor, is_normal, dtype):
    """The torch pooling against JAX's jitted _pool_on_device on the same
    plane: within 1e-6·max at f32 (another summation order), within one
    f16 ulp on the f16 wire (one side may round the other way)."""
    rng = np.random.default_rng(divisor * 10 + is_normal)
    shape = (64, 64, 3) if is_normal else (64, 64)
    x = rng.normal(size=shape).astype(np.float32)
    if is_normal:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    got = _pool_on_device(divisor, is_normal, dtype)(torch.from_numpy(x))
    want = np.asarray(jserve._pool_on_device(divisor, is_normal, dtype)(
        jnp.asarray(x)))
    assert got.dtype == getattr(torch, dtype) and want.dtype == dtype
    got = got.numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(
            got, decimate_plane(x, divisor, "normal" if is_normal else "h"),
            rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        _assert_within_f16_ulp(got, want)


# ------------------------------------------------ the modules as processes

def test_stream_client_module_in_its_own_process(tmp_path):
    """python -m tpu_ocean_torch.stream_client --device cpu: three frames
    read from its own server, a shaded PNG written, exit 0."""
    out = tmp_path / "stream.png"
    r = subprocess.run([sys.executable, "-m", "tpu_ocean_torch.stream_client",
                        "--device", "cpu", "--frames", "3", "--res", "32",
                        "--out", str(out)], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-1000:]
    assert r.stderr.count("step ") == 3
    assert os.path.getsize(out) > 300


def test_serve_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, tpu_ocean_torch.serve, tpu_ocean_torch.stream_client, "
            "tpu_ocean_torch.demo\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_ocean')]\n"
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1000:]
