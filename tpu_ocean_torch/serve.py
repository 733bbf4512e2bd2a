"""Frame serving: stream solver fields to remote consumers in real time.

JAX counterpart: ``tpu_ocean/serve.py``, with the same wire, byte for byte.
The chip that simulates is not the machine that renders, so the
reference's per-frame hand-off (OceanRenderer.cs:98-136) becomes a network
stream:

    FrameServer — owns a runtime.Simulation (or CascadeSimulation,
        PondSimulation), steps it, and broadcasts the requested field
        planes to every connected client with real-time drop semantics: a
        slow client's queue drops its oldest frames (the bounded-ring
        policy of the native AsyncExporter) instead of applying
        backpressure to the solver loop.

    stream_frames — the matching client: a generator of
        (meta, {field: ndarray}) tuples.

Wire protocol (version tag "tpu-ocean/1", little-endian planes):

    client → server on connect (optional, one JSON line): {"lod": d} (a
        power-of-two resolution divisor), {"camera_distance": meters}
        (mapped through lod_divisor_for_distance), {"frame_stride": k}
        (every k-th frame), {"dtype": "float16"} (half-width planes, cast
        on the device before the pull) and {"codec": "zlib"} (zlib-1 of
        each frame's plane blob; the meta line then carries "nbytes").
        A client that sends nothing gets the raw f32 full grid after a
        0.25 s negotiation window.
    server → client on connect:  one JSON line
        {"proto": "tpu-ocean/1", "resolution": N/d, "length": L,
         "lod": d, "frame_stride": k, "full_resolution": N,
         "fields": [...], "dtype": "float32"|"float16",
         "codec": "none"|"zlib"}
    per frame:                   one JSON line {"step": k, "t": seconds}
      followed by the (N/d)×(N/d) planes of each declared field, in
      declared order (normal is (N/d)×(N/d)×3).

The device side differs from the JAX package's synchronous pull. Each
frame's planes are mean-pooled and cast on the device, then copied into
pinned host buffers (one set per (divisor, dtype) tier) with
``non_blocking`` copies on a side stream that waits on the step's stream,
fenced by an event. ``run`` keeps one frame in flight: frame k's pull
overlaps step k + 1 on the device, and frame k is sent after step k + 1
is done. Everything CUDA runs on the thread that calls ``run``; the sender
threads handle bytes only. On the CPU the same code copies plainly.
"""

from __future__ import annotations

import functools
import json
import math
import queue
import socket
import threading
import zlib
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

PROTO = "tpu-ocean/1"

#: fields streamable per frame: OceanFields leaves with a fixed wire shape,
#: and "velocity", the solver's analytic ∂h/∂t computed per frame
STREAMABLE = ("height", "disp_x", "disp_z", "pos_x", "pos_z", "normal",
              "foam", "jacobian", "velocity")


def lod_divisor_for_distance(camera_distance: float, length: float,
                             resolution: int,
                             reference_distance: float = 100.0,
                             max_divisor: int = 8) -> int:
    """Camera distance → served-resolution divisor, the spatial half of the
    camera LOD whose temporal half is lod.periods_for_distance (the same
    reference distance). At or below it the full grid is served; each
    doubling of distance halves the served resolution. ``length`` is kept
    for the signature of periods_for_distance. Clamped to a power of two
    ≤ max_divisor that divides the grid into at least 8×8 texels."""
    d = 1
    if not math.isfinite(camera_distance):
        # json reads 1e999 as inf, and log2(inf) overflows: an infinitely
        # far camera gets the coarsest divisor
        d = max_divisor if camera_distance > 0 else 1
    elif camera_distance > reference_distance:
        d = 2 ** int(math.log2(camera_distance / reference_distance))
    return _clamp_divisor(d, resolution, max_divisor)


def _clamp_divisor(d: int, resolution: int, max_divisor: int = 8) -> int:
    """Largest power of two ≤ d that divides ``resolution`` into ≥8 texels."""
    try:
        d = int(d)                   # int(inf) raises OverflowError
    except OverflowError:
        d = max_divisor if d > 0 else 1
    d = max(1, min(d, max_divisor))
    d = 2 ** int(np.log2(d))
    while d > 1 and (resolution % d != 0 or resolution // d < 8):
        d //= 2
    return d


@functools.lru_cache(maxsize=None)
def _pool_on_device(divisor: int, is_normal: bool, dtype: str):
    """The device twin of decimate_plane and the wire dtype's cast: the
    pooling and the f16 narrowing run on the plane's device before the
    pull, so the bytes pulled scale with 1/d² (and ½ on f16)."""
    def pool(x: torch.Tensor) -> torch.Tensor:
        if divisor > 1:
            m = x.shape[0] // divisor
            if is_normal:
                y = x.reshape(m, divisor, m, divisor, 3).mean(dim=(1, 3))
                norm = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
                x = y / torch.clamp(norm, min=1e-12)
            else:
                x = x.reshape(m, divisor, m, divisor).mean(dim=(1, 3))
        if dtype == "float16":
            x = x.to(torch.float16)
        return x

    return pool


class _LazyZlibPayload:
    """A frame payload whose zlib compression runs in the first sender
    thread that needs it (memoized under a lock), not in the solver loop:
    zlib releases the GIL on large buffers, so it overlaps the next step."""

    __slots__ = ("_meta", "_body", "_lock", "_bytes")

    def __init__(self, meta: dict, body):
        self._meta = meta
        self._body = body
        self._lock = threading.Lock()
        self._bytes = None

    def get(self) -> bytes:
        with self._lock:
            if self._bytes is None:
                comp = zlib.compress(self._body, 1)
                meta = dict(self._meta, nbytes=len(comp))
                self._bytes = (json.dumps(meta) + "\n").encode() + comp
                self._meta = self._body = None     # free the raw frame
            return self._bytes


def decimate_plane(x: np.ndarray, divisor: int, name: str) -> np.ndarray:
    """Mean-pool a served plane by ``divisor`` on the host (normals are
    pooled, then renormalized so they stay unit)."""
    if divisor == 1:
        return x
    n = x.shape[0]
    m = n // divisor
    if name == "normal":
        y = x.reshape(m, divisor, m, divisor, 3).mean(axis=(1, 3))
        norm = np.sqrt((y * y).sum(axis=-1, keepdims=True))
        return y / np.maximum(norm, np.float32(1e-12))
    return x.reshape(m, divisor, m, divisor).mean(axis=(1, 3))


class _Frame(NamedTuple):
    """A frame in flight: its meta line, the tiers due, each tier's host
    planes, and the event after their copies (None on the CPU)."""
    meta: dict
    due: list
    pulls: dict
    fence: Optional[torch.cuda.Event]


class FrameServer:
    """Broadcast a Simulation's fields to TCP clients, dropping for laggards.

    ``run(steps)`` drives the solver loop in the calling thread (accepting
    clients in the background); ``stop()``/context-manager exit shuts the
    listener and every client down. ``port=0`` binds an ephemeral port —
    read ``server.address`` after construction.
    """

    def __init__(self, sim, fields: Sequence[str] = ("height", "foam"),
                 host: str = "127.0.0.1", port: int = 0,
                 queue_frames: int = 4):
        unknown = set(fields) - set(STREAMABLE)
        if unknown:
            raise ValueError(f"cannot stream {sorted(unknown)}; "
                             f"streamable: {STREAMABLE}")
        if "velocity" in fields and not hasattr(sim.solver, "velocity"):
            raise ValueError(f"{type(sim.solver).__name__} does not "
                             f"provide velocity (∂h/∂t)")
        self.sim = sim
        self.fields = tuple(fields)
        self._queue_frames = queue_frames
        self.dropped_frames = 0          # across all clients, for observability
        self._clients = []               # list of dicts: queue, socket, tier
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._host_planes = {}           # (divisor, dtype) -> {name: tensor}
        self._copy_stream = None         # made by the first pull on a card

        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)   # so the accept loop can observe stop
        self.address = self._listener.getsockname()
        self._accept_thread.start()

    # ------------------------------------------------------------- plumbing

    def _frame_bytes_for(self, divisor: int,
                         dtype: str = "float32") -> int:
        m = self.sim.cfg.resolution // divisor
        item = 2 if dtype == "float16" else 4
        return sum(item * int(np.prod(_plane_shape(name, m)))
                   for name in self.fields)

    def _header_for(self, divisor: int, stride: int = 1,
                    dtype: str = "float32",
                    codec: str = "none") -> bytes:
        n = self.sim.cfg.resolution
        return (json.dumps({
            "proto": PROTO,
            "resolution": n // divisor,   # what the stream actually carries
            "length": self._world_length,
            "lod": divisor,
            "frame_stride": stride,
            "full_resolution": n,
            "fields": list(self.fields),
            "dtype": dtype,
            "codec": codec,
        }) + "\n").encode()

    def _negotiate_lod(self, conn: socket.socket):
        """Read the optional one-line request ({"lod": d},
        {"camera_distance": x}, {"frame_stride": k},
        {"dtype": "float16"|"float32"}, {"codec": "zlib"|"none"}); returns
        (divisor, stride, dtype, codec). A client that sends nothing gets
        the full grid at full rate in raw f32 after the window; every
        malformed value clamps to the defaults, so a client's bug never
        takes its handler down."""
        n = self.sim.cfg.resolution
        conn.settimeout(0.25)
        buf = b""
        try:
            while not buf.endswith(b"\n") and len(buf) < 1024:
                chunk = conn.recv(256)
                if not chunk:
                    break
                buf += chunk
        except OSError:                  # socket.timeout included
            pass
        finally:
            conn.settimeout(None)
        if not buf.strip():
            return 1, 1, "float32", "none"
        try:
            req = json.loads(buf)
        except ValueError:
            return 1, 1, "float32", "none"
        if not isinstance(req, dict):    # e.g. a bare '5\n'
            return 1, 1, "float32", "none"
        stride = 1
        try:
            stride = max(1, min(64, int(req.get("frame_stride", 1))))
        except (TypeError, ValueError, OverflowError):
            pass
        dtype = ("float16" if req.get("dtype") == "float16" else "float32")
        codec = "zlib" if req.get("codec") == "zlib" else "none"
        try:
            if "lod" in req:
                # _clamp_divisor converts (inf included); int() here would
                # overflow first
                return (_clamp_divisor(req["lod"], n), stride, dtype,
                        codec)
            if "camera_distance" in req:
                return (lod_divisor_for_distance(
                    float(req["camera_distance"]),
                    self._world_length, n), stride, dtype, codec)
        except (TypeError, ValueError, OverflowError):
            pass
        return 1, stride, dtype, codec

    def _accept_loop(self):
        """Accept only: each client negotiates in its own handler thread,
        so a silent client does not hold up the others' admission."""
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                   # listener closed by stop()
            threading.Thread(target=self._client_handler, args=(conn,),
                             daemon=True).start()

    def _client_handler(self, conn: socket.socket):
        """Negotiate, register the client, send the header, then become
        its sender thread. The client is registered before its header is
        sent, so a client that has read its header receives every frame
        broadcast after that. A failure closes only this connection."""
        q = queue.Queue(maxsize=self._queue_frames)
        try:
            divisor, stride, dtype, codec = self._negotiate_lod(conn)
            # bound the kernel's send buffer to ~2 frames, so the drop
            # policy (queue_frames), not tcp_wmem, caps the staleness
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                            max(65536,
                                2 * self._frame_bytes_for(divisor, dtype)))
            with self._lock:
                self._clients.append({"q": q, "conn": conn, "lod": divisor,
                                      "stride": stride, "seen": 0,
                                      "dtype": dtype, "codec": codec})
            conn.sendall(self._header_for(divisor, stride, dtype, codec))
        except OSError:
            self._drop_client(q, conn)
            return
        self._send_loop(q, conn)

    def _drop_client(self, q: queue.Queue, conn: socket.socket):
        conn.close()
        with self._lock:
            self._clients = [cl for cl in self._clients if cl["q"] is not q]

    def _send_loop(self, q: queue.Queue, conn: socket.socket):
        try:
            while True:
                try:
                    # a bounded wait, so stop() is always observed
                    payload = q.get(timeout=0.5)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                if payload is None:      # stop() sentinel
                    return
                if isinstance(payload, _LazyZlibPayload):
                    payload = payload.get()
                conn.sendall(payload)
        except OSError:
            pass                         # client went away
        finally:
            self._drop_client(q, conn)

    def _broadcast(self, payloads: dict):
        """Enqueue each client's tier-matched payload (a client whose tier
        has no payload, because it connected while the frame was in
        flight, skips that frame)."""
        if self._stop.is_set():          # racing stop(): don't bury sentinels
            return
        with self._lock:
            clients = list(self._clients)
        for cl in clients:
            q = cl["q"]
            # temporal LOD: every stride-th broadcast frame, counted per
            # client from its subscription
            cl["seen"] += 1
            if (cl["seen"] - 1) % cl["stride"] != 0:
                continue
            payload = payloads.get((cl["lod"], cl["dtype"],
                                    cl["codec"]))
            if payload is None:
                continue
            while True:
                try:
                    q.put_nowait(payload)
                    break
                except queue.Full:       # real-time policy: drop its oldest
                    try:
                        oldest = q.get_nowait()
                        if oldest is None:   # stop() sentinel, not a frame:
                            try:             # hand it back, drop this one
                                q.put_nowait(None)
                            except queue.Full:
                                pass
                            break
                        self.dropped_frames += 1
                    except queue.Empty:
                        pass

    # ----------------------------------------------------------------- API

    @property
    def client_count(self) -> int:
        with self._lock:
            return len(self._clients)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def _world_length(self) -> float:
        """The planes' physical extent (a cascade's display length; the
        pond's resolution × unit width), read at each header, so a header
        after a live reconfigure reports the new length."""
        sim = self.sim
        return (sim.world_length if hasattr(sim, "world_length")
                else sim.cfg.length)

    def _device_planes(self, fields) -> dict:
        """The served fields on the device: one solver-side compute a frame
        (velocity is derived here, once, for every tier); nothing is
        pulled yet."""
        def get(name):
            if name == "velocity":
                return self.sim.solver.velocity(self.sim.state)
            return getattr(fields, name)

        return {name: get(name) for name in self.fields}

    def _pulled_planes(self, dev: dict, divisor: int, dtype: str) -> dict:
        """Mean-pool by the divisor and cast to the wire dtype on the
        device, then copy into the tier's host buffers. On a card the
        copies are enqueued on the side stream after the step's stream's
        work and are done once ``_fence`` has been waited on; until then
        nothing may read the returned buffers."""
        pooled = {name: _pool_on_device(divisor, name == "normal",
                                        dtype)(x)
                  for name, x in dev.items()}
        host = self._host_buffers((divisor, dtype), pooled)
        x0 = next(iter(pooled.values()))
        if x0.device.type != "cuda":
            for name, x in pooled.items():
                host[name].copy_(x)
            return host
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(x0.device)
        stream = self._copy_stream
        stream.wait_stream(torch.cuda.current_stream(x0.device))
        with torch.cuda.stream(stream):
            for name, x in pooled.items():
                host[name].copy_(x, non_blocking=True)
                # the allocator must not hand x's memory to step k + 1
                # before this stream has read it
                x.record_stream(stream)
        return host

    def _host_buffers(self, tier: Tuple[int, str], pooled: dict) -> dict:
        """The tier's host planes, pinned where the planes are on a card;
        made again when a plane's shape changes (a reconfigure)."""
        bufs = self._host_planes.setdefault(tier, {})
        for name, x in pooled.items():
            b = bufs.get(name)
            if b is None or b.shape != x.shape:
                bufs[name] = torch.empty(x.shape, dtype=x.dtype,
                                         pin_memory=x.device.type == "cuda")
        return bufs

    def _fence(self):
        """An event after every copy enqueued so far on the side stream;
        None before the first pull on a card."""
        if self._copy_stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._copy_stream)
        return event

    def frame_payload(self, fields, divisor: int = 1,
                      dtype: str = "float32",
                      codec: str = "none") -> bytes:
        """Meta line + planes of one OceanFields, mean-pooled by the
        client's divisor — exposed for tests."""
        dev = self._device_planes(fields)
        pulled = self._pulled_planes(dev, divisor, dtype)
        fence = self._fence()
        if fence is not None:
            fence.synchronize()
        p = self._payload_from_pulled(pulled, self._meta(), dtype, codec)
        return bytes(p.get() if isinstance(p, _LazyZlibPayload) else p)

    def _meta(self) -> dict:
        return {"step": self.sim.step_count,
                "t": self.sim.step_count * self.sim.dt}

    def _payload_from_pulled(self, pulled: dict, meta: dict, dtype: str,
                             codec: str = "none"):
        """The wire bytes of one tier: the host planes copied once, into
        one buffer behind the meta line (zlib: the planes alone, which the
        sender thread compresses). The host planes may be reused once this
        returns."""
        wire = np.dtype("<f2" if dtype == "float16" else "<f4")
        planes = [pulled[name].numpy() for name in self.fields]
        head = b"" if codec == "zlib" else (json.dumps(meta) + "\n").encode()
        out = bytearray(len(head) + sum(p.size for p in planes)
                        * wire.itemsize)
        out[:len(head)] = head
        offset = len(head)
        for p in planes:
            view = np.frombuffer(out, dtype=wire, count=p.size, offset=offset)
            view[:] = p.reshape(-1)
            offset += p.size * wire.itemsize
        if codec == "zlib":
            # the sender thread compresses (see _LazyZlibPayload)
            return _LazyZlibPayload(meta, out)
        return out

    def _begin_frame(self, fields) -> Optional[_Frame]:
        """Pool and enqueue the pulls of the tiers due this frame, with
        the frame's meta taken now; None when no client is connected."""
        with self._lock:
            if not self._clients:
                return None
            # tiers due this frame (the stride phase)
            due = sorted({(cl["lod"], cl["dtype"], cl["codec"])
                          for cl in self._clients
                          if cl["seen"] % cl["stride"] == 0})
        # one field compute a frame; each (divisor, dtype) tier pulls its
        # pooled planes once, for every codec
        dev = self._device_planes(fields) if due else {}
        pulls = {}
        for key in due:
            if key[:2] not in pulls:
                pulls[key[:2]] = self._pulled_planes(dev, *key[:2])
        return _Frame(self._meta(), due, pulls, self._fence())

    def _end_frame(self, frame: _Frame):
        """Wait for the frame's pulls, then, unless the server has stopped
        (the frame is dropped), build its payloads and broadcast them. The
        broadcast runs even with no tier due: it advances every client's
        stride counter."""
        if frame.fence is not None:
            frame.fence.synchronize()
        if self._stop.is_set():
            return
        payloads = {key: self._payload_from_pulled(
                        frame.pulls[key[:2]], frame.meta, key[1], key[2])
                    for key in frame.due}
        self._broadcast(payloads)

    def run(self, steps: Optional[int] = None):
        """Step the simulation, broadcasting every frame; None = until
        stop(). The solver loop never blocks on a client. One frame is in
        flight: frame k's pull is enqueued, step k + 1 runs, then frame k
        is sent. The last frame is sent before run returns, so it holds
        the final state; a frame in flight at stop() is dropped."""
        done = 0
        frame = None
        while not self._stop.is_set() and (steps is None or done < steps):
            fields = self.sim.step()
            done += 1
            if frame is not None:
                self._end_frame(frame)
            frame = None if self._stop.is_set() else self._begin_frame(fields)
        if frame is not None:
            self._end_frame(frame)

    def stop(self):
        self._stop.set()
        self._listener.close()
        with self._lock:
            clients = list(self._clients)
        for q, conn in ((cl["q"], cl["conn"]) for cl in clients):
            # best-effort sentinel (make room if the queue is full): the
            # sender sees None, or an OSError from the closed socket
            try:
                q.put_nowait(None)
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _plane_shape(name: str, n: int) -> Tuple[int, ...]:
    return (n, n, 3) if name == "normal" else (n, n)


def _read_exact(sock_file, count: int) -> bytes:
    data = sock_file.read(count)
    if data is None or len(data) != count:
        raise ConnectionError("stream ended mid-frame")
    return data


def stream_frames(host: str, port: int,
                  max_frames: Optional[int] = None,
                  lod: Optional[int] = None,
                  camera_distance: Optional[float] = None,
                  frame_stride: Optional[int] = None,
                  dtype: Optional[str] = None,
                  codec: Optional[str] = None
                  ) -> Iterator[Tuple[dict, dict]]:
    """Connect to a FrameServer and yield (meta, {field: ndarray}) frames.

    ``lod`` requests planes decimated by that power-of-two divisor;
    ``camera_distance`` lets the server pick the divisor; ``frame_stride``
    asks for every k-th frame; ``dtype="float16"`` asks for the f16 wire
    (the planes still yield as f32 arrays); ``codec="zlib"`` for zlib-1
    frames. The header reports what was granted. The arrays are fresh
    copies. Stops after ``max_frames`` or when the server closes the
    stream.
    """
    req = {}
    if lod is not None:
        req["lod"] = int(lod)
    if camera_distance is not None:
        req["camera_distance"] = float(camera_distance)
    if frame_stride is not None:
        req["frame_stride"] = int(frame_stride)
    if dtype is not None:
        req["dtype"] = str(dtype)
    if codec is not None:
        req["codec"] = str(codec)
    with socket.create_connection((host, port)) as sock:
        # always send the request line (even empty): it ends the server's
        # negotiation window at once
        sock.sendall((json.dumps(req) + "\n").encode())
        f = sock.makefile("rb")
        header = json.loads(f.readline())
        if header.get("proto") != PROTO:
            raise ConnectionError(f"not a tpu-ocean stream: {header!r}")
        n = header["resolution"]
        wire = ("<f2" if header.get("dtype") == "float16" else "<f4")
        item = 2 if wire == "<f2" else 4
        zipped = header.get("codec") == "zlib"
        shapes = {name: _plane_shape(name, n) for name in header["fields"]}
        served = 0
        while max_frames is None or served < max_frames:
            line = f.readline()
            if not line:
                return                   # server closed between frames
            meta = json.loads(line)
            planes = {}
            if zipped:
                blob = zlib.decompress(_read_exact(f, int(meta["nbytes"])))
                off = 0
                for name, shape in shapes.items():
                    count = item * int(np.prod(shape))
                    planes[name] = np.frombuffer(
                        blob[off:off + count], wire).reshape(
                        shape).astype(np.float32)
                    off += count
            else:
                for name, shape in shapes.items():
                    raw = _read_exact(f, item * int(np.prod(shape)))
                    planes[name] = np.frombuffer(raw, wire).reshape(
                        shape).astype(np.float32)
            yield meta, planes
            served += 1
