"""Consume a live tpu-ocean frame stream — the renderer side of ``serve``.

JAX counterpart: ``examples/stream_client.py``, with the same flags plus
``--device``. Without ``--host`` it serves the ocean preset from this
process (a ``FrameServer`` on the card, or on the CPU with ``--device
cpu``); with ``--host``/``--port`` it reads a running server, e.g. one of
``python -m tpu_ocean_torch serve``. It reads K frames, prints each one's
step, time and height range on stderr, and writes a shaded PNG of the last
frame (``viz.save_render_png``)::

    python -m tpu_ocean_torch.stream_client --frames 10 --out out/stream.png
    python -m tpu_ocean_torch.stream_client --host 10.0.0.2 --port 7777
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from types import SimpleNamespace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_ocean_torch.stream_client")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--host", type=str, default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", type=str, default="out/stream.png")
    ap.add_argument("--lod", type=int, default=0,
                    help="spatial LOD: power-of-two resolution divisor")
    ap.add_argument("--camera", type=float, default=0.0,
                    help="camera distance (m): the server picks the divisor")
    ap.add_argument("--stride", type=int, default=0,
                    help="temporal LOD: receive every k-th frame")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the self-contained server (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from tpu_ocean_torch.serve import stream_frames

    server = pump_thread = None
    pump_error = []
    if args.host:
        host, port = args.host, args.port
    else:
        # self-contained demo: serve the ocean preset from this process
        import torch
        from tpu_ocean_torch.config import OCEAN_DEMO
        from tpu_ocean_torch.runtime import Simulation
        from tpu_ocean_torch.serve import FrameServer

        cfg = OCEAN_DEMO.replace(resolution=args.res,
                                 length=float(args.res))
        sim = Simulation(cfg, fft_backend="matmul",
                         generator=torch.Generator().manual_seed(0),
                         device=args.device)
        server = FrameServer(sim, fields=("height", "normal", "foam"))
        host, port = server.address

        def pump():
            # wait for our own subscription so no frame precedes the
            # client, then stop() → EOF, so the client never blocks even
            # if the drop policy thinned the stream below --frames
            try:
                while server.client_count == 0 and not server.stopped:
                    time.sleep(0.01)
                # a strided client reads every k-th broadcast
                server.run(args.frames * max(1, args.stride) + 4)
            except Exception as e:       # reported by the main thread
                pump_error.append(e)
            finally:
                server.stop()

        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()

    last = None
    lod_kw = {}
    if args.lod:
        lod_kw["lod"] = args.lod
    if args.camera:
        lod_kw["camera_distance"] = args.camera
    if args.stride:
        lod_kw["frame_stride"] = args.stride
    for meta, planes in stream_frames(host, port, max_frames=args.frames,
                                      **lod_kw):
        h = planes["height"]
        print(f"step {meta['step']:4d}  t={meta['t']:7.3f}s  "
              f"h in [{h.min():+.3f}, {h.max():+.3f}]  "
              f"foam {planes.get('foam', h).mean():.4f}", file=sys.stderr)
        last = planes

    if server is not None:
        server.stop()
        # the pump steps the solver: join it before the interpreter exits
        pump_thread.join(timeout=30)
        if pump_thread.is_alive():
            print("the server's pump did not stop", file=sys.stderr)
            return 1
        if pump_error:
            raise pump_error[0]
    if last is None:
        print("no frames received", file=sys.stderr)
        return 1

    if {"normal", "foam"} <= set(last):
        from tpu_ocean_torch import viz
        viz.save_render_png(args.out, SimpleNamespace(**last))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
